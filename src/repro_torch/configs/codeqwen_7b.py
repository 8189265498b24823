"""codeqwen1.5-7b [dense]: 32L, kv=32 (MHA-style GQA), RoPE.
[hf:Qwen/CodeQwen1.5-7B]

Port of `repro/configs/codeqwen_7b.py`, value for value."""
from repro_torch.configs.base import ModelConfig

ID = "codeqwen1.5-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense",
        pattern=("attn", "mlp"), n_rep=32,
        d_model=4096, num_heads=32, num_kv_heads=32, head_dim=128,
        d_ff=13440, vocab_size=92416,
        rope_theta=1_000_000.0, window=8_192,
        act="silu", num_vehicles=16, grad_accum=4,
        long_context_variant="swa",
        citation="hf:Qwen/CodeQwen1.5-7B",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_rep=2, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512, attn_chunk=64, num_vehicles=2,
        grad_accum=1, window=64)
