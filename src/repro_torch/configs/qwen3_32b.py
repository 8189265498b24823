"""qwen3-32b [dense]: 64L, GQA kv=8, qk-norm, RoPE. [hf:Qwen/Qwen3-8B]

Port of `repro/configs/qwen3_32b.py`, value for value."""
from repro_torch.configs.base import ModelConfig

ID = "qwen3-32b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense",
        pattern=("attn", "mlp"), n_rep=64,
        d_model=5120, num_heads=64, num_kv_heads=8, head_dim=128,
        d_ff=25600, vocab_size=151936,
        qk_norm=True, rope_theta=1_000_000.0, window=8_192,
        act="silu", num_vehicles=16, grad_accum=8,
        long_context_variant="swa",
        citation="hf:Qwen/Qwen3-8B",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_rep=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, attn_chunk=64, num_vehicles=2,
        grad_accum=1, window=64)
