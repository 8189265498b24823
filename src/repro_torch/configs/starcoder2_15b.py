"""starcoder2-15b [dense]: 40L, GQA kv=4, RoPE, gelu MLP. [arXiv:2402.19173]

Port of `repro/configs/starcoder2_15b.py`, value for value."""
from repro_torch.configs.base import ModelConfig

ID = "starcoder2-15b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense",
        pattern=("attn", "mlp"), n_rep=40,
        d_model=6144, num_heads=48, num_kv_heads=4, head_dim=128,
        d_ff=24576, vocab_size=49152,
        rope_theta=100_000.0, window=8_192,
        act="gelu", num_vehicles=16, grad_accum=4,
        long_context_variant="swa",
        citation="arXiv:2402.19173",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_rep=2, d_model=256, num_heads=8, num_kv_heads=2, head_dim=32,
        d_ff=512, vocab_size=512, attn_chunk=64, num_vehicles=2,
        grad_accum=1, window=64)
