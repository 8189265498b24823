"""granite-moe-1b-a400m [moe]: 24L, 32 experts top-8, expert d_ff=512.
[hf:ibm-granite/granite-3.0-1b-a400m-base]

Port of `repro/configs/granite_moe_1b.py`, value for value."""
from repro_torch.configs.base import ModelConfig

ID = "granite-moe-1b-a400m"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="moe",
        pattern=("attn", "moe"), n_rep=24,
        d_model=1024, num_heads=16, num_kv_heads=8, head_dim=64,
        d_ff=512, vocab_size=49155,
        num_experts=32, experts_per_tok=8, moe_d_ff=512,
        rope_theta=10_000.0, window=8_192,
        act="silu", num_vehicles=16, grad_accum=1,
        long_context_variant="swa",
        citation="hf:ibm-granite/granite-3.0-1b-a400m-base",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_rep=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=128, vocab_size=512, num_experts=4, experts_per_tok=2,
        moe_d_ff=128, attn_chunk=64, num_vehicles=2, grad_accum=1, window=64)
