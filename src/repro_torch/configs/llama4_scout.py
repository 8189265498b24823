"""llama4-scout-17b-a16e [moe]: 48L, 16 experts top-1 + shared expert,
40H (row-TP on a 16-way model axis). ~109B total params -> num_vehicles=1
with ZeRO-style data-axis sharding; federation over the pod axis on the
multi-pod mesh. [hf:meta-llama/Llama-4-Scout-17B-16E]

Port of `repro/configs/llama4_scout.py`, value for value."""
from repro_torch.configs.base import ModelConfig

ID = "llama4-scout-17b-a16e"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="moe",
        pattern=("attn", "moe"), n_rep=48,
        d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
        d_ff=8192, vocab_size=202048,
        num_experts=16, experts_per_tok=1, moe_d_ff=8192,
        shared_expert=True,
        rope_theta=500_000.0, window=8_192,
        act="silu", num_vehicles=1, grad_accum=4,
        long_context_variant="swa",
        citation="hf:meta-llama/Llama-4-Scout-17B-16E",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_rep=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=128, vocab_size=512, num_experts=4, experts_per_tok=1,
        moe_d_ff=128, attn_chunk=64, num_vehicles=1, grad_accum=1, window=64)
