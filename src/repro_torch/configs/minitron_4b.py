"""minitron-4b [dense]: pruned nemotron, 24H (row-TP on a 16-way model axis),
256k vocab. [arXiv:2407.14679]

Port of `repro/configs/minitron_4b.py`, value for value."""
from repro_torch.configs.base import ModelConfig

ID = "minitron-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="dense",
        pattern=("attn", "mlp"), n_rep=32,
        d_model=3072, num_heads=24, num_kv_heads=8, head_dim=128,
        d_ff=9216, vocab_size=256000,
        rope_theta=10_000.0, window=8_192,
        act="relu", num_vehicles=16, grad_accum=2,
        long_context_variant="swa",
        citation="arXiv:2407.14679",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_rep=2, d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, attn_chunk=64, num_vehicles=2,
        grad_accum=1, window=64)
