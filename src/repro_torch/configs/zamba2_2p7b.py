"""zamba2-2.7b [hybrid]: Mamba2 backbone + shared attention blocks.

54 sub-layers = 9 super-blocks x (5 Mamba2 + 1 shared attn(+mlp)); the
attention/MLP pair is weight-tied across super-blocks (Zamba2's shared
transformer block). [arXiv:2411.15242]

Port of `repro/configs/zamba2_2p7b.py`, value for value."""
from repro_torch.configs.base import ModelConfig

ID = "zamba2-2.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="hybrid",
        pattern=("mamba", "mamba", "mamba", "mamba", "mamba", "attn", "mlp"),
        n_rep=9, shared_attn=True,
        d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
        d_ff=10240, vocab_size=32000,
        ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_conv_k=4,
        ssm_chunk=128,
        rope_theta=10_000.0, window=8_192,
        act="silu", num_vehicles=16, grad_accum=4,
        long_context_variant="native",
        citation="arXiv:2411.15242",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_rep=1, pattern=("mamba", "mamba", "attn", "mlp"),
        d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        d_ff=512, vocab_size=512, ssm_chunk=32, attn_chunk=64,
        num_vehicles=2, grad_accum=1, window=64)
