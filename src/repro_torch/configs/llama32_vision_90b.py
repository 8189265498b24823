"""llama-3.2-vision-90b [vlm]: 100 decoder layers = 20 x (4 self + 1 cross).

The vision tower is a stub: the batch carries precomputed patch
embeddings `src` [B, 2048, 1280]; a linear projector maps them to
d_model. [hf:meta-llama/Llama-3.2-11B-Vision]

Port of `repro/configs/llama32_vision_90b.py`, value for value."""
from repro_torch.configs.base import ModelConfig

ID = "llama-3.2-vision-90b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="vlm",
        pattern=("attn", "mlp", "attn", "mlp", "attn", "mlp", "attn", "mlp",
                 "cross", "mlp"),
        n_rep=20,
        d_model=8192, num_heads=64, num_kv_heads=8, head_dim=128,
        d_ff=28672, vocab_size=128256,
        num_src_tokens=2048, src_dim=1280,
        rope_theta=500_000.0, window=8_192,
        act="silu", num_vehicles=1, grad_accum=8,
        long_context_variant="swa",
        citation="hf:meta-llama/Llama-3.2-11B-Vision",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_rep=1, pattern=("attn", "mlp", "cross", "mlp"),
        d_model=256, num_heads=4, num_kv_heads=2, head_dim=64,
        d_ff=512, vocab_size=512, num_src_tokens=32, src_dim=48,
        attn_chunk=64, num_vehicles=1, grad_accum=1, window=64)
