"""whisper-small [audio]: enc-dec; 12 encoder + 12 decoder layers.

The mel-spectrogram + conv frontend is a stub: the batch carries
precomputed frame embeddings `src` [B, 1536, 768] (1500 frames padded to
1536). Decoder = (self-attn, cross-attn, mlp) x 12. [arXiv:2212.04356]

Port of `repro/configs/whisper_small.py`, value for value."""
from repro_torch.configs.base import ModelConfig

ID = "whisper-small"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="audio",
        pattern=("attn", "cross", "mlp"), n_rep=12,
        encoder_layers=12,
        d_model=768, num_heads=12, num_kv_heads=12, head_dim=64,
        d_ff=3072, vocab_size=51865,
        num_src_tokens=1536, src_dim=768,
        rope_theta=10_000.0, window=8_192,
        act="gelu", num_vehicles=16, grad_accum=1,
        long_context_variant="swa",
        citation="arXiv:2212.04356",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_rep=2, encoder_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        head_dim=64, d_ff=512, vocab_size=512, num_src_tokens=32, src_dim=256,
        attn_chunk=64, num_vehicles=2, grad_accum=1, window=64)
