"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks, 7:1 ratio (48 = 6 x (7 mLSTM +
1 sLSTM)). d_ff=0: blocks carry internal up/down projections.
[arXiv:2405.04517]

Port of `repro/configs/xlstm_1p3b.py`, value for value."""
from repro_torch.configs.base import ModelConfig

ID = "xlstm-1.3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ID, family="ssm",
        pattern=("mlstm",) * 7 + ("slstm",),
        n_rep=6,
        d_model=2048, num_heads=4, num_kv_heads=4, head_dim=512,
        d_ff=0, vocab_size=50304,
        lstm_proj_factor=2.0, ssm_chunk=128,
        act="silu", num_vehicles=16, grad_accum=4,
        long_context_variant="native",
        citation="arXiv:2405.04517",
    )


def smoke_config() -> ModelConfig:
    return config().replace(
        n_rep=1, pattern=("mlstm", "mlstm", "slstm"),
        d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
        vocab_size=512, ssm_chunk=32, num_vehicles=2, grad_accum=1)
