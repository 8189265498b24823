"""Unified model/run configuration.

Port of `repro/configs/base.py`: `ModelConfig` and `ShapeConfig` are
declared again field for field (the tests pin them against the
reference), and `dtype`/`pdtype` give `torch.dtype`s. An architecture is
a sequence of super-blocks: `pattern` (a short list of sub-block kinds)
stacked `n_rep` times.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

# Sub-block kinds understood by the transformer engine.
ATTN = "attn"            # full (causal) self-attention + MLP handled separately
ATTN_SWA = "attn_swa"    # sliding-window self-attention
CROSS = "cross"          # cross-attention to source embeddings
MLP = "mlp"
MOE = "moe"
MAMBA = "mamba"          # Mamba2 / SSD block
MLSTM = "mlstm"
SLSTM = "slstm"

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)

SHAPES_BY_NAME = {s.name: s for s in INPUT_SHAPES}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense|moe|ssm|hybrid|vlm|audio|cnn
    # super-block structure: `pattern` stacked `n_rep` times, plus
    # optional prologue blocks. total sub-layers = len(pattern) * n_rep.
    pattern: Tuple[str, ...]
    n_rep: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # attention details
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    window: int = 8_192              # sliding window size for ATTN_SWA
    attn_chunk: int = 512            # q-chunk for flash-style attention
    shared_attn: bool = False        # Zamba2-style weight-tied attn block
    # MoE
    num_experts: int = 0
    experts_per_tok: int = 0
    moe_d_ff: int = 0
    shared_expert: bool = False
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_k: int = 4
    ssm_chunk: int = 256
    # xLSTM
    lstm_proj_factor: float = 2.0
    # cross-attention sources (vlm frames / audio frames); stub frontends
    num_src_tokens: int = 0
    src_dim: int = 0
    # encoder (whisper-style); encoder uses ATTN (non-causal) + MLP
    encoder_layers: int = 0
    # activations / numerics
    act: str = "silu"
    tie_embeddings: bool = False
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # FL / distribution
    num_vehicles: int = 16           # vehicle groups on the data axis (1 = FSDP)
    grad_accum: int = 1              # microbatch accumulation inside local SGD
    remat: bool = True
    # "tp": model dims sharded over the model axis (default).
    # "dp": params replicated, per-vehicle batch sharded over the model axis.
    sharding_profile: str = "tp"
    long_context_variant: str = "swa"  # "native" (ssm) | "swa" (dense fallback)
    citation: str = ""

    # ---- derived -----------------------------------------------------------
    @property
    def num_layers(self) -> int:
        return len(self.pattern) * self.n_rep + 2 * self.encoder_layers

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // self.num_kv_heads

    @property
    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def supports_shape(self, shape: ShapeConfig) -> bool:
        return True  # all assigned archs decode; long ctx uses swa/native

    def effective_window(self, seq_len: int) -> int:
        return min(self.window, seq_len)


def round_up(x: int, m: int) -> int:
    return int(math.ceil(x / m) * m)
