"""Architecture registry: --arch <id> resolution for launch/train.

Port of `repro/configs/registry.py`. `ARCH_IDS` is the reference's tuple,
and every id is ported: the dense `qwen3-32b`, `starcoder2-15b`,
`codeqwen1.5-7b` and `minitron-4b`, the hybrid `zamba2-2.7b` (Mamba2 and
a weight-tied attention block), the MoE `granite-moe-1b-a400m` and
`llama4-scout-17b-a16e`, the xLSTM `xlstm-1.3b`, the encoder-decoder
`whisper-small` and the vlm `llama-3.2-vision-90b` (the last two take a
`src` batch entry).
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs import (codeqwen_7b, granite_moe_1b,
                                 llama32_vision_90b, llama4_scout,
                                 minitron_4b, qwen3_32b, starcoder2_15b,
                                 whisper_small, xlstm_1p3b, zamba2_2p7b)
from repro_torch.configs.base import ModelConfig

ARCH_IDS: Tuple[str, ...] = (
    "zamba2-2.7b", "xlstm-1.3b", "qwen3-32b", "starcoder2-15b",
    "minitron-4b", "llama-3.2-vision-90b", "granite-moe-1b-a400m",
    "whisper-small", "codeqwen1.5-7b", "llama4-scout-17b-a16e")

_PORTED = {m.ID: m for m in (qwen3_32b, zamba2_2p7b, starcoder2_15b,
                              codeqwen_7b, minitron_4b, granite_moe_1b,
                              llama4_scout, xlstm_1p3b, whisper_small,
                              llama32_vision_90b)}


def _module(arch: str):
    if arch in _PORTED:
        return _PORTED[arch]
    raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
