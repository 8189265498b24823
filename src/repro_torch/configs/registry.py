"""Architecture registry: --arch <id> resolution for launch/train.

Port of `repro/configs/registry.py`. `ARCH_IDS` is the reference's tuple;
`qwen3-32b` (dense, GQA) and `zamba2-2.7b` (hybrid: Mamba2 and a
weight-tied attention block) are ported so far. Every other id raises
`NotImplementedError` naming the slice of the port that brings its
blocks.
"""
from __future__ import annotations

from typing import Tuple

from repro_torch.configs import qwen3_32b, zamba2_2p7b
from repro_torch.configs.base import ModelConfig

ARCH_IDS: Tuple[str, ...] = (
    "zamba2-2.7b", "xlstm-1.3b", "qwen3-32b", "starcoder2-15b",
    "minitron-4b", "llama-3.2-vision-90b", "granite-moe-1b-a400m",
    "whisper-small", "codeqwen1.5-7b", "llama4-scout-17b-a16e")

_PORTED = {qwen3_32b.ID: qwen3_32b, zamba2_2p7b.ID: zamba2_2p7b}

# what each unported architecture still needs (ROADMAP.md queue 1)
_WAITS_FOR = {
    "xlstm-1.3b": "the xLSTM blocks (mlstm/slstm, queue 1 item 9)",
    "starcoder2-15b": "the rest of the LLM zoo (queue 1 item 9)",
    "minitron-4b": "row-parallel attention (queue 1 item 9)",
    "llama-3.2-vision-90b": "the vlm projector and cross-attention "
                            "sources (queue 1 item 9)",
    "granite-moe-1b-a400m": "the MoE blocks (queue 1 item 9)",
    "whisper-small": "the encoder (queue 1 item 9)",
    "codeqwen1.5-7b": "the rest of the LLM zoo (queue 1 item 9)",
    "llama4-scout-17b-a16e": "the MoE blocks (queue 1 item 9)",
}


def _module(arch: str):
    if arch in _PORTED:
        return _PORTED[arch]
    if arch in ARCH_IDS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet: it waits for "
            f"{_WAITS_FOR[arch]}; ported: {sorted(_PORTED)}")
    raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).config()


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).smoke_config()
