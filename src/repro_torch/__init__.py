"""PyTorch/CUDA port of the VEDS + federated-learning system.

This package mirrors the module layout of the JAX package `repro`
(`repro/core/veds.py` <-> `repro_torch/core/veds.py`), which stays the
reference the port is held against. It imports torch, numpy and the
standard library only, never jax and nothing under `repro`.

Entry points take an explicit `device` and default to CUDA. Where no
CUDA device is present they raise instead of falling back to the CPU:
the CPU is used only when the caller asks for it (`device="cpu"`).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Raises when CUDA is asked for (or defaulted to) and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev
