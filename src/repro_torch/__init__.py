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


def device_scalar(x, like: torch.Tensor) -> torch.Tensor:
    """`x` as a 0-dim float32 tensor on `like`'s device, filled there
    (no copy from the host, so a CUDA graph may capture it); a tensor
    passes through. Decision paths divide by this, never by a Python
    number: PyTorch's CUDA division by a Python number multiplies by its
    rounded reciprocal, which can land an ulp away from the correctly
    rounded quotient that the CPU and the reference compute; division
    by a tensor is correctly rounded on both."""
    if torch.is_tensor(x):
        return x
    return torch.full((), x, dtype=torch.float32, device=like.device)


def is_fake(x: torch.Tensor) -> bool:
    """Whether `x` is, or an op on it makes, a fake tensor
    (`torch._subclasses.fake_tensor.FakeTensorMode`): one that stands
    for a tensor on its device and holds no data, so its values cannot
    be read and no CUDA graph can capture work on it."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import is_fake as _is_fake
    return _is_fake(x) or detect_fake_mode() is not None
