"""Shared helpers of the port's tests (`test_torch_*.py`): moving data
between the JAX reference and the PyTorch port as numpy arrays, and the
skip rule of the tests that need a CUDA card."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core.veds import RoundInputs


def tt(x, dtype=None):
    """A JAX or numpy array as a CPU tensor (copied, writable)."""
    return torch.tensor(np.array(x), dtype=dtype)


def tn(x):
    """A tensor or JAX array as a numpy array."""
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def round_to_torch(rnd) -> RoundInputs:
    """A reference `RoundInputs` (JAX arrays) as the port's, on the CPU."""
    return RoundInputs(**{
        f.name: (None if getattr(rnd, f.name) is None
                 else tt(getattr(rnd, f.name)))
        for f in dataclasses.fields(RoundInputs)})


def require_cuda():
    """Skip the calling test unless a CUDA card is present. Called inside
    the test, never at import, so every worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with the CUDA toolkit (nvcc); "
                    "the CUDA kernel cannot run on the CPU")
