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


def p4_candidates(U, seed, B=2, S=3, device="cpu"):
    """A slot's [B, S, U] candidates as `core/veds.py _cot_candidates`
    lays them out (OPV prefixes, cw broadcast over them), from numpy:
    gains of 1e-13..1e-11 W over a noise of 8e-14 W, one infeasible SOV
    (its link stronger than every OPV's, so d0 >= 0) and unscheduled
    OPVs (a = 0 outside each prefix), and one SOV whose weight is too
    small to transmit at all (its value floored at 0)."""
    rng = np.random.default_rng(seed)
    noise = 8.007e-14
    g_sr = 10.0 ** rng.uniform(-13, -11, (B, S))
    g_so = np.sort(10.0 ** rng.uniform(-12.5, -10.5, (B, S, U)))[..., ::-1]
    g_or = 10.0 ** rng.uniform(-13, -11, (B, S, U))
    g_sr[0, 0] = 2.0 * g_so[0, 0, 0]                      # infeasible
    prefix = np.arange(U)[:, None] >= np.arange(U)[None, :]
    a_opv = np.where(prefix, (g_or / noise)[..., None, :], 0.0)
    a0 = np.broadcast_to((g_sr / noise)[..., None, None], (B, S, U, 1))
    d0 = ((g_sr[..., None] - g_so) / noise)[..., None]
    a = np.concatenate([a0, a_opv], -1)
    d = np.concatenate([d0, a_opv], -1)
    q = np.concatenate([np.broadcast_to(rng.uniform(1e-4, 5e-2, (B, S, 1, 1)),
                                        (B, S, U, 1)),
                        np.where(prefix, rng.uniform(1e-4, 5e-2,
                                                     (B, S, 1, U)), 0.0)],
                       -1)
    q = np.maximum(q, 1e-9)
    cw = rng.uniform(1e-3, 2.0, (B, S))
    cw[-1, -1] = 1e-7                 # not worth transmitting: p = 0
    t = [torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
         for x in (a, q, d)]
    cw = torch.from_numpy(cw.astype(np.float32)).to(device)
    return cw[..., None].expand(B, S, U), *t, torch.full_like(t[0], 0.3)


def p4_table(shape, seed, device="cpu"):
    """A warm table as the streaming path carries one: earlier optima,
    OPV powers of infeasible candidates at 1e-9 W among them."""
    rng = np.random.default_rng(seed)
    tab = rng.uniform(0.0, 0.3, shape)
    tab[rng.random(shape) < 0.3] = 1e-9
    return torch.from_numpy(tab.astype(np.float32)).to(device)
