"""Tests of the port that need an NVIDIA GPU: the CUDA kernels against
their plain PyTorch versions on the card. Marked `cuda`; each skips
itself where no card is present. This file imports no jax, so it also
runs on a machine without the reference package's toolchain:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.veds_score.ops import (veds_dt_score,
                                                veds_dt_score_plain)
from torch_port_util import require_cuda

KW = dict(V=0.2, kappa=0.1, bw=20e6, noise=8.007e-14, p_max=0.3)


def _inputs(shape, seed, device):
    rng = np.random.default_rng(seed)
    g = (10.0 ** rng.uniform(-13, -11, shape)).astype(np.float32)
    g[rng.random(shape) < 0.2] = 0.0
    q = np.abs(rng.normal(0, 0.1, shape)).astype(np.float32)
    w = (np.abs(rng.normal(0, 1, shape)) * 1e-7).astype(np.float32)
    e = rng.random(shape) < 0.75
    return tuple(torch.from_numpy(x).to(device) for x in (g, q, w, e))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 10), (1 << 20,), (0,)])
def test_veds_score_kernel_matches_plain_version(shape):
    """The kernel and the plain version run the same fp32 ops in the same
    order, with IEEE division and CUDA's log1pf, so they agree to the
    bit. One launch per call, none for an empty grid."""
    require_cuda()
    g, q, w, e = _inputs(shape, 3, "cuda")
    before = veds_dt_score.launches
    outs = veds_dt_score(g, q, w, e, **KW)
    torch.cuda.synchronize()
    assert veds_dt_score.launches == before + (g.numel() > 0)
    for a, b in zip(outs, veds_dt_score_plain(g, q, w, e, **KW)):
        assert a.shape == g.shape and a.device == g.device
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_veds_score_wrapper_checks_its_inputs():
    require_cuda()
    g, q, w, e = _inputs((64,), 4, "cuda")
    with pytest.raises(ValueError, match="contiguous"):
        veds_dt_score(g[::2], q[::2], w[::2], e[::2], **KW)
    with pytest.raises(ValueError, match="float32"):
        veds_dt_score(g, q.double(), w, e, **KW)
    with pytest.raises(ValueError, match="shape"):
        veds_dt_score(g, q[:32], w, e, **KW)
    with pytest.raises(ValueError, match="cuda"):
        veds_dt_score(g, q.cpu(), w, e, **KW)
