"""The port's `veds_score` kernel module against the reference kernel.

On the CPU the wrapper runs the plain PyTorch version, which is held here
against the Pallas kernel (interpret mode, as the reference's own tests
run it) and its `ref.py` oracle. The CUDA kernel itself runs only on a
card: its tests are in `test_torch_cuda.py`.

Tolerance: rtol 2e-6 with atol 0, elementwise. Both sides are fp32 and
run the same ops in the same order; XLA and PyTorch may differ by an ulp
or two in `log1p` and in the division by a constant. Gains are realistic
(1e-13..1e-11), so an absolute tolerance would hide everything.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.veds_score.ops import veds_dt_score_tpu
from repro.kernels.veds_score.ref import veds_dt_score_ref
from repro_torch.kernels import build
from repro_torch.kernels.veds_score.ops import (NEG, veds_dt_score,
                                                veds_dt_score_plain)
from torch_port_util import tn, tt

KW = dict(V=0.2, kappa=0.1, bw=20e6, noise=8.007e-14, p_max=0.3)
RTOL = 2e-6


def _inputs(shape, seed):
    """Realistic candidate grids: gains 1e-13..1e-11 with dead links,
    queues, sigmoid weights, and an eligibility mask with one all-False
    row where the grid has rows."""
    rng = np.random.default_rng(seed)
    g = (10.0 ** rng.uniform(-13, -11, shape)).astype(np.float32)
    g[rng.random(shape) < 0.2] = 0.0
    q = np.abs(rng.normal(0, 0.1, shape)).astype(np.float32)
    q[rng.random(shape) < 0.1] = 0.0          # empty queue: q_eff = 1e-9
    w = (np.abs(rng.normal(0, 1, shape)) * 1e-7).astype(np.float32)
    e = rng.random(shape) < 0.75
    if len(shape) == 2:
        e[0] = False
    return g, q, w, e


def _check(a, b, e, g):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)
    dead = ~(e & (g > 0))
    assert (a[dead] == b[dead]).all()


@pytest.mark.parametrize("shape", [(100,), (17,), (1, 10), (3, 10),
                                   (7, 13)])
def test_plain_matches_pallas_kernel_and_ref(shape):
    g, q, w, e = _inputs(shape, seed=sum(shape))
    ours = veds_dt_score_plain(tt(g), tt(q), tt(w), tt(e), **KW)
    pallas = veds_dt_score_tpu(jnp.asarray(g), jnp.asarray(q),
                               jnp.asarray(w), jnp.asarray(e),
                               block_c=8, **KW)
    ref = veds_dt_score_ref(jnp.asarray(g), jnp.asarray(q),
                            jnp.asarray(w), jnp.asarray(e), **KW)
    for o, p_, r in zip(ours, pallas, ref):
        assert tuple(o.shape) == shape and o.dtype == torch.float32
        _check(tn(o), p_, e, g)
        _check(tn(o), r, e, g)
    y, p, z = (tn(o) for o in ours)
    dead = ~(e & (g > 0))
    assert (y[dead] == NEG).all()
    assert not p[dead].any() and not z[dead].any()
    assert (p >= 0).all() and (p <= KW["p_max"]).all()


def test_wrapper_runs_plain_version_on_cpu_without_counting():
    g, q, w, e = _inputs((3, 10), seed=5)
    before = veds_dt_score.launches
    outs = veds_dt_score(tt(g), tt(q), tt(w), tt(e), **KW)
    plain = veds_dt_score_plain(tt(g), tt(q), tt(w), tt(e), **KW)
    for a, b in zip(outs, plain):
        assert torch.equal(a, b)
    assert veds_dt_score.launches == before


def test_wrapper_refuses_other_devices():
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        veds_dt_score(x, x, x, x.bool(), **KW)


def test_build_takes_every_source_for_sm90a_without_fast_math():
    srcs = [p.relative_to(build.KERNELS_DIR).as_posix()
            for p in build.sources()]
    assert "veds_score/csrc/veds_score.cu" in srcs
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert "--fmad=false" in build.NVCC_FLAGS
    assert build.BUILD_DIR.relative_to(build.REPO_ROOT).parts[0] == "build"
