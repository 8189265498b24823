"""The port's kernel modules (`veds_score`, `flash_attention`,
`fedavg_agg`) against the reference kernels.

On the CPU each wrapper runs its plain PyTorch version, which is held here
against the Pallas kernel (interpret mode, as the reference's own tests
run it) and its `ref.py` oracle. The CUDA kernels themselves run only on a
card: their tests are in `test_torch_cuda.py`.

`veds_score` tolerance: rtol 2e-6 with atol 0, elementwise. Both sides
are fp32 and run the same ops in the same order; XLA and PyTorch may
differ by an ulp or two in `log1p` and in the division by a constant.
Gains are realistic (1e-13..1e-11), so an absolute tolerance would hide
everything. The other kernels' tolerances are stated at their tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fedavg_agg.ops import fedavg_agg_tpu
from repro.kernels.fedavg_agg.ops import fedavg_agg_tree as j_fedavg_agg_tree
from repro.kernels.flash_attention.ops import flash_attention_tpu
from repro.kernels.veds_score.ops import veds_dt_score_tpu
from repro.kernels.veds_score.ref import veds_dt_score_ref
from repro.models.attention import flash_attention as j_attention
from repro_torch.kernels import build
from repro_torch.kernels.fedavg_agg.ops import (fedavg_agg, fedavg_agg_plain,
                                                fedavg_agg_tree)
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_fwd,
                                                     flash_attention_plain)
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


# ---------------------------------------------------------------------------
# flash_attention and fedavg_agg (plain versions; the kernels run on a card)
# ---------------------------------------------------------------------------

def _normal(shape, seed, dtype=np.float32):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x if dtype == np.float32 else jnp.asarray(x, jnp.bfloat16)


# the reference's kernel grid (tests/test_kernels.py:14); tolerance as
# there: 2e-5 in fp32, 2e-2 in bf16 (both sides round the output to bf16)
@pytest.mark.parametrize("t,s,h,kv,d,causal,window,dtype", [
    (128, 128, 4, 2, 32, True, None, "f32"),
    (256, 256, 4, 4, 64, True, 64, "f32"),
    (64, 256, 8, 2, 32, False, None, "f32"),
    (100, 200, 4, 1, 16, True, None, "f32"),
    (128, 128, 2, 2, 64, True, None, "bf16"),
])
def test_flash_attention_plain_matches_pallas_kernel_and_ref(
        t, s, h, kv, d, causal, window, dtype):
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    q = jnp.asarray(_normal((2, t, h, d), 1), jdt)
    k = jnp.asarray(_normal((2, s, kv, d), 2), jdt)
    v = jnp.asarray(_normal((2, s, kv, d), 3), jdt)
    off = s - t if causal else 0
    pallas = flash_attention_tpu(q, k, v, causal=causal, window=window,
                                 block_q=64, block_kv=64, q_offset=off)
    ref = flash_attention_tpu(q, k, v, causal=causal, window=window,
                              force_ref=True, q_offset=off)

    def port(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.float32 if dtype == "f32" else torch.bfloat16)

    out, lse = flash_attention_plain(port(q), port(k), port(v),
                                     causal=causal, window=window,
                                     q_offset=off)
    assert out.dtype == port(q).dtype and tuple(lse.shape) == (2, h, t)
    tol = 2e-5 if dtype == "f32" else 2e-2
    for other in (pallas, ref):
        np.testing.assert_allclose(out.float().numpy(),
                                   np.asarray(other, np.float32),
                                   atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,window,q_offset", [
    (True, None, 0), (True, 40, 0), (False, None, 0), (True, None, 24)])
def test_flash_attention_gradients_match_jax_grad_of_reference(
        causal, window, q_offset):
    """dq, dk, dv of the port's autograd Function (plain forward, flash
    backward in PyTorch ops, chunked over 32 query rows) against
    `jax.grad` of the reference's jnp attention, GQA layout, fp32:
    atol 2e-5 and rtol 2e-5."""
    B, T, S, KV, G, D = 2, 96, 120, 2, 3, 16
    q5 = _normal((B, T, KV, G, D), 4)
    k = _normal((B, S, KV, D), 5)
    v = _normal((B, S, KV, D), 6)
    ct = _normal((B, T, KV, G, D), 7)

    def jloss(q5, k, v):
        o = j_attention(q5, k, v, causal=causal, window=window, q_chunk=32,
                        kv_chunk=32, q_offset=q_offset)
        return jnp.sum(o * ct)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(q5), jnp.asarray(k),
                                            jnp.asarray(v))
    qt, kt, vt = (tt(x).requires_grad_() for x in (q5, k, v))
    o = flash_attention(qt.reshape(B, T, KV * G, D), kt, vt, causal=causal,
                        window=window, q_offset=q_offset, bwd_chunk=32)
    grads = torch.autograd.grad(o.reshape(B, T, KV, G, D), (qt, kt, vt),
                                tt(ct))
    for ours, ref in zip(grads, jg):
        np.testing.assert_allclose(tn(ours), np.asarray(ref), atol=2e-5,
                                   rtol=2e-5)


@pytest.mark.parametrize("v,l,dead", [(4, 1000, False), (8, 4096, False),
                                      (2, 37, False), (4, 100, True)])
def test_fedavg_agg_plain_matches_pallas_kernel_and_ref(v, l, dead):
    rng = np.random.default_rng(v * l)
    x = rng.normal(size=(v, l)).astype(np.float32)
    w = np.abs(rng.normal(size=v)).astype(np.float32)
    w = np.zeros_like(w) if dead else w * (rng.uniform(size=v) > 0.3)
    old = rng.normal(size=l).astype(np.float32)
    ours = tn(fedavg_agg_plain(tt(x), tt(w), tt(old)))
    for force_ref in (False, True):
        ref = fedavg_agg_tpu(jnp.asarray(x), jnp.asarray(w),
                             jnp.asarray(old), block_l=64,
                             force_ref=force_ref)
        np.testing.assert_allclose(ours, np.asarray(ref), atol=2e-5,
                                   rtol=2e-5)
    if dead:
        np.testing.assert_array_equal(ours, old)


def test_fedavg_agg_tree_matches_reference_leaf_by_leaf():
    rng = np.random.default_rng(11)
    shapes = {"a": (3, 5), "b": [(7,), (2, 2, 3)]}
    tree = {"a": rng.normal(size=(4,) + shapes["a"]).astype(np.float32),
            "b": [rng.normal(size=(4,) + s).astype(np.float32)
                  for s in shapes["b"]]}
    old = {"a": tree["a"][0], "b": [x[0] for x in tree["b"]]}
    w = np.array([1.0, 0.0, 2.0, 1.0], np.float32)
    ref = j_fedavg_agg_tree(jax.tree.map(jnp.asarray, tree),
                            jnp.asarray(w), jax.tree.map(jnp.asarray, old))
    ours = fedavg_agg_tree(jax.tree.map(tt, tree), tt(w),
                           jax.tree.map(tt, old))
    for a, b in zip(jax.tree.leaves(jax.tree.map(tn, ours,
                                                 is_leaf=torch.is_tensor)),
                    jax.tree.leaves(ref)):
        np.testing.assert_allclose(a, np.asarray(b), atol=2e-5, rtol=2e-5)


def test_new_wrappers_run_plain_versions_on_cpu_without_counting():
    q = tt(_normal((1, 8, 2, 16), 8))
    k = tt(_normal((1, 8, 1, 16), 9))
    n_fa, n_fed = flash_attention_fwd.launches, fedavg_agg.launches
    o, lse = flash_attention_fwd(q, k, k)
    o2, lse2 = flash_attention_plain(q, k, k)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    x = tt(_normal((3, 10), 10))
    w = torch.tensor([1.0, 2.0, 0.0])
    assert torch.equal(fedavg_agg(x, w, x[0]), fedavg_agg_plain(x, w, x[0]))
    assert (flash_attention_fwd.launches, fedavg_agg.launches) == \
        (n_fa, n_fed)


def test_new_wrappers_refuse_other_devices_and_bad_shapes():
    m = torch.zeros((1, 8, 2, 16), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention_fwd(m, m[:, :, :1], m[:, :, :1])
    with pytest.raises(ValueError, match="KV must divide H"):
        flash_attention_fwd(torch.zeros(1, 8, 3, 16),
                            torch.zeros(1, 8, 2, 16),
                            torch.zeros(1, 8, 2, 16))
    with pytest.raises(ValueError, match="window"):
        flash_attention_fwd(torch.zeros(1, 8, 2, 16),
                            torch.zeros(1, 8, 2, 16),
                            torch.zeros(1, 8, 2, 16), window=0)
    x = torch.zeros((2, 4), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fedavg_agg(x, torch.zeros(2, device="meta"),
                   torch.zeros(4, device="meta"))


def test_build_takes_the_new_kernel_sources():
    srcs = [p.relative_to(build.KERNELS_DIR).as_posix()
            for p in build.sources()]
    assert "flash_attention/csrc/flash_attention.cu" in srcs
    assert "fedavg_agg/csrc/fedavg_agg.cu" in srcs
