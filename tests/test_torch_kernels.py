"""The port's kernel modules (`veds_score`, `flash_attention`,
`fedavg_agg`, `ssd_scan`) against the reference kernels.

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
from repro.kernels.ssd_scan.ops import ssd_scan_tpu
from repro.kernels.ssd_scan.ref import ssd_scan_ref
from repro.kernels.veds_score.ops import veds_dt_score_tpu
from repro.kernels.veds_score.ref import veds_dt_score_ref
from repro.models.attention import flash_attention as j_attention
from repro.models.blocks import _ssd_chunk_scan as j_ssd_chunk_scan
from repro_torch.kernels import build
from repro_torch.kernels.fedavg_agg.ops import (fedavg_agg, fedavg_agg_plain,
                                                fedavg_agg_tree)
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_fwd,
                                                     flash_attention_plain)
from repro_torch.kernels.ssd_scan.ops import (ssd_scan, ssd_scan_fwd,
                                              ssd_scan_naive, ssd_scan_plain)
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


def test_build_hashes_headers_so_a_header_edit_rebuilds(tmp_path,
                                                       monkeypatch):
    """The library's name keys every file under `kernels/**/csrc/`: an
    edit of the shared header alone gives another name (a rebuild), an
    edit outside `csrc/` does not; the kernels directory is on nvcc's
    include path, where the sources find `csrc/hopper.cuh`."""
    assert "-I" in build.NVCC_FLAGS
    assert build.NVCC_FLAGS[build.NVCC_FLAGS.index("-I") + 1] == \
        str(build.KERNELS_DIR)
    files = [p.relative_to(build.KERNELS_DIR).as_posix()
             for p in build.csrc_files()]
    assert "csrc/hopper.cuh" in files
    assert "flash_attention/csrc/flash_attention_sm90.cu" in files
    for rel in files:
        dst = tmp_path / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_bytes((build.KERNELS_DIR / rel).read_bytes())
    (tmp_path / "ops.py").write_text("x = 1\n")
    monkeypatch.setattr(build, "KERNELS_DIR", tmp_path)
    name = build.library_name()
    assert name == build.library_name()
    (tmp_path / "ops.py").write_text("x = 2\n")
    assert build.library_name() == name
    header = tmp_path / "csrc" / "hopper.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert build.library_name() != name


# ---------------------------------------------------------------------------
# flash_attention and fedavg_agg (plain versions; the kernels run on a card)
# ---------------------------------------------------------------------------

def _normal(shape, seed, dtype=np.float32):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return x if dtype == np.float32 else jnp.asarray(x, jnp.bfloat16)


# the reference's kernel grid (tests/test_kernels.py:14) and zamba2's head
# dim 80; tolerance as there: 2e-5 in fp32, 2e-2 in bf16 (both sides round
# the output to bf16)
@pytest.mark.parametrize("t,s,h,kv,d,causal,window,dtype", [
    (128, 128, 4, 2, 32, True, None, "f32"),
    (256, 256, 4, 4, 64, True, 64, "f32"),
    (64, 256, 8, 2, 32, False, None, "f32"),
    (100, 200, 4, 1, 16, True, None, "f32"),
    (128, 128, 2, 2, 64, True, None, "bf16"),
    (128, 128, 4, 4, 80, True, None, "f32"),
    (96, 160, 4, 2, 80, True, 48, "bf16"),
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


# ---------------------------------------------------------------------------
# ssd_scan (plain version, naive recurrence and the autograd Function; the
# kernel runs on a card)
# ---------------------------------------------------------------------------

def _ssd_inputs(B, T, H, P, N, seed, decay=1.0):
    """v [B,T,H,P], b/c [B,T,N], log_a [B,T,H] = -decay * softplus(normal)
    (<= 0), as the reference's kernel test draws it."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(B, T, H, P)).astype(np.float32)
    b = rng.normal(size=(B, T, N)).astype(np.float32)
    c = rng.normal(size=(B, T, N)).astype(np.float32)
    la = (-decay * np.logaddexp(rng.normal(size=(B, T, H)), 0.0)).astype(
        np.float32)
    return v, b, c, la


# the reference's kernel grid (tests/test_kernels.py:37-41), in the Pallas
# layout [BH, T, *] = the port's layout with H = 1; tolerance as there:
# 5e-4 in fp32, 5e-2 in bf16 (both sides round y to bf16)
@pytest.mark.parametrize("bh,t,p,n,chunk,dtype", [
    (4, 64, 16, 8, 16, "f32"),
    (6, 96, 32, 16, 32, "f32"),
    (2, 40, 8, 4, 16, "f32"),    # ragged T -> pad path
    (2, 64, 16, 8, 32, "bf16"),
])
def test_ssd_scan_plain_matches_pallas_kernel_and_ref(bh, t, p, n, chunk,
                                                      dtype):
    v, b, c, la = _ssd_inputs(bh, t, 1, p, n, bh * t)
    jdt = jnp.float32 if dtype == "f32" else jnp.bfloat16
    jv, jb, jc = (jnp.asarray(x, jdt) for x in (v[:, :, 0], b, c))
    pallas = ssd_scan_tpu(jv, jb, jc, jnp.asarray(la[..., 0]), chunk=chunk)
    ref = ssd_scan_tpu(jv, jb, jc, jnp.asarray(la[..., 0]), force_ref=True)

    def port(x):
        return tt(np.asarray(x, np.float32)).to(
            torch.float32 if dtype == "f32" else torch.bfloat16)

    y, state = ssd_scan_plain(port(jv)[:, :, None], port(jb), port(jc),
                              tt(la), chunk)
    assert y.dtype == port(jv).dtype and tuple(y.shape) == (bh, t, 1, p)
    assert tuple(state.shape) == (bh, 1, n, p)
    tol = 5e-4 if dtype == "f32" else 5e-2
    for other in (pallas, ref):
        np.testing.assert_allclose(y[:, :, 0].float().numpy(),
                                   np.asarray(other, np.float32), atol=tol,
                                   rtol=tol)


@pytest.mark.parametrize("T,chunk,H", [(64, 16, 3), (64, 64, 3), (96, 32, 1),
                                       (128, 128, 2)])
def test_ssd_scan_plain_and_naive_match_model_scan(T, chunk, H):
    """`ssd_scan_plain` (shared b/c, H heads) and the naive recurrence
    against the reference model's `_ssd_chunk_scan`: y and the final
    state, fp32, atol = rtol = 5e-5 (sums in other orders over up to 128
    steps). The decay keeps the reference finite (its masked product
    gives NaN once a chunk's decay passes ~88: see the next test)."""
    v, b, c, la = _ssd_inputs(2, T, H, 8, 4, T + chunk, decay=0.5)
    s0 = np.random.default_rng(5).normal(size=(2, H, 4, 8)).astype(
        np.float32)
    for state0 in (None, s0):
        jy, js = j_ssd_chunk_scan(
            *(jnp.asarray(x) for x in (v, b, c, la)), chunk,
            None if state0 is None else jnp.asarray(state0))
        assert np.isfinite(np.asarray(jy)).all()
        t0 = None if state0 is None else tt(state0)
        for y, s in (ssd_scan_plain(tt(v), tt(b), tt(c), tt(la), chunk, t0),
                     ssd_scan_naive(tt(v), tt(b), tt(c), tt(la), t0)):
            np.testing.assert_allclose(tn(y), np.asarray(jy), atol=5e-5,
                                       rtol=5e-5)
            np.testing.assert_allclose(tn(s), np.asarray(js), atol=5e-5,
                                       rtol=5e-5)


def _per_head(v, b, c, la):
    """The model's layout (v [B,T,H,P], b/c [B,T,N] shared by the heads,
    log_a [B,T,H]) as the Pallas kernel's [BH, T, *] (b and c repeated for
    each head)."""
    B, T, H, P = v.shape
    return (v.transpose(0, 2, 1, 3).reshape(B * H, T, P),
            np.repeat(b, H, axis=0), np.repeat(c, H, axis=0),
            la.transpose(0, 2, 1).reshape(B * H, T))


def test_ssd_scan_plain_stays_finite_where_the_reference_gives_nan():
    """The reference model's fault (`repro/models/blocks.py:343-349`): at
    zamba2's chunk of 128 with log_a = -softplus(normal) (A = -1 and dt =
    softplus, as at init), a chunk's decays sum past ~88, exp(cum_i -
    cum_j) above the diagonal overflows, and `s * causal * dec` makes
    0 * inf = NaN. At chunk 32 it is finite. The port masks the exponent
    and computes what the Pallas kernel (a select) and its oracle (the
    O(T) recurrence) compute: y within atol = rtol = 5e-4 of both (the
    reference's fp32 kernel tolerance), and the gradients of sum(y * ct)
    for v, b, c and log_a within 1e-4 of each one's largest entry of
    `jax.grad` of `ssd_scan_ref`."""
    v, b, c, la = _ssd_inputs(1, 256, 2, 8, 16, 0)
    assert float(-la[0, :128].sum(axis=0).min()) > 88.7
    jy, _ = j_ssd_chunk_scan(*(jnp.asarray(x) for x in (v, b, c, la)), 128)
    assert np.isnan(np.asarray(jy)).any()
    jy32, _ = j_ssd_chunk_scan(*(jnp.asarray(x) for x in (v, b, c, la)), 32)
    assert np.isfinite(np.asarray(jy32)).all()

    ts = [tt(x).requires_grad_() for x in (v, b, c, la)]
    y, s = ssd_scan(*ts, 128)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    pv, pb, pc, pla = (jnp.asarray(x) for x in _per_head(v, b, c, la))
    yh = tn(y).transpose(0, 2, 1, 3).reshape(2, 256, 8)
    for other in (ssd_scan_tpu(pv, pb, pc, pla, chunk=128),
                  ssd_scan_tpu(pv, pb, pc, pla, force_ref=True)):
        np.testing.assert_allclose(yh, np.asarray(other), atol=5e-4,
                                   rtol=5e-4)
    np.testing.assert_allclose(tn(y), np.asarray(jy32), atol=5e-4,
                               rtol=5e-4)

    ct = np.random.default_rng(1).normal(size=v.shape).astype(np.float32)
    got = torch.autograd.grad((y * tt(ct)).sum(), ts)
    cth = jnp.asarray(ct.transpose(0, 2, 1, 3).reshape(2, 256, 8))
    gv, gb, gc, gla = jax.grad(
        lambda *a: jnp.sum(ssd_scan_ref(*a) * cth), argnums=(0, 1, 2, 3))(
            pv, pb, pc, pla)
    want = (np.asarray(gv).reshape(1, 2, 256, 8).transpose(0, 2, 1, 3),
            np.asarray(gb).sum(0, keepdims=True),     # b, c shared by heads
            np.asarray(gc).sum(0, keepdims=True),
            np.asarray(gla).reshape(1, 2, 256).transpose(0, 2, 1))
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(tn(g), w, rtol=0,
                                   atol=1e-4 * float(np.abs(w).max()))


@pytest.mark.parametrize("T,chunk,with_state0", [(64, 16, False),
                                                 (40, 16, False),
                                                 (64, 32, True)])
def test_ssd_scan_function_gradients_match_jax_grad_of_reference(
        T, chunk, with_state0):
    """dv, db, dc, dlog_a (and dstate0) of `SsdScanFn` (plain forward on
    the CPU, backward by autograd through the plain version) against
    `jax.grad` of the reference's `_ssd_chunk_scan` with random
    cotangents on y and the final state, fp32: atol 5e-5 and rtol 5e-5.
    T = 40 takes the pad path (the reference pads nothing: its chunk is
    8, which divides 40 and gives the same function)."""
    H, P, N = 3, 8, 4
    v, b, c, la = _ssd_inputs(2, T, H, P, N, T, decay=0.5)
    rng = np.random.default_rng(T + 1)
    cy = rng.normal(size=v.shape).astype(np.float32)
    cs = rng.normal(size=(2, H, N, P)).astype(np.float32)
    s0 = rng.normal(size=(2, H, N, P)).astype(np.float32) if with_state0 \
        else None
    jchunk = chunk if T % chunk == 0 else 8

    def jloss(v, b, c, la, s0):
        y, s = j_ssd_chunk_scan(v, b, c, la, jchunk, s0)
        return jnp.sum(y * cy) + jnp.sum(s * cs)

    args = [jnp.asarray(x) for x in (v, b, c, la)] + \
        [None if s0 is None else jnp.asarray(s0)]
    argnums = (0, 1, 2, 3, 4) if with_state0 else (0, 1, 2, 3)
    jg = jax.grad(jloss, argnums=argnums)(*args)
    ts = [tt(x).requires_grad_() for x in (v, b, c, la)]
    t0 = None if s0 is None else tt(s0).requires_grad_()
    y, s = ssd_scan(*ts, chunk, t0)
    wrt = ts + ([t0] if with_state0 else [])
    grads = torch.autograd.grad((y * tt(cy)).sum() + (s * tt(cs)).sum(), wrt)
    for ours, ref in zip(grads, jg):
        np.testing.assert_allclose(tn(ours), np.asarray(ref), atol=5e-5,
                                   rtol=5e-5)


def test_ssd_scan_wrapper_runs_plain_version_on_cpu_without_counting():
    v, b, c, la = (tt(x) for x in _ssd_inputs(1, 48, 2, 8, 4, 9))
    n = ssd_scan_fwd.launches
    y, s = ssd_scan_fwd(v, b, c, la, 16)
    y2, s2 = ssd_scan_plain(v, b, c, la, 16)
    assert torch.equal(y, y2) and torch.equal(s, s2)
    assert ssd_scan_fwd.launches == n


def test_ssd_scan_wrapper_refuses_other_devices_and_bad_shapes():
    v, b, c, la = (tt(x) for x in _ssd_inputs(1, 16, 2, 8, 4, 10))
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_scan_fwd(*(x.to("meta") for x in (v, b, c, la)), 16)
    with pytest.raises(ValueError, match="does not fit"):
        ssd_scan_fwd(v, b, c, la[:, :, :1], 16)
    with pytest.raises(ValueError, match="need v"):
        ssd_scan_fwd(v[:, :, 0], b, c, la, 16)
    with pytest.raises(ValueError, match="state0"):
        ssd_scan_fwd(v, b, c, la, 16, torch.zeros(1, 2, 4, 4))
    assert "ssd_scan/csrc/ssd_scan.cu" in [
        p.relative_to(build.KERNELS_DIR).as_posix() for p in build.sources()]
