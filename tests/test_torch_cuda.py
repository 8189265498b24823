"""Tests of the port that need an NVIDIA GPU: the CUDA kernels
(`veds_score`, `flash_attention`, `fedavg_agg`) against their plain
PyTorch versions on the card. Marked `cuda`; each skips
itself where no card is present. This file imports no jax, so it also
runs on a machine without the reference package's toolchain:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fedavg_agg.ops import fedavg_agg, fedavg_agg_plain
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_fwd,
                                                     flash_attention_plain)
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


# ---------------------------------------------------------------------------
# flash_attention and fedavg_agg
# ---------------------------------------------------------------------------

def _qkv(B, T, S, H, KV, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, T, H, D), (B, S, KV, D), (B, S, KV, D)))


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,H,KV,D,causal,window,off,dtype", [
    (128, 128, 4, 2, 32, True, None, 0, torch.float32),
    (256, 256, 4, 4, 64, True, 64, 0, torch.float32),
    (64, 256, 8, 2, 32, False, None, 0, torch.float32),
    (100, 200, 4, 1, 16, True, None, 100, torch.float32),
    (128, 128, 2, 2, 64, True, None, 0, torch.bfloat16),
    (1000, 1000, 16, 2, 128, True, None, 0, torch.bfloat16),
    (77, 131, 8, 8, 128, True, 50, 54, torch.float32),
])
def test_flash_attention_kernel_matches_plain_version(
        T, S, H, KV, D, causal, window, off, dtype):
    """Kernel vs plain version on the card: out within 2e-5 (fp32) or
    2e-2 (bf16; both round the fp32 result to bf16 once), lse within
    1e-4. One launch per call."""
    require_cuda()
    q, k, v = _qkv(2, T, S, H, KV, D, dtype, T + S)
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal,
                                         window=window, q_offset=off)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_flash_attention_function_gradients_on_card():
    """The Function (kernel forward, PyTorch-ops backward) against
    autograd through the plain version, both on the card, fp32."""
    require_cuda()
    q, k, v = (x.requires_grad_() for x in
               _qkv(2, 96, 96, 6, 2, 32, torch.float32, 5))
    out = flash_attention(q, k, v, causal=True, bwd_chunk=32)
    ct = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), ct)
    ref, _ = flash_attention_plain(q, k, v, causal=True)
    want = torch.autograd.grad(ref, (q, k, v), ct)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_unembed_of_bf16_on_card_matches_cpu():
    """`layers.unembed` on bf16 inputs, card against CPU: float32 logits
    within 1e-5 of the largest; bf16 gradients from a float32 cotangent
    within one bf16 ulp (or 1e-6 of the largest entry where a sum
    cancels), with at most 1% of the entries differing at all."""
    require_cuda()
    from repro_torch.models import layers as L
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(64, 96, generator=gen).bfloat16()
    w = (0.1 * torch.randn(96, 200, generator=gen)).bfloat16()
    g = torch.randn(64, 200, generator=gen)
    res = []
    for dev in ("cpu", "cuda"):
        xd, wd = (t.to(dev).requires_grad_() for t in (x, w))
        out = L.unembed({"w": wd}, xd)
        assert out.dtype == torch.float32
        res.append((out, *torch.autograd.grad(out, (xd, wd), g.to(dev))))
    for ours, ref in zip(res[1], res[0]):
        ours, ref = ours.float().cpu(), ref.float()
        if ours.shape == (64, 200):
            torch.testing.assert_close(
                ours, ref, atol=1e-5 * float(ref.abs().max()), rtol=0)
            continue
        big = torch.maximum(ours.abs(), ref.abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
        tol = torch.clamp_min(ulp, 1e-6 * float(ref.abs().max()))
        assert bool(((ours - ref).abs() <= tol).all())
        assert float((ours != ref).float().mean()) <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("V,L,dtype,dead,offset", [
    (4, 1 << 20, torch.bfloat16, False, 0),
    (4, 1 << 20, torch.float32, False, 0),
    (3, 1001, torch.bfloat16, False, 0),    # ragged L: scalar path
    (4, 4096, torch.float32, True, 0),      # every upload failed
    (4, 4096, torch.bfloat16, False, 1),    # misaligned: scalar path
])
def test_fedavg_agg_kernel_matches_plain_version(V, L, dtype, dead, offset):
    """Kernel vs plain version on the card: fp32 within 2e-5; bf16
    within 2e-2 (the fp32 sums may round to neighbouring bf16 values);
    Sigma w = 0 returns `old` exactly."""
    require_cuda()
    g = torch.Generator(device="cuda").manual_seed(V * L)
    x = torch.randn((V * L + offset,), generator=g, device="cuda").to(
        dtype)[offset:].reshape(V, L)
    old = torch.randn((L,), generator=g, device="cuda").to(dtype)
    w = torch.rand((V,), generator=g, device="cuda") * 3
    if dead:
        w = torch.zeros_like(w)
    before = fedavg_agg.launches
    out = fedavg_agg(x, w, old)
    torch.cuda.synchronize()
    assert fedavg_agg.launches == before + 1
    assert out.dtype == dtype and out.shape == (L,)
    if dead:
        assert torch.equal(out, old)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(),
                               fedavg_agg_plain(x, w, old).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
def test_new_kernel_wrappers_check_their_inputs():
    require_cuda()
    q, k, v = _qkv(1, 16, 16, 2, 1, 32, torch.float32, 1)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q[..., :24].contiguous(),
                            k[..., :24].contiguous(),
                            v[..., :24].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="must be"):
        flash_attention_fwd(q, k.double(), v)
    x = torch.zeros((2, 8), device="cuda")
    with pytest.raises(ValueError, match="float32"):
        fedavg_agg(x, torch.zeros(2, device="cuda", dtype=torch.float64),
                   x[0])
    with pytest.raises(ValueError, match="contiguous"):
        fedavg_agg(x[:, ::2], torch.zeros(2, device="cuda"), x[0, ::2])
