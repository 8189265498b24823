"""DT candidate scoring (Prop. 1 + objective 21a): CUDA kernel wrapper and
its plain PyTorch version.

The kernel (`csrc/veds_score.cu`) replaces the Pallas TPU kernel
`repro/kernels/veds_score/veds_score.py`. `veds_dt_score` takes candidate
grids of any shape, the scheduler's batched [B, S] grid included, by
flattening into the kernel's 1-D candidate layout and restoring the shape
on the way out. For tensors on the CPU it runs `veds_dt_score_plain`; for
CUDA tensors it launches the kernel, or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels.build import load_library

LN2 = 0.6931471805599453
NEG = -1e30
# g, q, w, e, y, p, z pointers; n; V, kappa, bw, noise, p_max; stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int64]
             + [ctypes.c_float] * 5 + [ctypes.c_void_p])


def veds_dt_score_plain(g, q, w, e, *, V, kappa, bw, noise, p_max):
    """The same function in plain PyTorch, op for op as the kernel and the
    reference (`repro/kernels/veds_score/ref.py`). The scalar divisors are
    0-dim tensors on the inputs' device (filled there, not copied from
    the host): PyTorch's CUDA division by a Python scalar multiplies by
    its reciprocal instead, which rounds differently from the IEEE
    division of the kernel and the reference."""
    def const(x):
        return torch.full((), x, dtype=torch.float32, device=g.device)

    a = g / const(noise)
    cw = V * w * kappa * bw / const(LN2)
    q_eff = torch.clamp_min(q * kappa, 1e-9)
    p = torch.clamp(cw / q_eff - 1.0 / torch.clamp_min(a, 1e-30),
                    0.0, p_max)
    rate = bw * torch.log1p(p * a) / const(LN2)
    z = kappa * rate
    y = V * w * z - q * kappa * p
    valid = e & (g > 0)
    return (torch.where(valid, y, NEG), torch.where(valid, p, 0.0),
            torch.where(valid, z, 0.0))


def veds_dt_score(g, q, w, e, *, V, kappa, bw, noise, p_max):
    """Score every DT candidate: returns (y, p, z), each shaped like `g`.

    g, q, w: float32; e: bool; all of one shape, contiguous, on one device.
    Adds one to `veds_dt_score.launches` each time it launches the kernel.
    """
    kw = dict(V=V, kappa=kappa, bw=bw, noise=noise, p_max=p_max)
    if g.device.type == "cpu":
        return veds_dt_score_plain(g, q, w, e, **kw)
    if g.device.type != "cuda":
        raise ValueError(f"veds_dt_score: unsupported device {g.device}")
    for name, x, dtype in (("g", g, torch.float32), ("q", q, torch.float32),
                           ("w", w, torch.float32), ("e", e, torch.bool)):
        if x.device != g.device or x.dtype != dtype:
            raise ValueError(f"veds_dt_score: {name} must be {dtype} on "
                             f"{g.device}, got {x.dtype} on {x.device}")
        if x.shape != g.shape:
            raise ValueError(f"veds_dt_score: {name} has shape "
                             f"{tuple(x.shape)}, g has {tuple(g.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"veds_dt_score: {name} is not contiguous")
    y, p, z = (torch.empty_like(g) for _ in range(3))
    n = g.numel()
    if n == 0:
        return y, p, z
    lib = load_library()
    fn = lib.function("veds_score_f32", _ARGTYPES)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        rc = fn(g.data_ptr(), q.data_ptr(), w.data_ptr(), e.data_ptr(),
                y.data_ptr(), p.data_ptr(), z.data_ptr(), n,
                V, kappa, bw, noise, p_max, stream)
    lib.check(rc, "veds_score")
    veds_dt_score.launches += 1
    return y, p, z


veds_dt_score.launches = 0
