"""DT candidate scoring (Prop. 1 + objective 21a): CUDA kernel wrapper and
its plain PyTorch version.

The kernel (`csrc/veds_score.cu`) replaces the Pallas TPU kernel
`repro/kernels/veds_score/veds_score.py`. `veds_dt_score` takes candidate
grids of any shape, the scheduler's batched [B, S] grid included, by
flattening into the kernel's 1-D candidate layout and restoring the shape
on the way out. For tensors on the CPU it runs `veds_dt_score_plain`; for
CUDA tensors it launches the kernel, or raises.

The launch is safe to capture into a CUDA graph (`core/veds.py` replays
the VEDS slot step as one): it goes on PyTorch's current stream, which is
the capturing stream during a capture, allocates only through
`torch.empty` and does not synchronise (but once a process and device,
outside any capture, when it makes the device's counter of the kernel's
runs).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from repro_torch.kernels import (DeviceCounts, check_device, register_cost,
                                 through_operator)
from repro_torch.kernels.build import load_library

LN2 = 0.6931471805599453
NEG = -1e30
# a candidate moves 13 bytes in (g, q, w fp32, e bool) and 12 out (y, p, z
# fp32), for 24 fp32 operations (log1p counted as one)
VEDS_BYTES_PER_ELEM = 25
VEDS_OPS_PER_ELEM = 24
# g, q, w, e, y, p, z pointers; n; V, kappa, bw, noise, p_max; the run
# counter (or null); stream
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int64]
             + [ctypes.c_float] * 5 + [ctypes.c_void_p] * 2)


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


@functools.cache
def _launcher():
    """The library and its `veds_score_f32`, resolved once per process."""
    lib = load_library()
    return lib, lib.function("veds_score_f32", _ARGTYPES)


class _VedsDtScore(DeviceCounts):
    """The kernel's wrapper; `veds_dt_score` is its one instance.

    `veds_dt_score(g, q, w, e, *, V, kappa, bw, noise, p_max)` scores every
    DT candidate and returns (y, p, z), each shaped like `g`. g, q, w:
    float32; e: bool; all of one shape, contiguous, on one device.

    `launches` counts the kernel's runs on the card, as the kernel itself
    counts them (`DeviceCounts`), graph replays included; launches made
    under `uncounted()` are not counted.
    """

    def __init__(self):
        super().__init__("veds_dt_score")

    def __call__(self, g, q, w, e, *, V, kappa, bw, noise, p_max):
        """Through the custom operator `torch.ops.repro.veds_dt_score`
        where a mode must see it (`through_operator`)."""
        check_device("veds_dt_score", g)
        if through_operator(g):
            return torch.ops.repro.veds_dt_score(
                g, q, w, e, float(V), float(kappa), float(bw), float(noise),
                float(p_max))
        return _veds_dt_score_impl(g, q, w, e, V, kappa, bw, noise, p_max)

    def _launch(self, g, q, w, e, V, kappa, bw, noise, p_max):
        """The operator's implementation on CUDA tensors: the checks,
        then the kernel's launch."""
        for name, x, dtype in (("g", g, torch.float32),
                               ("q", q, torch.float32),
                               ("w", w, torch.float32),
                               ("e", e, torch.bool)):
            if x.device != g.device or x.dtype != dtype:
                raise ValueError(f"veds_dt_score: {name} must be {dtype} on "
                                 f"{g.device}, got {x.dtype} on {x.device}")
            if x.shape != g.shape:
                raise ValueError(f"veds_dt_score: {name} has shape "
                                 f"{tuple(x.shape)}, g has {tuple(g.shape)}")
            if not x.is_contiguous():
                raise ValueError(f"veds_dt_score: {name} is not contiguous")
        y, p, z = (torch.empty(g.shape, dtype=torch.float32, device=g.device)
                   for _ in range(3))
        n = g.numel()
        if n == 0:
            return y, p, z
        lib, fn = _launcher()
        with torch.cuda.device(g.device):
            count = self.counts(g.device)
            stream = torch.cuda.current_stream(g.device).cuda_stream
            rc = fn(g.data_ptr(), q.data_ptr(), w.data_ptr(), e.data_ptr(),
                    y.data_ptr(), p.data_ptr(), z.data_ptr(), n,
                    V, kappa, bw, noise, p_max,
                    count.data_ptr() if self.counting else None, stream)
        lib.check(rc, "veds_score")
        return y, p, z


veds_dt_score = _VedsDtScore()


def _veds_dt_score_impl(g: torch.Tensor, q: torch.Tensor, w: torch.Tensor,
                        e: torch.Tensor, V: float, kappa: float, bw: float,
                        noise: float, p_max: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The operator's implementation: the plain version on the CPU, the
    kernel on CUDA."""
    if g.device.type == "cpu":
        return veds_dt_score_plain(g, q, w, e, V=V, kappa=kappa, bw=bw,
                                   noise=noise, p_max=p_max)
    if g.device.type != "cuda":
        raise ValueError(f"veds_dt_score: unsupported device {g.device}")
    return veds_dt_score._launch(g, q, w, e, V, kappa, bw, noise, p_max)


_veds_dt_score_op = torch.library.custom_op(
    "repro::veds_dt_score", mutates_args=())(_veds_dt_score_impl)


@_veds_dt_score_op.register_fake
def _(g, q, w, e, V, kappa, bw, noise, p_max):
    return tuple(torch.empty_like(g, dtype=torch.float32) for _ in range(3))


def veds_dt_score_cost(g, q, w, e, *args, **kwargs):
    """(operations, bytes) of the scoring: `VEDS_OPS_PER_ELEM` and
    `VEDS_BYTES_PER_ELEM` a candidate."""
    n = g.numel()
    return VEDS_OPS_PER_ELEM * n, VEDS_BYTES_PER_ELEM * n


register_cost(torch.ops.repro.veds_dt_score, veds_dt_score_cost)
