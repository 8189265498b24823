"""Flash attention: the CUDA forward kernel's wrapper, its plain PyTorch
version, the backward in explicit PyTorch ops, and the autograd Function
that joins them.

The kernels replace the Pallas TPU kernel
`repro/kernels/flash_attention/flash_attention.py`, one per dtype: bf16
inputs run on the tensor cores (`csrc/flash_attention_sm90.cu`: wgmma and
TMA), fp32 inputs on the CUDA cores (`csrc/flash_attention.cu`), where the
fp32 tolerances hold. Layout, as the reference's GQA wrapper
`ops.py:flash_attention_tpu`: q [B, T, H, D], k and v [B, S, KV, D] with
KV dividing H, out [B, T, H, D]. For tensors on the CPU
`flash_attention_fwd` runs `flash_attention_plain`; for CUDA tensors it
launches the kernel of their dtype, or raises.

The JAX package has no backward kernel: it differentiates the jnp
attention with autodiff. Here the backward is the standard flash
backward written in PyTorch ops (`flash_attention_bwd`), chunked over
query rows so that it never holds a [T, S] score matrix per head for the
whole batch, recomputing P from the forward's log-sum-exp.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import (check_device, register_cost,
                                 through_operator)
from repro_torch.kernels.build import load_library

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 80, 128)
# the C entry point of each dtype
ENTRY_POINTS = {torch.float32: "flash_attention_fwd_f32",
                torch.bfloat16: "flash_attention_fwd_bf16_sm90"}
# q, k, v, o, lse pointers; B, T, S, H, KV, D, causal, window, q_offset;
# scale; stream
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_void_p])


def _mask(T: int, S: int, causal: bool, window: Optional[int],
          q_offset: int, device, t0: int = 0, s0: int = 0) -> torch.Tensor:
    """[T, S] validity of the (query t0 + i, key s0 + j) pairs."""
    qpos = q_offset + t0 + torch.arange(T, device=device)[:, None]
    kpos = s0 + torch.arange(S, device=device)[None, :]
    mask = torch.ones((T, S), dtype=torch.bool, device=device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    return mask


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, *, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch, as the reference's oracle
    (`repro/kernels/flash_attention/ref.py:flash_attention_ref`) over
    the GQA layout of its `ops.py`: naive masked softmax attention in
    float32. Returns (out [B, T, H, D] in q's dtype, lse [B, H, T])."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    g = H // KV
    scale = 1.0 / math.sqrt(D)
    qf = q.to(torch.float32).permute(0, 2, 1, 3)                # [B,H,T,D]
    kf = k.to(torch.float32).repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    vf = v.to(torch.float32).repeat_interleave(g, dim=2).permute(0, 2, 1, 3)
    s = (qf @ kf.transpose(-1, -2)) * scale                     # [B,H,T,S]
    s = torch.where(_mask(T, S, causal, window, q_offset, q.device), s,
                    NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = (p @ vf) / torch.clamp_min(l, 1e-37)
    lse = (m + torch.log(l))[..., 0]
    return out.permute(0, 2, 1, 3).to(q.dtype), lse


def _check(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: need q [B,T,H,D], k and v "
                         f"[B,S,KV,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, T, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or H % k.shape[2] != 0:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"fit q {tuple(q.shape)} (KV must divide H)")
    if k.shape[1] == 0:
        raise ValueError("flash_attention: no keys (S = 0)")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got "
                         f"{window}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (out [B, T, H, D] in q's dtype, lse [B, H, T] float32),
    through the custom operator `torch.ops.repro.flash_attention_fwd`
    where a mode must see it (`through_operator`). Adds one to
    `flash_attention_fwd.launches` each time it launches a kernel, and
    names its entry point in `flash_attention_fwd.entry`."""
    _check(q, k, v, window)
    check_device("flash_attention", q)
    op = torch.ops.repro.flash_attention_fwd if through_operator(q) \
        else _flash_attention_impl
    return op(q, k, v, causal, window, q_offset)


def _flash_attention_impl(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, causal: bool,
                          window: Optional[int], q_offset: int
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator's implementation: the plain version on the CPU, the
    kernel of the inputs' dtype on CUDA. Both give contiguous outputs, as
    the fake implementation does."""
    if q.device.type == "cpu":
        out, lse = flash_attention_plain(q, k, v, causal=causal,
                                         window=window, q_offset=q_offset)
        return out.contiguous(), lse
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} must be {q.dtype} "
                             f"on {q.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if t.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} is not 16-byte "
                             f"aligned (the bf16 kernel loads it by TMA)")
    if q.dtype not in ENTRY_POINTS:
        raise ValueError(f"flash_attention: dtype {q.dtype} not in "
                         f"{list(ENTRY_POINTS)}")
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in "
                         f"{HEAD_DIMS}")
    out = torch.empty_like(q)
    lse = torch.empty((B, H, T), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    lib = load_library()
    entry = ENTRY_POINTS[q.dtype]
    fn = lib.function(entry, _ARGTYPES)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), B, T, S, H, KV, D, int(causal),
                0 if window is None else int(window), int(q_offset),
                1.0 / math.sqrt(D), stream)
    lib.check(rc, "flash_attention")
    flash_attention_fwd.launches += 1
    flash_attention_fwd.entry = entry
    return out, lse


flash_attention_fwd.launches = 0
flash_attention_fwd.entry = None
_flash_attention_op = torch.library.custom_op(
    "repro::flash_attention_fwd", mutates_args=())(_flash_attention_impl)


@_flash_attention_op.register_fake
def _(q, k, v, causal, window, q_offset):
    B, T, H, _ = q.shape
    return torch.empty_like(q), q.new_empty((B, H, T), dtype=torch.float32)


def _kept_pairs(T: int, S: int, causal: bool, window: Optional[int],
                q_offset: int) -> int:
    """The (query, key) pairs the masks keep, counted per query row:
    query q_offset + t sees keys lo..hi."""
    t = np.arange(T, dtype=np.int64) + q_offset
    hi = np.minimum(S - 1, t) if causal else np.full(T, S - 1)
    lo = np.maximum(0, t - window + 1) if window is not None \
        else np.zeros(T, dtype=np.int64)
    return int(np.clip(hi - lo + 1, 0, None).sum())


def flash_attention_cost(q, k, v, causal: bool = True,
                         window: Optional[int] = None, q_offset: int = 0):
    """(operations, bytes) of the forward: 2 * 2 * D operations per
    (query, key) pair the masks keep (q k and p v), causal
    4 B H D T (T + 1) / 2; q, k, v read once, out and the float32 lse
    written once."""
    B, T, H, D = q.shape
    S = k.shape[1]
    ops = 4 * B * H * D * _kept_pairs(T, S, causal, window, q_offset)
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + B * H * T * 4
    return ops, nbytes


register_cost(torch.ops.repro.flash_attention_fwd, flash_attention_cost)


def flash_attention_bwd(q, k, v, out, lse, d_out, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        chunk: int = 512):
    """Gradients (dq, dk, dv) of the attention output, in float32 and
    cast to the inputs' dtype, chunk of query rows by chunk:
      P = exp(s - lse) on the pairs the mask keeps, delta = rowsum(dO o O),
      dS = P (dP - delta), dq = dS k scale, dk = dS^T q scale, dv = P^T dO,
    with dk and dv summed over the H / KV query heads of each KV head.
    Each chunk only touches the keys its rows can see (causal and window
    band), and holds [B, KV, G * chunk, keys] at a time."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    f32 = torch.float32
    qf = q.to(f32)
    kt = k.to(f32).permute(0, 2, 1, 3)                          # [B,KV,S,D]
    vt = v.to(f32).permute(0, 2, 1, 3)
    do = d_out.to(f32)
    delta = (do * out.to(f32)).sum(-1)                          # [B,T,H]
    dq = torch.zeros((B, T, H, D), dtype=f32, device=q.device)
    dk = torch.zeros((B, KV, S, D), dtype=f32, device=q.device)
    dv = torch.zeros((B, KV, S, D), dtype=f32, device=q.device)

    def grouped(x, t0, t1):
        # [B, t, H, X] rows t0:t1 -> [B, KV, G * t, X] (row g * t + i)
        xc = x[:, t0:t1]
        tc = t1 - t0
        return xc.reshape(B, tc, KV, G, -1).permute(0, 2, 3, 1, 4) \
            .reshape(B, KV, G * tc, -1)

    for t0 in range(0, T, chunk):
        t1 = min(T, t0 + chunk)
        tc = t1 - t0
        s_hi = min(S, q_offset + t1) if causal else S
        s_lo = 0 if window is None else max(0, q_offset + t0 - window + 1)
        if s_hi <= s_lo:
            continue
        kc, vc = kt[:, :, s_lo:s_hi], vt[:, :, s_lo:s_hi]
        qc = grouped(qf, t0, t1)
        doc = grouped(do, t0, t1)
        lse_c = lse[:, :, t0:t1].reshape(B, KV, G * tc, 1)
        delta_c = grouped(delta[..., None], t0, t1)             # [..., 1]
        mask = _mask(tc, s_hi - s_lo, causal, window, q_offset, q.device,
                     t0, s_lo).repeat(G, 1)                     # [G*tc, sc]
        s = (qc @ kc.transpose(-1, -2)) * scale
        p = torch.where(mask, torch.exp(s - lse_c), 0.0)
        dp = doc @ vc.transpose(-1, -2)
        ds = p * (dp - delta_c)
        dq_c = (ds @ kc) * scale                                # [B,KV,G*tc,D]
        dq[:, t0:t1] = dq_c.reshape(B, KV, G, tc, D).permute(0, 3, 1, 2, 4) \
            .reshape(B, tc, H, D)
        dk[:, :, s_lo:s_hi] += (ds.transpose(-1, -2) @ qc) * scale
        dv[:, :, s_lo:s_hi] += p.transpose(-1, -2) @ doc
    return (dq.to(q.dtype), dk.permute(0, 2, 1, 3).to(k.dtype),
            dv.permute(0, 2, 1, 3).to(v.dtype))


class FlashAttentionFn(torch.autograd.Function):
    """Forward through `flash_attention_fwd` (the kernel on CUDA, the
    plain version on the CPU), backward through `flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, bwd_chunk):
        out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                       window=window, q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset,
                        chunk=bwd_chunk)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, d_out,
                                         **ctx.opts)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, bwd_chunk: int = 512
                    ) -> torch.Tensor:
    """Differentiable attention: q [B, T, H, D], k and v [B, S, KV, D]
    -> [B, T, H, D]."""
    return FlashAttentionFn.apply(q, k, v, causal, window, q_offset,
                                  bwd_chunk)
