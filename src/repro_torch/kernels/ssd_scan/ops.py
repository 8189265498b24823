"""The Mamba2/SSD chunked scan: the CUDA forward kernel's wrapper, its
plain PyTorch version, the naive recurrence (an oracle for the tests),
and the autograd Function that joins the kernel to a backward in
PyTorch ops.

The kernels replace the Pallas TPU kernel
`repro/kernels/ssd_scan/ssd_scan.py`, one per dtype: bf16 inputs run on
the tensor cores (`csrc/ssd_scan_sm90.cu`), fp32 inputs on the CUDA cores
(`csrc/ssd_scan.cu`), where the fp32 tolerances hold. They run where the
reference's model computes the same function with the jnp scan
`repro/models/blocks.py:_ssd_chunk_scan`:

  S_t = exp(la_t) S_{t-1} + b_t v_t^T,   y_t = c_t . S_t,

chunked, in float32, with y cast to v's dtype chunk by chunk. Layout, the
model's: v [B, T, H, P], b and c [B, T, N] shared by the H heads of a
batch row (the Pallas kernel's [BH, T, N] is the case H = 1), log_a
[B, T, H] float32 and <= 0, state [B, H, N, P] float32. T is padded to
a multiple of the chunk with log_a = 0 and b = c = v = 0, which changes
neither y before T nor the state (the Pallas wrapper's pad path,
`repro/kernels/ssd_scan/ops.py:20-31`).

For tensors on the CPU `ssd_scan_fwd` runs `ssd_scan_plain`; for CUDA
tensors it launches the kernel of their dtype, or raises. The reference has no backward
kernel (it differentiates the jnp scan under `jax.checkpoint`), so
`SsdScanFn.backward` re-runs `ssd_scan_plain` under autograd and takes
its gradients.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import (check_device, register_cost,
                                 through_operator)
from repro_torch.kernels.build import load_library

# what the kernels are compiled for (their `dispatch` and `launch`)
CHUNKS = (32, 128)
STATE_DIM = 64
HEAD_DIM = 64
# the C entry point of each dtype
ENTRY_POINTS = {torch.float32: "ssd_scan_fwd_f32",
                torch.bfloat16: "ssd_scan_fwd_bf16_sm90"}
# v, b, c, log_a, state0 (or null), y, state pointers; B, T, H, N, P,
# chunk; stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def _pad_to_chunk(v, b, c, log_a, chunk: int):
    """(chunk, inputs padded along T to a multiple of it). The padded
    steps (v = b = c = 0, log_a = 0) change neither y before them nor the
    final state."""
    T = v.shape[1]
    pad = (-T) % chunk
    if pad:
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, pad))
        log_a = F.pad(log_a, (0, 0, 0, pad))
    return chunk, v, b, c, log_a


def _kernel_chunk(chunk: int, T: int) -> int:
    """The chunk the kernels run T steps in: a sequence shorter than a
    kernel's chunk runs as one such chunk, padded (the reference's
    min(chunk, T) may be a chunk the kernels do not take, e.g. zamba2's
    128 over a 64-token prompt)."""
    return chunk if chunk in CHUNKS else min(chunk, T)


def _padded_len(T: int, chunk: int) -> int:
    """The length the kernels pad T steps to: a multiple of their
    chunk."""
    k = _kernel_chunk(chunk, T)
    return T + (-T) % k


def ssd_scan_plain(v: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   log_a: torch.Tensor, chunk: int,
                   state0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The chunked algorithm of the reference's `_ssd_chunk_scan` in
    plain PyTorch: per chunk, cum = cumsum(la); intra-chunk weights
    W_ij = (c_i . b_j) exp(cum_i - cum_j) for j <= i; y = W v + (c o
    exp(cum)) S; S <- exp(cum_C) S + sum_j exp(cum_C - cum_j) b_j v_j^T.
    Returns (y [B, T, H, P] in v's dtype, final state [B, H, N, P]
    float32).

    The causal mask is applied to the exponent (exp(-inf) = 0), not by
    multiplying by 0 after the exponential: above the diagonal
    cum_i - cum_j >= 0, and once a chunk's decay passes ~88 its
    exponential overflows to inf, where the reference's `s * causal *
    dec` gives 0 * inf = NaN. The Pallas kernel masks with `where` and
    stays finite; so does this, in its gradients too."""
    B, T, H, P = v.shape
    N = b.shape[-1]
    chunk, v, b, c, log_a = _pad_to_chunk(v, b, c, log_a,
                                          min(chunk, v.shape[1]))
    f32 = torch.float32
    state = torch.zeros((B, H, N, P), dtype=f32, device=v.device) \
        if state0 is None else state0.to(f32)
    ii = torch.arange(chunk, device=v.device)
    causal = (ii[:, None] >= ii[None, :])[None, :, :, None]  # [1,i,j,1]
    ys = []
    for t0 in range(0, v.shape[1], chunk):
        xc = v[:, t0:t0 + chunk].to(f32)                      # [B,C,H,P]
        bc = b[:, t0:t0 + chunk].to(f32)                      # [B,C,N]
        cc = c[:, t0:t0 + chunk].to(f32)
        cum = torch.cumsum(log_a[:, t0:t0 + chunk].to(f32), dim=1)
        s = torch.einsum("bin,bjn->bij", cc, bc)
        diff = cum[:, :, None, :] - cum[:, None, :, :]        # [B,i,j,H]
        dec = torch.exp(torch.where(causal, diff, float("-inf")))
        w = s[..., None] * dec
        y = torch.einsum("bijh,bjhp->bihp", w, xc)
        qeff = cc[:, :, None, :] * torch.exp(cum)[..., None]  # [B,i,H,N]
        y = y + torch.einsum("bihn,bhnp->bihp", qeff, state)
        tail = torch.exp(cum[:, -1:, :] - cum)                # [B,j,H]
        keff = bc[:, :, None, :] * tail[..., None]            # [B,j,H,N]
        state = (torch.exp(cum[:, -1])[:, :, None, None] * state
                 + torch.einsum("bjhn,bjhp->bhnp", keff, xc))
        ys.append(y.to(v.dtype))
    return torch.cat(ys, dim=1)[:, :T], state


def ssd_scan_naive(v: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   log_a: torch.Tensor,
                   state0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The O(T) recurrence of the reference's oracle
    (`repro/kernels/ssd_scan/ref.py:ssd_scan_ref`), step by step in
    float32, over the model's layout; a different algorithm from the
    chunked scan, for the tests only. Returns (y in v's dtype, state)."""
    B, T, H, P = v.shape
    N = b.shape[-1]
    f32 = torch.float32
    state = torch.zeros((B, H, N, P), dtype=f32, device=v.device) \
        if state0 is None else state0.to(f32)
    ys = []
    for t in range(T):
        a = torch.exp(log_a[:, t].to(f32))                    # [B,H]
        state = a[:, :, None, None] * state + torch.einsum(
            "bn,bhp->bhnp", b[:, t].to(f32), v[:, t].to(f32))
        ys.append(torch.einsum("bn,bhnp->bhp", c[:, t].to(f32), state))
    return torch.stack(ys, dim=1).to(v.dtype), state


def _check(v, b, c, log_a, state0):
    if v.ndim != 4 or b.ndim != 3 or c.shape != b.shape or log_a.ndim != 3:
        raise ValueError(f"ssd_scan: need v [B,T,H,P], b and c [B,T,N], "
                         f"log_a [B,T,H]; got {tuple(v.shape)}, "
                         f"{tuple(b.shape)}, {tuple(c.shape)}, "
                         f"{tuple(log_a.shape)}")
    B, T, H, P = v.shape
    N = b.shape[-1]
    if b.shape[:2] != (B, T) or log_a.shape != (B, T, H):
        raise ValueError(f"ssd_scan: b {tuple(b.shape)} or log_a "
                         f"{tuple(log_a.shape)} does not fit v "
                         f"{tuple(v.shape)}")
    if state0 is not None and state0.shape != (B, H, N, P):
        raise ValueError(f"ssd_scan: state0 must be {(B, H, N, P)}, got "
                         f"{tuple(state0.shape)}")
    if T == 0:
        raise ValueError("ssd_scan: empty sequence (T = 0)")


def ssd_scan_fwd(v: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                 log_a: torch.Tensor, chunk: int = 128,
                 state0: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (y [B, T, H, P] in v's dtype, final state [B, H, N, P]
    float32), through the custom operator `torch.ops.repro.ssd_scan_fwd`
    where a mode must see it (`through_operator`). Adds one to
    `ssd_scan_fwd.launches` each time it launches a kernel, and names its
    entry point in `ssd_scan_fwd.entry`."""
    _check(v, b, c, log_a, state0)
    check_device("ssd_scan", v)
    op = torch.ops.repro.ssd_scan_fwd if through_operator(v) \
        else _ssd_scan_impl
    return op(v, b, c, log_a, chunk, state0)


def _ssd_scan_impl(v: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
                   log_a: torch.Tensor, chunk: int,
                   state0: Optional[torch.Tensor]
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The operator's implementation: the plain version on the CPU (y
    contiguous), the kernel of the inputs' dtype on CUDA (y the first T
    steps of the padded sequence the kernel wrote, `_padded_len`): the
    layouts the fake implementation gives on each device."""
    if v.device.type == "cpu":
        y, state = ssd_scan_plain(v, b, c, log_a, chunk, state0)
        return y.contiguous(), state
    if v.device.type != "cuda":
        raise ValueError(f"ssd_scan: unsupported device {v.device}")
    if v.dtype not in ENTRY_POINTS:
        raise ValueError(f"ssd_scan: dtype {v.dtype} not in "
                         f"{list(ENTRY_POINTS)}")
    named = [("v", v, v.dtype), ("b", b, v.dtype), ("c", c, v.dtype),
             ("log_a", log_a, torch.float32)]
    if state0 is not None:
        named.append(("state0", state0, torch.float32))
    for name, t, dtype in named:
        if t.device != v.device or t.dtype != dtype:
            raise ValueError(f"ssd_scan: {name} must be {dtype} on "
                             f"{v.device}, got {t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"ssd_scan: {name} is not contiguous")
        if v.dtype == torch.bfloat16 and t.data_ptr() % 16:
            raise ValueError(f"ssd_scan: {name} is not 16-byte aligned "
                             f"(the bf16 kernel loads it by cp.async)")
    B, T, H, P = v.shape
    N = b.shape[-1]
    chunk, vp, bp, cp, lp = _pad_to_chunk(v, b, c, log_a,
                                          _kernel_chunk(chunk, T))
    if chunk not in CHUNKS or N != STATE_DIM or P != HEAD_DIM:
        raise ValueError(f"ssd_scan: the kernel takes chunk in {CHUNKS} "
                         f"(after min(chunk, T)), N = {STATE_DIM} and P = "
                         f"{HEAD_DIM}; got chunk {chunk}, N {N}, P {P}")
    y = torch.empty_like(vp)
    state = torch.empty((B, H, N, P), dtype=torch.float32, device=v.device)
    lib = load_library()
    entry = ENTRY_POINTS[v.dtype]
    fn = lib.function(entry, _ARGTYPES)
    with torch.cuda.device(v.device):
        stream = torch.cuda.current_stream(v.device).cuda_stream
        rc = fn(vp.data_ptr(), bp.data_ptr(), cp.data_ptr(), lp.data_ptr(),
                None if state0 is None else state0.data_ptr(),
                y.data_ptr(), state.data_ptr(), B, vp.shape[1], H, N, P,
                chunk, stream)
    lib.check(rc, "ssd_scan")
    ssd_scan_fwd.launches += 1
    ssd_scan_fwd.entry = entry
    return y[:, :T], state


ssd_scan_fwd.launches = 0
ssd_scan_fwd.entry = None
_ssd_scan_op = torch.library.custom_op(
    "repro::ssd_scan_fwd", mutates_args=())(_ssd_scan_impl)


@_ssd_scan_op.register_fake
def _(v, b, c, log_a, chunk, state0):
    B, T, H, P = v.shape
    state = v.new_empty((B, H, b.shape[-1], P), dtype=torch.float32)
    if v.device.type != "cuda":
        return torch.empty_like(v), state
    padded = v.new_empty((B, _padded_len(T, chunk), H, P))
    return padded.as_strided(v.shape, padded.stride()), state


def ssd_scan_cost(v, b, c, log_a, chunk: int = 128, state0=None):
    """(operations, bytes) of the scan, as the Pallas kernel does it: per
    row, head and chunk of C = min(chunk, T) the C x C scores over N, W v
    over P, c S and the state update over N x P, 2 operations a
    multiply-add; v, b, c, log_a (and state0) read once, y and the
    float32 final state written once."""
    B, T, H, P = v.shape
    N = b.shape[-1]
    C = min(chunk, T)
    n_chunks = -(-T // C)
    ops = B * H * n_chunks * (2 * C * C * (N + P) + 4 * C * N * P)
    nbytes = (2 * v.numel() + 2 * b.numel()) * v.element_size() \
        + B * T * H * 4 + B * H * N * P * 4 * (1 if state0 is None else 2)
    return ops, nbytes


register_cost(torch.ops.repro.ssd_scan_fwd, ssd_scan_cost)


class SsdScanFn(torch.autograd.Function):
    """Forward through `ssd_scan_fwd` (the kernel on CUDA, the plain
    version on the CPU); backward by autograd through `ssd_scan_plain`,
    re-run on the saved inputs. Gradients for v, b, c, log_a and, when
    given, state0; the outputs are (y, final state)."""

    @staticmethod
    def forward(ctx, v, b, c, log_a, state0, chunk):
        y, state = ssd_scan_fwd(v, b, c, log_a, chunk, state0)
        ctx.save_for_backward(v, b, c, log_a, state0)
        ctx.chunk = chunk
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        saved = ctx.saved_tensors
        inputs = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(saved, ctx.needs_input_grad)]
        wanted = [t for t in inputs if t is not None and t.requires_grad]
        with torch.enable_grad():
            y, state = ssd_scan_plain(*inputs[:4], ctx.chunk, inputs[4])
            grads = iter(torch.autograd.grad((y, state), wanted,
                                             (dy, dstate)))
        return tuple(next(grads) if t is not None and t.requires_grad
                     else None for t in inputs) + (None,)


def ssd_scan(v: torch.Tensor, b: torch.Tensor, c: torch.Tensor,
             log_a: torch.Tensor, chunk: int = 128,
             state0: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Differentiable chunked scan: (y [B, T, H, P], state [B, H, N, P])."""
    return SsdScanFn.apply(v, b, c, log_a, state0, chunk)
