"""Masked weighted FedAvg aggregation (eq. 11): CUDA kernel wrapper, its
plain PyTorch version, and the leaf-by-leaf tree form.

The kernel (`csrc/fedavg_agg.cu`) replaces the Pallas TPU kernel
`repro/kernels/fedavg_agg/fedavg_agg.py`; `fedavg_agg_tree` mirrors
`repro/kernels/fedavg_agg/ops.py:fedavg_agg_tree`. For tensors on the CPU
`fedavg_agg` runs `fedavg_agg_plain`; for CUDA tensors it launches the
kernel, or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import (check_device, register_cost,
                                 through_operator)
from repro_torch.kernels.build import load_library
from repro_torch.models.module import tree_map

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# x, w, old, out pointers; dtype; V; L; stream
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                      ctypes.c_int64, ctypes.c_void_p])
MAX_V = 1024


def fedavg_agg_plain(x: torch.Tensor, w: torch.Tensor,
                     old: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch, as the reference's oracle
    (`repro/kernels/fedavg_agg/ref.py:fedavg_agg_ref`)."""
    den = w.sum()
    avg = torch.einsum("v,vl->l", w.to(torch.float32),
                       x.to(torch.float32)) / torch.clamp_min(den, 1e-9)
    return torch.where(den > 0, avg, old.to(torch.float32)).to(x.dtype)


def fedavg_agg(x: torch.Tensor, w: torch.Tensor,
               old: torch.Tensor) -> torch.Tensor:
    """x [V, L] (float32 or bfloat16), w [V] float32, old [L] in x's
    dtype -> [L] in x's dtype: the w-weighted mean of the rows of x, or
    `old` where w sums to 0, through the custom operator
    `torch.ops.repro.fedavg_agg` where a mode must see it
    (`through_operator`). Adds one to `fedavg_agg.launches` each time it
    launches the kernel."""
    check_device("fedavg_agg", x)
    op = torch.ops.repro.fedavg_agg if through_operator(x) \
        else _fedavg_agg_impl
    return op(x, w, old)


def _fedavg_agg_impl(x: torch.Tensor, w: torch.Tensor,
                     old: torch.Tensor) -> torch.Tensor:
    """The operator's implementation: the plain version on the CPU, the
    kernel on CUDA."""
    if x.device.type == "cpu":
        return fedavg_agg_plain(x, w, old)
    if x.device.type != "cuda":
        raise ValueError(f"fedavg_agg: unsupported device {x.device}")
    if x.ndim != 2 or w.shape != (x.shape[0],) or \
            old.shape != (x.shape[1],):
        raise ValueError(f"fedavg_agg: need x [V, L], w [V], old [L]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(old.shape)}")
    if x.dtype not in _DTYPES or old.dtype != x.dtype or \
            w.dtype != torch.float32:
        raise ValueError(f"fedavg_agg: x and old must share a float32 or "
                         f"bfloat16 dtype and w be float32; got {x.dtype}, "
                         f"{old.dtype}, {w.dtype}")
    for name, t in (("x", x), ("w", w), ("old", old)):
        if t.device != x.device:
            raise ValueError(f"fedavg_agg: {name} is on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"fedavg_agg: {name} is not contiguous")
    V, L = x.shape
    if not 0 < V <= MAX_V:
        raise ValueError(f"fedavg_agg: V={V} outside 1..{MAX_V}")
    out = torch.empty_like(old)
    if L == 0:
        return out
    lib = load_library()
    fn = lib.function("fedavg_agg", _ARGTYPES)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), w.data_ptr(), old.data_ptr(), out.data_ptr(),
                _DTYPES[x.dtype], V, L, stream)
    lib.check(rc, "fedavg_agg")
    fedavg_agg.launches += 1
    return out


fedavg_agg.launches = 0
_fedavg_agg_op = torch.library.custom_op(
    "repro::fedavg_agg", mutates_args=())(_fedavg_agg_impl)


@_fedavg_agg_op.register_fake
def _(x, w, old):
    return torch.empty_like(old)


def fedavg_agg_cost(x, w, old):
    """(operations, bytes) of the aggregation: x read once, out written
    once (old is read only when every upload failed), w read; 2V + 1
    float32 operations an element."""
    V, L = x.shape
    return (2 * V + 1) * L, (V + 1) * L * x.element_size() + 4 * V


register_cost(torch.ops.repro.fedavg_agg, fedavg_agg_cost)


def fedavg_agg_tree(params_v, w: torch.Tensor, old_tree):
    """`fedavg_agg` leaf by leaf over a tree (dicts and lists) of
    [V, ...] stacked leaves, each seen as a [V, L] view (no copy); `old`
    leaves have the unstacked shapes."""
    def leaf(x, old):
        out = fedavg_agg(x.reshape(x.shape[0], -1), w, old.reshape(-1))
        return out.reshape(old.shape)
    return tree_map(leaf, params_v, old_tree)
