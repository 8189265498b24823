"""The port's hand-written CUDA kernels, one package each.

Each kernel's forward is a PyTorch custom operator (`torch.ops.repro.*`,
declared in its `ops.py`): real CUDA tensors launch the kernel, CPU
tensors run its plain version, and a fake tensor
(`torch._subclasses.fake_tensor.FakeTensorMode`) gets the output shapes,
dtypes and strides from the operator's fake implementation, with no
kernel run. A wrapper calls the operator only where something must see
it (`through_operator`: a fake tensor, or a dispatch mode such as
`FlopCounterMode` or the dry run's counter); otherwise it calls the
operator's implementation itself, without the dispatcher's overhead.
`register_cost` gives each operator the work its kernel does, the count
behind `PERF.md`'s bound column: its operations (registered with
`torch.utils.flop_counter`, so `FlopCounterMode` counts them) and its
bytes (each input read once, each output written once).
`launch/op_costs.py` reads both.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

# the operator's qualified name ("repro::flash_attention_fwd") -> a
# function of the operator's arguments (tensors, or anything with
# `.shape`, `.dtype`, `.numel()` and `.element_size()`) giving (operations,
# bytes)
KERNEL_COSTS: Dict[str, Callable[..., Tuple[int, int]]] = {}


def register_cost(op, cost: Callable[..., Tuple[int, int]]) -> None:
    """Record `cost` for the custom operator `op` (a `torch.ops.repro.*`
    packet) and register its operations as `op`'s FLOP formula."""
    from torch.utils.flop_counter import register_flop_formula
    KERNEL_COSTS[op._qualified_op_name] = cost

    def flops(*args, out_val=None, **kwargs):
        return cost(*args, **kwargs)[0]
    register_flop_formula(op, get_raw=True)(flops)


def check_device(kernel: str, x) -> None:
    """A kernel runs on CUDA tensors, or its plain version on CPU ones
    (fake tensors say which they stand for); any other device raises
    before the operator is called (its fake implementation would take a
    meta tensor)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {x.device}")


def through_operator(x: torch.Tensor) -> bool:
    """Whether a wrapper's call on `x` goes through its custom operator:
    where `x` is a tensor subclass (a fake tensor) or a dispatch mode is
    on (`FakeTensorMode`, `FlopCounterMode`, `launch/op_costs.OpCosts`),
    which must see the operator. Otherwise the wrapper calls the
    operator's implementation directly: the custom operator's Python
    dispatch costs tens of microseconds a call (PERF.md section 6)."""
    return type(x) is not torch.Tensor or \
        torch._C._len_torch_dispatch_stack() > 0
