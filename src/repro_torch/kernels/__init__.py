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

import contextlib
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


class DeviceCounts:
    """Counters that a kernel adds to on the card, for a kernel launched
    from CUDA graphs: a graph's replay runs the kernel without passing
    through its wrapper, so the count is kept where the kernel runs. Each
    launch hands the kernel counters on its device (`counts(device)`: an
    int64 tensor of `slots` entries); the kernel adds one to entry 0 each
    time it runs, eagerly or from a graph (a capture records the launch
    and runs nothing), and may count other events in the other entries.

    `launches` reads entry 0 over every device, synchronising each;
    setting it (to 0, say) sets the count from then on, and leaves the
    other entries as they are. A launch made under `uncounted()`
    (`counting` is False there) passes the kernel no counters, so it adds
    to no entry."""

    def __init__(self, name: str, slots: int = 1):
        self._name = name
        self._slots = slots
        self._base = 0
        self._counts: Dict[torch.device, torch.Tensor] = {}
        self.counting = True

    def read(self, slot: int) -> int:
        """Entry `slot` summed over the devices, after synchronising."""
        n = 0
        for count in self._counts.values():
            torch.cuda.synchronize(count.device)
            n += int(count[slot].item())
        return n

    @property
    def launches(self) -> int:
        return self._base + self.read(0)

    @launches.setter
    def launches(self, n: int) -> None:
        self._base = int(n)
        for count in self._counts.values():
            count[0].zero_()

    @contextlib.contextmanager
    def uncounted(self):
        """Launches in this block are not counted: for runs that are not
        part of a path, such as the warm-up before a capture."""
        self.counting, before = False, self.counting
        try:
            yield
        finally:
            self.counting = before

    def counts(self, device: torch.device) -> torch.Tensor:
        """The device's counters, made (outside any capture) at first
        use."""
        count = self._counts.get(device)
        if count is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{self._name}: first launch on a device inside a "
                    f"stream capture; launch it once outside the capture "
                    f"first (as PyTorch's warm-up before a capture does), "
                    f"so that its counters exist")
            count = torch.zeros(self._slots, dtype=torch.int64,
                                device=device)
            torch.cuda.synchronize(device)
            self._counts[device] = count
        return count
