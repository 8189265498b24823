"""Scheduler carry and the batched round-output container.

Port of `repro/core/scheduler.py`. Rounds may carry a leading batch axis
`B` (independent RSU cells, or independent rounds of one cell); a
scheduler accepts both the single-cell layout (`g_sr: [T, S]`) and the
batched layout (`g_sr: [B, T, S]`) and returns outputs of matching
batchedness. The virtual energy queues (eqs. 19-20) come in through an
optional `SchedulerCarry` and go out in `RoundOutputs.carry`; `carry=None`
starts them at zero. A multi-round rollout threads them, with the P4
warm-start table, from round to round (`RolloutCarry`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import (Any, Dict, Iterator, Optional, Protocol,
                    runtime_checkable)

import numpy as np
import torch

from repro_torch import device_scalar


def map_tensors(fn, obj):
    """Apply `fn` to every tensor of a dataclass, through nested
    dataclasses, dicts and tuples (None stays None)."""
    return dataclasses.replace(obj, **{
        f.name: map_tree(fn, getattr(obj, f.name))
        for f in dataclasses.fields(obj)})


def zip_tree(fn, a, b):
    """`fn(x, y)` on the paired tensors of two like-shaped trees of
    dataclasses, dicts and tuples (None stays None); the tree of the
    results."""
    if a is None:
        return None
    if dataclasses.is_dataclass(a):
        return dataclasses.replace(a, **{
            f.name: zip_tree(fn, getattr(a, f.name), getattr(b, f.name))
            for f in dataclasses.fields(a)})
    if isinstance(a, dict):
        return {k: zip_tree(fn, x, b[k]) for k, x in a.items()}
    if isinstance(a, tuple):
        return tuple(zip_tree(fn, x, y) for x, y in zip(a, b))
    return fn(a, b)


def stack_tree(objs, fn=torch.stack):
    """Dataclasses of tensors (or tensors) combined field by field with
    `fn` (stack on a new leading axis, or `torch.cat`); None stays
    None."""
    first = objs[0]
    if first is None:
        return None
    if torch.is_tensor(first):
        return fn(list(objs))
    if dataclasses.is_dataclass(first):
        return dataclasses.replace(first, **{
            f.name: stack_tree([getattr(o, f.name) for o in objs], fn)
            for f in dataclasses.fields(first)})
    if isinstance(first, dict):
        return {k: stack_tree([o[k] for o in objs], fn) for k in first}
    if isinstance(first, tuple):
        parts = [stack_tree([o[i] for o in objs], fn)
                 for i in range(len(first))]
        return (type(first)(*parts) if hasattr(first, "_fields")
                else tuple(parts))
    raise TypeError(f"stack_tree: cannot combine {type(first).__name__}")


def map_tree(fn, v):
    """`fn` on every tensor of a tree of dataclasses, dicts and tuples
    (None stays None)."""
    if v is None:
        return None
    if dataclasses.is_dataclass(v):
        return map_tensors(fn, v)
    if isinstance(v, dict):
        return {k: map_tree(fn, x) for k, x in v.items()}
    if isinstance(v, tuple):
        return tuple(map_tree(fn, x) for x in v)
    return fn(v)


@dataclasses.dataclass(frozen=True)
class SchedulerCarry:
    """Virtual energy queues threaded round-to-round (eqs. 19-20), plus
    the optional P4 warm-start table.

      qs  [S] / [B, S]   per-SOV queue [J]
      qu  [U] / [B, U]   per-OPV queue [J]
      p4  [S, U, 1+U] / [B, S, U, 1+U] or None: each SOV slot's last P4
          power vectors over the U prefix candidates (sorted-prefix
          layout). VEDS consumes and refreshes it only when
          `VedsParams.ipm_warm_iters > 0` and COT is on; otherwise it
          stays None.
    """
    qs: torch.Tensor
    qu: torch.Tensor
    p4: Optional[torch.Tensor] = None

    @staticmethod
    def zeros(rnd) -> "SchedulerCarry":
        """Fresh queues matching `rnd`'s fleet shape."""
        return SchedulerCarry(qs=torch.zeros_like(rnd.e_sov),
                              qu=torch.zeros_like(rnd.e_opv))


@dataclasses.dataclass(frozen=True)
class RolloutCarry:
    """The carry of a multi-round rollout. A scheduling-only rollout
    (`repro_torch.core.streaming.stream_rounds`) threads just `sched`: a
    `SchedulerCarry` in fresh-fleet mode, a persistent `FleetState`
    otherwise. The fused training engine (`repro_torch.fl.engine.
    fused_rollout`) adds the global model and the optimizer state.

      sched      SchedulerCarry (virtual queues) or FleetState
      params     global model, dict of tensors with a leading [B] cell
                 axis (or None)
      opt_state  optimizer state with a leading [B] cell axis (or None)
    """
    sched: Any
    params: Any = None
    opt_state: Any = None


def init_queues(rnd, carry: Optional[SchedulerCarry]):
    """Round-start queues (qs0, qu0) broadcast to `rnd`'s fleet shape: the
    one place the carry-is-None => zero-queues convention lives."""
    carry = carry if carry is not None else SchedulerCarry.zeros(rnd)
    return (torch.broadcast_to(carry.qs, rnd.e_sov.shape),
            torch.broadcast_to(carry.qu, rnd.e_opv.shape))


def divisors(rb, prm, ch) -> Dict[str, torch.Tensor]:
    """The scalars a batched round `rb` divides by, as 0-dim float32
    tensors on its device: the slot count "T", the model size "Q", the
    noise power "noise" and "ln2"; and "per_slot", the float32
    reciprocal of the slot length, which the slot length's divisions
    multiply by. A CUDA division by a Python number multiplies by its
    rounded reciprocal; by a tensor it divides, correctly rounded, as
    the CPU does, so that a decision (a budget spent to its last joule,
    a tie of objectives) comes out the same on both. "per_slot" is the
    product the reference's compiled rounds take instead: XLA rewrites a
    division by a constant c into a product with the float32 1 / c, and
    `madca`'s last partial slot of a budget, p = e_left / slot, leaves
    a residual of e_left - slot p whose sign decides whether the SOV
    takes another slot. A product is correctly rounded on both devices.
    Made once a round (once a round shape in the VEDS slot graph)."""
    vals = {"T": float(rb.g_sr.shape[-2]), "Q": prm.Q,
            "per_slot": float(np.float32(1.0) / np.float32(prm.slot)),
            "noise": ch.noise_power, "ln2": math.log(2.0)}
    return {k: device_scalar(v, rb.g_sr) for k, v in vals.items()}


def masked_e_cp(rnd) -> torch.Tensor:
    """Computation energy chargeable to each SOV slot: zero for padded /
    never-eligible slots (`valid_sov == False`)."""
    if rnd.valid_sov is None:
        return rnd.e_cp
    return torch.where(rnd.valid_sov, rnd.e_cp, 0.0)


def unbatch(out: "RoundOutputs", batched: bool) -> "RoundOutputs":
    """Strip the canonical B=1 axis when the caller's round was unbatched."""
    return out if batched else map_tensors(lambda x: x[0], out)


@dataclasses.dataclass(frozen=True)
class RoundOutputs:
    """Per-round scheduling outcome. Unbatched / batched field shapes:

      success     [S]  / [B, S]   which SOVs uploaded the full model
      n_success   []   / [B]      successful aggregations in the cell
      zeta        [S]  / [B, S]   delivered bits at round end
      energy_sov  [S]  / [B, S]   total SOV energy (compute + transmit) [J]
      energy_opv  [U]  / [B, U]   total OPV relay energy [J]
      n_cot_slots []   / [B]      slots spent on cooperative transmission
      n_dt_slots  []   / [B]      slots spent on direct transmission
      carry       SchedulerCarry  virtual queues at round end (or None)
    """
    success: torch.Tensor
    n_success: torch.Tensor
    zeta: torch.Tensor
    energy_sov: torch.Tensor
    energy_opv: torch.Tensor
    n_cot_slots: torch.Tensor
    n_dt_slots: torch.Tensor
    carry: Optional[SchedulerCarry] = None

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)

    def keys(self) -> Iterator[str]:
        """Tensor diagnostic fields (`carry` excluded)."""
        return iter(f.name for f in dataclasses.fields(self)
                    if f.name != "carry")

    @property
    def batched(self) -> bool:
        return self.success.ndim == 2

    @property
    def batch_size(self) -> int:
        return self.success.shape[0] if self.batched else 1

    def cell(self, b: int) -> "RoundOutputs":
        """Slice one cell out of a batched output."""
        if not self.batched:
            return self
        return map_tensors(lambda x: x[b], self)


@runtime_checkable
class Scheduler(Protocol):
    """A named round scheduler. Implementations are frozen dataclasses, so
    they hash and compare by their configuration.

    `carry` is the optional queue state at round start; every output
    reports the round-end queues in `.carry` regardless, so streaming
    rollouts can thread them and single-round callers can ignore them.
    """

    name: str

    def solve_round(self, rnd, prm, ch,
                    carry: Optional[SchedulerCarry] = None
                    ) -> RoundOutputs:
        ...

    def __call__(self, rnd, prm, ch,
                 carry: Optional[SchedulerCarry] = None) -> RoundOutputs:
        ...
