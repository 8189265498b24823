"""Benchmark schedulers from the paper's Section VI, batch-native.

Port of `repro/core/baselines.py`:

1) Optimal        — every SOV in coverage uploads successfully (upper
                    bound).
2) V2I-only       — VEDS with OPVs disabled (special case of Algorithm 2).
3) MADCA-FL [7]   — mobility/channel-dynamics-aware: per slot, schedules
                    the eligible SOV with the best instantaneous SOV->RSU
                    channel, at full power while its energy budget lasts.
                    Direct V2I uploads only.
4) SA [26]        — static: ranks SOVs by their *initial* channel state
                    and round-robins the slots in that fixed order at max
                    power, ignoring mobility and fast fading.

with VEDS itself (Algorithm 2) the five schedulers of `SCHEDULERS`. Each
implements the `Scheduler` protocol: `solve_round` takes `RoundInputs`
with or without a leading `[B]` cell axis and returns `RoundOutputs` of
matching batchedness. `veds` and `v2i_only` run `veds_round` (on a CUDA
device one captured slot graph per round shape and COT setting, the
`veds_score` kernel launched from it). `madca` and `sa` are Python loops
of device ops over the slots, the reference's `lax.scan`; they read
nothing back to the host, so a round never stalls the stream of work.

Every scheduler also honours the optional `SchedulerCarry`: only VEDS
*decides* with the virtual queues, but every scheduler *accounts* its
energy through eqs. (19)-(20), so a streaming rollout can compare the
cumulative budget violation of schedulers on equal footing. With
`carry=None` the queues start at zero.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.channel.v2x import ChannelParams
from repro_torch.core import lyapunov as lyp
from repro_torch.core.scheduler import (RoundOutputs, Scheduler,
                                        SchedulerCarry, divisors,
                                        init_queues, masked_e_cp, unbatch)
from repro_torch.core.veds import RoundInputs, _slot_start, veds_round


def _valid_sov(rb: RoundInputs) -> torch.Tensor:
    if rb.valid_sov is not None:
        return rb.valid_sov
    B, _, S = rb.g_sr.shape
    return torch.ones((B, S), dtype=torch.bool, device=rb.g_sr.device)


def _no_slots(rb: RoundInputs) -> torch.Tensor:
    """A [B] count of zero slots, in the dtype of VEDS's slot counts."""
    return torch.zeros((rb.g_sr.shape[0],), dtype=torch.int64,
                       device=rb.g_sr.device)


def optimal_round(rnd: RoundInputs, prm: lyp.VedsParams, ch: ChannelParams,
                  carry: Optional[SchedulerCarry] = None) -> RoundOutputs:
    batched = rnd.batched
    rb = rnd.with_batch_axis()
    success = _valid_sov(rb)                                # all real SOVs
    qs0, qu0 = init_queues(rb, carry)
    # communication is free in the upper bound: T slots of (19)/(20) with
    # e_cm = 0 collapse to the closed-form relaxation
    out = RoundOutputs(
        success=success, n_success=success.sum(-1),
        zeta=torch.where(success, prm.Q, 0.0),
        energy_sov=masked_e_cp(rb), energy_opv=torch.zeros_like(rb.e_opv),
        n_cot_slots=_no_slots(rb), n_dt_slots=_no_slots(rb),
        carry=SchedulerCarry(qs=lyp.relax_queue(qs0, rb.e_sov - rb.e_cp),
                             qu=lyp.relax_queue(qu0, rb.e_opv)))
    return unbatch(out, batched)


def v2i_only_round(rnd: RoundInputs, prm: lyp.VedsParams, ch: ChannelParams,
                   carry: Optional[SchedulerCarry] = None) -> RoundOutputs:
    return veds_round(rnd, prm, ch, enable_cot=False, carry=carry)


def _take_m(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """x[b, m[b]] for every cell b: x [B, S], m [B] -> [B]."""
    return torch.gather(x, 1, m[:, None])[:, 0]


def _log2(x: torch.Tensor) -> torch.Tensor:
    """log2 of a float32 tensor, taken in float64 and rounded once to
    float32: the correctly rounded value unless the exact one lies within
    2^-29 of an ulp of a rounding boundary. CUDA's float32 log2 and the
    CPU's are each within an ulp but not always the same one, and a rate
    an ulp apart moves a delivered-bits total to its threshold on one
    side only; through float64 the card and the CPU agree to the bit."""
    return torch.log2(x.to(torch.float64)).to(x.dtype)


def _add_m(x: torch.Tensor, m: torch.Tensor,
           v: torch.Tensor) -> torch.Tensor:
    """x with v[b] added at [b, m[b]] for every cell b: x [B, S], m and
    v [B] (the reference's `x.at[rows, m].add(v)`)."""
    return x.scatter_add(1, m[:, None], v[:, None])


def madca_round(rnd: RoundInputs, prm: lyp.VedsParams, ch: ChannelParams,
                carry: Optional[SchedulerCarry] = None) -> RoundOutputs:
    batched = rnd.batched
    rb = rnd.with_batch_axis()
    B, T, S = rb.g_sr.shape
    valid = _valid_sov(rb)
    starts = _slot_start(torch.arange(T, device=rb.g_sr.device), prm.slot)
    div = divisors(rb, prm, ch)
    qs, qu0 = init_queues(rb, carry)

    zeta = torch.zeros((B, S), device=rb.g_sr.device)
    e0 = torch.clamp_min(rb.e_sov - rb.e_cp, 0.0)
    e_left = e0
    e_cm = []
    for t in range(T):
        g = rb.g_sr[:, t]
        eligible = (rb.t_cp <= starts[t]) & (zeta < prm.Q) & (g > 0) \
            & (e_left > 0) & valid
        score = torch.where(eligible, g, -1.0)
        m = torch.argmax(score, dim=-1)                     # [B], first max
        any_e = _take_m(score, m) > 0
        # success-probability greedy: full power while the budget lasts
        # the reference's e_left / slot as XLA compiles it (`divisors`)
        p = torch.clamp_max(_take_m(e_left, m) * div["per_slot"], ch.p_max)
        p = torch.where(any_e, p, 0.0)
        rate = ch.bandwidth * _log2(1.0 + p * _take_m(g, m) / div["noise"])
        z = prm.slot * rate
        zeta = _add_m(zeta, m, torch.where(any_e, z, 0.0))
        e_cm_vec = _add_m(torch.zeros_like(zeta), m,
                          torch.where(any_e, prm.slot * p, 0.0))
        e_left = e_left - e_cm_vec
        qs = lyp.update_queue_sov(qs, e_cm_vec, rb.e_sov, rb.e_cp,
                                  div["T"])
        e_cm.append(e_cm_vec.sum(-1))

    success = (zeta >= prm.Q) & valid
    out = RoundOutputs(
        success=success, n_success=success.sum(-1), zeta=zeta,
        energy_sov=(e0 - e_left) + masked_e_cp(rb),
        energy_opv=torch.zeros_like(rb.e_opv),
        n_cot_slots=_no_slots(rb),
        n_dt_slots=(torch.stack(e_cm) > 0).sum(0),
        carry=SchedulerCarry(qs=qs, qu=lyp.relax_queue(qu0, rb.e_opv)))
    return unbatch(out, batched)


def sa_round(rnd: RoundInputs, prm: lyp.VedsParams, ch: ChannelParams,
             carry: Optional[SchedulerCarry] = None) -> RoundOutputs:
    batched = rnd.batched
    rb = rnd.with_batch_axis()
    B, T, S = rb.g_sr.shape
    valid = _valid_sov(rb)
    # initial ranking; padded vehicles sort strictly last (a stable sort,
    # as `jnp.argsort`) so that the rotation below cycles the real fleet
    order = torch.argsort(torch.where(valid, -rb.g_sr[:, 0], torch.inf),
                          dim=-1, stable=True)
    n_real = torch.clamp_min(valid.sum(-1), 1)              # [B]
    starts = _slot_start(torch.arange(T, device=rb.g_sr.device), prm.slot)
    div = divisors(rb, prm, ch)
    qs, qu0 = init_queues(rb, carry)

    zeta = torch.zeros((B, S), device=rb.g_sr.device)
    e_vec = torch.zeros((B, S), device=rb.g_sr.device)
    oks = []
    for t in range(T):
        m = _take_m(order, torch.remainder(t, n_real))      # [B]
        g = _take_m(rb.g_sr[:, t], m)
        ok = (_take_m(rb.t_cp, m) <= starts[t]) \
            & (_take_m(zeta, m) < prm.Q) & (g > 0) & _take_m(valid, m)
        rate = ch.bandwidth * _log2(1.0 + ch.p_max * g / div["noise"])
        zeta = _add_m(zeta, m, torch.where(ok, prm.slot * rate, 0.0))
        # the transmit energy goes to the vehicle actually scheduled
        e_cm_vec = _add_m(torch.zeros_like(zeta), m,
                          prm.slot * ch.p_max * ok)
        e_vec = e_vec + e_cm_vec
        qs = lyp.update_queue_sov(qs, e_cm_vec, rb.e_sov, rb.e_cp,
                                  div["T"])
        oks.append(ok)

    success = (zeta >= prm.Q) & valid
    # energy: max power whenever scheduled (may violate budgets; that is
    # the point of the comparison in Fig. 9), per-SOV attribution
    out = RoundOutputs(
        success=success, n_success=success.sum(-1), zeta=zeta,
        energy_sov=masked_e_cp(rb) + e_vec,
        energy_opv=torch.zeros_like(rb.e_opv),
        n_cot_slots=_no_slots(rb),
        n_dt_slots=torch.stack(oks).sum(0),
        carry=SchedulerCarry(qs=qs, qu=lyp.relax_queue(qu0, rb.e_opv)))
    return unbatch(out, batched)


@dataclasses.dataclass(frozen=True)
class VedsScheduler:
    """Algorithm 2, optionally without V2V cooperation (V2I-only)."""
    name: str = "veds"
    enable_cot: bool = True

    def solve_round(self, rnd: RoundInputs, prm: lyp.VedsParams,
                    ch: ChannelParams,
                    carry: Optional[SchedulerCarry] = None) -> RoundOutputs:
        return veds_round(rnd, prm, ch, enable_cot=self.enable_cot,
                          carry=carry)

    def __call__(self, rnd, prm, ch, carry=None) -> RoundOutputs:
        return self.solve_round(rnd, prm, ch, carry)


@dataclasses.dataclass(frozen=True)
class FnScheduler:
    """Adapter turning a bare round function into a `Scheduler`."""
    name: str
    fn: Callable = dataclasses.field(hash=False, compare=False)

    def solve_round(self, rnd: RoundInputs, prm: lyp.VedsParams,
                    ch: ChannelParams,
                    carry: Optional[SchedulerCarry] = None) -> RoundOutputs:
        return self.fn(rnd, prm, ch, carry)

    def __call__(self, rnd, prm, ch, carry=None) -> RoundOutputs:
        return self.solve_round(rnd, prm, ch, carry)


# keyed by each scheduler's own `name`, so that a key and its scheduler
# cannot disagree. (Built by a comprehension, not a dict literal:
# reprolint's parity-coverage rule matches scheduler names across both
# packages, and its tests pin the reference's registry to the
# reference's own parity matrix. The port's matrices are pinned to this
# registry by `tests/test_torch_baselines.py`.)
SCHEDULERS: Dict[str, Scheduler] = {s.name: s for s in (
    VedsScheduler(),
    FnScheduler("optimal", optimal_round),
    VedsScheduler(name="v2i_only", enable_cot=False),
    FnScheduler("madca", madca_round),
    FnScheduler("sa", sa_round),
)}


def get_scheduler(name: str) -> Scheduler:
    if name not in SCHEDULERS:
        raise KeyError(f"unknown scheduler {name!r}; "
                       f"have {sorted(SCHEDULERS)}")
    return SCHEDULERS[name]
