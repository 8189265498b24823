"""Streaming multi-round rollout: R rounds of B cells in one loop.

Port of `repro/core/streaming.py`. The paper's stochastic optimisation is
long-term: vehicles drive continuously through RSU coverage while the
drift-plus-penalty virtual energy queues (eqs. 19-20) track cumulative
budget violation across rounds. `stream_rounds` runs a whole run's
scheduling as one loop: each round advances the persistent `FleetState`
(mobility, residual energy, per-vehicle virtual queues), re-selects
SOVs/OPVs by coverage, draws channels, runs the scheduler with the
carried queues and scatters queue/energy updates back into the fleet.
The reference's `lax.scan` is a Python loop here; on a CUDA device each
round's VEDS slots replay the captured slot graph (`core/veds.py`).
Axes of configuration:

  fresh_fleet    True  -> draw an independent fleet per round
                          (`make_round_batch`); with `carry_queues=False`
                          every round is the blocked path's round.
                 False -> thread one persistent fleet (time-correlated
                          trajectories, coverage-driven re-selection).
  carry_queues   True  -> virtual queues persist round to round.
                 False -> queues reset each round.
  handover_delay persistent mode: vehicles entering coverage mid-round
                 become eligible only the next round.
  handoff        persistent mode: the B cells are B RSUs on one road
                 network, and each round starts with `exchange_fleet`.
  round_chunk    fresh-fleet, carry_queues=False only: solve
                 `round_chunk` rounds at once as one widened cell batch.

Queue freeze/restore rule (eqs. 19-20 across coverage gaps): a vehicle's
virtual queue updates only in rounds it plays (selected with `valid_*`
True); while it is out of coverage, unselected or parked, its queue is
frozen in `FleetState.queue` and restored as the round-start queue when
it is selected again, whatever its role. Under handoff the queue moves
with the vehicle.

Warm-started interior point (persistent VEDS+COT): with
`VedsParams.ipm_warm_iters > 0` the per-vehicle P4 warm-start table
(`FleetState.p4_tab`) rides along: each round gathers the SOV slots'
tables into `SchedulerCarry.p4`, VEDS re-solves every candidate from the
previous optimum with the shortened budget (chaining slot to slot inside
the round), and the refreshed table scatters back under the same freeze
rule as the queues.

Randomness: every round draws from its own generator, seeded with a
round key derived from (seed, stream, r) alone (`round_keys`), so a run
cut into segments draws what the one-loop run draws. A round key may
also be the round's draws themselves (a dict), which is how tests feed
the reference's draws, or, in persistent mode, a list of B per-cell keys
(the serving layer's packed sessions: cell b draws what a B = 1 round
with its key draws).
"""
from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Union

import torch

from repro_torch import resolve_device
from repro_torch.channel.mobility import ManhattanParams
from repro_torch.channel.v2x import ChannelParams
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scenario import (FleetState, ScenarioParams,
                                       exchange_fleet, fleet_round,
                                       init_fleet, make_round_batch,
                                       per_cell, round_key, rsu_grid)
from repro_torch.core.scheduler import (RoundOutputs, SchedulerCarry,
                                        map_tensors, map_tree, stack_tree)

# the draw streams of a run: one generator per (stream, round)
ROUND_STREAM, FLEET_STREAM, SEL_STREAM, MB_STREAM = 0, 1, 2, 3


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Static configuration of a streaming rollout."""
    n_rounds: int = 50
    batch: int = 1                  # B parallel cells per round
    carry_queues: bool = False      # thread eqs. (19)-(20) across rounds
    fresh_fleet: bool = False       # blocked-parity mode (see module doc)
    hetero_fleet: bool = False      # fresh-fleet mode: pad fleets per cell
    n_fleet: Optional[int] = None   # persistent pool size (default 2(S+U))
    energy_horizon: Optional[float] = None  # battery, in rounds of budget
    handover_delay: bool = False    # persistent mode: one-round lag on entry
    handoff: bool = False           # persistent mode: cross-cell exchange
    round_chunk: int = 1            # fresh mode: rounds solved per step


class StreamResult(NamedTuple):
    """One streaming rollout's results.

      outputs  RoundOutputs stacked [R, B, ...] (`.carry` stacked too:
               the per-round virtual-queue trace)
      fleet    final FleetState (None in fresh-fleet mode)
      carry    final round's queue state [B, S]/[B, U]
    """
    outputs: RoundOutputs
    fleet: Optional[FleetState]
    carry: SchedulerCarry


SchedState = Union[FleetState, SchedulerCarry]


def _zero_carry(sc: ScenarioParams, B: int, device) -> SchedulerCarry:
    return SchedulerCarry(qs=torch.zeros((B, sc.n_sov), device=device),
                          qu=torch.zeros((B, sc.n_opv), device=device))


def validate_stream_config(cfg: StreamConfig, *,
                           threads_params: bool = False) -> None:
    """Reject flag combinations that would be silently ignored, before
    anything is built. `threads_params` marks callers that thread model
    parameters round to round (the fused training engine): they cannot
    honour `round_chunk > 1`, whose rounds are solved in parallel."""
    if cfg.fresh_fleet and cfg.handover_delay:
        raise ValueError("handover_delay needs the persistent fleet's "
                         "coverage memory (fresh_fleet=False)")
    if cfg.fresh_fleet and cfg.handoff:
        raise ValueError("handoff moves vehicles between persistent "
                         "cells (fresh_fleet=False)")
    C = int(cfg.round_chunk)
    if C < 1:
        raise ValueError(f"round_chunk={C} must be >= 1")
    if C > 1:
        if threads_params:
            raise ValueError("fused_rollout threads params round-to-round "
                             "and cannot honor round_chunk > 1")
        if not cfg.fresh_fleet:
            raise ValueError("round_chunk > 1 requires fresh_fleet=True")
        if cfg.carry_queues:
            raise ValueError("round_chunk > 1 solves chunk rounds in "
                             "parallel and cannot thread carry_queues")
        if int(cfg.n_rounds) % C:
            raise ValueError(f"n_rounds={int(cfg.n_rounds)} not "
                             f"divisible by round_chunk={C}")


# The FleetState fields that tolerate reduced-precision storage between
# rounds: only the P4 warm-start table, ~95% of the fleet's bytes (110
# floats a vehicle at U = 10, against 5 for everything else). The solver
# re-projects and polishes from the seed, so rounding it perturbs only
# the warm path's low bits; the [B, N] world fields feed hard thresholds
# (coverage, t_cp eligibility, budgets) and stay fp32.
FLEET_CAST_FIELDS = ("p4_tab",)


def _cast_fields(state: SchedState, dtype) -> SchedState:
    return dataclasses.replace(state, **{
        f: getattr(state, f).to(dtype) for f in FLEET_CAST_FIELDS})


def cast_sched_state(state: SchedState, dtype) -> SchedState:
    """Demote the cast-tolerant fields of a persistent `FleetState` to
    `dtype` for storage between rounds. A `SchedulerCarry` passes through
    (its queues are the masters); `dtype` None is a no-op."""
    if dtype is None or not isinstance(state, FleetState):
        return state
    return _cast_fields(state, dtype)


def promote_sched_state(state: SchedState,
                        dtype=torch.float32) -> SchedState:
    """Inverse of `cast_sched_state`: the stored fields back to the
    compute dtype at round start, so every round computes in fp32."""
    if not isinstance(state, FleetState):
        return state
    return _cast_fields(state, dtype)


def round_keys(seed: int, cfg: StreamConfig, n_rounds: int,
               r0: int = 0) -> List[int]:
    """The scheduling keys of rounds r0 .. r0 + n_rounds - 1 of a run
    seeded with `seed`, in both fleet modes: each from (seed, r) alone,
    so any slice of a run's keys is what the one-loop run uses."""
    return [round_key(seed, ROUND_STREAM, r)
            for r in range(r0, r0 + n_rounds)]


def sched_state0(key, sc: ScenarioParams, mob: ManhattanParams,
                 cfg: StreamConfig, fleet: Optional[FleetState] = None,
                 ch: Optional[ChannelParams] = None,
                 device=None) -> SchedState:
    """The scheduling side's initial carry: zero queues in fresh-fleet
    mode, a (possibly freshly drawn) `FleetState` in persistent mode.
    `key` is the run's seed (the fleet draws from its own stream), or the
    fleet's draws (`init_fleet_draws`). With `cfg.handoff` the default
    fleet's RSUs sit on the overlapping-coverage grid (`rsu_grid`). `ch`
    seeds the P4 warm-start table at the run's `p_max`."""
    device = resolve_device(device)
    if cfg.fresh_fleet:
        return _zero_carry(sc, int(cfg.batch), device)
    if fleet is None:
        rsu = (rsu_grid(int(cfg.batch), mob, device=device) if cfg.handoff
               else None)
        fkey = key if isinstance(key, dict) else round_key(
            key, FLEET_STREAM, 0)
        fleet = init_fleet(fkey, sc, mob, int(cfg.batch),
                           n_fleet=cfg.n_fleet,
                           energy_horizon=cfg.energy_horizon, rsu_xy=rsu,
                           p_max=None if ch is None else ch.p_max,
                           device=device)
    return fleet


def pack_cells(states, pad_to: Optional[int] = None) -> SchedState:
    """Concatenate per-session B=1 states (any dataclass of tensors with
    a leading cell axis: `RolloutCarry`, `FleetState`, `SchedulerCarry`)
    into one packed state along the [B] cell axis. `pad_to` fills spare
    cell slots with replicas of the first state; the caller must
    deactivate them."""
    states = list(states)
    if pad_to is not None:
        if pad_to < len(states):
            raise ValueError(f"pad_to={pad_to} smaller than the "
                             f"{len(states)} states to pack")
        states = states + [states[0]] * (pad_to - len(states))
    if len(states) == 1:
        return states[0]
    return stack_tree(states, torch.cat)


def unpack_cell(state, b: int):
    """Cell `b` of a packed state (a dataclass or dict of tensors) as a
    B=1 state (`pack_cells`'s inverse for one session)."""
    return map_tree(lambda x: x[b:b + 1], state)


def warm_p4(sched, prm: VedsParams) -> bool:
    """Whether a rollout threads the P4 warm-start table: VEDS with
    cooperation (the only scheduler that solves P4) and a nonzero warm
    budget. Persistent fleets only."""
    return prm.ipm_warm_iters > 0 and bool(getattr(sched, "enable_cot",
                                                   False))


def _rows_set(x: torch.Tensor, idx: torch.Tensor, v: torch.Tensor):
    """x with x[b, idx[b]] = v[b] for every row (idx unique per row)."""
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x.index_put((rows, idx), v)


def round_carry(fl, sel, warm: bool, carry_queues: bool):
    """The scheduler's carry for a fleet round: the queues of the round's
    selected vehicles (`sel`), gathered from the fleet, and with `warm`
    their P4 table rows ([B,S,U,1+U]). Returns (carry or None, qs, qu,
    p4): the gathered values, which the round scatters back for the
    vehicles that did not play."""
    rows = torch.arange(fl.batch_size, device=fl.queue.device)[:, None]
    qs_old = torch.gather(fl.queue, 1, sel.sov_idx)
    qu_old = torch.gather(fl.queue, 1, sel.opv_idx)
    p4_old = fl.p4_tab[rows, sel.sov_idx] if warm else None
    if carry_queues:
        c_in = SchedulerCarry(qs=qs_old, qu=qu_old, p4=p4_old)
    elif warm:
        # the table threads without the queues: they start at zero
        c_in = SchedulerCarry(qs=torch.zeros_like(qs_old),
                              qu=torch.zeros_like(qu_old), p4=p4_old)
    else:
        c_in = None
    return c_in, qs_old, qu_old, p4_old


def sched_round_step(state: SchedState, k, sched, sc: ScenarioParams,
                     mob: ManhattanParams, ch: ChannelParams,
                     prm: VedsParams, cfg: StreamConfig, stage_hook=None,
                     exchange=exchange_fleet):
    """One round of scheduling: advance the fleet (or draw a fresh one
    from round key `k`), run the scheduler with the carried queues and
    scatter queue/energy updates back. Returns (state', RoundOutputs).

    With `warm_p4(sched, prm)` the fleet's P4 table is gathered for this
    round's SOV slots, threaded through the scheduler
    (`SchedulerCarry.p4`) and scattered back under the freeze rule of
    the queues: only slots that played update. `stage_hook(name)`, if
    given, is called after "scenario" and after "schedule" (a caller may
    time them).

    `k` may be one round key or a sequence of B per-cell keys (the
    serving layer's packed sessions): per-cell keys need the persistent
    fleet's per-cell draws (`fleet_round`), so fresh-fleet mode rejects
    them. With `cfg.handoff` the round starts with `exchange(state,
    mob)`: the one-device `exchange_fleet`, or where the cells are split
    over processes the exchange of `mesh_exec.allgather_exchange`."""
    hook = stage_hook or (lambda name: None)
    if cfg.fresh_fleet:
        if per_cell(k):
            raise ValueError("per-cell keys [B] need a persistent fleet "
                             "(fresh_fleet draws the whole batch from "
                             "one round key)")
        rnd = make_round_batch(k, sc, mob, ch, prm, int(cfg.batch),
                               hetero_fleet=cfg.hetero_fleet,
                               device=state.qs.device)
        hook("scenario")
        out = sched.solve_round(rnd, prm, ch,
                                state if cfg.carry_queues else None)
        hook("schedule")
        return out.carry, out

    if cfg.handoff:
        state = exchange(state, mob)
    fl, rnd, sel = fleet_round(k, state, sc, mob, ch, prm,
                               handover_delay=cfg.handover_delay,
                               handoff=cfg.handoff)
    hook("scenario")
    warm = warm_p4(sched, prm)
    c_in, qs_old, qu_old, p4_old = round_carry(fl, sel, warm,
                                               cfg.carry_queues)
    out = sched.solve_round(rnd, prm, ch, c_in)
    # freeze/restore: round-end queues go back only to the fleet slots
    # that played (valid_*); unselected vehicles are never written, and
    # batteries drain only by energy spent in valid slots
    queue = fl.queue
    if cfg.carry_queues:
        queue = _rows_set(queue, sel.sov_idx, torch.where(
            rnd.valid_sov, out.carry.qs, qs_old))
        queue = _rows_set(queue, sel.opv_idx, torch.where(
            rnd.valid_opv, out.carry.qu, qu_old))
    p4_tab = fl.p4_tab
    if warm:
        p4_tab = _rows_set(p4_tab, sel.sov_idx, torch.where(
            rnd.valid_sov[..., None, None], out.carry.p4, p4_old))
    energy = fl.energy.scatter_add(
        1, sel.sov_idx, -torch.where(rnd.valid_sov, out.energy_sov, 0.0))
    energy = energy.scatter_add(
        1, sel.opv_idx, -torch.where(rnd.valid_opv, out.energy_opv, 0.0))
    fl = dataclasses.replace(fl, queue=queue, p4_tab=p4_tab,
                             energy=torch.clamp_min(energy, 0.0))
    hook("schedule")
    return fl, out


def stream_rounds(key, sched, sc: ScenarioParams, mob: ManhattanParams,
                  ch: ChannelParams, prm: VedsParams, cfg: StreamConfig,
                  fleet: Optional[FleetState] = None, *,
                  keys: Optional[Sequence] = None, device=None,
                  exchange=exchange_fleet) -> StreamResult:
    """Roll out `cfg.n_rounds` rounds of `cfg.batch` cells. `key` is the
    run's seed: the rounds use `round_keys(key, ...)` unless `keys` (one
    round key each) is given, and the fleet draws from its own stream
    unless `fleet` is given. Resumable: pass the returned `fleet` and the
    next rounds' `keys` to continue. Runs on `device` (CUDA by default;
    the fleet's device where a fleet is given). `exchange` is the
    cross-cell exchange of `cfg.handoff` (`sched_round_step`)."""
    R = int(cfg.n_rounds)
    validate_stream_config(cfg)
    if fleet is not None:
        device = fleet.pos.device
    device = resolve_device(device)
    if keys is None:
        keys = round_keys(key, cfg, R)
    keys = list(keys)[:R]
    if int(cfg.round_chunk) > 1:
        return _stream_fresh_chunked(keys, sched, sc, mob, ch, prm, cfg,
                                     device)
    state = sched_state0(key, sc, mob, cfg, fleet, ch, device)
    outs = []
    for k in keys:
        state, out = sched_round_step(state, k, sched, sc, mob, ch, prm,
                                      cfg, exchange=exchange)
        outs.append(out)
    outputs = stack_tree(outs)
    if cfg.fresh_fleet:
        return StreamResult(outputs=outputs, fleet=None, carry=state)
    return StreamResult(outputs=outputs, fleet=state, carry=outs[-1].carry)


def _stream_fresh_chunked(keys, sched, sc, mob, ch, prm, cfg: StreamConfig,
                          device) -> StreamResult:
    """Fresh-fleet mode with `round_chunk = C > 1`: C rounds' cells (each
    round from its own key) solved as ONE widened [C * B] batch, so the
    P4 candidate solves batch across rounds. The flags were validated by
    the caller."""
    C, B = int(cfg.round_chunk), int(cfg.batch)
    outs = []
    for c0 in range(0, len(keys), C):
        rnds = [make_round_batch(k, sc, mob, ch, prm, B,
                                 hetero_fleet=cfg.hetero_fleet,
                                 device=device) for k in keys[c0:c0 + C]]
        wide = stack_tree(rnds, torch.cat)
        out = sched.solve_round(wide, prm, ch, None)
        outs += [map_tensors(lambda x, j=j: x[j * B:(j + 1) * B], out)
                 for j in range(C)]
    return StreamResult(outputs=stack_tree(outs), fleet=None,
                        carry=outs[-1].carry)
