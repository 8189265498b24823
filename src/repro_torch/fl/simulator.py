"""Single-host VFL simulator for the paper-scale experiments (Figs 10-12).

Port of `repro/fl/simulator.py`, with any of the five schedulers (VEDS
and the Section VI benchmarks) and any model whose loss takes a dict of
tensors (the CIFAR CNN of Figs. 10/11, LaneGCN of Fig. 12). 40 clients
hold data partitions; each round, S of them are the SOVs (vehicles in
coverage) and U others relay as OPVs. One local SGD step per round (eq.
2), success decided by the scheduler, aggregation by (11). For one local
step, FedAvg of models == FedSGD of gradients, so the clients' gradients
are one vmapped gradient call over the stacked minibatches.

Blocked path (`streaming=False`): every round draws an independent fleet
from its own generator and the queues start at zero. With
`round_batch = B > 1`, B rounds' scenarios are stacked on the [B] axis of
one `veds_round`; the history is the same for every `round_batch`. Client
selection and minibatches come from `numpy.random.default_rng(sim.seed)`,
drawn in the reference's order.

Streaming path (`streaming=True`), the paper's loop: a persistent fleet
drives through coverage from round to round, the virtual energy queues
carry (`carry_queues`), the P4 warm-start table rides along
(`ipm_warm_iters`), clients are sampled per round (a permutation, and
uniform minibatch draws, each round from its own generator) and the
model trains in the same loop (`fused`, `repro_torch.fl.engine
.fused_rollout`). Evaluation runs inside that loop by default
(`eval_in_scan`); `eval_in_scan=False` cuts the run into segments at the
eval points, each padded with no-op rounds to one length. `fused=False`
keeps the reference's host-gather path: the whole run's scheduling first,
then a host loop that gathers and trains.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.channel.mobility import ManhattanParams
from repro_torch.channel.v2x import ChannelParams
from repro_torch.core.baselines import get_scheduler
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scenario import (ScenarioParams, make_round,
                                       round_generator, round_key)
from repro_torch.core.scheduler import RolloutCarry
from repro_torch.core.streaming import (FLEET_STREAM, MB_STREAM, SEL_STREAM,
                                        StreamConfig, round_keys,
                                        sched_state0, stream_rounds)
from repro_torch.core.veds import RoundInputs
from repro_torch.fl.engine import (ClientShards, client_grads, fedavg_apply,
                                   fused_segment, init_carry)


@dataclasses.dataclass(frozen=True)
class FLSimConfig:
    n_clients: int = 40
    n_sov: int = 10
    n_opv: int = 10
    n_slots: int = 60
    rounds: int = 50
    round_batch: int = 1         # blocked: rounds scheduled together (B)
    batch_size: int = 32
    lr: float = 0.05
    scheduler: str = "veds"
    v_max: float = 10.0
    alpha: float = 2.0
    V: float = 0.2
    q_bits: float = 1e7
    seed: int = 0
    streaming: bool = False      # persistent fleet, carried state
    carry_queues: bool = True    # streaming: thread eqs. (19)-(20)
    n_fleet: int = 0             # streaming: pool size (0 -> 2 (S + U))
    fused: bool = True           # streaming: train inside the same loop
    fused_unroll: int = 1        # the reference's XLA lever; no effect
    handover_delay: bool = False  # streaming: one-round coverage lag
    ipm_warm_iters: int = 0      # streaming VEDS+COT: warm-started P4
    #                              budget (VedsParams.ipm_warm_iters);
    #                              0 keeps the cold full-budget solves
    eval_in_scan: bool = True    # streaming+fused: eval inside the loop;
    #                              False cuts the run into segments
    fused_history_chunk: int = 1  # streaming+fused: write the per-round
    #                              history in blocks of this many rounds
    #                              (bit for bit the same); segment lengths
    #                              must divide by it


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def run_fl(seed: int, params: Dict[str, torch.Tensor], loss_fn: Callable,
           client_data: Union[List[Dict[str, object]], ClientShards],
           sim: FLSimConfig, eval_fn: Callable | None = None,
           eval_every: int = 5, *, device=None,
           stage_hook: Callable[[str], None] | None = None
           ) -> Dict[str, list]:
    """Generic FL loop. `seed` seeds every draw of the run (blocked:
    round r's scenario from `round_generator(seed, r)`; streaming: the
    draw streams of `_stream_draws`); `client_data` is a list of
    per-client dicts of arrays or tensors, or an already padded
    `ClientShards`; `params` a dict of tensors. Runs on `device` (CUDA by
    default; raises if absent).

    `sim.scheduler` names any of the five schedulers of
    `repro_torch.core.baselines.SCHEDULERS` (VEDS and the four Section VI
    benchmarks: optimal, v2i_only, madca, sa), on every path.

    Returns history: round, time, n_success, eval metric, plus
    `scheduled_rounds`, the number of rounds scheduled (== sim.rounds).
    The fused streaming path also reports `dispatches`: the loop segments
    the run took (1 with eval inside the loop or without eval). The
    blocked and fused paths call `stage_hook(name)`, if given, after every
    stage of every round: "scenario", "schedule", "train" and "eval" (on
    the blocked path a block's rounds share its "scenario" and
    "schedule", which come with its first round).
    """
    device = resolve_device(device)
    mob = ManhattanParams(v_max=sim.v_max)
    ch = ChannelParams()
    prm = VedsParams(alpha=sim.alpha, V=sim.V, Q=sim.q_bits, slot=0.1,
                     ipm_warm_iters=sim.ipm_warm_iters)
    sc = ScenarioParams(n_sov=sim.n_sov, n_opv=sim.n_opv,
                        n_slots=sim.n_slots, batch_size=sim.batch_size)
    sched = get_scheduler(sim.scheduler)
    params = {k: v.detach().to(device) for k, v in params.items()}

    if sim.streaming and sim.fused:
        shards = (client_data.to(device)
                  if isinstance(client_data, ClientShards)
                  else ClientShards.from_ragged(client_data, device))
        return _run_fused(seed, params, loss_fn, shards, sim, sc, mob, ch,
                          prm, eval_fn, eval_every, device, stage_hook)

    # the gather paths stay host-side: per-client numpy arrays (padded
    # input sliced back to its true counts) with true-count weights
    if isinstance(client_data, ClientShards):
        np_n = _host(client_data.n_samples).astype(np.int64)
        host = {k: _host(v) for k, v in client_data.data.items()}
        np_clients = [{k: v[c, :np_n[c]] for k, v in host.items()}
                      for c in range(client_data.n_clients)]
    else:
        np_clients = [{k: _host(v) for k, v in d.items()}
                      for d in client_data]
        np_n = np.array([next(iter(d.values())).shape[0] if d else 0
                         for d in np_clients], np.int64)
    # minibatch schema for empty clients (a client may be a bare {})
    schema = next(({k: (v.shape[1:], v.dtype) for k, v in d.items()}
                   for d in np_clients if d), {})

    history = {"round": [], "time": [], "n_success": [], "metric": [],
               "scheduled_rounds": 0}
    sim_time = 0.0

    if sim.streaming:
        masks, n_succ, sel, mb_u = _streaming_schedule(
            seed, sim, sc, mob, ch, prm, sched, device)
        rng = None
    else:
        rng = np.random.default_rng(sim.seed)
    # stages are timed on the blocked path only: the host-gather path
    # schedules the whole run before it trains
    hook = (None if sim.streaming else stage_hook) or (lambda name: None)

    def round_step(r, mask, n_success, sel_r, mb_u_r, params):
        nonlocal sim_time
        mbs, weights = [], []
        for s, ci in enumerate(sel_r):
            n = int(np_n[int(ci)])
            if n == 0:                               # empty client: zero
                mbs.append({                         # batch, weight 0
                    k: np.zeros((sim.batch_size,) + shp, dt)
                    for k, (shp, dt) in schema.items()})
                weights.append(0.0)
                continue
            if mb_u_r is None:                       # host-RNG contract
                idx = rng.choice(max(n, 1), size=sim.batch_size,
                                 replace=n < sim.batch_size)
            else:                                    # streaming uniforms:
                idx = np.minimum((mb_u_r[s] * n).astype(np.int64),  # fp32
                                 max(n - 1, 0))
            mbs.append({k: v[idx] for k, v in np_clients[int(ci)].items()})
            weights.append(float(n))                 # true sample count
        mb_stack = {k: torch.as_tensor(np.stack([m[k] for m in mbs])
                                       ).to(device) for k in schema}
        grads = client_grads(loss_fn, params, mb_stack)
        params, _ = fedavg_apply(
            params, grads, torch.as_tensor(mask, dtype=torch.float32,
                                           device=device),
            torch.tensor(weights, dtype=torch.float32, device=device),
            lr=sim.lr)
        sim_time += sim.n_slots * prm.slot
        hook("train")
        if eval_fn is not None and (r % eval_every == 0 or
                                    r == sim.rounds - 1):
            history["round"].append(r)
            history["time"].append(sim_time)
            history["n_success"].append(n_success)
            history["metric"].append(float(eval_fn(params)))
        hook("eval")
        return params

    if sim.streaming:
        for r in range(sim.rounds):
            params = round_step(r, masks[r], int(n_succ[r]), sel[r],
                                mb_u[r], params)
        history["scheduled_rounds"] = sim.rounds
        _sync(device)
        return history

    B = max(1, sim.round_batch)
    for r0 in range(0, sim.rounds, B):
        n_block = min(B, sim.rounds - r0)
        rounds = [make_round(round_generator(seed, r, device), sc, mob, ch,
                             prm) for r in range(r0, r0 + n_block)]
        hook("scenario")
        out = sched.solve_round(
            RoundInputs.stack(rounds) if B > 1 else rounds[0], prm, ch)
        hook("schedule")
        history["scheduled_rounds"] += n_block
        for j in range(n_block):
            cell = out.cell(j) if B > 1 else out
            mask = cell.success.to(torch.float32)
            sel_r = rng.choice(sim.n_clients, size=sim.n_sov,
                               replace=False)
            params = round_step(r0 + j, mask, int(cell.n_success), sel_r,
                                None, params)
    _sync(device)
    return history


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _stream_cfg(sim: FLSimConfig) -> StreamConfig:
    return StreamConfig(n_rounds=sim.rounds, batch=1,
                        carry_queues=sim.carry_queues,
                        n_fleet=sim.n_fleet or None,
                        handover_delay=sim.handover_delay)


def client_draws(seed: int, n_rounds: int, n_clients: int, n_sov: int,
                 batch_size: int, device):
    """The training side's draws of rounds 0 .. n_rounds - 1 of a run
    seeded with `seed`: (sel [R, S], mb_u [R, S, bs]), a client
    permutation per round and uniform minibatch draws, each round from
    its own generator on `device`."""
    def gen(stream, r):
        return torch.Generator(device=device).manual_seed(
            round_key(seed, stream, r))

    sel = torch.stack([
        torch.randperm(n_clients, generator=gen(SEL_STREAM, r),
                       device=device)[:n_sov] for r in range(n_rounds)])
    mb_u = torch.stack([
        torch.rand((n_sov, batch_size), generator=gen(MB_STREAM, r),
                   device=device) for r in range(n_rounds)])
    return sel, mb_u


def _stream_draws(seed: int, sim: FLSimConfig, device):
    """The streaming draws shared by the fused and host-gather paths:
    (round keys [R], the fleet's key, sel [R, S], mb_u [R, S, bs])."""
    R = sim.rounds
    sel, mb_u = client_draws(seed, R, sim.n_clients, sim.n_sov,
                             sim.batch_size, device)
    return (round_keys(seed, _stream_cfg(sim), R),
            round_key(seed, FLEET_STREAM, 0), sel, mb_u)


def _run_fused(seed, params, loss_fn, shards: ClientShards,
               sim: FLSimConfig, sc, mob, ch, prm, eval_fn, eval_every,
               device, stage_hook=None):
    """The fused path. Default (`eval_in_scan`, or no eval_fn): the whole
    run, scheduling, training and eval, is ONE `fused_rollout` loop with
    a single trailing device synchronisation. With `eval_in_scan=False`
    the run is cut at the eval points (host-side eval_fn per segment),
    every segment padded with no-op rounds to one length."""
    R = sim.rounds
    cfg = _stream_cfg(sim)
    keys, fleet_key, sel, mb_u = _stream_draws(seed, sim, device)
    sel = sel[:, None]                                       # [R, 1, S]
    mb_u = mb_u[:, None]                                     # [R, 1, S, bs]
    carry = init_carry(fleet_key, sc, mob, cfg, params, ch=ch,
                       device=device)
    evals = ([] if eval_fn is None else
             [r for r in range(R) if r % eval_every == 0 or r == R - 1])
    history = {"round": [], "time": [], "n_success": [], "metric": [],
               "scheduled_rounds": R, "dispatches": 0}
    seg_cfg = dataclasses.replace(cfg, n_rounds=0)
    K = max(1, sim.fused_history_chunk)

    if eval_fn is None or sim.eval_in_scan:
        seg_fn = fused_segment(loss_fn, sim.scheduler, sc, mob, ch, prm,
                               seg_cfg, sim.lr, max(1, sim.fused_unroll),
                               eval_fn, K)
        ev = np.zeros(R, bool)
        ev[evals] = True
        res = seg_fn(carry, keys, sel, mb_u, shards, range(R),
                     np.ones(R, bool), ev, stage_hook=stage_hook)
        history["dispatches"] = 1
        # the one trailing synchronisation: what is read below is done
        _sync(device)
        if evals:
            n_succ = _host(res.outputs.n_success[:, 0])
            met = _host(res.metric[:, 0])
            for r in evals:
                history["round"].append(r)
                history["time"].append((r + 1) * sim.n_slots * prm.slot)
                history["n_success"].append(int(n_succ[r]))
                history["metric"].append(float(met[r]))
        return history

    seg_fn = fused_segment(loss_fn, sim.scheduler, sc, mob, ch, prm,
                           seg_cfg, sim.lr, max(1, sim.fused_unroll), None,
                           K)
    cuts = [e + 1 for e in evals]
    # one segment length for the whole run: every segment is padded to
    # the longest (then to a multiple of the history chunk) with no-op
    # (inactive) tail rounds, as the reference pads its segments
    L = max(cut - r0 for r0, cut in zip([0] + cuts[:-1], cuts))
    L = -(-L // K) * K

    def padded(x, r0, n):
        s = x[r0:r0 + n]
        if n == L:
            return s
        if torch.is_tensor(s):
            return torch.cat([s, s[-1:].expand((L - n,) + s.shape[1:])])
        return list(s) + [s[-1]] * (L - n)

    r0 = 0
    for cut in cuts:
        n = cut - r0
        res = seg_fn(carry, padded(keys, r0, n), padded(sel, r0, n),
                     padded(mb_u, r0, n), shards,
                     padded(list(range(R)), r0, n), np.arange(L) < n,
                     np.zeros(L, bool), stage_hook=stage_hook)
        carry = RolloutCarry(
            sched=res.fleet if res.fleet is not None else res.carry,
            params=res.params, opt_state=res.opt_state)
        history["dispatches"] += 1
        r = cut - 1
        history["round"].append(r)
        history["time"].append((r + 1) * sim.n_slots * prm.slot)
        history["n_success"].append(int(res.outputs.n_success[n - 1, 0]))
        history["metric"].append(float(eval_fn(
            {k: v[0] for k, v in res.params.items()})))
        r0 = cut
    _sync(device)
    return history


def _streaming_schedule(seed, sim: FLSimConfig, sc, mob, ch, prm, sched,
                        device):
    """Host-gather streaming path: the whole run's scheduling first, on
    the fused path's draws, then the host loop trains. Returns
    (masks [R,S], n_success [R], sel [R,S], mb_u [R,S,batch]) as host
    arrays."""
    cfg = _stream_cfg(sim)
    keys, fleet_key, sel, mb_u = _stream_draws(seed, sim, device)
    fleet = sched_state0(fleet_key, sc, mob, cfg, ch=ch, device=device)
    res = stream_rounds(seed, sched, sc, mob, ch, prm, cfg, fleet,
                        keys=keys)
    return (_host(res.outputs.success[:, 0].to(torch.float32)),
            _host(res.outputs.n_success[:, 0]), _host(sel), _host(mb_u))
