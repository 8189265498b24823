"""Single-host VFL simulator for the paper-scale experiments (Figs 10-12).

Port of the blocked path of `repro/fl/simulator.py` (`run_fl` with
`streaming=False`). 40 clients hold data partitions; each round, S of
them are the SOVs and U others relay as OPVs. One local SGD step per
round (eq. 2), success decided by the scheduler, aggregation by (11). For
one local step, FedAvg of models == FedSGD of gradients, so the clients'
gradients are one vmapped gradient call over the stacked minibatches.

With `round_batch = B > 1`, B rounds are scheduled together: their
scenarios, each drawn from its own per-round generator, are stacked on
the [B] axis of one `veds_round`. The history is the same for every
`round_batch`; the knob only groups the scheduling work. Client selection
and minibatches come from `numpy.random.default_rng(sim.seed)`, drawn in
the reference's order. The streaming and fused paths come with a later
slice of the port and raise here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.channel.mobility import ManhattanParams
from repro_torch.channel.v2x import ChannelParams
from repro_torch.core.baselines import get_scheduler
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scenario import (ScenarioParams, make_round,
                                       round_generator)
from repro_torch.core.veds import RoundInputs
from repro_torch.fl.engine import client_grads, fedavg_apply


@dataclasses.dataclass(frozen=True)
class FLSimConfig:
    n_clients: int = 40
    n_sov: int = 10
    n_opv: int = 10
    n_slots: int = 60
    rounds: int = 50
    round_batch: int = 1         # rounds scheduled together (B)
    batch_size: int = 32
    lr: float = 0.05
    scheduler: str = "veds"
    v_max: float = 10.0
    alpha: float = 2.0
    V: float = 0.2
    q_bits: float = 1e7
    seed: int = 0
    # the reference's streaming and fused engine; not ported yet
    streaming: bool = False
    carry_queues: bool = True
    n_fleet: int = 0
    fused: bool = True
    fused_unroll: int = 1
    handover_delay: bool = False
    ipm_warm_iters: int = 0
    eval_in_scan: bool = True
    fused_history_chunk: int = 1


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def run_fl(seed: int, params: Dict[str, torch.Tensor], loss_fn: Callable,
           client_data: List[Dict[str, object]], sim: FLSimConfig,
           eval_fn: Callable | None = None, eval_every: int = 5, *,
           device=None) -> Dict[str, list]:
    """Generic FL loop. `seed` seeds every round's scenario generator
    (round r draws from `round_generator(seed, r)`); `client_data` is a
    list of per-client dicts of arrays or tensors; `params` a dict of
    tensors. Runs on `device` (CUDA by default; raises if absent).

    Returns history: round, time, n_success, eval metric, plus
    `scheduled_rounds`, the number of rounds scheduled (== sim.rounds).
    """
    device = resolve_device(device)
    if sim.streaming:
        raise NotImplementedError(
            "run_fl(streaming=True) and the fused engine come with the "
            "streaming slice of the port; only the blocked path is here")
    mob = ManhattanParams(v_max=sim.v_max)
    ch = ChannelParams()
    prm = VedsParams(alpha=sim.alpha, V=sim.V, Q=sim.q_bits, slot=0.1,
                     ipm_warm_iters=sim.ipm_warm_iters)
    sc = ScenarioParams(n_sov=sim.n_sov, n_opv=sim.n_opv,
                        n_slots=sim.n_slots, batch_size=sim.batch_size)
    sched = get_scheduler(sim.scheduler)
    params = {k: v.detach().to(device) for k, v in params.items()}

    # minibatches are gathered on the host from per-client numpy arrays
    np_clients = [{k: _host(v) for k, v in d.items()} for d in client_data]
    np_n = np.array([next(iter(d.values())).shape[0] if d else 0
                     for d in np_clients], np.int64)
    # minibatch schema for empty clients (a client may be a bare {})
    schema = next(({k: (v.shape[1:], v.dtype) for k, v in d.items()}
                   for d in np_clients if d), {})

    history = {"round": [], "time": [], "n_success": [], "metric": [],
               "scheduled_rounds": 0}
    sim_time = 0.0
    rng = np.random.default_rng(sim.seed)

    def round_step(r, mask, n_success, sel_r, params):
        nonlocal sim_time
        mbs, weights = [], []
        for ci in sel_r:
            n = int(np_n[int(ci)])
            if n == 0:                               # empty client: zero
                mbs.append({                         # batch, weight 0
                    k: np.zeros((sim.batch_size,) + shp, dt)
                    for k, (shp, dt) in schema.items()})
                weights.append(0.0)
                continue
            idx = rng.choice(max(n, 1), size=sim.batch_size,
                             replace=n < sim.batch_size)
            mbs.append({k: v[idx] for k, v in np_clients[int(ci)].items()})
            weights.append(float(n))                 # true sample count
        mb_stack = {k: torch.as_tensor(np.stack([m[k] for m in mbs])
                                       ).to(device) for k in schema}
        grads = client_grads(loss_fn, params, mb_stack)
        params = fedavg_apply(params, grads, mask,
                              torch.tensor(weights, dtype=torch.float32,
                                           device=device), lr=sim.lr)
        sim_time += sim.n_slots * prm.slot
        if eval_fn is not None and (r % eval_every == 0 or
                                    r == sim.rounds - 1):
            history["round"].append(r)
            history["time"].append(sim_time)
            history["n_success"].append(n_success)
            history["metric"].append(float(eval_fn(params)))
        return params

    B = max(1, sim.round_batch)
    for r0 in range(0, sim.rounds, B):
        n_block = min(B, sim.rounds - r0)
        rounds = [make_round(round_generator(seed, r, device), sc, mob, ch,
                             prm) for r in range(r0, r0 + n_block)]
        out = sched.solve_round(
            RoundInputs.stack(rounds) if B > 1 else rounds[0], prm, ch)
        history["scheduled_rounds"] += n_block
        for j in range(n_block):
            cell = out.cell(j) if B > 1 else out
            mask = cell.success.to(torch.float32)
            sel_r = rng.choice(sim.n_clients, size=sim.n_sov,
                               replace=False)
            params = round_step(r0 + j, mask, int(cell.n_success), sel_r,
                                params)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return history
