"""The FL training engine: FedAvg of per-client gradients (eq. 11) and
the fused rollout that schedules, trains and aggregates in one loop.

Port of `repro/fl/engine.py`. The paper's pipeline is one loop: schedule
(Algorithm 2), train locally (eq. 2), aggregate (eq. 11). `fused_rollout`
runs the same per-round scheduling step as `repro_torch.core.streaming`
(mobility -> coverage re-selection -> channels -> `solve_round` ->
queue/energy carry) and, in the same round, gathers each selected
client's minibatch from the padded `[C, n_max, ...]` shard layout, takes
one local SGD step per client (for one local step, FedAvg of models ==
FedSGD of gradients) and applies the mask-weighted aggregation. The
carry is a `RolloutCarry`: the scheduling state (queues or persistent
fleet, with the P4 warm-start table) beside the global model and the
optimizer state. The reference's `lax.scan` is a Python loop over rounds
here; evaluation runs inside it on the flagged rounds.

Parameters and gradients are dicts of tensors; a stack of per-client
gradients has a leading [S] axis on every entry. Client data is padded,
not ragged: `ClientShards` holds every client's shard at a common `n_max`
with the true counts in `n_samples`. Minibatch indices are drawn against
the true counts and aggregation weights are the true counts, so padding
rows are never sampled and a client with zero samples never moves the
global model (its weight is 0 and its gradient is hard-zeroed before the
weighted average, so even NaNs from garbage padding cannot leak in).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch.channel.mobility import ManhattanParams
from repro_torch.channel.v2x import ChannelParams
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scenario import FleetState, ScenarioParams, per_cell
from repro_torch.core.scheduler import (RolloutCarry, RoundOutputs,
                                        SchedulerCarry, map_tensors,
                                        map_tree, stack_tree, zip_tree)
from repro_torch.core.streaming import (StreamConfig, cast_sched_state,
                                        promote_sched_state,
                                        sched_round_step, sched_state0,
                                        validate_stream_config)
from repro_torch.data.synthetic import pad_client_shards

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ClientShards:
    """Padded client shards: every entry of `data` is `[C, n_max, ...]`;
    `n_samples [C]` holds the true per-client counts used for minibatch
    index draws and aggregation weights."""
    data: Dict[str, torch.Tensor]
    n_samples: torch.Tensor

    @property
    def n_clients(self) -> int:
        return self.n_samples.shape[0]

    @property
    def n_max(self) -> int:
        return next(iter(self.data.values())).shape[1]

    @staticmethod
    def from_ragged(client_data, device=None) -> "ClientShards":
        """Pad a list of per-client dicts of arrays or tensors onto
        `device`: CUDA unless the caller names another."""
        data, n = pad_client_shards(client_data, device)
        return ClientShards(data=data, n_samples=n)

    def to(self, device) -> "ClientShards":
        return map_tensors(lambda x: x.to(device), self)


class FusedResult(NamedTuple):
    """One fused rollout segment's results.

      params     global model, leading [B] cell axis
      opt_state  optimizer state, leading [B] cell axis (None for SGD)
      outputs    RoundOutputs stacked [R, B, ...]
      loss       [R, B] weighted mean local training loss per round
      fleet      final FleetState (None in fresh-fleet mode)
      carry      the last active round's queue state [B, S]/[B, U]
      metric     [R, B] in-loop eval values (NaN on rounds without
                 eval), or None without `eval_fn`
    """
    params: Any
    opt_state: Any
    outputs: RoundOutputs
    loss: torch.Tensor
    fleet: Optional[FleetState]
    carry: SchedulerCarry
    metric: Optional[torch.Tensor] = None


def replicate(tree, batch: int):
    """Broadcast a dict of tensors (or tuple/None) to a leading [B] cell
    axis, as copies."""
    return map_tree(lambda x: x[None].repeat((batch,) + (1,) * x.ndim),
                    tree)


def client_grads(loss_fn: Callable, params: Params, batches) -> Params:
    """Every client's gradient of `loss_fn(params, batch)` at the same
    `params`, for a stack of minibatches with a leading [S] client axis
    (the reference's `vmap(grad(loss_fn), in_axes=(None, 0))`)."""
    return torch.func.vmap(torch.func.grad(loss_fn),
                           in_dims=(None, 0))(params, batches)


def fedavg_grads(grads_stack: Params, mask: torch.Tensor,
                 weights: torch.Tensor, clip: float = 5.0):
    """Mask-weighted FedSGD gradient average (eq. 11 on gradients).

    mask [S] success indicators; weights [S] true sample counts. Returns
    (avg, scale): the weighted average gradient and the scalar
    `ok * clip_factor` to fold into the update (ok = 0 when every upload
    failed, keeping the previous global model). Clients with zero weight
    are hard-zeroed before the average so NaN gradients (e.g. from an
    empty client) cannot poison the update.
    """
    w = mask * weights
    den = torch.clamp_min(w.sum(), 1e-9)

    def _avg(g):
        wb = w.reshape(w.shape + (1,) * (g.ndim - 1))
        return torch.einsum("s,s...->...", w,
                            torch.where(wb > 0, g, 0.0)) / den

    avg = {k: _avg(g) for k, g in grads_stack.items()}
    gn = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                        for g in avg.values()))
    c = torch.clamp_max(clip / (gn + 1e-9), 1.0)
    ok = (w.sum() > 0).to(torch.float32)
    return avg, ok * c


def fedavg_apply(params: Params, grads_stack: Params, mask: torch.Tensor,
                 weights: torch.Tensor, *, lr: float, clip: float = 5.0,
                 opt=None, opt_state=None, step=0):
    """One aggregated global update from a stack of per-client grads.

    With `opt=None` this is the plain SGD rule of the blocked simulator;
    with an `(init, update)` pair from `repro_torch.optim` the clipped
    weighted-average gradient goes through `update` instead. Returns
    (new_params, new_opt_state)."""
    avg, scale = fedavg_grads(grads_stack, mask, weights, clip=clip)
    gsc = {k: scale * g for k, g in avg.items()}
    if opt is None:
        return {k: p - lr * gsc[k] for k, p in params.items()}, opt_state
    return opt[1](params, gsc, opt_state, step)


def minibatch_indices(u: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Uniform draws `u [..., batch]` -> sample indices against the true
    per-client counts `n [...]`: the fp32 product truncated, as the
    reference computes it (empty clients pin to row 0, which their zero
    aggregation weight then discards)."""
    nf = n.to(torch.float32)[..., None]
    idx = (u * nf).to(torch.int64)
    return torch.minimum(idx, torch.clamp_min(n[..., None].to(torch.int64)
                                              - 1, 0))


def _cast_opt_state(os_, dtype):
    """Demote an optimizer state's floating entries to `dtype` for
    storage between rounds; integer entries pass through. A None dtype
    is a no-op."""
    if dtype is None:
        return os_
    return map_tree(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    os_)


def _promote_opt_state(os_, dtype=torch.float32):
    """Inverse of `_cast_opt_state`: floating entries back to fp32 so the
    optimizer update runs in full precision."""
    return _cast_opt_state(os_, dtype)


def local_grads(params: Params, loss_fn: Callable, shards: ClientShards,
                sel: torch.Tensor, u: torch.Tensor):
    """Gather each selected client's minibatch from the padded layout and
    take every client's loss and gradient (eq. 2, one local step, over
    the [S] selected clients at once). sel [S] client ids; u [S, batch]
    uniforms. Returns (losses [S], grads with leading [S], weights [S])."""
    n = shards.n_samples[sel]                                # [S]
    idx = minibatch_indices(u, n)                            # [S, bs]
    mb = {k: a[sel[:, None], idx] for k, a in shards.data.items()}
    grads, losses = torch.func.vmap(torch.func.grad_and_value(loss_fn),
                                    in_dims=(None, 0))(params, mb)
    return losses, grads, n.to(torch.float32)


def init_carry(key, sc: ScenarioParams, mob: ManhattanParams,
               cfg: StreamConfig, params: Params, *, opt=None,
               fleet: Optional[FleetState] = None,
               ch: Optional[ChannelParams] = None,
               device=None) -> RolloutCarry:
    """Initial fused-rollout carry: the scheduling state (per `cfg`; `key`
    as for `sched_state0`) and the model replicated over the [B] cell
    axis on `device` (with the optimizer state where an `(init, update)`
    pair is given). Pass the rollout's `ch` so the P4 warm-start table
    seeds at its `p_max`."""
    B = int(cfg.batch)
    sched = sched_state0(key, sc, mob, cfg, fleet, ch, device)
    dev = (sched.pos if isinstance(sched, FleetState) else sched.qs).device
    params = {k: v.detach().to(dev) for k, v in params.items()}
    opt_state = None if opt is None else replicate(opt[0](params), B)
    return RolloutCarry(sched=sched, params=replicate(params, B),
                        opt_state=opt_state)


def _host_bool(x, shape) -> np.ndarray:
    """A mask given as a tensor, array or sequence (None: all True), on
    the host: the loop's control flow reads it there."""
    if x is None:
        return np.ones(shape, bool)
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x,
                      bool)


def fused_rollout(keys: Sequence, sel: torch.Tensor, mb_u: torch.Tensor,
                  sched, sc: ScenarioParams, mob: ManhattanParams,
                  ch: ChannelParams, prm: VedsParams, cfg: StreamConfig,
                  loss_fn: Callable, shards: ClientShards,
                  carry: RolloutCarry, *, lr: float = 0.05,
                  clip: float = 5.0, opt=None, steps=None, active=None,
                  eval_fn: Optional[Callable] = None, eval_mask=None,
                  unroll: int = 1, history_chunk: int = 1,
                  state_dtype=None, stage_hook=None) -> FusedResult:
    """A (segment of a) training run as one loop: scheduling + minibatch
    gather + local SGD + aggregation per round.

      keys  [R] | [R][B]   per-round scheduling keys (`round_keys`, or
                           the rounds' draws), or per round a sequence
                           of B per-cell keys (the serving layer's
                           packed sessions; persistent fleets only, and
                           not with `cfg.handoff`)
      sel   [R, B, S]      client id of each cell's SOV slot per round
      mb_u  [R, B, S, bs]  uniform minibatch draws
      carry                `init_carry(...)` or a previous segment's
      steps [R]            absolute round indices (optimizer schedules);
                           defaults to 0 .. R-1
      active [R] | [R, B]  no-op mask: an inactive round (or cell) runs
                           and is then discarded, so the carry passes
                           through it untouched, bit for bit. `run_fl`
                           pads its eval segments to one length with
                           inactive tail rounds. Per-cell masks cannot
                           compose with `cfg.handoff`. Outputs and
                           losses of inactive rounds are garbage.
      eval_fn              per-cell eval `params -> scalar`, run inside
                           the loop on the post-aggregation params of the
                           rounds flagged by `eval_mask` (ANDed with
                           `active`); `FusedResult.metric [R, B]` holds
                           NaN on the other rounds.
      unroll               the reference's XLA lever (rounds unrolled per
                           scan step); in a Python loop it changes
                           nothing and is accepted for the same calls.
      history_chunk        with k > 1 the per-round history is written
                           k rounds at a time into preallocated [R, ...]
                           buffers; bit for bit the same. R must divide
                           by k.
      state_dtype          storage dtype (e.g. torch.bfloat16) of the
                           carry state between rounds that tolerates it:
                           the fleet's P4 table and the optimizer
                           accumulators. Params, queues, batteries and
                           the world fields stay fp32, every round
                           computes in fp32, and results come back
                           promoted.
      stage_hook           called with "scenario", "schedule", "train" and
                           "eval" after each stage of every round (a
                           caller may time them; "eval" also where the
                           round runs no eval).

    Resumable: feed `FusedResult`'s (fleet or carry, params, opt_state)
    back as the next segment's carry with the next rounds' keys, sel and
    mb_u; a segmented rollout replays the one-loop run exactly.
    """
    validate_stream_config(cfg, threads_params=True)
    hook = stage_hook or (lambda name: None)
    keys = list(keys)
    R, B = len(keys), int(cfg.batch)
    steps = list(range(R)) if steps is None else [int(s) for s in steps]
    act = _host_bool(active, (R,))
    if act.ndim == 2 and cfg.handoff:
        raise ValueError("per-cell active masks [R, B] cannot compose "
                         "with handoff: the cross-cell exchange moves "
                         "vehicles between cells, which an inactive "
                         "cell's carry pass-through cannot revert")
    if cfg.handoff and any(per_cell(k) for k in keys):
        raise ValueError("per-cell keys [R][B] cannot compose with "
                         "handoff: the cross-cell exchange moves vehicles "
                         "between the cells that own them")
    ev = np.zeros(R, bool) if eval_mask is None else _host_bool(eval_mask,
                                                                (R,))
    K = int(history_chunk)
    if 1 < K < R and R % K:
        raise ValueError(f"segment length {R} not divisible by "
                         f"history_chunk={K}")

    def train_cell(p, os_, sel_c, u_c, mask_c, step):
        losses, grads, nf = local_grads(p, loss_fn, shards, sel_c, u_c)
        new_p, new_os = fedavg_apply(p, grads, mask_c, nf, lr=lr,
                                     clip=clip, opt=opt, opt_state=os_,
                                     step=step)
        w = mask_c * nf
        den = torch.clamp_min(w.sum(), 1e-9)
        loss = torch.sum(torch.where(w > 0, losses * w, 0.0)) / den
        return new_p, new_os, loss

    c = carry
    if state_dtype is not None:
        c = RolloutCarry(sched=cast_sched_state(c.sched, state_dtype),
                         params=c.params,
                         opt_state=_cast_opt_state(c.opt_state, state_dtype))
    bufs, block = None, []

    def emit(r, ys):
        # history: one round at a time, or k-round blocks, written into
        # the preallocated [R, ...] buffers
        nonlocal bufs
        if bufs is None:
            bufs = map_tree(lambda x: x.new_empty((R,) + tuple(x.shape)), ys)
        block.append(ys)
        if len(block) == max(K, 1) or r == R - 1:
            r0 = r + 1 - len(block)
            zip_tree(lambda b, y: b[r0:r0 + len(block)].copy_(y), bufs,
                     stack_tree(block))
            block.clear()

    for r in range(R):
        st_in = promote_sched_state(c.sched) if state_dtype else c.sched
        os_in = (_promote_opt_state(c.opt_state) if state_dtype
                 else c.opt_state)
        st, out = sched_round_step(st_in, keys[r], sched, sc, mob, ch, prm,
                                   cfg, stage_hook)
        mask = out.success.to(torch.float32)                 # [B, S]
        cells = [train_cell({k: v[b] for k, v in c.params.items()},
                            map_tree(lambda x, b=b: x[b], os_in),
                            sel[r, b], mb_u[r, b], mask[b], steps[r])
                 for b in range(B)]
        new_c = RolloutCarry(
            sched=cast_sched_state(st, state_dtype),
            params=stack_tree([x[0] for x in cells]),
            opt_state=_cast_opt_state(
                None if os_in is None else stack_tree(
                    [x[1] for x in cells]), state_dtype))
        loss = torch.stack([x[2] for x in cells])
        hook("train")
        a = act[r]
        if a.ndim == 0:
            if a:
                c = new_c
        else:
            # per-cell mask: only the inactive cells pass through
            keep = torch.as_tensor(a, device=loss.device)
            c = zip_tree(lambda n, o: torch.where(
                keep.reshape(keep.shape + (1,) * (n.ndim - 1)), n, o),
                new_c, c)
        ys = (out, loss)
        if eval_fn is not None:
            if ev[r] and a.any():
                met = torch.stack([torch.as_tensor(
                    eval_fn({k: v[b] for k, v in c.params.items()}),
                    dtype=torch.float32) for b in range(B)]).to(loss.device)
            else:
                met = torch.full((B,), float("nan"), device=loss.device)
            if a.ndim:
                met = torch.where(torch.as_tensor(a, device=met.device),
                                  met, float("nan"))
            ys = ys + (met,)
        hook("eval")
        emit(r, ys)

    if state_dtype is not None:
        c = RolloutCarry(sched=promote_sched_state(c.sched),
                         params=c.params,
                         opt_state=_promote_opt_state(c.opt_state))
    outs, losses = bufs[0], bufs[1]
    metric = bufs[2] if eval_fn is not None else None
    fleet = None if cfg.fresh_fleet else c.sched
    # `.carry` reports the last ACTIVE round's queues: a padded segment's
    # trailing rounds are no-ops whose outputs are junk
    if act.ndim == 2:
        last = torch.as_tensor(np.max(np.where(act, np.arange(R)[:, None],
                                               -1), 0))
        cell = torch.arange(B)
        carry_out = map_tensors(
            lambda x: x[last.to(x.device), cell.to(x.device)], outs.carry)
    else:
        last = int(np.max(np.where(act, np.arange(R), -1)))
        carry_out = map_tensors(lambda x: x[last], outs.carry)
    return FusedResult(params=c.params, opt_state=c.opt_state,
                       outputs=outs, loss=losses, fleet=fleet,
                       carry=carry_out, metric=metric)


def fused_segment(loss_fn: Callable, sched_name: str, sc, mob, ch, prm,
                  cfg: StreamConfig, lr: float, unroll: int,
                  eval_fn: Optional[Callable] = None,
                  history_chunk: int = 1):
    """A fused-rollout segment for these settings: `fused_rollout` with
    them bound. (The reference caches its jitted segments; a Python loop
    has no compiled program to keep, so nothing is cached here.) Callers
    normalise `cfg.n_rounds` to 0: the segment's length comes from its
    `keys` argument. `eval_fn` joins the key; the rounds it runs on
    arrive as the `ev` argument, and a `stage_hook` as a keyword."""
    from repro_torch.core.baselines import get_scheduler
    sched = get_scheduler(sched_name)

    def seg(carry, keys, sel, mb_u, shards, steps, active, ev,
            stage_hook=None):
        return fused_rollout(keys, sel, mb_u, sched, sc, mob, ch, prm,
                             cfg, loss_fn, shards, carry, lr=lr,
                             steps=steps, active=active, eval_fn=eval_fn,
                             eval_mask=ev, unroll=unroll,
                             history_chunk=history_chunk,
                             stage_hook=stage_hook)

    return seg
