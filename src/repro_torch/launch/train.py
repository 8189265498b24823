"""End-to-end VFL training driver on one device.

Port of `repro/launch/train.py`: trains a reduced variant (the smoke
config) of an architecture with the full paper pipeline, Manhattan
mobility -> 3GPP channels -> scheduling (`--scheduler`: VEDS or any of
the Section VI benchmarks) -> local SGD -> masked aggregation, on
synthetic LM data. Runs on CUDA unless `--device cpu`:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
      --rounds 2 --vehicles 4 --batch-per-vehicle 2 --seq 64

`--arch` takes every registered id whose model trains on token batches
alone: qwen3-32b, zamba2-2.7b, xlstm-1.3b, granite-moe-1b-a400m,
llama4-scout-17b-a16e, starcoder2-15b, codeqwen1.5-7b and minitron-4b.
whisper-small and llama-3.2-vision-90b attend to a `src` batch entry
(frame or patch embeddings) that the driver's LM batches do not carry,
as the reference's do not; they are refused up front. `train` is the
loop itself, for any `ModelConfig`; its `batch_fn` may add `src`
(`chip_smoke.py` drives it at qwen3-32b's full width and at
zamba2-2.7b's, granite-moe-1b-a400m's, xlstm-1.3b's and
whisper-small's full width and depth).

`--devices N` follows the reference's mesh (V, max(1, N // V)) of
("data", "model"): N = 1 is one process holding every vehicle (the
aggregation is the `fedavg_agg` kernel on the card); N = V M runs a
world of N ranks, spawned here (one card a rank, or with `--device cpu`
one gloo process a rank) or joined under `torchrun`: each vehicle's
model split over M ranks (`attention_tp_mode(H, M)`: head-parallel
attention where M divides the heads, else row-parallel), aggregated with
all-reduces over the vehicle axis (`fl/vfl.py`). Rank 0 prints the round
lines. Any other N raises, as does a model axis that does not divide a
dim the model splits over it (`engine.check_model_axis`), before any
rank starts; on CUDA so does an N above the card count. `--ckpt PATH`
saves vehicle 0's params after the last round, gathered whole
(`checkpoint/np_ckpt.py`, the reference's npz layout):

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --devices 2 --vehicles 2 --rounds 2 --batch-per-vehicle 2 \
      --seq 64 --ckpt /tmp/qwen3.npz
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
      --arch zamba2-2.7b --devices 4 --vehicles 2 --rounds 2 \
      --batch-per-vehicle 2 --seq 64
"""
from __future__ import annotations

import argparse
import functools
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.channel.mobility import ManhattanParams
from repro_torch.channel.v2x import ChannelParams
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.baselines import get_scheduler
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scenario import (ScenarioParams, make_round,
                                       round_generator)
from repro_torch.data.synthetic import lm_batch
from repro_torch.fl.vfl import lm_loss, make_train_step, vehicle_axes
from repro_torch.launch.mesh import (init_world, make_host_mesh, run_world,
                                     under_torchrun)
from repro_torch.models import engine
from repro_torch.models.module import materialize, param_bytes, tree_map
from repro_torch.sharding.model_axis import (gather_params, model_axis,
                                             shard_params)
from repro_torch.sharding.policy import attention_tp_mode
from repro_torch.sharding.mesh_exec import world_device
from repro_torch.sharding.rules import default_rules, shard_tree

EVAL_STREAM = 999


def _generator(seed: int, stream: int, r: int, device) -> torch.Generator:
    """The generator of draw stream `stream` in round `r` (data batches;
    the scenario uses `round_generator(seed, r)`)."""
    state = np.random.SeedSequence([int(seed), int(stream), int(r)]) \
        .generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def train(cfg: ModelConfig, *, rounds: int, batch_per_vehicle: int,
          seq: int, lr: float, scheduler: str = "veds", seed: int = 0,
          device=None, log: Callable[[str], None] = print,
          stage_hook: Optional[Callable[[str], None]] = None,
          on_round: Optional[Callable[[dict], None]] = None,
          batch_fn: Optional[Callable[..., Dict[str, torch.Tensor]]] = None,
          mesh=None, ckpt: Optional[str] = None) -> List[dict]:
    """`rounds` VFL rounds of `cfg` over `cfg.num_vehicles` vehicles:
    per round a scenario, the scheduler's success mask, local SGD and
    the masked aggregation, then the loss of vehicle 0's (aggregated)
    model on a fixed eval batch. Returns one record per round.

    `batch_fn(gen, b, seq, vocab)` makes every batch (default
    `lm_batch`); a model that needs `src` needs a `batch_fn` that adds
    it. `stage_hook(name)` is called after "setup", and in every round
    after "scenario", "schedule", "local_sgd", "aggregate" and "eval";
    `on_round(record)` after every round.

    Over a mesh whose vehicle axes hold the V vehicles (`mesh`, this
    rank's world; `fl.vfl.vehicle_axes`) this rank trains its vehicle:
    every rank draws the same scenario, schedule and batches, and keeps
    its vehicle's block, and over a model axis its block of that
    vehicle's model (`sharding.model_axis.shard_params`). `ckpt` saves
    vehicle 0's params after the last round (gathered whole, from rank
    0)."""
    if batch_fn is None:
        if cfg.family in ("vlm", "audio"):
            raise NotImplementedError(
                f"{cfg.name}: its cross-attention needs a src batch entry "
                f"[b, {cfg.num_src_tokens}, {cfg.src_dim}] and the driver's "
                f"LM batches carry none, as the reference's launch/train.py "
                f"builds none; run it through fl/vfl.py with a src batch")
        batch_fn = lm_batch
    device = resolve_device(device)
    V = cfg.num_vehicles
    ax = model_axis(mesh)
    tp = attention_tp_mode(cfg.num_heads, ax.size)
    sched = get_scheduler(scheduler)
    if vehicle_axes(mesh, V):
        rules = default_rules()

        def vehicles(tree):          # this rank's vehicle of [V, ...]
            return tree_map(lambda x: shard_tree(mesh, rules.spec(
                ("vehicle",) + (None,) * (x.ndim - 1)), x), tree)
    else:
        def vehicles(tree):
            return tree

    decl = engine.model_decl(cfg, tp)
    params = materialize(torch.Generator(device=device).manual_seed(seed),
                         decl)
    if ax.size > 1:
        params = shard_params(mesh, params, decl)
    params_v = vehicles(tree_map(
        lambda x: x.unsqueeze(0).expand(V, *x.shape), params))
    del params
    hook = stage_hook or (lambda name: None)
    q_bits = 8.0 * param_bytes(decl)
    log(f"arch={cfg.name}: {param_bytes(decl)/1e6:.1f} MB params -> "
        f"Q={q_bits:.3g} bits, {V} vehicles, tp={tp}, device={device}")

    mob, ch = ManhattanParams(), ChannelParams()
    prm = VedsParams(Q=min(q_bits, 2e7), slot=0.1)
    sc = ScenarioParams(n_sov=V, n_opv=8, n_slots=50)
    step = make_train_step(cfg, mesh, tp, lr=lr, inline_scheduler=True,
                           veds_prm=prm, ch_prm=ch, sched=sched,
                           stage_hook=stage_hook)
    weights = torch.ones((V,), device=device)
    eval_batch = batch_fn(_generator(seed, EVAL_STREAM, 0, device), 8, seq,
                          cfg.vocab_size)
    hook("setup")
    history = []
    for r in range(rounds):
        t0 = time.perf_counter()
        rnd = make_round(round_generator(seed, r, device), sc, mob, ch, prm)
        batch = batch_fn(_generator(seed, 1, r, device),
                         V * batch_per_vehicle, seq, cfg.vocab_size)
        batch_v = vehicles({k: x.reshape(V, batch_per_vehicle, *x.shape[1:])
                            for k, x in batch.items()})
        hook("scenario")
        params_v, stats = step(params_v, batch_v, rnd, weights)
        with torch.no_grad():
            loss = float(lm_loss(tree_map(lambda x: x[0], params_v),
                                 eval_batch, cfg, tp, mesh=ax))
        hook("eval")
        wall = time.perf_counter() - t0
        rec = dict(round=r, n_success=int(stats["n_success"]),
                   mask=[int(m) for m in stats["mask"].tolist()],
                   loss=loss, wall_s=wall)
        history.append(rec)
        log(f"round {r:3d} succ={int(stats['mask'].sum())}/{V} "
            f"loss={loss:.4f}  ({wall:.1f}s)")
        if on_round is not None:
            on_round(rec)
    if ckpt:
        last = gather_params(ax, tree_map(lambda x: x[0], params_v), decl)
        if mesh is None or torch.distributed.get_rank() == 0:
            save_checkpoint(ckpt, last, meta={"arch": cfg.name},
                            step=rounds)
            log(f"saved {ckpt}")
    return history


def _train_rank(rank: int, cfg: ModelConfig, model_par: int,
                kw: dict) -> None:
    """One rank of `--devices N`: a ("data", "model") mesh of (N / M, M)
    over the world, this rank's block of its vehicle trained; rank 0
    logs and saves."""
    log = functools.partial(print, flush=True) if rank == 0 \
        else (lambda s: None)
    train(cfg, mesh=make_host_mesh(model_par), device=world_device(),
          log=log, **kw)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-32b")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--devices", type=int, default=1)
    ap.add_argument("--vehicles", type=int, default=4)
    ap.add_argument("--batch-per-vehicle", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--scheduler", default="veds",
                    choices=["veds", "optimal", "v2i_only", "madca", "sa"])
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' on request)")
    args = ap.parse_args(argv)
    N, V = args.devices, args.vehicles
    model_par = max(1, N // V)
    if N not in (1, V * model_par):
        raise ValueError(f"--devices {N}: 1, or one a vehicle (--vehicles "
                         f"{V}), or a multiple of it (a model axis)")
    cfg = get_smoke_config(args.arch).replace(num_vehicles=V, grad_accum=1)
    if N > 1:
        engine.check_model_axis(cfg, attention_tp_mode(cfg.num_heads,
                                                       model_par), model_par)
    kw = dict(rounds=args.rounds, batch_per_vehicle=args.batch_per_vehicle,
              seq=args.seq, lr=args.lr, scheduler=args.scheduler,
              seed=args.seed, ckpt=args.ckpt or None)
    device = resolve_device(args.device)
    if N == 1:
        train(cfg, device=device, **kw)
    elif under_torchrun():
        world = int(os.environ["WORLD_SIZE"])
        if world != N:
            raise ValueError(f"--devices {N} in a torchrun world of {world}")
        rank = int(os.environ["RANK"])
        init_world(rank, N, None, device.type)
        try:
            _train_rank(rank, cfg, model_par, kw)
        finally:
            torch.distributed.destroy_process_group()
    else:
        # CPU ranks share the host's cores
        threads = (max(1, len(os.sched_getaffinity(0)) // N)
                   if device.type == "cpu" else 0)
        run_world(_train_rank, N, cfg, model_par, kw, device=device.type,
                  threads=threads)
    return 0


if __name__ == "__main__":
    sys.exit(main())
