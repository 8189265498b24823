"""The rollouts that `test_torch_mesh_exec.py` runs on every rank of a
spawned gloo world, and the same rollouts on one process (N = 1); and
the VFL rounds of `test_torch_vfl_mesh.py` on every rank.

This module imports torch and the port only (the ranks are spawned
processes and import no jax). The inputs, made by the test from its
fixture, are one dict saved with `torch.save`: the problem (`params`,
the clients' ragged data), the loop xs `sel` [R, B, S] and `mb_u`
[R, B, S, bs], and for the runs on the reference's draws the fleet's
draws `ref_fleet` and the rounds' draws `ref_rounds` [R]. Every case
returns the whole run's result (`gather_result` on the mesh).
"""
import dataclasses

import torch

from repro_torch.channel.mobility import ManhattanParams
from repro_torch.channel.v2x import ChannelParams
from repro_torch.core import scenario as scn
from repro_torch.core.baselines import get_scheduler
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.streaming import StreamConfig, round_keys, stream_rounds
from repro_torch.fl.engine import ClientShards, fused_rollout, init_carry
from repro_torch.sharding import mesh_exec

# `tests/test_mesh_exec.py`'s setting
MOB = ManhattanParams(v_max=10.0)
CH = ChannelParams()
PRM = VedsParams(alpha=2.0, V=0.2, Q=1e7, slot=0.1)
SC = scn.ScenarioParams(n_sov=4, n_opv=3, n_slots=10)
R, B, SEED, LR = 4, 8, 0, 0.1
CFG = StreamConfig(n_rounds=R, batch=B, fresh_fleet=False,
                   carry_queues=True, handoff=True)
# the cases every world runs: (rollout, scheduler, draws)
CASES = (("fused", "madca", "port"), ("fused", "veds", "port"),
         ("stream", "madca", "port"), ("fused", "madca", "ref"),
         ("fused", "veds", "ref"), ("stream", "madca", "ref"))


def loss_fn(p, b):
    logp = torch.log_softmax(b["x"] @ p["w"], -1)
    return -torch.gather(logp, -1, b["y"][:, None]).mean()


def _fleet(inp):
    return scn.init_fleet(inp["ref_fleet"], SC, MOB, B,
                          rsu_xy=scn.rsu_grid(B, MOB, device="cpu"))


def _setup(inp, draws, device="cpu"):
    """(round keys, initial carry) of a run on the port's draws (seed
    SEED) or on the reference's."""
    params = {k: v.to(device) for k, v in inp["params"].items()}
    if draws == "port":
        return (round_keys(SEED, CFG, R),
                init_carry(SEED, SC, MOB, CFG, params, ch=CH, device=device))
    return (inp["ref_rounds"],
            init_carry(SEED, SC, MOB, CFG, params, fleet=_fleet(inp), ch=CH,
                       device=device))


def run_one(inp, case, mesh=None, device="cpu", **kw):
    """One case on one process (`mesh` None: the port's one-device loops)
    or on this rank's block of the mesh, gathered, on `device` (the
    mesh's: the CPU under gloo, the card under NCCL)."""
    kind, name, draws = case
    sched = get_scheduler(name)
    keys, carry = _setup(inp, draws, device)
    if kind == "stream":
        fleet = carry.sched
        if mesh is None:
            return stream_rounds(SEED, sched, SC, MOB, CH, PRM, CFG, fleet,
                                 keys=keys, device=device)
        return mesh_exec.gather_result(mesh, mesh_exec.mesh_stream_rounds(
            mesh, SEED, sched, SC, MOB, CH, PRM, CFG, fleet, keys=keys))
    shards = ClientShards.from_ragged(inp["data"], device)
    sel, mb_u = inp["sel"].to(device), inp["mb_u"].to(device)
    if mesh is None:
        return fused_rollout(keys, sel, mb_u, sched, SC, MOB, CH, PRM, CFG,
                             loss_fn, shards, carry, lr=LR, **kw)
    return mesh_exec.gather_result(mesh, mesh_exec.mesh_fused_rollout(
        mesh, keys, sel, mb_u, sched, SC, MOB, CH, PRM, CFG, loss_fn,
        shards, carry, lr=LR, **kw))


def rank_main(rank: int, inputs_path: str, out_path: str) -> None:
    """Every case on this rank's block of a 1-D mesh over the world, the
    bf16-state run and two cases on a (2, 2) ("data", "model") mesh on
    worlds of 4, and the uneven batch's error; rank 0 saves the gathered
    results to `out_path`."""
    from repro_torch.launch.mesh import make_host_mesh
    inp = torch.load(inputs_path, weights_only=False)
    mesh = mesh_exec.fleet_mesh()
    out = {case: run_one(inp, case, mesh) for case in CASES}
    if mesh_exec.num_vehicles(mesh) == 4:
        out["bf16"] = run_one(inp, CASES[0], mesh,
                              state_dtype=torch.bfloat16)
        grid = make_host_mesh(2)
        for case in (CASES[0], CASES[2]):
            out[("2x2",) + case] = run_one(inp, case, grid)
    try:
        uneven = dataclasses.replace(CFG, batch=mesh.size() + 1)
        mesh_exec.mesh_stream_rounds(mesh, SEED, get_scheduler("madca"), SC,
                                     MOB, CH, PRM, uneven)
        out["uneven"] = None
    except ValueError as e:
        out["uneven"] = str(e)
    if rank == 0:
        torch.save(out, out_path)


def vfl_rank_main(rank: int, inputs_path: str, out_path: str) -> None:
    """The VFL round over a ("data", "model") mesh of (V, 1): this rank
    trains vehicle `rank` and aggregates with the others, for every
    (mask, weights) of the inputs, then the whole-run step
    (`make_train_step(stream=...)`); every rank saves its results to
    `out_path` formatted with its rank."""
    from repro_torch.fl.vfl import make_train_step, make_vfl_round
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.module import tree_map
    inp = torch.load(inputs_path, weights_only=False)
    mesh = make_host_mesh(1)
    round_fn = make_vfl_round(inp["cfg"], mesh, "head", lr=inp["lr"])
    mine = tree_map(lambda x: x[None], inp["params"])
    batch = {k: v[rank:rank + 1] for k, v in inp["batch_v"].items()}
    out = [round_fn(mine, batch, m, w) for m, w in inp["cases"]]
    st = inp["stream"]
    run = make_train_step(inp["cfg"], mesh, "head", lr=inp["lr"], **st["kw"])
    out.append(run(mine, {k: v[:, rank:rank + 1]
                          for k, v in st["batches_v"].items()},
                   torch.ones(inp["cfg"].num_vehicles), st["seed"]))
    torch.save(out, out_path.format(rank=rank))
