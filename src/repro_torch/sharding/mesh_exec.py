"""Mesh execution of the fused rollout and the streaming engine.

Port of `repro/sharding/mesh_exec.py` over `torch.distributed`. The
reference commits every carry and xs leaf under the `NamedSharding` its
logical axes dictate and lets GSPMD place the work; here each rank
holds its block of the cell axis as plain local tensors (`place_*`, by
`rules.shard_tree`) and runs the one-device loops (`fused_rollout`,
`stream_rounds`) on its B / N cells. The loops couple cells in two
places only, and the collectives stand there:

- the round's draws: every rank draws the whole batch from the round
  key and keeps its rows (`block_keys`), so each cell gets the numbers
  one device gives it;
- the cross-cell exchange of handoff: `allgather_exchange` all-gathers
  the fleet, runs the one-device `exchange_fleet` on it (every rank
  computes the same permutation, bit for bit that of one device) and
  keeps its rows.

Axis placement (a 1-D "data" mesh):

  leaf                      layout           block
  FleetState.*              [B, N, ...]      rows of the cell axis
  FleetState.rsu_xy         [B, 2]           rows of the cell axis (the
                                             reference replicates it;
                                             here the exchange, which
                                             scores every RSU, gathers
                                             it with the fleet)
  SchedulerCarry.qs/qu/p4   [B, S|U, ...]    rows of the cell axis
  params / opt_state        [B, ...]         rows of the cell axis
  sel / mb_u                [R, B, ...]      rows of dim 1
  ClientShards.*            [C, n_max, ...]  whole (the minibatch gather
                                             indexes any client from
                                             any cell)

The collectives run through the group at every world size, one rank
included: nothing takes a shortcut around them. `gather_result`
all-gathers a run's result so that every rank returns what one device
returns. `cfg.batch` must split evenly over the data axes; that is
checked up front with the reference's message. On a ("data",
"model") mesh the rollout's collectives run over the data group of this
rank's model coordinate: the ranks of one data group hold the cells
between them, and each model coordinate holds them all again (the
rollout has no parameter split over the model axis).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.core.scenario import (FleetState, exchange_fleet,
                                       fleet_round_draws, per_cell,
                                       round_batch_draws)
from repro_torch.core.scheduler import RolloutCarry, map_tree
from repro_torch.core.streaming import (StreamConfig, StreamResult,
                                        round_keys, sched_state0,
                                        stream_rounds, validate_stream_config)
from repro_torch.fl.engine import ClientShards, FusedResult, fused_rollout
from repro_torch.sharding.rules import (LogicalRules, data_axis_names,
                                        default_rules, fleet_spec,
                                        fused_batch_spec, mesh_shape,
                                        num_vehicles, shard_tree)


# card 0 while this process is a rank of a shared-card world
# (`launch/mesh.py init_world(shared_card=True)`), else None
SHARED_CARD: Optional[torch.device] = None


def world_device() -> torch.device:
    """This rank's device in the initialized world: its card under NCCL,
    card 0 in a shared-card world, the CPU in another gloo world."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return SHARED_CARD if SHARED_CARD is not None else torch.device("cpu")


def fleet_mesh(n_devices: Optional[int] = None, axis: str = "data"):
    """1-D `DeviceMesh` over the cell/batch axis of the initialized world
    (`launch.mesh.init_world`), the only axis the rollout shards:
    vehicles inside a cell couple through the per-slot argmax, so the
    pool axis stays local (`rules.fleet_spec`). `n_devices` must be the
    world's size."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("no process group: start one with "
                           "repro_torch.launch.mesh.init_world")
    n = dist.get_world_size()
    if n_devices is not None and int(n_devices) != n:
        raise ValueError(f"asked for {int(n_devices)} devices, the world "
                         f"has {n} ranks")
    return init_device_mesh(world_device().type, (n,),
                            mesh_dim_names=(axis,))


def _data_group(mesh):
    """(process group, this rank's coordinate, size) of the data axes:
    on a 1-D mesh or a ("data", "model") one, the group of the ranks
    that share this rank's other coordinates."""
    shape = mesh_shape(mesh)
    names = data_axis_names(mesh)
    if len(names) == 1:
        return (mesh.get_group(names[0]), mesh.get_local_rank(names[0]),
                shape[names[0]])
    other = {a: s for a, s in shape.items() if a not in names and s > 1}
    if other:
        raise NotImplementedError(
            f"mesh axes {other} beside the data axes {names}: the rollout "
            f"takes one data axis beside a model axis")
    # several data axes ("pod", "data") and no other axis of more than one
    # rank: their product is the whole world, first axis major
    return dist.group.WORLD, dist.get_rank(), num_vehicles(mesh)


def check_batch_divisible(mesh, batch: int) -> None:
    n = num_vehicles(mesh)
    if int(batch) % n:
        raise ValueError(
            f"batch={int(batch)} cells cannot shard evenly over the "
            f"{n}-device data axes {data_axis_names(mesh)} of the mesh "
            "(NamedSharding rejects uneven shards); pick batch as a "
            "multiple of the device count")


def cell_spec(rules: LogicalRules, ndim: int):
    """Spec for a leading-[B] leaf (params/opt_state/queue carries)."""
    return (rules.mesh_axis("cell"), *([None] * max(ndim - 1, 0)))


def _map_specs(mesh, tree, spec_of):
    return map_tree(lambda x: shard_tree(mesh, spec_of(x.ndim), x), tree)


def place_fleet(mesh, fleet: FleetState,
                rules: Optional[LogicalRules] = None) -> FleetState:
    """This rank's block of a FleetState under `fleet_spec`, `rsu_xy`
    [B, 2] included: the exchange's distance matrix, which reads every
    RSU, is made on the fleet `allgather_exchange` gathers."""
    rules = rules or default_rules()
    return _map_specs(mesh, fleet, lambda nd: fleet_spec(rules, nd))


def place_carry(mesh, carry: RolloutCarry,
                rules: Optional[LogicalRules] = None) -> RolloutCarry:
    """This rank's block of a fused-rollout carry: the FleetState under
    `fleet_spec` (queue carries, params and optimizer state under the
    cell spec)."""
    rules = rules or default_rules()

    def put_cell(t):
        return _map_specs(mesh, t, lambda nd: cell_spec(rules, nd))

    sched = (place_fleet(mesh, carry.sched, rules)
             if isinstance(carry.sched, FleetState)
             else put_cell(carry.sched))
    return RolloutCarry(sched=sched, params=put_cell(carry.params),
                        opt_state=put_cell(carry.opt_state))


def place_batch(mesh, tree, rules: Optional[LogicalRules] = None):
    """This rank's block of `[R, B, ...]` loop xs (sel / mb_u) under
    `fused_batch_spec`: round axis whole, cell axis sharded."""
    rules = rules or default_rules()
    return _map_specs(mesh, tree, lambda nd: fused_batch_spec(rules, nd))


def place_shards(mesh, shards: ClientShards,
                 rules: Optional[LogicalRules] = None) -> ClientShards:
    """The padded client data, whole on every rank, on the rank's device:
    the round's minibatch gather indexes any client from any cell (the
    reference shards it under the "client" rule and lets GSPMD gather;
    here every rank keeps it all)."""
    return shards.to(world_device())


def allgather_exchange(group=None):
    """The cross-cell exchange of handoff for a rank holding a block of
    the cells: all-gather the block's rows of every `FleetState` field
    (`rsu_xy` too: the nearest-RSU search scores every RSU), run the
    one-device `exchange_fleet` on the whole fleet, and keep the block's
    rows.
    Every rank computes the same permutation, bit for bit that of one
    device. It moves the whole fleet (about 19 KB a cell at fig10's
    width); an all-to-all of the migrants alone is what may later take
    its place."""
    def exchange(fleet: FleetState, mob) -> FleetState:
        n = dist.get_world_size(group)
        b, lo = fleet.batch_size, dist.get_rank(group) * fleet.batch_size
        out = exchange_fleet(
            map_tree(lambda x: _all_gather(x, n, group), fleet), mob)
        return map_tree(lambda x: x[lo:lo + b], out)

    return exchange


def _all_gather(x: torch.Tensor, n: int, group, dim: int = 0):
    """Every rank's `x` concatenated along `dim`, in rank order (bool
    tensors travel as uint8)."""
    y = x.to(torch.uint8) if x.dtype == torch.bool else x
    y = y.movedim(dim, 0).contiguous()
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=group)
    out = torch.cat(parts).movedim(0, dim)
    return out.to(torch.bool) if x.dtype == torch.bool else out


def _blocks(mesh, cfg: StreamConfig):
    group, coord, n = _data_group(mesh)
    check_batch_divisible(mesh, int(cfg.batch))
    b = int(cfg.batch) // n
    return group, coord * b, dataclasses.replace(cfg, batch=b)


def cell_rows(draws, lo: int, hi: int):
    """Rows [lo, hi) of every tensor of a (nested) dict of draws."""
    if isinstance(draws, dict):
        return {k: cell_rows(v, lo, hi) for k, v in draws.items()}
    return draws[lo:hi]


def batch_draws(sc, mob, cfg: StreamConfig, n_vehicles: int, device):
    """`draw(key)`: the whole batch's draws of one round from an integer
    round key, as the one-device round builders draw them on `device`
    (`make_round_batch`'s in fresh-fleet mode, `fleet_round`'s of a
    persistent fleet of `n_vehicles` slots a cell)."""
    def draw(key: int):
        gen = torch.Generator(device=device).manual_seed(int(key))
        if cfg.fresh_fleet:
            return round_batch_draws(gen, sc, mob, int(cfg.batch), device)
        return fleet_round_draws(gen, sc, int(cfg.batch), n_vehicles,
                                 device)
    return draw


def block_keys(keys, lo: int, hi: int, draw) -> list:
    """The round keys of a rank holding cells [lo, hi): each round's
    whole-batch draws (`draw(key)` for an integer key, the key itself
    where it is a dict of draws) cut to the block's rows, so the block
    gets bit for bit the numbers one device gives its cells; a sequence
    of per-cell keys is cut to the block's keys. Every round is drawn
    here, before the loop: the block holds its rows of all of them (at
    fig10's width 192 KB a cell a round of a persistent fleet)."""
    return [k[lo:hi] if per_cell(k) else
            cell_rows(k if isinstance(k, dict) else draw(k), lo, hi)
            for k in keys]


def mesh_fused_rollout(mesh, keys, sel, mb_u, sched, sc, mob, ch, prm,
                       cfg: StreamConfig, loss_fn, shards: ClientShards,
                       carry: RolloutCarry, *,
                       rules: Optional[LogicalRules] = None,
                       lr: float = 0.05, clip: float = 5.0, opt=None,
                       steps=None, active=None, eval_fn=None,
                       eval_mask=None, unroll: int = 1,
                       history_chunk: int = 1, state_dtype=None,
                       donate: bool = True) -> FusedResult:
    """`fused_rollout` over the mesh's data axes: this rank runs its
    block of `cfg.batch` cells. The carry, `sel`, `mb_u` and the shards
    are whole and cut here to the rank's block; `keys` are the whole
    batch's round keys (ints or draws dicts, `block_keys`), and a
    per-cell `active` mask [R, B] is cut to the block. Returns this
    rank's block of the result (`gather_result` gives the whole).
    `donate` (the reference's buffer donation) and `unroll` (its scan
    lever) are accepted for the same calls and change nothing here."""
    rules = rules or default_rules()
    validate_stream_config(cfg, threads_params=True)
    group, lo, local = _blocks(mesh, cfg)
    hi = lo + int(local.batch)
    n_vehicles = (carry.sched.n_vehicles
                  if isinstance(carry.sched, FleetState) else 0)
    keys = block_keys(keys, lo, hi, batch_draws(sc, mob, cfg, n_vehicles,
                                                world_device()))
    if active is not None and torch.as_tensor(active).ndim == 2:
        active = torch.as_tensor(active)[:, lo:hi]
    return fused_rollout(
        keys, place_batch(mesh, sel, rules), place_batch(mesh, mb_u, rules),
        sched, sc, mob, ch, prm, local, loss_fn,
        place_shards(mesh, shards, rules), place_carry(mesh, carry, rules),
        lr=lr, clip=clip, opt=opt, steps=steps, active=active,
        eval_fn=eval_fn, eval_mask=eval_mask, unroll=unroll,
        history_chunk=history_chunk, state_dtype=state_dtype,
        exchange=allgather_exchange(group))


def mesh_stream_rounds(mesh, key, sched, sc, mob, ch, prm,
                       cfg: StreamConfig, fleet: Optional[FleetState] = None,
                       *, rules: Optional[LogicalRules] = None,
                       donate: bool = True, keys=None) -> StreamResult:
    """Scheduling-only `stream_rounds` over the mesh's data axes: this
    rank runs its block of the cells. The persistent fleet is built
    whole (or taken whole from `fleet`) and cut to the block; in
    fresh-fleet mode the block's queues start at zero. `keys` (default
    `round_keys(key, ...)`) are the whole batch's round keys
    (`block_keys`). Returns this rank's block (`gather_result` gives the
    whole). `donate` is accepted for the reference's calls and changes
    nothing."""
    rules = rules or default_rules()
    validate_stream_config(cfg)
    group, lo, local = _blocks(mesh, cfg)
    dev = world_device()
    n_vehicles = 0
    if not cfg.fresh_fleet:
        fleet = sched_state0(key, sc, mob, cfg, fleet, ch, dev)
        n_vehicles = fleet.n_vehicles
        fleet = place_fleet(mesh, fleet, rules)
    if keys is None:
        keys = round_keys(key, cfg, int(cfg.n_rounds))
    keys = block_keys(list(keys)[:int(cfg.n_rounds)], lo,
                      lo + int(local.batch),
                      batch_draws(sc, mob, cfg, n_vehicles, dev))
    return stream_rounds(key, sched, sc, mob, ch, prm, local, fleet,
                         keys=keys, device=dev,
                         exchange=allgather_exchange(group))


def gather_result(mesh, res):
    """A `FusedResult` or `StreamResult` of `mesh_fused_rollout` /
    `mesh_stream_rounds` all-gathered along the cell axis (dim 0 of
    params, optimizer state, fleet and carry; dim 1 of the [R, B, ...]
    history and losses): every rank returns what one device returns."""
    group, _, n = _data_group(mesh)

    def cells(t, dim=0):
        return map_tree(lambda x: _all_gather(x, n, group, dim), t)

    common = dict(outputs=cells(res.outputs, 1), fleet=cells(res.fleet),
                  carry=cells(res.carry))
    if isinstance(res, StreamResult):
        return StreamResult(**common)
    return FusedResult(params=cells(res.params),
                       opt_state=cells(res.opt_state),
                       loss=cells(res.loss, 1),
                       metric=cells(res.metric, 1), **common)
