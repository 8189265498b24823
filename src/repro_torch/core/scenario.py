"""Scenario generation: mobility rollout + channel draws -> RoundInputs.

Port of `repro/core/scenario.py`. A fleet of vehicles drives on the
Manhattan grid; per round, the first S in-coverage vehicles are SOVs
(they hold data and train) and the next U are OPVs (relays).

`make_round` builds one cell ([T, ...] layout) from one `torch.Generator`;
`make_round_batch` builds B cells with independent RSU placements and,
optionally, heterogeneous fleet sizes (padding + validity masks). Both
draw an independent fleet per call.

The streaming engine instead threads a persistent `FleetState` from round
to round: `init_fleet` seeds a pool of vehicles per cell, `fleet_round`
drives them for one round and re-selects SOVs/OPVs from the vehicles in
coverage, and `rollout_rounds` loops that into [R, B, T, ...] rounds.
Under multi-RSU handoff `exchange_fleet` hands every vehicle, with its
whole state, to the cell of its nearest RSU between rounds.

Every random function is split into a draws step (`*_draws`, from a
`torch.Generator`) and a deterministic step. The round builders take a
round key: an integer that seeds the generator of the round's draws, or
the draws themselves (a dict, as the `*_draws` functions return), which
is how tests feed the reference's own draws.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.channel.mobility import (ManhattanParams, init_draws,
                                          init_from_draws, init_mobility,
                                          rollout_from_draws,
                                          rollout_positions, step_draws)
from repro_torch.channel.v2x import (ChannelParams, channel_draws,
                                     channel_gain, gain_from_draws)
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scheduler import stack_tree
from repro_torch.core.solver import p4_seed_table
from repro_torch.core.veds import RoundInputs


@dataclasses.dataclass(frozen=True)
class ScenarioParams:
    n_sov: int = 10
    n_opv: int = 10
    n_slots: int = 100
    n_flop: float = 2.0e7        # FLOPs per sample (paper's computation model)
    batch_size: int = 32
    clock_hz: float = 1.0e9      # vehicle processor clock
    rho: float = 1.0e-28         # energy coefficient (Table I)
    e_min: float = 0.05          # energy budget low [J]  (Table I)
    e_max: float = 0.10          # energy budget high [J]


def compute_model(sc: ScenarioParams) -> Tuple[float, float]:
    """Returns (t_cp, e_cp) for the standard computation model."""
    work = sc.n_flop * sc.batch_size
    t_cp = work / sc.clock_hz
    e_cp = sc.rho * sc.clock_hz ** 2 * work
    return t_cp, e_cp


def _uniform(gen: torch.Generator, n: int, lo: float, hi: float,
             device) -> torch.Tensor:
    return lo + torch.rand(n, generator=gen, device=device) * (hi - lo)


def _cell_fields(gen: torch.Generator, sc: ScenarioParams,
                 mob: ManhattanParams, ch: ChannelParams, prm: VedsParams,
                 rsu_xy: Tuple[float, float],
                 device) -> Dict[str, torch.Tensor]:
    """One cell's gains/budgets around an RSU position."""
    S, U, T = sc.n_sov, sc.n_opv, sc.n_slots
    st = init_mobility(gen, S + U, mob, rsu_xy=rsu_xy)
    _, traj = rollout_positions(gen, st, mob, T, prm.slot)      # [T,N,2]
    rsu = torch.tensor(rsu_xy, dtype=torch.float32, device=device)
    d_rsu = torch.linalg.vector_norm(traj - rsu, dim=-1)        # [T,N]
    cov = d_rsu <= mob.coverage
    d_sov_opv = torch.linalg.vector_norm(
        traj[:, :S, None, :] - traj[:, None, S:, :], dim=-1)    # [T,S,U]

    g_sr = channel_gain(gen, d_rsu[:, :S], ch, in_range=cov[:, :S])
    g_or = channel_gain(gen, d_rsu[:, S:], ch, in_range=cov[:, S:])
    g_so = channel_gain(gen, d_sov_opv, ch)

    t_cp_s, e_cp_s = compute_model(sc)
    # small heterogeneity across vehicles in clock speed
    jitter = _uniform(gen, S, 0.8, 1.2, device)
    t_cp = t_cp_s / jitter
    e_cp = e_cp_s * jitter ** 2
    e_sov = _uniform(gen, S, sc.e_min, sc.e_max, device)
    e_opv = _uniform(gen, U, sc.e_min, sc.e_max, device)
    return dict(g_sr=g_sr, g_or=g_or, g_so=g_so, t_cp=t_cp,
                e_cp=e_cp, e_sov=e_sov, e_opv=e_opv)


def make_round(gen: torch.Generator, sc: ScenarioParams,
               mob: ManhattanParams, ch: ChannelParams,
               prm: VedsParams) -> RoundInputs:
    """One round's gains/budgets, drawn from `gen` on its device.
    Vehicles: [0:S] SOVs, [S:S+U] OPVs."""
    return RoundInputs(**_cell_fields(gen, sc, mob, ch, prm, mob.rsu_xy,
                                      gen.device))


def round_generator(seed: int, r: int, device) -> torch.Generator:
    """The generator of round `r`'s scenario draws, seeded from
    (seed, r) alone: a round draws the same numbers however the rounds
    are grouped into blocks."""
    state = np.random.SeedSequence([int(seed), int(r)]).generate_state(1)
    return torch.Generator(device=device).manual_seed(int(state[0]))


def round_key(seed: int, stream: int, r: int) -> int:
    """The key of draw stream `stream` in round `r` of a run seeded with
    `seed`: derived from (seed, stream, r) alone, so a round draws the
    same numbers however a run is cut into segments."""
    return int(np.random.SeedSequence([int(seed), int(stream), int(r)])
               .generate_state(1)[0])


def _draws_of(key, draw_fn, device, *args):
    """A round's draws: `key` itself where it is a dict of draws, else
    `draw_fn` on a generator seeded with the integer `key` on `device`
    (CUDA unless the caller names another)."""
    if isinstance(key, dict):
        return key
    gen = torch.Generator(device=device).manual_seed(int(key))
    return draw_fn(gen, *args)


def _rdiv(x: float, t: torch.Tensor) -> torch.Tensor:
    """x / t as one IEEE division (PyTorch's `x / t` for a Python scalar
    x multiplies by t's reciprocal, rounding twice)."""
    return torch.full_like(t, x) / t


def _uniform_shape(gen, shape, lo: float, hi: float, device):
    return lo + torch.rand(shape, generator=gen, device=device) * (hi - lo)


def _rsu_draws(gen, B: int, mob: ManhattanParams, device):
    """B RSU placements, uniform over the central half of the network."""
    return _uniform_shape(gen, (B, 2), 0.25 * mob.extent, 0.75 * mob.extent,
                          device)


def round_batch_draws(gen: torch.Generator, sc: ScenarioParams,
                      mob: ManhattanParams, batch: int, device):
    """Random numbers of `make_round_batch` for B cells: RSU placements,
    fleet sizes, each cell's mobility (init and T steps of S + U
    vehicles), the three channel draws, clock jitter and budgets."""
    B, S, U, T = int(batch), sc.n_sov, sc.n_opv, sc.n_slots
    N = S + U
    return {
        "rsu": _rsu_draws(gen, B, mob, device),
        "s_cnt": torch.randint((S + 1) // 2, S + 1, (B,), generator=gen,
                               device=device),
        "u_cnt": torch.randint((U + 1) // 2, U + 1, (B,), generator=gen,
                               device=device),
        "init": init_draws(gen, (B, N), mob, device),
        "steps": step_draws(gen, (B, T, N), device),
        "g_sr": channel_draws(gen, (B, T, S), device),
        "g_or": channel_draws(gen, (B, T, U), device),
        "g_so": channel_draws(gen, (B, T, S, U), device),
        "jitter": _uniform_shape(gen, (B, S), 0.8, 1.2, device),
        "e_sov": _uniform_shape(gen, (B, S), sc.e_min, sc.e_max, device),
        "e_opv": _uniform_shape(gen, (B, U), sc.e_min, sc.e_max, device),
    }


def _drive(pos, d, speed, mob: ManhattanParams, dt: float, steps):
    """Drive [B, N] vehicles with step draws [B, T, N]: returns the final
    (pos, dir, speed), each [B, N, ...], and positions [B, T, N, 2]."""
    B, N = d.shape
    T = steps["u_turn"].shape[1]
    st = {"pos": pos.reshape(B * N, 2), "dir": d.reshape(B * N),
          "speed": speed.reshape(B * N)}
    flat = {k: v.transpose(0, 1).reshape(T, B * N) for k, v in steps.items()}
    st, traj = rollout_from_draws(st, mob, dt, flat)
    return (st["pos"].reshape(B, N, 2), st["dir"].reshape(B, N),
            st["speed"].reshape(B, N),
            traj.reshape(T, B, N, 2).transpose(0, 1))


def _dist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x - y, dim=-1)


def make_round_batch(key, sc: ScenarioParams, mob: ManhattanParams,
                     ch: ChannelParams, prm: VedsParams, batch: int, *,
                     hetero_fleet: bool = True,
                     rsu_xy: Optional[torch.Tensor] = None,
                     device=None) -> RoundInputs:
    """B cells in one batched RoundInputs ([B, T, ...] layout).

    Each cell gets an independent RSU placement (uniform over the central
    half of the road network unless `rsu_xy` [B,2] is given), independent
    mobility/channel/energy/clock draws, and, with `hetero_fleet`, a
    heterogeneous fleet size: cell b has s_b in [ceil(S/2), S] real SOVs
    and u_b in [ceil(U/2), U] real OPVs, the rest being padding with zero
    gains, zero budgets and `valid_*` False. `key` is the round's key (an
    int seeding its draws on `device`, or the draws of
    `round_batch_draws`)."""
    B, S, U = int(batch), sc.n_sov, sc.n_opv
    if not isinstance(key, dict):
        device = resolve_device(device)
    dr = _draws_of(key, round_batch_draws, device, sc, mob, B, device)
    rsu = (dr["rsu"] if rsu_xy is None else torch.broadcast_to(
        torch.as_tensor(rsu_xy, dtype=torch.float32,
                        device=dr["rsu"].device), (B, 2)))
    st = init_from_draws(dr["init"], mob, rsu_xy=rsu)
    *_, traj = _drive(st["pos"], st["dir"], st["speed"], mob, prm.slot,
                      dr["steps"])                             # [B,T,N,2]
    d_rsu = _dist(traj, rsu[:, None, None])                    # [B,T,N]
    cov = d_rsu <= mob.coverage
    d_so = _dist(traj[:, :, :S, None], traj[:, :, None, S:])   # [B,T,S,U]
    g_sr = gain_from_draws(d_rsu[..., :S], ch, dr["g_sr"], cov[..., :S])
    g_or = gain_from_draws(d_rsu[..., S:], ch, dr["g_or"], cov[..., S:])
    g_so = gain_from_draws(d_so, ch, dr["g_so"])

    t_cp_s, e_cp_s = compute_model(sc)
    jitter = dr["jitter"]
    dev = g_sr.device
    if hetero_fleet:
        valid_sov = (torch.arange(S, device=dev)[None]
                     < dr["s_cnt"][:, None])                   # [B,S]
        valid_opv = torch.arange(U, device=dev)[None] < dr["u_cnt"][:, None]
    else:
        valid_sov = torch.ones((B, S), dtype=torch.bool, device=dev)
        valid_opv = torch.ones((B, U), dtype=torch.bool, device=dev)
    vs, vo = valid_sov[:, None, :], valid_opv[:, None, :]
    return RoundInputs(
        g_sr=g_sr * vs, g_or=g_or * vo,
        g_so=g_so * (valid_sov[:, None, :, None]
                     & valid_opv[:, None, None, :]),
        t_cp=_rdiv(t_cp_s, jitter) * valid_sov,
        e_cp=(e_cp_s * jitter ** 2) * valid_sov,
        e_sov=dr["e_sov"] * valid_sov, e_opv=dr["e_opv"] * valid_opv,
        valid_sov=valid_sov, valid_opv=valid_opv)


# ---------------------------------------------------------------------------
# Persistent fleets for the streaming multi-round engine
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetState:
    """Per-cell vehicle pool threaded round-to-round by the streaming
    engine. N is the pool size (>= S + U); all fields are batched [B, ...].

      pos [B,N,2], dir [B,N], speed [B,N]  mobility state (resumable)
      jitter [B,N]     persistent clock-speed heterogeneity (0.8..1.2)
      allowance [B,N]  per-round energy budget draw [J] (e_min..e_max)
      energy [B,N]     residual battery [J]; +inf when not tracked
      queue [B,N]      per-vehicle virtual energy queue (eqs. 19-20),
                       gathered into the scheduler carry for whichever
                       role the vehicle plays this round
      rsu_xy [B,2]     static RSU placement per cell
      covered [B,N]    bool: in coverage at the previous round start
                       (with `handover_delay`, vehicles entering coverage
                       mid-round become eligible only the next round)
      cell_id [B,N]    int64: the RSU this vehicle is associated with;
                       the row index without handoff, -1 for a vehicle
                       `exchange_fleet` parked for lack of capacity
      p4_tab [B,N,U,1+U]  P4 warm-start table: the last interior-point
                       optima solved with this vehicle as the SOV,
                       seeded with the solver's cold start; gathered and
                       scattered only when `VedsParams.ipm_warm_iters >
                       0`, and it migrates with the vehicle under handoff
    """
    pos: torch.Tensor
    dir: torch.Tensor
    speed: torch.Tensor
    jitter: torch.Tensor
    allowance: torch.Tensor
    energy: torch.Tensor
    queue: torch.Tensor
    rsu_xy: torch.Tensor
    covered: torch.Tensor
    cell_id: torch.Tensor
    p4_tab: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.pos.shape[0]

    @property
    def n_vehicles(self) -> int:
        return self.pos.shape[1]


class FleetSelection(NamedTuple):
    """Round role assignment: fleet indices of this round's SOVs/OPVs."""
    sov_idx: torch.Tensor   # [B, S]
    opv_idx: torch.Tensor   # [B, U]


def init_fleet_draws(gen: torch.Generator, mob: ManhattanParams,
                     sc: ScenarioParams, batch: int, n: int, device):
    """Random numbers of `init_fleet`: RSU placements, each vehicle's
    mobility init, clock jitter and per-round energy allowance."""
    B = int(batch)
    return {"rsu": _rsu_draws(gen, B, mob, device),
            "init": init_draws(gen, (B, n), mob, device),
            "jitter": _uniform_shape(gen, (B, n), 0.8, 1.2, device),
            "allowance": _uniform_shape(gen, (B, n), sc.e_min, sc.e_max,
                                        device)}


def _n_fleet(sc: ScenarioParams, n_fleet: Optional[int]) -> int:
    N = int(n_fleet) if n_fleet is not None else 2 * (sc.n_sov + sc.n_opv)
    if N < sc.n_sov + sc.n_opv:
        raise ValueError(f"n_fleet={N} < S + U = {sc.n_sov + sc.n_opv}")
    return N


def init_fleet(key, sc: ScenarioParams, mob: ManhattanParams, batch: int,
               *, n_fleet: Optional[int] = None,
               rsu_xy: Optional[torch.Tensor] = None,
               energy_horizon: Optional[float] = None,
               p_max: Optional[float] = None, device=None) -> FleetState:
    """Seed B persistent vehicle pools of `n_fleet` vehicles each.

    `key` is an int seeding the draws on `device`, or the draws of
    `init_fleet_draws`. `energy_horizon = H` gives every vehicle a
    battery of H rounds' worth of its allowance; None disables battery
    tracking (+inf). RSU placements are drawn like `make_round_batch`'s
    unless given. `p_max` seeds the P4 warm-start table (default:
    `ChannelParams`'s); a warm solve from the seed at the full budget is
    bit for bit cold."""
    B = int(batch)
    N = _n_fleet(sc, n_fleet)
    if not isinstance(key, dict):
        device = resolve_device(device)
    dr = _draws_of(key, init_fleet_draws, device, mob, sc, B, N, device)
    dev = dr["jitter"].device
    rsu = (dr["rsu"] if rsu_xy is None else torch.broadcast_to(
        torch.as_tensor(rsu_xy, dtype=torch.float32, device=dev), (B, 2)))
    st = init_from_draws(dr["init"], mob, rsu_xy=rsu)
    allowance = dr["allowance"]
    energy = (torch.full((B, N), float("inf"), device=dev)
              if energy_horizon is None
              else allowance * float(energy_horizon))
    U = sc.n_opv
    return FleetState(
        pos=st["pos"], dir=st["dir"], speed=st["speed"],
        jitter=dr["jitter"], allowance=allowance, energy=energy,
        queue=torch.zeros((B, N), device=dev), rsu_xy=rsu,
        covered=_dist(st["pos"], rsu[:, None]) <= mob.coverage,
        cell_id=torch.arange(B, device=dev)[:, None].expand(B, N),
        p4_tab=p4_seed_table((B, N, U, U + 1),
                             ChannelParams().p_max if p_max is None
                             else float(p_max), device=dev))


def rsu_grid(batch: int, mob: ManhattanParams, *,
             pitch: Optional[float] = None, device=None) -> torch.Tensor:
    """[B,2] RSU placements on a square grid over the road network.

    The default pitch (`0.75 * coverage`) puts neighbouring RSUs well
    inside each other's coverage radius, the overlapping-coverage
    multi-RSU topology of handoff. Where the grid would overrun the road
    network, the pitch shrinks to fit, so RSU positions stay distinct.
    On `device`: CUDA unless the caller names another."""
    B = int(batch)
    g = math.ceil(math.sqrt(B))
    rows = (B + g - 1) // g
    p = float(pitch) if pitch is not None else 0.75 * mob.coverage
    span = max(g - 1, rows - 1, 1)
    p = min(p, mob.extent / span)
    idx = torch.arange(B, device=resolve_device(device))
    gx, gy = (idx % g).to(torch.float32), (idx // g).to(torch.float32)
    x = 0.5 * mob.extent + (gx - 0.5 * (g - 1)) * p
    y = 0.5 * mob.extent + (gy - 0.5 * (rows - 1)) * p
    return torch.stack([x, y], -1)


def migrated_fraction(fleet0: FleetState, fleet1: FleetState) -> float:
    """Fraction of vehicles whose cell (row) differs between two fleet
    snapshots, tracking identity by the persistent per-vehicle `jitter`
    value, which `exchange_fleet` permutes with the vehicle and nothing
    rewrites."""
    j0 = fleet0.jitter.detach().cpu().numpy()
    j1 = fleet1.jitter.detach().cpu().numpy()
    row_of = {float(t): b for b in range(j1.shape[0]) for t in j1[b]}
    return float(np.mean([[row_of[float(t)] != b for t in j0[b]]
                          for b in range(j0.shape[0])]))


def exchange_fleet(fleet: FleetState, mob: ManhattanParams) -> FleetState:
    """Cross-cell vehicle exchange: hand every vehicle to its nearest RSU.

    Each of the M = B * N vehicles targets the cell of its nearest RSU;
    its full state (position, heading, speed, jitter, allowance, battery,
    virtual queue, P4 table, `covered`) moves to a slot of the target row
    by one permutation of the flat [M] layout. No randomness is consumed,
    so the permutation is the reference's exactly: a stable sort by
    target cell, a right-sided search for the free slots, and scatters
    into unique indices.

    Capacity: a cell admits at most N vehicles, first come by flat
    (cell, slot) order; the overflow fills the rows left short, in
    row-major order, parked with `cell_id = -1` and `covered = False`.
    A vehicle that changed cells gets `covered = False` (one round of
    handover delay where `handover_delay` is on). For B = 1 the exchange
    is the identity."""
    B, N = fleet.batch_size, fleet.n_vehicles
    M = B * N
    dev = fleet.pos.device

    def flat(x):
        return x.reshape((M,) + tuple(x.shape[2:]))

    dist = _dist(flat(fleet.pos)[:, None], fleet.rsu_xy[None])   # [M,B]
    tgt = torch.argmin(dist, dim=-1)                              # [M]
    src_cell = torch.arange(B, device=dev).repeat_interleave(N)
    moved = tgt != src_cell

    # stable sort by target cell: vehicles for cell 0 first, then 1, ...
    order = torch.argsort(tgt, stable=True)
    tgt_s = tgt[order]
    counts = torch.bincount(tgt, minlength=B)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(M, device=dev) - start[tgt_s]           # in-cell
    admitted = rank < N

    # overflow <-> free-slot bijection: the o-th overflow vehicle (sorted
    # order) takes the o-th free slot (row-major)
    filled = torch.clamp_max(counts, N)
    free_before = torch.cumsum(N - filled, 0) - (N - filled)     # [B]
    ovf_ord = torch.cumsum((~admitted).to(torch.int64), 0) - 1   # [M]
    c_of = torch.clamp(torch.searchsorted(free_before, ovf_ord,
                                          right=True) - 1, 0, B - 1)
    j_of = filled[c_of] + (ovf_ord - free_before[c_of])
    dest = torch.where(admitted, tgt_s * N + rank, c_of * N + j_of)

    # invert: which source vehicle lands in each flat slot (dest is a
    # permutation, so every scatter writes each slot once)
    src_of_slot = torch.zeros(M, dtype=torch.int64, device=dev).scatter(
        0, dest, order)
    cell_id = torch.zeros(M, dtype=torch.int64, device=dev).scatter(
        0, dest, torch.where(admitted, tgt_s, -1)).reshape(B, N)

    def take(x):
        return flat(x)[src_of_slot].reshape((B, N) + tuple(x.shape[2:]))

    covered = take(fleet.covered) & ~moved[src_of_slot].reshape(B, N) \
        & (cell_id >= 0)
    return FleetState(pos=take(fleet.pos), dir=take(fleet.dir),
                      speed=take(fleet.speed), jitter=take(fleet.jitter),
                      allowance=take(fleet.allowance),
                      energy=take(fleet.energy), queue=take(fleet.queue),
                      rsu_xy=fleet.rsu_xy, covered=covered,
                      cell_id=cell_id, p4_tab=take(fleet.p4_tab))


def fleet_round_draws(gen: torch.Generator, sc: ScenarioParams,
                      batch: int, n: int, device):
    """Random numbers of one `fleet_round`: T mobility steps of every
    pool vehicle ([B, T, N]) and the three channel draws of the
    selected vehicles ([B, T, S], [B, T, U], [B, T, S, U])."""
    B, S, U, T = int(batch), sc.n_sov, sc.n_opv, sc.n_slots
    return {"steps": step_draws(gen, (B, T, n), device),
            "g_sr": channel_draws(gen, (B, T, S), device),
            "g_or": channel_draws(gen, (B, T, U), device),
            "g_so": channel_draws(gen, (B, T, S, U), device)}


def per_cell(key) -> bool:
    """Whether a round key is a sequence of B per-cell keys (the serving
    layer's packed sessions) rather than one key for the whole batch."""
    return isinstance(key, (list, tuple))


def _fleet_round_draws_of(key, sc: ScenarioParams, B: int, N: int,
                          device):
    """The draws of one `fleet_round`: from one round key for all B
    cells, or from B per-cell keys, cell b drawing its own [1, ...]
    draws from its own generator (or taking them as given) exactly as a
    B = 1 call with its key does, concatenated along the cell axis."""
    if not per_cell(key):
        return _draws_of(key, fleet_round_draws, device, sc, B, N, device)
    if len(key) != B:
        raise ValueError(f"{len(key)} per-cell keys for {B} cells")
    return stack_tree([_draws_of(k, fleet_round_draws, device, sc, 1, N,
                                 device) for k in key], torch.cat)


def fleet_round(key, fleet: FleetState, sc: ScenarioParams,
                mob: ManhattanParams, ch: ChannelParams, prm: VedsParams, *,
                handover_delay: bool = False, handoff: bool = False
                ) -> Tuple[FleetState, RoundInputs, FleetSelection]:
    """Advance every cell's pool one round and build the batched
    RoundInputs for the selected SOVs/OPVs.

    Roles are chosen by coverage at round start: eligible vehicles first
    (a stable sort keeps index order, so vehicles keep their role while
    they stay covered), the first S are SOVs and the next U OPVs, padded
    with `valid_*` False where fewer qualify. With `handover_delay` a
    vehicle is eligible only if it was covered at the previous round
    start too; with `handoff`, vehicles parked by `exchange_fleet`
    (`cell_id == -1`) are not. The pool then drives T slots and the
    selected vehicles' channels are drawn. Queue and energy fields come
    back untouched (the streaming engine scatters the scheduler's outputs
    back); `covered` is refreshed to this round's start. `key` is the
    round's key (an int seeding its draws on the fleet's device, or the
    draws of `fleet_round_draws`), or a sequence of B per-cell keys (the
    serving layer's packed sessions, each bringing its own round key):
    cell b then draws what a B = 1 call with `key[b]` draws, so a packed
    cell is the same request run alone."""
    B, N = fleet.batch_size, fleet.n_vehicles
    S, U = sc.n_sov, sc.n_opv
    dr = _fleet_round_draws_of(key, sc, B, N, fleet.pos.device)
    rsu = fleet.rsu_xy
    cov0 = _dist(fleet.pos, rsu[:, None]) <= mob.coverage
    if handoff:
        cov0 = cov0 & (fleet.cell_id >= 0)
    elig = cov0 & fleet.covered if handover_delay else cov0
    order = torch.argsort(torch.where(elig, 0, 1), dim=1, stable=True)
    sov_idx, opv_idx = order[:, :S], order[:, S:S + U]
    valid_sov = torch.gather(elig, 1, sov_idx)
    valid_opv = torch.gather(elig, 1, opv_idx)

    pos, d, speed, traj = _drive(fleet.pos, fleet.dir, fleet.speed, mob,
                                 prm.slot, dr["steps"])       # [B,T,N,2]
    T = traj.shape[1]
    traj_s = torch.gather(traj, 2, sov_idx[:, None, :, None].expand(
        B, T, S, 2))                                           # [B,T,S,2]
    traj_u = torch.gather(traj, 2, opv_idx[:, None, :, None].expand(
        B, T, U, 2))                                           # [B,T,U,2]
    d_rsu_s = _dist(traj_s, rsu[:, None, None])                # [B,T,S]
    d_rsu_u = _dist(traj_u, rsu[:, None, None])                # [B,T,U]
    cov_s = (d_rsu_s <= mob.coverage) & valid_sov[:, None]
    cov_u = (d_rsu_u <= mob.coverage) & valid_opv[:, None]
    d_so = _dist(traj_s[:, :, :, None], traj_u[:, :, None])    # [B,T,S,U]

    g_sr = gain_from_draws(d_rsu_s, ch, dr["g_sr"], cov_s)
    g_or = gain_from_draws(d_rsu_u, ch, dr["g_or"], cov_u)
    g_so = gain_from_draws(d_so, ch, dr["g_so"]) \
        * (valid_sov[:, None, :, None] & valid_opv[:, None, None, :])

    t_cp_s, e_cp_s = compute_model(sc)
    jit_s = torch.gather(fleet.jitter, 1, sov_idx)
    budget = torch.minimum(fleet.allowance,
                           torch.clamp_min(fleet.energy, 0.0))
    rnd = RoundInputs(
        g_sr=g_sr, g_or=g_or, g_so=g_so,
        t_cp=_rdiv(t_cp_s, jit_s) * valid_sov,
        e_cp=(e_cp_s * jit_s ** 2) * valid_sov,
        e_sov=torch.gather(budget, 1, sov_idx) * valid_sov,
        e_opv=torch.gather(budget, 1, opv_idx) * valid_opv,
        valid_sov=valid_sov, valid_opv=valid_opv)
    new_fleet = dataclasses.replace(fleet, pos=pos, dir=d, speed=speed,
                                    covered=cov0)
    return new_fleet, rnd, FleetSelection(sov_idx, opv_idx)


def rollout_rounds(keys: Sequence, fleet: FleetState, sc: ScenarioParams,
                   mob: ManhattanParams, ch: ChannelParams, prm: VedsParams,
                   n_rounds: int, *, handover_delay: bool = False,
                   handoff: bool = False
                   ) -> Tuple[FleetState, RoundInputs, FleetSelection]:
    """R resumable rounds of one persistent fleet, one round key each
    (`keys[:n_rounds]`): returns (final fleet, RoundInputs [R, B, T, ...],
    FleetSelection [R, B, ...]). Scheduling is not included
    (`repro_torch.core.streaming.stream_rounds` adds it). With `handoff`
    each round starts with the cross-cell exchange."""
    rnds, sels = [], []
    for k in list(keys)[:n_rounds]:
        if handoff:
            fleet = exchange_fleet(fleet, mob)
        fleet, rnd, sel = fleet_round(k, fleet, sc, mob, ch, prm,
                                      handover_delay=handover_delay,
                                      handoff=handoff)
        rnds.append(rnd)
        sels.append(sel)
    return fleet, stack_tree(rnds), stack_tree(sels)
