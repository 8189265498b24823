"""Scenario generation: mobility rollout + channel draws -> RoundInputs.

Port of the single-cell part of `repro/core/scenario.py`. A fleet of
vehicles drives on the Manhattan grid; per round, vehicles [0:S] are the
SOVs (they hold data and train) and [S:S+U] the OPVs (relays).
`make_round` builds one cell ([T, ...] layout) from one `torch.Generator`;
the batched builders and persistent fleets of the reference
(`make_round_batch`, `FleetState`, `fleet_round`, ...) come with a later
slice of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.channel.mobility import (ManhattanParams, init_mobility,
                                          rollout_positions)
from repro_torch.channel.v2x import ChannelParams, channel_gain
from repro_torch.core.lyapunov import VedsParams
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
