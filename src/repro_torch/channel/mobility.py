"""Manhattan-grid mobility (SUMO-like).

Port of `repro/channel/mobility.py`. Vehicles move along a grid of streets
(spacing `block`), turning at intersections with a configurable
probability, with per-vehicle speeds up to v_max. The RSU sits at the grid
center with a circular coverage area.

Each random function is split in two: a `*_draws` function makes the
random numbers from a `torch.Generator`, and a deterministic function
takes them as tensors, so tests can feed the reference's own draws.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch


@dataclasses.dataclass(frozen=True)
class ManhattanParams:
    extent: float = 1000.0       # square road network side [m]
    block: float = 250.0         # street spacing [m]
    v_max: float = 10.0          # max speed [m/s]
    turn_prob: float = 0.25      # turn probability at an intersection
    rsu_xy: Tuple[float, float] = (500.0, 500.0)
    coverage: float = 400.0      # RSU coverage radius [m]


# Directions: 0:+x 1:-x 2:+y 3:-y. A step computes the unit vector from
# the index (axis = dir // 2, sign -1 for odd dir; reversing flips the low
# bit), so it needs no table copied to the device.


def init_draws(gen: torch.Generator, n, prm: ManhattanParams,
               device) -> Dict[str, torch.Tensor]:
    """Random numbers of `init_mobility`: street index, offset along the
    street, orientation, heading bit and speed of each of `n` vehicles
    (an int, or a shape such as [B, N] for B cells)."""
    shape = (n,) if isinstance(n, int) else tuple(n)
    n_lines = int(prm.extent // prm.block) + 1
    line = torch.randint(0, n_lines, shape, generator=gen, device=device)
    offset = torch.rand(shape, generator=gen, device=device) * prm.extent
    horiz = torch.rand(shape, generator=gen, device=device) < 0.5
    d_bit = torch.randint(0, 2, shape, generator=gen, device=device)
    v_lo, v_hi = 0.3 * prm.v_max, max(prm.v_max, 1e-3)
    speed = v_lo + torch.rand(shape, generator=gen, device=device) \
        * (v_hi - v_lo)
    return dict(line=line, offset=offset, horiz=horiz, d_bit=d_bit,
                speed=speed)


def init_from_draws(draws: Dict[str, torch.Tensor], prm: ManhattanParams,
                    near_rsu: bool = True,
                    rsu_xy: Union[Tuple[float, float], torch.Tensor,
                                  None] = None):
    """Deterministic half of `init_mobility`: state dict with pos [...,2],
    dir [...] (int64) and speed [...], for draws of any shape [..., n].

    `rsu_xy` is a Python pair, or an fp32 tensor [..., 2] of per-cell
    RSU positions (the draws' leading axes are the cells); the clamp
    bounds are then computed in fp32, as the reference computes them
    for a traced RSU position."""
    line = draws["line"].to(torch.float32)
    offset = draws["offset"]
    if near_rsu and torch.is_tensor(rsu_xy):
        r = 0.8 * prm.coverage
        cx, cy = rsu_xy[..., 0, None], rsu_xy[..., 1, None]
        lo_l = torch.floor(torch.clamp_min(cx - r, 0.0) / prm.block)
        hi_l = torch.ceil(torch.clamp_max(cx + r, prm.extent) / prm.block)
        line = torch.clamp(line, lo_l, hi_l)
        offset = torch.clamp(offset, cy - r, cy + r)
    elif near_rsu:
        r = 0.8 * prm.coverage
        cx, cy = prm.rsu_xy if rsu_xy is None else rsu_xy
        lo_l = float(int(max(cx - r, 0.0) // prm.block))
        hi_l = -float(int(-min(cx + r, prm.extent) // prm.block))
        line = torch.clamp(line, lo_l, hi_l)
        offset = torch.clamp(offset, cy - r, cy + r)
    horiz = draws["horiz"]
    x = torch.where(horiz, offset, line * prm.block)
    y = torch.where(horiz, line * prm.block, offset)
    d = torch.where(horiz, draws["d_bit"], 2 + draws["d_bit"])
    return {"pos": torch.stack([x, y], -1), "dir": d,
            "speed": draws["speed"]}


def init_mobility(gen: torch.Generator, n: int, prm: ManhattanParams,
                  near_rsu: bool = True,
                  rsu_xy: Optional[Tuple[float, float]] = None):
    """Returns state dict: pos [n,2] on the grid, dir [n], speed [n], on
    `gen`'s device.

    near_rsu: sample initial positions within ~coverage of the RSU.
    """
    return init_from_draws(init_draws(gen, n, prm, gen.device), prm,
                           near_rsu=near_rsu, rsu_xy=rsu_xy)


def step_draws(gen: torch.Generator, shape,
               device) -> Dict[str, torch.Tensor]:
    """Random numbers of one `step_mobility` per vehicle (any leading
    shape, e.g. [T, N] for a whole rollout): the turn uniform and the
    new-heading bits for a horizontal and for a vertical mover."""
    return dict(
        u_turn=torch.rand(shape, generator=gen, device=device),
        bit_h=torch.randint(0, 2, shape, generator=gen, device=device),
        bit_v=torch.randint(0, 2, shape, generator=gen, device=device))


def step_from_draws(state, prm: ManhattanParams, dt: float,
                    draws: Dict[str, torch.Tensor]):
    """Deterministic half of `step_mobility`: pos [n,2], dir and speed
    [n], draws [n]."""
    pos, d, speed = state["pos"], state["dir"], state["speed"]
    moving_axis = torch.where(d < 2, 0, 1)
    sign = 1.0 - 2.0 * (d % 2)
    unit = torch.stack([torch.where(d < 2, sign, 0.0),
                        torch.where(d < 2, 0.0, sign)], -1)
    step = speed[:, None] * dt * unit
    new = pos + step
    # intersection crossing detection (per moving axis)
    coord_old = torch.gather(pos, 1, moving_axis[:, None])[:, 0]
    coord_new = torch.gather(new, 1, moving_axis[:, None])[:, 0]
    cell_old = torch.floor(coord_old / prm.block)
    cell_new = torch.floor(coord_new / prm.block)
    crossed = cell_old != cell_new
    turn = (draws["u_turn"] < prm.turn_prob) & crossed
    # when turning, snap to the intersection and switch axis
    snap = torch.where(coord_new > coord_old, cell_new, cell_old) * prm.block
    new_snapped = new.scatter(1, moving_axis[:, None], snap[:, None])
    new_dir_turn = torch.where(d < 2, 2 + draws["bit_h"], draws["bit_v"])
    d = torch.where(turn, new_dir_turn, d)
    new = torch.where(turn[:, None], new_snapped, new)
    # bounce at the network boundary
    hit = ((new > prm.extent) | (new < 0.0)).any(-1)
    new = torch.clamp(new, 0.0, prm.extent)
    d = torch.where(hit, torch.bitwise_xor(d, 1), d)
    return {"pos": new, "dir": d, "speed": speed}


def step_mobility(gen: torch.Generator, state, prm: ManhattanParams,
                  dt: float):
    return step_from_draws(
        state, prm, dt,
        step_draws(gen, state["dir"].shape, state["pos"].device))


def rollout_positions(gen: torch.Generator, state, prm: ManhattanParams,
                      n_steps: int, dt: float):
    """Drive the fleet n_steps slots; returns (final state, positions
    [n_steps, N, 2]). The draws of all steps are made up front."""
    draws = step_draws(gen, (n_steps,) + tuple(state["dir"].shape),
                       state["pos"].device)
    return rollout_from_draws(state, prm, dt, draws)


def rollout_from_draws(state, prm: ManhattanParams, dt: float,
                       draws: Dict[str, torch.Tensor]):
    """Deterministic half of `rollout_positions`: one step per leading
    entry of the draws ([n_steps, N] each). Returns (final state,
    positions [n_steps, N, 2])."""
    traj = []
    for t in range(draws["u_turn"].shape[0]):
        state = step_from_draws(state, prm, dt,
                                {k: v[t] for k, v in draws.items()})
        traj.append(state["pos"])
    return state, torch.stack(traj)
