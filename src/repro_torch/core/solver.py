"""Convex solvers for the per-slot subproblems.

Port of `repro/core/solver.py`.

* P3.1 (direct transmission): closed form (Proposition 1).
* P4 (cooperative transmission, fixed OPV prefix): log-barrier
  damped-Newton interior-point method with a fixed iteration budget,
  batched over every leading dimension: on the card one launch of the
  `p4_solve` CUDA kernel solves every candidate, one warp each; on the
  CPU its plain version, one `torch.linalg.solve_ex` call per Newton
  step over the [..., 1+U, 1+U] systems of all candidates
  (`kernels/p4_solve/ops.py`).

P4 in canonical form, variables p in R^{1+U} (index 0 = the SOV):
  maximize  cw * ln(1 + a.p) - q.p
  s.t.      0 <= p <= pmax,   d.p <= 0
with d = a - g_min * e0 (decodability constraint (28), reduced to the
weakest scheduled OPV), entries of a zeroed for unscheduled OPVs.

The P4 solver supports a warm start (`p_init` + `warm_iters`): the
streaming rollout threads the previous round's per-vehicle optima through
its carry and re-solves with the tail of the cold barrier schedule, and an
adaptive two-tier budget (`far_iters`, `far_grad_tol`) gives far-from-
stationary seeds the longer tail. The plain version runs both tiers as
masked updates in one loop, so no branch depends on a tensor value; the
kernel's near candidates skip the steps they do not apply.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch import resolve_device
# the plain solve's parts, for callers of this module's names
from repro_torch.kernels.p4_solve.ops import (  # noqa: F401
    _phi_grad_hess, _polish_count, _project_feasible, barrier_schedule,
    p4_solve)


def dt_power_opt(cw: torch.Tensor, q: torch.Tensor, gain: torch.Tensor,
                 noise: float, p_max: float) -> torch.Tensor:
    """Proposition 1: maximizes cw * ln(1 + gain * p / noise) - q * p over
    p in [0, p_max], with the slot length already folded into q.
    Interior optimum p* = cw/q - noise/gain, clipped to the box."""
    a = gain / noise
    p = cw / torch.clamp_min(q, 1e-12) - 1.0 / torch.clamp_min(a, 1e-30)
    return torch.clamp(p, 0.0, p_max)


def p4_seed_table(shape, p_max: float, device=None) -> torch.Tensor:
    """The cold starting point of `solve_p4`, broadcast to `shape` (whose
    trailing axis is the P4 power vector [1+U]). Warm-start tables are
    seeded with it, so a warm solve at the full iteration budget from an
    untouched table is bit for bit the cold solve. On `device`: CUDA
    unless the caller names another."""
    tab = torch.full(tuple(shape), 0.25 * p_max,
                     device=resolve_device(device))
    tab[..., 0] = 0.5 * p_max
    return tab


def solve_p4(cw: torch.Tensor, a: torch.Tensor, q: torch.Tensor,
             d: torch.Tensor, p_max: torch.Tensor, *, iters: int = 25,
             mu_final: float = 1e-3, p_init: Optional[torch.Tensor] = None,
             warm_iters: int = 0, far_iters: int = 0,
             far_grad_tol: float = 0.0):
    """Interior-point solve of P4 for every candidate at once.

    `a, q, d, p_max` are [..., 1+U] and `cw` is [...]. Unscheduled OPVs
    must have a=0, q arbitrary, p_max>0; their optimum is 0. Returns
    (p_opt [..., 1+U], value [...]) with value = cw*ln(1+a.p) - q.p,
    floored at the zero-power value 0.

    Warm start: `p_init [..., 1+U]` seeds the Newton iteration (pulled
    into the interior by the same margin-0.5 projection as the cold
    start), and the barrier schedule becomes the last `warm_iters` values
    of the cold one; the gradient polish shortens in proportion.
    `warm_iters <= 0` keeps the full budget, so `p_init =
    p4_seed_table(...)` at the full budget is bit for bit the cold solve.

    Adaptive two-tier budget (warm path only; `far_iters > warm_iters`
    and `far_grad_tol > 0` enable it): a candidate whose projected seed
    has a raw-objective gradient norm above `far_grad_tol` applies the
    last `far_iters` steps of the schedule, the others only the last
    `warm_iters`. Every candidate runs the `far_iters`-long loop and a
    masked update selects which steps it applies, so a near candidate
    is bit for bit the plain `warm_iters` solve and a far candidate with
    `far_iters == iters` the cold solve from its seed.
    """
    return p4_solve(*(x.contiguous() for x in (cw, a, q, d, p_max)),
                    None if p_init is None else p_init.contiguous(),
                    iters=iters, mu_final=mu_final, warm_iters=warm_iters,
                    far_iters=far_iters, far_grad_tol=far_grad_tol)
