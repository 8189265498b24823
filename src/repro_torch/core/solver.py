"""Convex solvers for the per-slot subproblems.

Port of `repro/core/solver.py`.

* P3.1 (direct transmission): closed form (Proposition 1).
* P4 (cooperative transmission, fixed OPV prefix): log-barrier
  damped-Newton interior-point method with a fixed iteration budget,
  batched over every leading dimension: one `torch.linalg.solve_ex` call
  per Newton step solves the [..., 1+U, 1+U] systems of all candidates.

P4 in canonical form, variables p in R^{1+U} (index 0 = the SOV):
  maximize  cw * ln(1 + a.p) - q.p
  s.t.      0 <= p <= pmax,   d.p <= 0
with d = a - g_min * e0 (decodability constraint (28), reduced to the
weakest scheduled OPV), entries of a zeroed for unscheduled OPVs.

The P4 solver supports a warm start (`p_init` + `warm_iters`): the
streaming rollout threads the previous round's per-vehicle optima through
its carry and re-solves with the tail of the cold barrier schedule, and an
adaptive two-tier budget (`far_iters`, `far_grad_tol`) gives far-from-
stationary seeds the longer tail. Both tiers run as masked updates in one
loop, so no branch depends on a tensor value.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device


def dt_power_opt(cw: torch.Tensor, q: torch.Tensor, gain: torch.Tensor,
                 noise: float, p_max: float) -> torch.Tensor:
    """Proposition 1: maximizes cw * ln(1 + gain * p / noise) - q * p over
    p in [0, p_max], with the slot length already folded into q.
    Interior optimum p* = cw/q - noise/gain, clipped to the box."""
    a = gain / noise
    p = cw / torch.clamp_min(q, 1e-12) - 1.0 / torch.clamp_min(a, 1e-30)
    return torch.clamp(p, 0.0, p_max)


def barrier_schedule(iters: int, mu_final: float) -> Tuple[float, ...]:
    """The barrier weights of the cold path: `iters` geometrically spaced
    values from 1e-1 down to `mu_final`, each rounded once to fp32 from
    the float64 geometric sequence (the reference calls
    `jnp.geomspace(1e-1, mu_final, iters)` in fp32)."""
    mus = np.geomspace(1e-1, mu_final, iters).astype(np.float32)
    return tuple(float(m) for m in mus)


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return (x * y).sum(-1)


def _outer(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return x[..., :, None] * y[..., None, :]


def _phi_grad_hess(p, a, q, cw, d, p_max, mu: float):
    """Barrier objective phi = F + mu * barriers; returns (grad, hess).
    Vectors are [..., n], cw is [...]."""
    s = (1.0 + _dot(a, p))[..., None]
    cw = cw[..., None]
    gF = cw * a / s - q
    HF = -cw[..., None] * _outer(a, a) / (s * s)[..., None]
    # box barriers
    lo = torch.clamp_min(p, 1e-12)
    hi = torch.clamp_min(p_max - p, 1e-12)
    g_lo = mu / lo
    g_hi = -mu / hi
    H_lo = -mu / lo ** 2
    H_hi = -mu / hi ** 2
    # decodability barrier: ln(-d.p), requires d.p < 0
    slack = torch.clamp_min(-_dot(d, p), 1e-12)[..., None]
    g_c = -mu * d / slack
    H_c = -mu * _outer(d, d) / (slack ** 2)[..., None]
    grad = gF + g_lo + g_hi + g_c
    hess = HF + torch.diag_embed(H_lo + H_hi) + H_c
    return grad, hess


def _project_feasible(p, d, p_max, margin: float = 0.999):
    """Clip into the box and scale OPV powers to satisfy d.p <= 0."""
    p = torch.minimum(torch.clamp_min(p, 1e-9), p_max - 1e-9)
    p_m = p[..., 0]
    rest = p[..., 1:]
    # d0 <= 0 when feasible candidate; headroom = -d0 * p_m
    headroom = torch.clamp_min(-d[..., 0] * p_m, 1e-30)
    load = _dot(d[..., 1:], rest)
    scale = torch.clamp_max(margin * headroom / torch.clamp_min(load, 1e-30),
                            1.0)
    return torch.cat([p[..., :1], rest * scale[..., None]], dim=-1)


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


def _polish_count(n_it: int, iters: int) -> int:
    """Gradient-polish steps for a Newton budget of `n_it` out of the cold
    `iters`: the full 10 at the full budget, proportionally fewer on a
    shortened budget."""
    return 10 if n_it == iters else max(2, (10 * n_it) // iters)


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
    n = a.shape[-1]
    adaptive = (p_init is not None and warm_iters > 0
                and far_iters > warm_iters and far_grad_tol > 0.0)
    if p_init is None:
        p0 = torch.full_like(a, 0.25) * p_max
        p0[..., 0] = 0.5 * p_max[..., 0]
        n_it = iters
    else:
        p0 = p_init
        n_it = min(int(warm_iters), iters) if warm_iters > 0 else iters
    p = _project_feasible(p0, d, p_max, margin=0.5)

    if adaptive:
        n_run = min(int(far_iters), iters)
        s0 = (1.0 + _dot(a, p))[..., None]
        g0 = torch.linalg.vector_norm(cw[..., None] * a / s0 - q, dim=-1)
        far = g0 > far_grad_tol
        # the first step a candidate applies, of the Newton loop and of
        # the polish loop
        first = torch.where(far, 0, n_run - n_it)[..., None]
        first_pol = torch.where(
            far, 0, _polish_count(n_run, iters)
            - _polish_count(n_it, iters))[..., None]
    else:
        n_run = n_it

    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    step_cap = (0.5 * p_max.amax(-1))[..., None]
    mus = barrier_schedule(iters, float(mu_final))[iters - n_run:]
    for i, mu in enumerate(mus):
        grad, hess = _phi_grad_hess(p, a, q, cw, d, p_max, mu)
        # damped Newton ascent on the concave barrier objective
        hess = hess - 1e-9 * eye
        dlt = torch.linalg.solve_ex(hess, -grad)[0]
        # keep steps inside the trust region of the barrier
        norm = torch.linalg.vector_norm(dlt, dim=-1, keepdim=True)
        dlt = dlt * torch.clamp_max(step_cap / (norm + 1e-12), 1.0)
        p_new = _project_feasible(p + dlt, d, p_max)
        p = torch.where(i >= first, p_new, p) if adaptive else p_new

    # gradient polish: a few projected-ascent steps on the raw objective
    lr_cap = (0.05 * p_max.amax(-1))[..., None]
    for j in range(_polish_count(n_run, iters)):
        s = (1.0 + _dot(a, p))[..., None]
        g = cw[..., None] * a / s - q
        lr = lr_cap / (torch.linalg.vector_norm(g, dim=-1, keepdim=True)
                       + 1e-12)
        p_new = _project_feasible(p + lr * g, d, p_max)
        p = torch.where(j >= first_pol, p_new, p) if adaptive else p_new

    val = cw * torch.log1p(_dot(a, p)) - _dot(q, p)
    # zero-power value as a floor (solver never worse than not transmitting)
    better = val >= 0.0
    p = torch.where(better[..., None], p, 0.0)
    return p, torch.clamp_min(val, 0.0)
