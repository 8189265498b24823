"""Convex solvers for the per-slot subproblems.

Port of `repro/core/solver.py`, cold path.

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

The warm-started and adaptive two-tier budgets of the reference are not
ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


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


def _polish_count(n_it: int, iters: int) -> int:
    """Gradient-polish steps for a Newton budget of `n_it` out of the cold
    `iters`: the full 10 at the full budget, proportionally fewer on a
    shortened budget."""
    return 10 if n_it == iters else max(2, (10 * n_it) // iters)


def solve_p4(cw: torch.Tensor, a: torch.Tensor, q: torch.Tensor,
             d: torch.Tensor, p_max: torch.Tensor, *, iters: int = 25,
             mu_final: float = 1e-3):
    """Cold interior-point solve of P4 for every candidate at once.

    `a, q, d, p_max` are [..., 1+U] and `cw` is [...]. Unscheduled OPVs
    must have a=0, q arbitrary, p_max>0; their optimum is 0. Returns
    (p_opt [..., 1+U], value [...]) with value = cw*ln(1+a.p) - q.p,
    floored at the zero-power value 0.
    """
    n = a.shape[-1]
    p0 = torch.full_like(a, 0.25) * p_max
    p0[..., 0] = 0.5 * p_max[..., 0]
    p = _project_feasible(p0, d, p_max, margin=0.5)
    eye = torch.eye(n, dtype=a.dtype, device=a.device)
    step_cap = (0.5 * p_max.amax(-1))[..., None]

    for mu in barrier_schedule(iters, float(mu_final)):
        grad, hess = _phi_grad_hess(p, a, q, cw, d, p_max, mu)
        # damped Newton ascent on the concave barrier objective
        hess = hess - 1e-9 * eye
        dlt = torch.linalg.solve_ex(hess, -grad)[0]
        # keep steps inside the trust region of the barrier
        norm = torch.linalg.vector_norm(dlt, dim=-1, keepdim=True)
        dlt = dlt * torch.clamp_max(step_cap / (norm + 1e-12), 1.0)
        p = _project_feasible(p + dlt, d, p_max)

    # gradient polish: a few projected-ascent steps on the raw objective
    lr_cap = (0.05 * p_max.amax(-1))[..., None]
    for _ in range(_polish_count(iters, iters)):
        s = (1.0 + _dot(a, p))[..., None]
        g = cw[..., None] * a / s - q
        lr = lr_cap / (torch.linalg.vector_norm(g, dim=-1, keepdim=True)
                       + 1e-12)
        p = _project_feasible(p + lr * g, d, p_max)

    val = cw * torch.log1p(_dot(a, p)) - _dot(q, p)
    # zero-power value as a floor (solver never worse than not transmitting)
    better = val >= 0.0
    p = torch.where(better[..., None], p, 0.0)
    return p, torch.clamp_min(val, 0.0)
