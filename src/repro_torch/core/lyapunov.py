"""Derivative-based drift-plus-penalty machinery (paper eqs. 16-20).

Port of `repro/core/lyapunov.py`. The stepwise indicator
1{sum_t z_m(t) >= Q} is approximated by the shifted sigmoid
sigma(z) = 1 / (1 + exp(-alpha (z - Q) / Q)); the per-slot scheduling
weight is its derivative at zeta_m(t) (bits already delivered). Virtual
queues track cumulative energy-budget violation. Every division by Q
or T is by a 0-dim tensor on the operands' device (`device_scalar`),
correctly rounded on the card as on the CPU; a caller in a CUDA graph
passes the tensors in, made once.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import device_scalar


@dataclasses.dataclass(frozen=True)
class VedsParams:
    alpha: float = 2.0       # sigmoid approximation sharpness
    V: float = 0.2           # drift-plus-penalty trade-off weight
    Q: float = 1e7           # model size [bits]
    slot: float = 0.1        # kappa [s]
    ipm_iters: int = 25      # Newton iterations for P4 (cold start)
    ipm_mu: float = 1e-3     # final barrier weight
    ipm_warm_iters: int = 0  # warm-started P4 budget: when > 0 and a
    #                          warm-start table is threaded in (streaming
    #                          carry, FleetState.p4_tab), each candidate
    #                          re-solves from its previous optimum with
    #                          this many Newton steps (the tail of the cold
    #                          schedule). 0 disables the warm path.
    ipm_far_iters: int = 0   # adaptive two-tier warm budget: candidates
    #                          whose seed is far from stationary (gradient
    #                          norm > ipm_far_grad_tol) apply this many
    #                          steps instead. Needs ipm_far_iters >
    #                          ipm_warm_iters and ipm_far_grad_tol > 0.
    ipm_far_grad_tol: float = 0.0  # gradient-norm threshold of the
    #                          near/far tiers (0 disables the split)


def sigmoid_shifted(z: torch.Tensor, prm: VedsParams,
                    Q=None) -> torch.Tensor:
    """`Q`: prm.Q as a 0-dim tensor on z's device (made here if None)."""
    Q = device_scalar(prm.Q if Q is None else Q, z)
    return torch.sigmoid(prm.alpha * (z - prm.Q) / Q)


def sigmoid_weight(zeta: torch.Tensor, prm: VedsParams,
                   Q=None) -> torch.Tensor:
    """d sigma / d zeta at the delivered-bits state (eq. below (17))."""
    Q = device_scalar(prm.Q if Q is None else Q, zeta)
    s = sigmoid_shifted(zeta, prm, Q)
    return prm.alpha * s * (1.0 - s) / Q


def psi(prm: VedsParams) -> float:
    """psi(alpha) = sigma'(0) / sigma'(Q), Theorem 2's bound factor."""
    s0 = 1.0 / (1.0 + math.exp(prm.alpha))
    sq = 0.5
    return (s0 * (1 - s0)) / (sq * (1 - sq))


def update_queue_sov(q: torch.Tensor, e_cm: torch.Tensor,
                     e_cons: torch.Tensor, e_cp: torch.Tensor,
                     T) -> torch.Tensor:
    """Eq. (19). `T`: the slot count, a number or a 0-dim tensor."""
    return torch.clamp_min(q + e_cm - (e_cons - e_cp) / device_scalar(T, q),
                           0.0)


def update_queue_opv(q: torch.Tensor, e_cm: torch.Tensor,
                     e_cons: torch.Tensor, T) -> torch.Tensor:
    """Eq. (20). `T`: the slot count, a number or a 0-dim tensor."""
    return torch.clamp_min(q + e_cm - e_cons / device_scalar(T, q), 0.0)


def update_zeta(zeta: torch.Tensor, z: torch.Tensor,
                prm: VedsParams) -> torch.Tensor:
    """Eq. (17): delivered bits, saturated at Q."""
    return torch.clamp_max(zeta + z, prm.Q)


def relax_queue(q: torch.Tensor, e_net: torch.Tensor) -> torch.Tensor:
    """T zero-transmission steps of (19)/(20) in closed form.

    With e_cm = 0 every slot, iterating q <- max(q - e_net / T, 0) for T
    slots collapses to max(q - e_net, 0) when e_net >= 0 (monotone
    descent, one clip) and to q - e_net when e_net < 0 (monotone ascent,
    the max never binds). Both are `max(q - e_net, 0)` since q >= 0.
    """
    return torch.clamp_min(q - e_net, 0.0)
