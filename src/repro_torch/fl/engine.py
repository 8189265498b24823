"""FedAvg of per-client gradients (eq. 11) and the per-client gradients.

Port of `fedavg_grads` and `fedavg_apply` of `repro/fl/engine.py` (the
plain SGD rule of the blocked simulator; the optimizer path and the fused
engine come with a later slice of the port). Parameters and gradients are
dicts of tensors; a stack of per-client gradients has a leading [S] axis
on every entry.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

Params = Dict[str, torch.Tensor]


def client_grads(loss_fn: Callable, params: Params, batches) -> Params:
    """Every client's gradient of `loss_fn(params, batch)` at the same
    `params`, for a stack of minibatches with a leading [S] client axis
    (the reference's `vmap(grad(loss_fn), in_axes=(None, 0))`)."""
    return torch.func.vmap(torch.func.grad(loss_fn),
                           in_dims=(None, 0))(params, batches)


def fedavg_grads(grads_stack: Params, mask: torch.Tensor,
                 weights: torch.Tensor, clip: float = 5.0):
    """Mask-weighted FedSGD gradient average (eq. 11 on gradients).

    mask [S] success indicators; weights [S] true sample counts. Returns
    (avg, scale): the weighted average gradient and the scalar
    `ok * clip_factor` to fold into the update (ok = 0 when every upload
    failed, keeping the previous global model). Clients with zero weight
    are hard-zeroed before the average so NaN gradients (e.g. from an
    empty client) cannot poison the update.
    """
    w = mask * weights
    den = torch.clamp_min(w.sum(), 1e-9)

    def _avg(g):
        wb = w.reshape(w.shape + (1,) * (g.ndim - 1))
        return torch.einsum("s,s...->...", w,
                            torch.where(wb > 0, g, 0.0)) / den

    avg = {k: _avg(g) for k, g in grads_stack.items()}
    gn = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2)
                        for g in avg.values()))
    c = torch.clamp_max(clip / (gn + 1e-9), 1.0)
    ok = (w.sum() > 0).to(torch.float32)
    return avg, ok * c


def fedavg_apply(params: Params, grads_stack: Params, mask: torch.Tensor,
                 weights: torch.Tensor, *, lr: float,
                 clip: float = 5.0) -> Params:
    """One aggregated SGD update of the global model from a stack of
    per-client grads; returns the new parameters."""
    avg, scale = fedavg_grads(grads_stack, mask, weights, clip=clip)
    return {k: p - lr * (scale * avg[k]) for k, p in params.items()}
