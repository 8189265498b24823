"""Minimal functional optimizers over dicts of tensors.

Port of `repro/optim/optimizers.py`. Each factory returns
(init_fn, update_fn):
  state = init_fn(params)
  new_params, new_state = update_fn(params, grads, state, step)
Learning rates may be floats or schedule callables step -> lr; `step` is
an int or a 0-dim tensor.
"""
from __future__ import annotations

import math
from typing import Callable, Union

import torch

Schedule = Union[float, Callable]


def _lr_at(lr: Schedule, step):
    return lr(step) if callable(lr) else lr


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step, dtype=torch.float32)


def sgd(lr: Schedule = 0.1):
    def init(params):
        return ()

    def update(params, grads, state, step=0):
        eta = _lr_at(lr, step)
        return {k: (p - eta * grads[k]).to(p.dtype)
                for k, p in params.items()}, state

    return init, update


def momentum(lr: Schedule = 0.1, beta: float = 0.9):
    def init(params):
        return {k: torch.zeros_like(p) for k, p in params.items()}

    def update(params, grads, state, step=0):
        eta = _lr_at(lr, step)
        new_m = {k: beta * m + grads[k] for k, m in state.items()}
        return {k: (p - eta * new_m[k]).to(p.dtype)
                for k, p in params.items()}, new_m

    return init, update


def adam(lr: Schedule = 1e-3, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8):
    def init(params):
        return {s: {k: torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device)
                    for k, p in params.items()} for s in ("m", "v")}

    def update(params, grads, state, step=0):
        eta = _lr_at(lr, step)
        t = _step(step) + 1.0
        m = {k: b1 * m + (1 - b1) * grads[k].to(m.dtype)
             for k, m in state["m"].items()}
        v = {k: b2 * v + (1 - b2) * torch.square(grads[k].to(v.dtype))
             for k, v in state["v"].items()}
        new = {}
        for k, p in params.items():
            mh = m[k] / (1 - torch.pow(b1, t.to(p.device)))
            vh = v[k] / (1 - torch.pow(b2, t.to(p.device)))
            new[k] = (p - eta * mh / (torch.sqrt(vh) + eps)).to(p.dtype)
        return new, {"m": m, "v": v}

    return init, update


def linear_warmup(peak: float, warmup_steps: int) -> Callable:
    def f(step):
        s = _step(step)
        return peak * torch.clamp_max((s + 1.0) / max(warmup_steps, 1), 1.0)
    return f


def cosine_schedule(peak: float, total_steps: int,
                    warmup_steps: int = 0, floor: float = 0.0) -> Callable:
    def f(step):
        s = _step(step)
        warm = peak * torch.clamp_max((s + 1.0) / max(warmup_steps, 1), 1.0)
        frac = torch.clamp((s - warmup_steps)
                           / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + (peak - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
        return torch.where(s < warmup_steps, warm, cos)
    return f
