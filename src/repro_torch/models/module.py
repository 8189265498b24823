"""Minimal parameter declarations and their random initialisation.

Port of `declare`/`materialize` of `repro/models/module.py`: a model
declares its parameters once as a tree (dicts and lists) of `Declared`
leaves, and `materialize` draws every leaf from one `torch.Generator`
with the reference's initialisers: `normal` (scale * N(0, 1)), `scaled`
(N(0, 1) truncated to [-2, 2], times scale / sqrt(fan_in), fan_in being
the second-to-last dimension), `zeros` and `ones`. Shapes are given in
the reference's layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Declared:
    shape: Tuple[int, ...]
    init: str = "scaled"  # normal | zeros | ones | scaled (fan_in)
    scale: float = 1.0


def declare(shape, init: str = "scaled", scale: float = 1.0) -> Declared:
    return Declared(tuple(shape), init, scale)


def truncated_normal(gen: torch.Generator, shape, lower: float,
                     upper: float, device) -> torch.Tensor:
    """N(0, 1) truncated to [lower, upper], by the inverse CDF of a
    uniform draw between the bounds' CDF values."""
    s = math.sqrt(2.0)
    lo, hi = math.erf(lower / s), math.erf(upper / s)
    u = lo + torch.rand(shape, generator=gen, device=device) * (hi - lo)
    return torch.clamp(s * torch.erfinv(u), lower, upper)


def _init_leaf(gen: torch.Generator, d: Declared, device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, device=device)
    if d.init == "normal":
        return d.scale * torch.randn(d.shape, generator=gen, device=device)
    if d.init == "scaled":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(fan_in, 1))
        return std * truncated_normal(gen, d.shape, -2.0, 2.0, device)
    raise ValueError(f"unknown init {d.init!r}")


def materialize(gen: torch.Generator, tree):
    """The tree with every `Declared` leaf drawn from `gen`, in the
    order of a depth-first walk (dict keys sorted), on `gen`'s device."""
    if isinstance(tree, Declared):
        return _init_leaf(gen, tree, gen.device)
    if isinstance(tree, dict):
        return {k: materialize(gen, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(materialize(gen, v) for v in tree)
    raise TypeError(f"not a parameter declaration: {type(tree)}")
