"""Minimal parameter declarations and their random initialisation.

Port of `repro/models/module.py`: a model declares its parameters once as
a tree (dicts and lists) of `Declared` leaves (shape, logical axes,
initialiser, dtype), and `materialize` draws every leaf from one
`torch.Generator` with the reference's initialisers: `normal`
(scale * N(0, 1)), `scaled` (N(0, 1) truncated to [-2, 2], times
scale / sqrt(fan_in), fan_in being the second-to-last dimension, so
`wq [d, H, Dh]` uses H as the reference does), `zeros` and `ones`. Draws
are made in float32 and cast to the leaf's dtype. Shapes are given in
the reference's layout.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Declared:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...] = ()
    init: str = "scaled"  # normal | zeros | ones | scaled (fan_in)
    scale: float = 1.0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.axes and len(self.shape) != len(self.axes):
            raise ValueError(
                f"shape {self.shape} and axes {self.axes} rank mismatch")


def declare(shape, axes=(), init: str = "scaled", scale: float = 1.0,
            dtype: torch.dtype = torch.float32) -> Declared:
    return Declared(tuple(shape), tuple(axes), init, scale, dtype)


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
        return torch.zeros(d.shape, dtype=d.dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=device)
    if d.init == "normal":
        x = d.scale * torch.randn(d.shape, generator=gen, device=device)
        return x.to(d.dtype)
    if d.init == "scaled":
        fan_in = d.shape[-2] if len(d.shape) >= 2 else d.shape[-1]
        std = d.scale / math.sqrt(max(fan_in, 1))
        x = std * truncated_normal(gen, d.shape, -2.0, 2.0, device)
        return x.to(d.dtype)
    raise ValueError(f"unknown init {d.init!r}")


def tree_map(fn, tree, *rest):
    """`fn` applied leaf by leaf over trees of dicts and lists (dict keys
    sorted) of one structure; any other value is a leaf."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *rs)
                          for t, *rs in zip(tree, *rest))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The leaves of a tree, in `tree_map`'s order."""
    out = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves):
    """A tree of `tree`'s structure holding `leaves` in order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def _decl_leaf(d):
    if not isinstance(d, Declared):
        raise TypeError(f"not a parameter declaration: {type(d)}")
    return d


def materialize(gen: torch.Generator, tree):
    """The tree with every `Declared` leaf drawn from `gen`, in the
    order of a depth-first walk (dict keys sorted), on `gen`'s device."""
    return tree_map(lambda d: _init_leaf(gen, _decl_leaf(d), gen.device),
                    tree)


def axes_of(tree):
    """The tree of each leaf's logical axes (a tuple of names), as the
    reference's `axes_of`: what `sharding.rules.tree_specs` maps to
    specs."""
    return tree_map(lambda d: _decl_leaf(d).axes, tree)


def param_count(tree) -> int:
    return sum(int(math.prod(d.shape)) for d in tree_leaves(tree))


def param_bytes(tree) -> int:
    return sum(int(math.prod(d.shape)) * d.dtype.itemsize
               for d in tree_leaves(tree))
