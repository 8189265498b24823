"""The FSDP axis of one-vehicle models, and the batch axis of a vehicle's
training.

The reference's `fsdp_rules` (`sharding/rules.py`) put the `embed` dim
of every parameter over the data axis for the configs too large for a
replica per vehicle (`num_vehicles == 1`: llama-3.2-vision-90b,
llama4-scout-17b-a16e), and XLA gathers each weight where it is used.
The port holds each rank's block (`model_axis.shard_params(mesh, params,
decl, fsdp_rules())`) and gathers it itself, sub-block by sub-block, as
ZeRO-3 does:

  gather    all-gather forward along the `embed` dim, reduce-scatter
            (SUM) backward; under `torch.no_grad` (serving) the forward
            alone. Inside a checkpointed sub-block the backward gathers
            again, so no gathered weight outlives its sub-block.

In training a vehicle's batch may be split over an axis of its ranks
(`ModelAxis.batch`: the data axis under FSDP, `specs.py`'s inner =
"data"; the model axis under the `dp` profile). Each rank's loss is the
mean over its rows, and `average_grads` makes each rank's gradient the
gradient of the whole batch's mean: a gathered leaf's reduce-scattered
gradient divided by the FSDP axis's size, every other leaf's all-reduced
over the batch axis and divided by its size. `batch_mean` averages a
statistic over the batch axis, with the gradient that convention needs
(the MoE load-balance loss, whose product of means is not the mean of
the ranks' products).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.models.module import Declared, tree_map
from repro_torch.sharding.model_axis import (LOCAL, ModelAxis, _all_gather,
                                             _reduce_scatter_from, mesh_axis,
                                             model_axis)
from repro_torch.sharding.rules import mesh_shape


def pick_layout(cfg) -> str:
    """How a config's parameters lie over a vehicle's ranks, the
    reference's `launch/specs.py:pick_rules`: "fsdp" for the one-vehicle
    configs (`fsdp_rules`: the `embed` dims over the data axis), "dp"
    under the `dp` profile (replicated, each vehicle's batch over the
    model axis), "model" otherwise (the model axis alone)."""
    if cfg.num_vehicles == 1:
        return "fsdp"
    if cfg.sharding_profile == "dp":
        return "dp"
    return "model"


def layout_axis(mesh, layout: str, split_batch: bool = False) -> ModelAxis:
    """The `ModelAxis` a step runs over on `mesh` under `layout`
    (`pick_layout`): the model axis; under "fsdp" with the data axis as
    its FSDP axis, and as its batch axis with `split_batch` (`specs.py`:
    inner = "data"); under "dp" no model split (the parameters
    replicated), the model axis as the decode caches' sequence axis
    (`ModelAxis.cache`: the reference's `cache_seq`, which its `dp`
    override leaves on the model axis) and, with `split_batch`, as the
    batch axis (inner = "model"). `mesh` None is one process."""
    if mesh is None:
        return LOCAL
    ax = model_axis(mesh)
    if layout == "fsdp" and mesh_shape(mesh).get("data", 1) > 1:
        data = mesh_axis(mesh, "data")
        return dataclasses.replace(ax, fsdp=data,
                                   batch=data if split_batch else None)
    if layout == "dp":
        return dataclasses.replace(
            LOCAL, batch=ax if split_batch and ax.size > 1 else None,
            cache=ax if ax.size > 1 else None)
    return ax


def embed_dims(decl, stacked: bool = False):
    """The tree of each declared leaf's `embed` dim (None where it has
    none); with `stacked`, of a repetition `a[r]` of a stacked leaf (its
    leading `layers` dim dropped)."""
    def dim(d: Declared) -> Optional[int]:
        if "embed" not in d.axes:
            return None
        return d.axes.index("embed") - (1 if stacked else 0)
    return tree_map(dim, decl)


def _reduce_scatter(g: torch.Tensor, ax: ModelAxis, dim: int):
    """This rank's block along `dim` of the sum of the ranks' `g`: one
    tensor reduce-scatter along dim 0, `dim` moved there and back."""
    x = g.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // ax.size,) + tuple(x.shape[1:]))
    _reduce_scatter_from(out, x, group=ax.group)
    return out.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.ax, ctx.dim), None, None


def gather(tree, dims, ax: ModelAxis):
    """`tree` (this rank's blocks) with every leaf of a dim in `dims`
    (`embed_dims`) gathered over `ax.fsdp`; the tree as it is when there
    is no FSDP axis."""
    fs = ax.fsdp
    if fs is None or fs.size == 1:
        return tree

    def one(x, d):
        return x if d is None else _Gather.apply(x, fs, d)
    return tree_map(one, tree, dims)


class _BatchMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return _mean(x, ax)

    @staticmethod
    def backward(ctx, g):
        return _mean(g, ctx.ax), None


def _mean(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    y = x.contiguous().clone()
    dist.all_reduce(y, group=ax.group)
    return y / ax.size


def batch_mean(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """The mean of `x` over `ax.batch`, each rank's statistic of its rows
    (x as it is without a batch axis). Forward and backward are each one
    all-reduce: every rank's loss uses the mean, so the gradient that
    reaches a rank's `x` is the mean of the ranks' gradients."""
    b = ax.batch
    return x if b is None or b.size == 1 else _BatchMean.apply(x, b)


def average_grads(grads, dims, ax: ModelAxis):
    """The gradient of the whole batch's mean loss, from each rank's
    gradient of its own rows' mean (`grads`, a list in `tree_leaves`
    order, `dims` the matching `embed_dims` leaves): gathered leaves
    divided by the FSDP axis's size, the rest all-reduced over the batch
    axis and divided by its size. A collective over both axes."""
    fs, b = ax.fsdp, ax.batch
    out = []
    for g, d in zip(grads, dims):
        if fs is not None and fs.size > 1 and d is not None:
            g = g / fs.size
        elif b is not None and b.size > 1:
            g = _mean(g, b)
        out.append(g)
    return out

