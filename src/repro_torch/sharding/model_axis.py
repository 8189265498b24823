"""The model mesh axis: its process group and the collectives that split
a layer across it.

The reference places its parameters on a ("data", "model") mesh by
their logical axes (`sharding/rules.py`) and XLA inserts the collectives
of the model axis. The port holds each rank's block explicitly
(`shard_params`) and runs those collectives itself, as conjugate pairs
of autograd functions (the tensor-parallel layers of Megatron-LM):

  copy_to      identity forward, all-reduce SUM backward: where a
               replicated tensor enters a computation split over the
               ranks (each rank's gradient is a part of the whole);
  reduce_from  all-reduce SUM forward, identity backward: where the
               ranks' partial results are summed back into one
               replicated tensor;
  gather_from  all-gather forward, this rank's slice backward: where
               split results are joined into a replicated tensor;
  scatter_to   this rank's slice forward, all-gather backward: where a
               replicated tensor is cut (the sequence-sharded core).

`all_reduce_max` (no gradient) serves the maxima of a vocab-parallel
softmax and of the flash-decode merge. These use `all_reduce` (SUM,
MAX) and `all_gather_into_tensor` only. A `ModelAxis` of one rank issues
no collective: every function returns its input, and the layers take their
one-device path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Optional

import torch
import torch.distributed as dist

from repro_torch.models.module import axes_of, tree_map
from repro_torch.sharding.rules import (LogicalRules, default_rules,
                                        mesh_shape, shard_tree, tree_specs)


@dataclasses.dataclass(frozen=True)
class ModelAxis:
    """The model axis as one rank sees it: the process group of the
    ranks that share this rank's other coordinates (None for one rank),
    this rank's coordinate on it and its size.

    Three more axes of a vehicle's ranks may ride along, each itself a
    `ModelAxis` of its group (`sharding/fsdp.py`): `fsdp`, the axis the
    parameters' `embed` dims are split over and gathered on use (the
    reference's `fsdp_rules`); `batch`, the axis the vehicle's batch is
    split over in training (the data axis under FSDP, the model axis
    under the `dp` profile), over which the gradients are averaged; and
    `cache`, the axis the decode caches' sequence dim (`cache_seq`) is
    cut over where the parameters are replicated (the model axis under
    the `dp` profile: every rank holds all heads and S/n slots, and the
    flash-decode merges the ranks' partial softmax statistics)."""

    group: Optional[Any]
    rank: int
    size: int
    fsdp: Optional["ModelAxis"] = None
    batch: Optional["ModelAxis"] = None
    cache: Optional["ModelAxis"] = None

    @property
    def seq(self) -> "ModelAxis":
        """The axis a decode cache's sequence dim is cut over: `cache`
        where it is set, else this axis (the heads' split and the
        cache's go together)."""
        return self if self.cache is None else self.cache

    def block(self, n: int) -> tuple:
        """(start, length) of this rank's block of a dim of `n`."""
        if n % self.size:
            raise ValueError(f"a dim of {n} does not split over a model "
                             f"axis of {self.size}")
        b = n // self.size
        return self.rank * b, b


LOCAL = ModelAxis(None, 0, 1)


def model_axis(mesh) -> ModelAxis:
    """The `ModelAxis` of `mesh`: None, a `ModelAxis` (returned as is),
    an `{axis: size}` mapping without a model axis larger than 1, or a
    `DeviceMesh` over the initialized world."""
    if mesh is None:
        return LOCAL
    if isinstance(mesh, ModelAxis):
        return mesh
    n = mesh_shape(mesh).get("model", 1)
    if n == 1:
        return LOCAL
    if isinstance(mesh, Mapping):
        raise ValueError(f"a model axis of {n} needs a DeviceMesh over an "
                         f"initialized world, not the mapping {dict(mesh)}")
    return mesh_axis(mesh, "model")


def shard_params(mesh, params, decl, rules: Optional[LogicalRules] = None):
    """This rank's block of the whole parameter tree `params` (or of a
    cache), cut along each dim whose logical axis in `decl` (the tree of
    `Declared` leaves it was materialised from) maps to a mesh axis of
    more than one rank under `rules` (`default_rules()`: heads, mlp,
    experts, vocab, row_in, row_head_dim, cache_seq, ... over `model`).
    `mesh` None (one device) returns `params`."""
    if mesh is None:
        return params
    rules = default_rules() if rules is None else rules
    return shard_tree(mesh, tree_specs(rules, axes_of(decl)), params)


def gather_params(mesh, params, decl, rules: Optional[LogicalRules] = None):
    """The whole tree from every rank's block (`shard_params`'s inverse
    for parameters): each leaf all-gathered over the model axis along
    its dims that map to it, and under `fsdp_rules` over the data axis
    along its `embed` dim. A collective: every rank of those groups
    calls it."""
    rules = default_rules() if rules is None else rules
    ax = model_axis(mesh)
    data = mesh_axis(mesh, "data") if rules.mesh_axis("embed") == "data" \
        and mesh_shape(mesh).get("data", 1) > 1 else LOCAL

    def whole(x, d):
        for dim, a in enumerate(d.axes):
            if ax.size > 1 and rules.mesh_axis(a) == "model":
                x = _all_gather(x, ax, dim)
            elif data.size > 1 and a == "embed":
                x = _all_gather(x, data, dim)
        return x
    return tree_map(whole, params, decl)


def mesh_axis(mesh, name: str) -> ModelAxis:
    """The axis `name` of a `DeviceMesh` as this rank sees it (its group,
    this rank's coordinate and its size), as a `ModelAxis`."""
    n = mesh_shape(mesh)[name]
    if n == 1:
        return LOCAL
    return ModelAxis(mesh.get_group(name), mesh.get_local_rank(name), n)


# ---------------------------------------------------------------------------
# the collectives
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, ax: ModelAxis, op=dist.ReduceOp.SUM):
    y = x.contiguous().clone()
    dist.all_reduce(y, op=op, group=ax.group)
    return y


# the tensor forms of the collectives under the name this torch gives them
# (newer releases rename them and warn on the old names)
_all_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_from = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _all_gather(x: torch.Tensor, ax: ModelAxis, dim: int):
    """The ranks' `x` joined along `dim`, in rank order: one
    `all_gather_into_tensor` along dim 0, moved to `dim`."""
    x = x.contiguous()
    out = x.new_empty((ax.size * x.shape[0],) + tuple(x.shape[1:]))
    _all_gather_into(out, x, group=ax.group)
    if dim == 0:
        return out
    parts = out.view(ax.size, *x.shape).movedim(0, dim)
    return parts.reshape(*x.shape[:dim], ax.size * x.shape[dim],
                         *x.shape[dim + 1:])


def _slice(x: torch.Tensor, ax: ModelAxis, dim: int):
    start, b = ax.block(x.shape[dim])
    return x.narrow(dim, start, b).contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.ax), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        return _all_reduce(x, ax)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _all_gather(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.ax, ctx.dim), None, None


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax, dim):
        ctx.ax, ctx.dim = ax, dim
        return _slice(x, ax, dim)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.ax, ctx.dim), None, None


def copy_to(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    return x if ax.size == 1 else _CopyTo.apply(x, ax)


def reduce_from(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    return x if ax.size == 1 else _ReduceFrom.apply(x, ax)


def gather_from(x: torch.Tensor, ax: ModelAxis, dim: int) -> torch.Tensor:
    return x if ax.size == 1 else _GatherFrom.apply(x, ax, dim % x.ndim)


def scatter_to(x: torch.Tensor, ax: ModelAxis, dim: int) -> torch.Tensor:
    return x if ax.size == 1 else _ScatterTo.apply(x, ax, dim % x.ndim)


def all_reduce_max(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """The elementwise maximum over the ranks, without a gradient."""
    x = x.detach()
    return x if ax.size == 1 else _all_reduce(x, ax, dist.ReduceOp.MAX)


def all_reduce_sum(x: torch.Tensor, ax: ModelAxis) -> torch.Tensor:
    """The elementwise sum over the ranks, without a gradient (decode)."""
    return x if ax.size == 1 else _all_reduce(x, ax)
