"""Logical-axis -> mesh-axis sharding rules (t5x-style).

Port of `repro/sharding/rules.py` (plain Python, copied). Every parameter
and activation is annotated with logical axis names ("vocab", "embed",
"heads", "mlp", "cell", ...); a `LogicalRules` table maps them to mesh
axes ("data", "model", "pod", or None = replicated).

A spec is a plain tuple with one entry per tensor dim: None, a mesh axis
name, or a tuple of names (the dim splits over their product), the
port's counterpart of a `PartitionSpec`. `shard_tree` cuts each tensor
of a tree to this rank's block under its spec, the counterpart of a
`device_put` under a `NamedSharding`: the port holds explicit per-rank
local tensors and runs the collectives itself
(`repro_torch.sharding.mesh_exec`).

A mesh is a `torch.distributed.device_mesh.DeviceMesh` or, where only
its geometry matters, an `{axis: size}` mapping (`mesh_shape`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


@dataclasses.dataclass(frozen=True)
class LogicalRules:
    """Mapping from logical axis name to mesh axis (or None = replicate)."""

    table: Mapping[str, Optional[str]]

    def mesh_axis(self, logical: Optional[str]) -> Optional[str]:
        if logical is None:
            return None
        if logical not in self.table:
            raise KeyError(f"unknown logical axis {logical!r}")
        return self.table[logical]

    def spec(self, logical_axes: Sequence[Optional[str]]) -> Spec:
        return tuple(self.mesh_axis(a) for a in logical_axes)

    def override(self, **kv: Optional[str]) -> "LogicalRules":
        t = dict(self.table)
        t.update(kv)
        return LogicalRules(t)


# Batch-like axes map to the data axis (and to the pod axis too under
# `default_rules(multi_pod=True)`, which folds ("pod", "data") into one
# spec entry).
_DEFAULT_TABLE: Mapping[str, Optional[str]] = {
    # activations
    "batch": "data",
    "vehicle": "data",     # per-vehicle param replicas in the VFL round
    "round": None,         # fused-rollout round axis: looped, never sharded
    "client": "data",      # padded [C, n_max, ...] client shards
    "cell": "data",        # FleetState [B, N, ...] leading RSU-cell axis
    "fleet": None,         # per-cell vehicle pool slot axis: the
    #                        exchange permutes the flat cell x fleet
    #                        layout, so it must stay whole per shard
    "prefix": None,        # P4 warm-start table [.., U, 1+U] candidate
    "power": None,         # axes (FleetState.p4_tab / SchedulerCarry.p4):
    #                        per-vehicle payload, never sharded; the
    #                        table rides the exchange with its vehicle
    "seq": None,
    "cache_seq": "model",   # decode caches: sequence dim sharded
    # params
    "vocab": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": None,      # replicated: kv head counts rarely divide TP
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "layers": None,        # stacked leading axis
    "ssm_heads": "model",
    "ssm_state": None,
    "conv_k": None,
    "frames": None,
    "patches": None,
    "classes": None,
    "row_in": "model",        # row-parallel TP: shard the input dim
    "row_head_dim": "model",  # row TP: shard head_dim on the O-projection
    "out": None,
}


def fsdp_rules(multi_pod: bool = False) -> LogicalRules:
    """Variant for archs too large for per-vehicle replicas: also shard
    the d_model ("embed") param dim over the data axis (ZeRO-style)."""
    return default_rules(multi_pod).override(embed="data")


def default_rules(multi_pod: bool = False) -> LogicalRules:
    table = dict(_DEFAULT_TABLE)
    if multi_pod:
        # batch-like axes shard over both pod and data axes
        table["batch"] = ("pod", "data")  # type: ignore[assignment]
        table["vehicle"] = ("pod", "data")  # type: ignore[assignment]
    return LogicalRules(table)


def spec_for(rules: LogicalRules, logical_axes: Sequence[Optional[str]]
             ) -> Spec:
    entries = []
    for a in logical_axes:
        if a is not None and a not in rules.table:
            raise KeyError(f"unknown logical axis {a!r}")
        entries.append(rules.table.get(a) if a is not None else None)
    return tuple(entries)


def tree_specs(rules: LogicalRules, axes_tree):
    """Map a tree (dicts, lists) of logical-axes tuples to a tree of
    specs."""
    if isinstance(axes_tree, dict):
        return {k: tree_specs(rules, v) for k, v in axes_tree.items()}
    if isinstance(axes_tree, list):
        return [tree_specs(rules, v) for v in axes_tree]
    return spec_for(rules, axes_tree)


def fused_batch_spec(rules: LogicalRules, ndim: int) -> Spec:
    """Spec of a fused-rollout batch leaf `[R, V, b, ...]`: the round
    axis is looped (replicated), the vehicle axis shards over the data
    axes, and each vehicle's local samples stay with its replica."""
    return (rules.mesh_axis("round"), rules.mesh_axis("vehicle"),
            *([None] * max(ndim - 2, 0)))


def fleet_spec(rules: LogicalRules, ndim: int) -> Spec:
    """Spec of a persistent-fleet leaf `[B, N, ...]`: the cell axis
    shards over the data axes, the per-cell vehicle slots and any
    trailing dims stay local. The P4 warm-start table
    `FleetState.p4_tab [B, N, U, 1+U]` is such a leaf (ndim 4): its
    trailing axes are per-vehicle payload and travel with the vehicle
    through the exchange.

    Contract of the cross-cell exchange
    (`repro_torch.core.scenario.exchange_fleet`) under a sharded cell
    axis: the exchange is a permutation of the flat [B * N] vehicle
    layout whose destinations are data-dependent (the nearest RSU), so
    any rank's vehicle may land in any other rank's cells
    (`mesh_exec.allgather_exchange` runs it). The nearest-RSU distance
    matrix [B * N, B] needs every RSU position on every rank: the
    reference replicates `FleetState.rsu_xy [B, 2]` (spec `()`); the
    port keeps each rank's rows, as for every other fleet leaf, and the
    exchange gathers them with the fleet."""
    return (rules.mesh_axis("cell"), rules.mesh_axis("fleet"),
            *([None] * max(ndim - 2, 0)))


def mesh_shape(mesh) -> Dict[str, int]:
    """`{axis: size}` of a `DeviceMesh` (or of a mapping, as given)."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_axis_names(mesh) -> Tuple[str, ...]:
    """All mesh axes that carry batch/vehicle parallelism."""
    names = tuple(mesh_shape(mesh))
    return tuple(n for n in names if n in ("pod", "data")) or (names[0],)


def num_vehicles(mesh) -> int:
    shape = mesh_shape(mesh)
    n = 1
    for name in data_axis_names(mesh):
        n *= shape[name]
    return n


def _axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_tree(mesh, specs, tree):
    """Each tensor of `tree` (dicts, lists, tuples; None stays None) cut
    to this rank's block under its spec in `specs` (a tree of dicts and
    lists like `tree`'s, or one spec for every leaf below it): along
    each dim whose entry names mesh axes of more than one rank, the
    block of the rank's coordinate on those axes (the first axis
    major). The block may share storage with the leaf."""
    shape = mesh_shape(mesh)

    def cut(x: torch.Tensor, spec: Spec) -> torch.Tensor:
        if len(spec) > x.ndim:
            raise ValueError(f"spec {spec} has more entries than the "
                             f"{x.ndim} dims of a tensor {tuple(x.shape)}")
        for dim, entry in enumerate(spec):
            axes = _axes(entry)
            n = math.prod(shape[ax] for ax in axes)
            if n == 1:
                continue
            idx = 0
            for ax in axes:
                idx = idx * shape[ax] + mesh.get_local_rank(ax)
            if x.shape[dim] % n:
                raise ValueError(
                    f"dim {dim} of size {x.shape[dim]} does not split "
                    f"evenly over the {n} ranks of {_axes(entry)}")
            b = x.shape[dim] // n
            x = x.narrow(dim, idx * b, b)
        return x.contiguous()

    def walk(t, s):
        if t is None:
            return None
        if isinstance(t, dict):
            return {k: walk(v, s[k] if isinstance(s, dict) else s)
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, s[i] if isinstance(s, list) else s)
                           for i, v in enumerate(t))
        return cut(t, s)

    return walk(tree, specs)
