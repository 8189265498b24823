"""The port's logical sharding rules (`repro_torch.sharding.rules`)
against the reference's `repro.sharding.rules`: every logical axis of
the table under each rule set, and the counterparts of
`tests/test_sharding_rules.py`. A port spec is a plain tuple; the
reference's `PartitionSpec` is a tuple of the same entries. Meshes here
are `{axis: size}` mappings: no process group is needed for the
geometry."""
import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from repro.sharding import rules as J
from repro_torch.sharding import rules as R
from repro_torch.sharding.rules import (data_axis_names, default_rules,
                                        fleet_spec, fsdp_rules,
                                        fused_batch_spec, num_vehicles,
                                        spec_for, tree_specs)

RULE_SETS = {
    "default": (R.default_rules(), J.default_rules()),
    "multi_pod": (R.default_rules(multi_pod=True),
                  J.default_rules(multi_pod=True)),
    "fsdp": (R.fsdp_rules(), J.fsdp_rules()),
    "fsdp_multi_pod": (R.fsdp_rules(True), J.fsdp_rules(True)),
    "override": (R.default_rules().override(seq="model", vocab=None),
                 J.default_rules().override(seq="model", vocab=None)),
}


@pytest.mark.parametrize("which", sorted(RULE_SETS))
def test_every_logical_axis_maps_as_the_reference(which):
    ours, ref = RULE_SETS[which]
    assert dict(ours.table) == dict(ref.table)
    assert list(ours.table) == list(ref.table)
    for axis in ref.table:
        assert ours.mesh_axis(axis) == ref.mesh_axis(axis), axis
        assert spec_for(ours, (axis, None)) == tuple(
            J.spec_for(ref, (axis, None))), axis
        assert ours.spec((None, axis)) == tuple(ref.spec((None, axis))), axis
    for nd in (1, 2, 3, 4):
        assert fleet_spec(ours, nd) == tuple(J.fleet_spec(ref, nd))
        assert fused_batch_spec(ours, nd) == tuple(
            J.fused_batch_spec(ref, nd))


def _jmesh(*names):
    devs = np.asarray(jax.devices()[:1]).reshape((1,) * len(names))
    return Mesh(devs, names)


def _mesh(*names, **sizes):
    return {n: sizes.get(n, 1) for n in names}


# ---- mesh geometry ------------------------------------------------------

def test_data_axis_names_1_2_3_axes():
    for names in (("data",), ("pod", "data"), ("pod", "data", "model"),
                  ("data", "model")):
        assert data_axis_names(_mesh(*names)) == J.data_axis_names(
            _jmesh(*names))
    assert data_axis_names(_mesh("pod", "data", "model")) == ("pod", "data")


def test_data_axis_names_fallback_is_first_axis():
    assert data_axis_names(_mesh("model")) == ("model",)
    assert data_axis_names(_mesh("x", "y")) == ("x",)
    assert J.data_axis_names(_jmesh("x", "y")) == ("x",)


def test_num_vehicles_products():
    assert num_vehicles(_mesh("data")) == 1
    assert num_vehicles(_mesh("pod", "data", "model")) == 1
    assert num_vehicles(_mesh("data", "model", data=4, model=2)) == 4
    assert num_vehicles(_mesh("pod", "data", "model", pod=2, data=4,
                              model=8)) == 8
    assert num_vehicles(_mesh("model", model=3)) == 3


# ---- rollout specs ------------------------------------------------------

def test_fleet_spec_shapes():
    r = default_rules()
    assert fleet_spec(r, 2) == ("data", None)
    assert fleet_spec(r, 4) == ("data", None, None, None)


def test_fused_batch_spec_shapes():
    r = default_rules()
    assert fused_batch_spec(r, 3) == (None, "data", None)
    assert fused_batch_spec(r, 4) == (None, "data", None, None)
    assert fused_batch_spec(r, 2) == (None, "data")


def test_multi_pod_rules_fold_pod_into_batch_axes():
    r = default_rules(multi_pod=True)
    assert fused_batch_spec(r, 3) == (None, ("pod", "data"), None)
    assert fleet_spec(r, 2) == ("data", None)


def test_fsdp_rules_shard_embed_only():
    r = fsdp_rules()
    assert spec_for(r, ("embed",)) == ("data",)
    assert spec_for(default_rules(), ("embed",)) == (None,)
    assert fleet_spec(r, 2) == fleet_spec(default_rules(), 2)


def test_spec_for_unknown_axis_raises():
    with pytest.raises(KeyError):
        spec_for(default_rules(), ("no_such_axis",))
    with pytest.raises(KeyError):
        default_rules().mesh_axis("no_such_axis")


def test_tree_specs_maps_leaves():
    r = default_rules()
    tree = {"fleet": ("cell", "fleet"),
            "tab": ("cell", "fleet", "prefix", "power")}
    specs = tree_specs(r, tree)
    assert specs["fleet"] == ("data", None)
    assert specs["tab"] == ("data", None, None, None)
    ref = J.tree_specs(J.default_rules(), tree)
    assert {k: tuple(v) for k, v in ref.items()} == specs
    assert tree_specs(r, [("vehicle", None)]) == [("data", None)]


class _FakeMesh:
    """A DeviceMesh's geometry and this rank's coordinates, for
    `shard_tree` without a process group."""

    def __init__(self, shape, coords):
        self.mesh_dim_names = tuple(shape)
        self.mesh = np.zeros(tuple(shape.values()))
        self.coords = coords

    def get_local_rank(self, axis):
        return self.coords[axis]


def test_shard_tree_cuts_each_leaf_to_the_rank_block():
    import torch
    x = torch.arange(4 * 6 * 2).reshape(4, 6, 2)
    mesh = _FakeMesh({"pod": 2, "data": 3, "model": 1},
                     {"pod": 1, "data": 2, "model": 0})
    got = R.shard_tree(mesh, {"a": ("pod", "data"), "b": (None,
                                                          ("pod", "data"))},
                       {"a": x, "b": x})
    assert torch.equal(got["a"], x[2:4, 4:6])
    assert torch.equal(got["b"], x[:, 5:6])          # block 1 * 3 + 2 of 6
    one = R.shard_tree(mesh, ("model",), [x, None])
    assert torch.equal(one[0], x) and one[1] is None
    with pytest.raises(ValueError, match="evenly"):
        R.shard_tree(mesh, (("pod", "data"),), x)
