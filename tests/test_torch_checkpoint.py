"""The port's npz checkpoint (`repro_torch.checkpoint.np_ckpt`) against
the reference's (`repro.checkpoint.np_ckpt`): the same keys (leaf paths
joined by "/" in the reference's flatten order), dtype strings, bytes
and meta JSON; bf16 leaves as their raw 2-byte payload (`|V2`), read
back bit for bit, the reference's own bf16 files included (which the
reference's `load_checkpoint` cannot read: ROADMAP queue 3); and the
driver's `--ckpt`."""
import json
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as j_load
from repro.checkpoint import save_checkpoint as j_save
from repro_torch.checkpoint import load_checkpoint, save_checkpoint
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import train as train_mod
from repro_torch.models import engine
from repro_torch.models.module import materialize, tree_leaves, tree_map


def _tree(seed):
    """A nested dict/list tree of bf16, fp32 and int32 numpy leaves."""
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return {"embed": f(5, 4).astype(ml_dtypes.bfloat16),
            "blocks": [{"w": f(4, 4).astype(ml_dtypes.bfloat16),
                        "b": f(4)},
                       {"w": f(4, 4).astype(ml_dtypes.bfloat16),
                        "b": f(4)}],
            "norm": {"scale": f(4), "step": np.arange(3, dtype=np.int32)},
            "head": f(4, 7).astype(ml_dtypes.bfloat16)}


def _torch(tree):
    def leaf(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())
    return tree_map(leaf, tree)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """The raw bits of a float tensor (NaNs compare equal)."""
    return x.view({torch.bfloat16: torch.int16,
                   torch.float32: torch.int32}.get(x.dtype, x.dtype))


def _assert_bitwise(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(_bits(x), _bits(y))


def test_round_trip_of_nested_bf16_and_fp32_trees_is_bit_for_bit(tmp_path):
    params = _torch(_tree(0))
    params["blocks"][0]["b"][0] = float("nan")
    path = save_checkpoint(str(tmp_path / "sub" / "ck.npz"), params,
                           meta={"arch": "x"}, step=3)
    assert path.endswith("ck.npz")
    like = _torch(_tree(1))
    got = load_checkpoint(path, like)
    _assert_bitwise(got, params)
    assert json.loads((tmp_path / "sub" / "ck.meta.json").read_text()) == \
        {"arch": "x", "step": 3}
    # a path without the suffix gains it, as the reference's does
    save_checkpoint(str(tmp_path / "plain"), params)
    _assert_bitwise(load_checkpoint(str(tmp_path / "plain"), like), params)


def test_file_is_the_reference_file(tmp_path):
    """Keys, dtype strings (`|V2` for bf16), shapes, bytes and the meta
    JSON as the reference writes them from the same values."""
    tree = _tree(2)
    j_save(str(tmp_path / "ref.npz"), jax.tree.map(jnp.asarray, tree),
           meta={"arch": "qwen3"}, step=7)
    save_checkpoint(str(tmp_path / "port.npz"), _torch(tree),
                    meta={"arch": "qwen3"}, step=7)
    with np.load(tmp_path / "ref.npz") as r, \
            np.load(tmp_path / "port.npz") as p:
        assert list(p.keys()) == list(r.keys())
        assert "blocks/1/w" in r.keys()
        for k in r.keys():
            assert p[k].dtype.str == r[k].dtype.str, k
            assert p[k].shape == r[k].shape, k
            assert p[k].tobytes() == r[k].tobytes(), k
        assert r["embed"].dtype.str == "|V2"
    assert (tmp_path / "port.meta.json").read_text() == \
        (tmp_path / "ref.meta.json").read_text()


def test_port_reads_the_reference_bf16_file_which_the_reference_cannot(
        tmp_path):
    """The reference writes bf16 leaves as `|V2`; its own loader's cast
    back to bf16 raises (ROADMAP queue 3). The port reads the file bit for
    bit. Should the reference's loader be fixed, it must then agree with
    the port bit for bit."""
    tree = _tree(3)
    path = str(tmp_path / "ref.npz")
    j_save(path, jax.tree.map(jnp.asarray, tree), step=1)
    got = load_checkpoint(path, _torch(_tree(4)))
    _assert_bitwise(got, _torch(tree))
    try:
        ref = j_load(path, jax.tree.map(jnp.asarray, _tree(4)))
    except ValueError as e:               # the fault as it stands
        assert "cast" in str(e)
    else:
        _assert_bitwise(got, _torch(jax.tree.map(np.asarray, ref)))
    # fp32 leaves round-trip through the reference's loader
    f32 = {"a": np.arange(6, dtype=np.float32).reshape(2, 3)}
    j_save(str(tmp_path / "f32.npz"), f32)
    np.testing.assert_array_equal(
        np.asarray(j_load(str(tmp_path / "f32.npz"), f32)["a"]), f32["a"])


def test_train_main_saves_a_checkpoint_that_loads(tmp_path, capsys):
    """`--ckpt`: vehicle 0's params after the last round, with the
    driver's meta, restored bit for bit into the model's template."""
    ck = str(tmp_path / "qwen3.npz")
    assert train_mod.main(["--device", "cpu", "--rounds", "1",
                           "--vehicles", "2", "--batch-per-vehicle", "2",
                           "--seq", "32", "--ckpt", ck]) == 0
    assert re.search(r"saved .*qwen3\.npz", capsys.readouterr().out)
    cfg = get_smoke_config("qwen3-32b").replace(num_vehicles=2)
    like = materialize(torch.Generator().manual_seed(9),
                       engine.model_decl(cfg, "head"))
    got = load_checkpoint(ck, like)
    assert [x.dtype for x in tree_leaves(got)] == \
        [x.dtype for x in tree_leaves(like)]
    assert any(x.dtype == torch.bfloat16 for x in tree_leaves(got))
    assert all(torch.isfinite(x.float()).all() for x in tree_leaves(got))
    save_checkpoint(str(tmp_path / "again.npz"), got)
    _assert_bitwise(load_checkpoint(str(tmp_path / "again.npz"), like), got)
    assert json.loads((tmp_path / "qwen3.meta.json").read_text()) == {
        "arch": cfg.name, "step": 1}


def test_missing_leaf_raises(tmp_path):
    save_checkpoint(str(tmp_path / "a.npz"), {"x": torch.zeros(2)})
    with pytest.raises(KeyError):
        load_checkpoint(str(tmp_path / "a.npz"), {"y": torch.zeros(2)})
