"""The port's CNN, its initialisation, data helpers and FedAvg against the
reference.

Weights come from the reference's `materialize` and are carried over with
`cnn_params_from_jax`, so both sides compute the same function. fp32 on
both sides; convolutions sum in another order (oneDNN vs XLA), so logits
and losses agree to rtol 1e-5 and gradients to rtol 1e-4 (their relative
error grows through the backward pass), each with an atol of 1e-6 of the
tensor's scale for entries that cancel to ~0.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.synthetic import partition_labels as j_partition_labels
from repro.fl.engine import fedavg_apply as j_fedavg_apply
from repro.fl.engine import fedavg_grads as j_fedavg_grads
from repro.models import layers as jlayers
from repro.models.cnn import cnn_apply as j_cnn_apply
from repro.models.cnn import cnn_decl as j_cnn_decl
from repro.models.cnn import cnn_loss as j_cnn_loss
from repro.models.module import materialize as j_materialize
from repro_torch.data.synthetic import cifar_like_dataset, partition_labels
from repro_torch.fl.engine import client_grads, fedavg_apply, fedavg_grads
from repro_torch.models import layers
from repro_torch.models.cnn import (CNN, cnn_accuracy, cnn_apply, cnn_decl,
                                    cnn_loss, cnn_params_from_jax,
                                    init_cnn)
from repro_torch.models.module import materialize, truncated_normal
from torch_port_util import tn, tt


def _close(a, b, rtol):
    a, b = tn(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=1e-6 * max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def jparams():
    return j_materialize(jax.random.key(0), j_cnn_decl())


def _images(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (n, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, n).astype(np.int32))


def _jtree_to_torch(tree):
    return {"convs": [{k: tt(v) for k, v in p.items()}
                      for p in tree["convs"]],
            "head": {k: tt(v) for k, v in tree["head"].items()}}


def test_cnn_logits_and_loss_match_reference(jparams):
    """Also pins the flatten: the head's 2048 rows are in the reference's
    NHWC (h, w, c) order, so carried-over head weights see the same
    features."""
    x, y = _images(5, 0)
    params = cnn_params_from_jax(jparams)
    _close(cnn_apply(params, tt(x)), j_cnn_apply(jparams, jnp.asarray(x)),
           rtol=1e-5)
    batch = {"x": tt(x), "y": tt(y, torch.int64)}
    _close(cnn_loss(params, batch),
           j_cnn_loss(jparams, {"x": jnp.asarray(x), "y": jnp.asarray(y)}),
           rtol=1e-5)
    acc = float(cnn_accuracy(params, batch))
    assert 0.0 <= acc <= 1.0


def test_cnn_module_carries_the_same_function(jparams):
    model = CNN()
    model.load_state_dict(cnn_params_from_jax(jparams))
    x, _ = _images(2, 1)
    with torch.no_grad():
        _close(model(tt(x)), j_cnn_apply(jparams, jnp.asarray(x)), 1e-5)
    assert [k for k, _ in model.named_parameters()] == \
        list(cnn_params_from_jax(jparams))
    # tensors in the reference layout convert the same as arrays
    t = cnn_params_from_jax(_jtree_to_torch(jparams))
    for k, v in cnn_params_from_jax(jparams).items():
        assert torch.equal(t[k], v)


def test_per_client_grads_match_reference(jparams):
    S, bs = 3, 4
    x, y = _images(S * bs, 2)
    xs, ys = x.reshape(S, bs, 32, 32, 3), y.reshape(S, bs)
    ref = jax.vmap(jax.grad(j_cnn_loss), in_axes=(None, 0))(
        jparams, {"x": jnp.asarray(xs), "y": jnp.asarray(ys)})
    ours = client_grads(cnn_loss, cnn_params_from_jax(jparams),
                        {"x": tt(xs), "y": tt(ys, torch.int64)})
    for i, p in enumerate(ref["convs"]):
        _close(ours[f"convs.{i}.weight"],
               np.asarray(p["w"]).transpose(0, 4, 3, 1, 2), 1e-4)
        _close(ours[f"convs.{i}.bias"], p["b"], 1e-4)
    _close(ours["head.weight"], np.asarray(ref["head"]["w"])
           .transpose(0, 2, 1), 1e-4)
    _close(ours["head.bias"], ref["head"]["b"], 1e-4)


def _grad_stack(S, seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(0, 1, (S, 4, 3)).astype(np.float32),
            "b": rng.normal(0, 1, (S, 3)).astype(np.float32)}


@pytest.mark.parametrize("case", ["mixed", "nan_zero_weight",
                                  "all_failed", "clipped"])
def test_fedavg_matches_reference(case):
    """Includes a zero-weight client whose grads are NaN (hard-zeroed
    before the sum) and the all-failed mask (the model stays put)."""
    S = 4
    g = _grad_stack(S, 3)
    mask = np.array([1, 0, 1, 1], np.float32)
    weights = np.array([10, 5, 3, 7], np.float32)
    if case == "nan_zero_weight":
        weights[2] = 0.0
        g["w"][2] = np.nan
        g["b"][1] = np.nan                         # masked-out client
    if case == "all_failed":
        mask[:] = 0
    if case == "clipped":
        g = {k: v * 100 for k, v in g.items()}
    params = {"w": np.ones((4, 3), np.float32),
              "b": np.zeros(3, np.float32)}
    jg = {k: jnp.asarray(v) for k, v in g.items()}
    avg, scale = fedavg_grads({k: tt(v) for k, v in g.items()}, tt(mask),
                              tt(weights))
    javg, jscale = j_fedavg_grads(jg, jnp.asarray(mask),
                                  jnp.asarray(weights))
    for k in g:
        _close(avg[k], javg[k], 1e-6)
    np.testing.assert_allclose(float(scale), float(jscale), rtol=1e-6)
    new, _ = fedavg_apply({k: tt(v) for k, v in params.items()},
                          {k: tt(v) for k, v in g.items()}, tt(mask),
                          tt(weights), lr=0.07)
    jnew, _ = j_fedavg_apply({k: jnp.asarray(v) for k, v in params.items()},
                             jg, jnp.asarray(mask), jnp.asarray(weights),
                             lr=0.07)
    for k in params:
        _close(new[k], jnew[k], 1e-6)
        assert np.isfinite(tn(new[k])).all()
    if case == "all_failed":
        for k in params:
            np.testing.assert_array_equal(tn(new[k]), params[k])
    if case == "clipped":
        assert float(scale) < 1.0


def test_init_matches_reference_distribution():
    """He-normal convs, fan-in-scaled truncated-normal head, zero
    biases: the port's draws have the reference's scales."""
    model = init_cnn(torch.Generator().manual_seed(0))
    p = dict(model.named_parameters())
    for i, (ci, _) in enumerate(((3, 32), (32, 32), (32, 64), (64, 64),
                                 (64, 128), (128, 128))):
        std = float(p[f"convs.{i}.weight"].std())
        assert abs(std / np.sqrt(2.0 / (9 * ci)) - 1) < 0.15, (i, std)
        assert not p[f"convs.{i}.bias"].any()
    hw = p["head.weight"]
    assert hw.shape == (10, 2048)
    assert float(hw.abs().max()) <= 2.0 / np.sqrt(2048) + 1e-7
    # truncated N(0,1) on [-2, 2] has std 0.8796
    assert abs(float(hw.std()) * np.sqrt(2048) / 0.8796 - 1) < 0.05
    tree = materialize(torch.Generator().manual_seed(1), cnn_decl())
    assert tuple(tree["convs"][0]["w"].shape) == (3, 3, 3, 32)
    t = truncated_normal(torch.Generator().manual_seed(2), (20000,),
                         -2.0, 2.0, "cpu")
    assert float(t.abs().max()) <= 2.0 and abs(float(t.std()) - 0.8796) < 0.02


def test_softmax_cross_entropy_matches_reference():
    rng = np.random.default_rng(4)
    logits = rng.normal(0, 3, (6, 5, 10)).astype(np.float32)
    labels = rng.integers(0, 10, (6, 5))
    mask = (rng.random((6, 5)) < 0.6).astype(np.float32)
    for m in (None, mask):
        ours = layers.softmax_cross_entropy(
            tt(logits), tt(labels), None if m is None else tt(m))
        ref = jlayers.softmax_cross_entropy(
            jnp.asarray(logits), jnp.asarray(labels),
            None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6)


def test_cifar_like_dataset_and_partition():
    gen = torch.Generator().manual_seed(0)
    x, y = cifar_like_dataset(gen, 300, noise=0.8)
    assert x.shape == (300, 32, 32, 3) and x.dtype == torch.float32
    assert y.shape == (300,) and int(y.min()) >= 0 and int(y.max()) <= 9
    xt, _ = cifar_like_dataset(torch.Generator().manual_seed(1), 10, 0.8)
    assert not torch.equal(x[:10], xt)        # same prototypes, new draws
    labels = tn(y)
    for iid in (True, False):
        ours = partition_labels(labels, 12, iid=iid)
        ref = j_partition_labels(labels, 12, iid=iid)
        assert len(ours) == len(ref) == 12
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a, b)
    # non-iid: each client holds at most 2 classes
    for part in partition_labels(labels, 12, iid=False):
        assert len(np.unique(labels[part])) <= 2
