"""The port's Mamba2 path (`models/blocks.py:mamba_apply`, the hybrid
engine with its weight-tied "shared" block) and the VFL round of the
hybrid model against the reference, at zamba2-2.7b's smoke config
(d_model 256, d_inner 512, 8 SSM heads of 64, N 64, chunk 32; 4 attention
heads of 64; vocab 512) with 2 repetitions, so that the tied attention
and MLP are each used twice.

Weights are the reference's own init (`materialize` of its declaration,
unchanged) carried over with `llm_params_from_jax`; activations and tokens
are numpy draws fed to both sides. Tolerances, fp32 on both sides:

- one `mamba_apply`: the output within 1e-5 of its largest entry and
  each gradient within 3e-5 of its largest entry (sums in other orders;
  over six seeds the output differed by up to 2.3e-6 and the worst
  gradient by 2.9e-6 to 9.3e-6);
- the whole model (2 x (2 Mamba2, the tied attention, the tied MLP)) is
  ill-conditioned at this init: attention has no qk-norm and the
  reference's `scaled` init takes fan_in = H = 4 for `wq [d, H, Dh]`
  (`repro/models/module.py:52`), so the attention scores reach ~900,
  where fp32 softmax turns a one-ulp difference of a score into a
  visible change of the output. The reference itself, with every
  parameter moved by half an ulp (x (1 +- 6e-8)), moves its logits by up
  to 0.052 (scale 7.46; `test_reference_init_is_ill_conditioned`) and
  its gradients by up to 2.0e-2 of a leaf's norm (2.8e-2 of its largest
  entry), and how far the port lands from it depends on the draw: over
  six init seeds the logits differed by 1.7e-3 to 4.3e-2 and the worst
  leaf's gradient by 1.9e-3 to 5.3e-2 of its norm. The port is held
  within about twice the worst of that: the logits within 0.1 absolute
  (measured 0.019 at this seed), each leaf's gradient within 1e-1 of its
  norm (measured up to 3.1e-2), and so each leaf's update in a VFL
  round (measured up to 1.3e-2);
- where the conditioning does not enter (the tied leaves' gradient
  against the sum of the same block's gradients used untied), within
  1e-6 of the gradient's scale.

In bf16 (the config as it ships) the two sides round at other places:
`mamba_apply` is held within 5e-2 of the output's scale.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channel.mobility import ManhattanParams as JManhattan
from repro.channel.v2x import ChannelParams as JChannel
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke_config as j_get_smoke_config
from repro.core.lyapunov import VedsParams as JVeds
from repro.core.scenario import ScenarioParams as JScenario
from repro.core.scenario import make_round as j_make_round
from repro.core.veds import veds_round as j_veds_round
from repro.fl.vfl import _local_sgd as j_local_sgd
from repro.fl.vfl import lm_loss as j_lm_loss
from repro.models import blocks as jB
from repro.models import engine as jengine
from repro.models.module import Declared as JDeclared
from repro.models.module import materialize as j_materialize
from repro.models.module import param_count as j_param_count
from repro_torch.channel.v2x import ChannelParams
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.core.lyapunov import VedsParams
from repro_torch.fl import vfl
from repro_torch.kernels.fedavg_agg import ops as fedavg_ops
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.launch import train as train_mod
from repro_torch.models import blocks as B
from repro_torch.models import engine
from repro_torch.models.module import (param_count, tree_leaves, tree_map,
                                       tree_unflatten)
from torch_port_util import round_to_torch, tn, tt

ARCH = "zamba2-2.7b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
SEQ, BATCH = 64, 2
V, BPV, LR = 4, 2, 0.1


def _cfgs(**kw):
    return (j_get_smoke_config(ARCH).replace(**kw),
            get_smoke_config(ARCH).replace(**kw))


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port(tree):
    return engine.llm_params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _close_scaled(a, b, rel):
    """|a - b| <= rel * max|b|, entry by entry."""
    b = np.asarray(b, np.float32)
    np.testing.assert_allclose(tn(a).astype(np.float32), b,
                               atol=rel * float(np.abs(b).max()), rtol=0)


def _close_normwise(a, b, rel):
    """||a - b|| <= rel * ||b||."""
    a, b = tn(a).astype(np.float64), np.asarray(b, np.float64)
    err = np.linalg.norm(a - b) / np.linalg.norm(b)
    assert err <= rel, f"norm-wise relative error {err:.3e} > {rel}"


def _decl_summary(tree, is_port):
    if is_port:
        return [(d.shape, d.axes, d.init, d.scale, str(d.dtype).split(".")[-1])
                for d in tree_leaves(tree)]
    return [(d.shape, d.axes, d.init, d.scale, str(d.dtype))
            for d in jax.tree.leaves(tree, is_leaf=lambda x:
                                     isinstance(x, JDeclared))]


def _init(jcfg, decl_fn, seed):
    """The reference's init of a declaration, unchanged."""
    return j_materialize(jax.random.key(seed), decl_fn(jcfg, "head"))


# ---------------------------------------------------------------------------
# declarations and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True])
def test_hybrid_model_decl_matches_reference(full):
    """Same leaves in the same order (the empty blocks of the tied
    positions, the "shared" trees keyed "5"/"6" or "2"/"3", fp32 A_log,
    dt_bias and D beside bf16 matrices); at full width and depth zamba2
    has 67 leaves and 2,063,416,880 parameters."""
    if full:
        jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    else:
        jcfg, cfg = _cfgs(n_rep=2)
    jd, d = jengine.model_decl(jcfg, "head"), engine.model_decl(cfg, "head")
    assert _decl_summary(d, True) == _decl_summary(jd, False)
    assert param_count(d) == j_param_count(jd)
    n_pat = len(cfg.pattern)
    assert sorted(d["shared"]) == [str(n_pat - 2), str(n_pat - 1)]
    assert d["blocks"][-1] == {} and d["blocks"][-2] == {}
    if full:
        assert len(tree_leaves(d)) == 67
        assert param_count(d) == 2_063_416_880


def test_llm_params_from_jax_carries_the_hybrid_tree():
    jcfg = j_get_smoke_config(ARCH)
    jp = _init(jcfg, jengine.model_decl, 0)
    ours = _port(jp)
    assert ours["blocks"][2] == {} and ours["blocks"][3] == {}
    assert sorted(ours["shared"]) == ["2", "3"]
    assert ours["blocks"][0]["A_log"].dtype == torch.float32
    assert ours["blocks"][0]["w_x"].dtype == torch.bfloat16
    for a, b in zip(tree_leaves(ours), jax.tree.leaves(jp)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# the Mamba2 sub-block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_apply_matches_reference(dtype):
    """fp32: atol 1e-5 of the output's scale. bf16 (the smoke config's
    own dtypes): atol 5e-2 of the output's scale, since the two
    frameworks round the bf16 intermediates at other places."""
    jcfg, cfg = _cfgs(param_dtype=dtype, compute_dtype=dtype)
    p = _init(jcfg, jB.mamba_decl, 1)
    x = _x((BATCH, SEQ, jcfg.d_model), 2)
    jx = jnp.asarray(x, jcfg.dtype)
    ref = jB.mamba_apply(p, jx, jcfg)
    assert np.isfinite(np.asarray(ref, np.float32)).all()
    ours = B.mamba_apply(_port(p), tt(np.asarray(jx, np.float32)).to(
        cfg.dtype), cfg)
    assert ours.dtype == cfg.dtype
    _close_scaled(ours.float(), np.asarray(ref, np.float32),
                  1e-5 if dtype == "float32" else 5e-2)


def test_mamba_apply_gradients_match_jax_grad():
    """Gradients of one mamba_apply (fp32) for every parameter and the
    input, with a random cotangent, against `jax.grad` of the reference:
    atol 3e-5 of each gradient's largest entry (module docstring)."""
    jcfg, cfg = _cfgs(**F32)
    p = _init(jcfg, jB.mamba_decl, 1)
    x, ct = _x((BATCH, SEQ, jcfg.d_model), 2), _x((BATCH, SEQ, jcfg.d_model),
                                                 3)
    jg = jax.grad(lambda p, x: jnp.sum(jB.mamba_apply(p, x, jcfg) * ct),
                  argnums=(0, 1))(p, jnp.asarray(x))
    params = _port(p)
    leaves = [a.requires_grad_() for a in tree_leaves(params)]
    xt = tt(x).requires_grad_()
    out = B.mamba_apply(tree_unflatten(params, leaves), xt, cfg)
    grads = torch.autograd.grad((out * tt(ct)).sum(), leaves + [xt])
    for g, r in zip(grads, jax.tree.leaves(jg[0]) + [jg[1]]):
        _close_scaled(g, r, 3e-5)


def test_mamba_softplus_and_decode_paths():
    """The softplus is jax's (logaddexp(x, 0), no cut-off at 20), and the
    decode paths raise naming their slice."""
    x = np.array([-30.0, -1.0, 0.0, 3.0, 19.0, 25.0, 80.0], np.float32)
    np.testing.assert_allclose(tn(B._softplus(tt(x))),
                               np.asarray(jax.nn.softplus(x)), rtol=1e-6)
    with pytest.raises(NotImplementedError, match="decode"):
        B.mamba_decode()
    with pytest.raises(NotImplementedError, match="decode"):
        B.mamba_cache_decl()


def test_ssd_chunk_scan_keeps_the_reference_contract():
    """The reference's `_ssd_chunk_scan` signature: chunk = min(chunk, T),
    T a multiple of it, y and the final state out (fp32, atol = rtol =
    5e-5)."""
    rng = np.random.default_rng(3)
    v = tt(rng.normal(size=(1, 48, 2, 8)).astype(np.float32))
    b = tt(rng.normal(size=(1, 48, 4)).astype(np.float32))
    la = -tt(rng.uniform(size=(1, 48, 2)).astype(np.float32))
    y, s = B._ssd_chunk_scan(v, b, b, la, 64)        # chunk -> 48
    ref = jB._ssd_chunk_scan(*(jnp.asarray(tn(t)) for t in (v, b, b, la)),
                             64)
    np.testing.assert_allclose(tn(y), np.asarray(ref[0]), atol=5e-5,
                               rtol=5e-5)
    np.testing.assert_allclose(tn(s), np.asarray(ref[1]), atol=5e-5,
                               rtol=5e-5)
    with pytest.raises(AssertionError):
        B._ssd_chunk_scan(v, b, b, la, 32)


# ---------------------------------------------------------------------------
# the hybrid engine: forward and the gradient of the tied block
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def hybrid():
    jcfg, cfg = _cfgs(n_rep=2, **F32)
    jp = _init(jcfg, jengine.model_decl, 4)
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size,
                                             (BATCH, SEQ))
    return jcfg, cfg, jp, toks


def _loss_grads(params, toks, cfg):
    leaves = [x.detach().clone().requires_grad_()
              for x in tree_leaves(params)]
    loss = vfl.lm_loss(tree_unflatten(params, leaves),
                       {"tokens": tt(toks),
                        "labels": tt(np.roll(toks, -1, axis=1))}, cfg,
                       "head")
    return list(torch.autograd.grad(loss, leaves))


def test_hybrid_forward_logits_match_reference(hybrid):
    """Logits with and without remat within 0.1 absolute (scale 7.46):
    see the module docstring for the conditioning that sets it."""
    jcfg, cfg, jp, toks = hybrid
    ref, _ = jengine.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                             tp="head")
    assert np.isfinite(np.asarray(ref)).all()
    params = _port(jp)
    for remat in (True, False):
        logits, aux = engine.forward(params, tt(toks),
                                     cfg.replace(remat=remat), tp="head")
        assert tuple(logits.shape) == (BATCH, SEQ, 512)
        np.testing.assert_allclose(tn(logits), np.asarray(ref), atol=0.1,
                                   rtol=0)


def test_reference_init_is_ill_conditioned(hybrid):
    """The reference fault behind the whole-model tolerances
    (`repro/models/module.py:52-54`, ROADMAP queue 3): the `scaled` init
    takes fan_in = shape[-2], so `wq [d, H, Dh]` is drawn with std
    0.88 / sqrt(H) (truncated normal on [-2, 2]), not / sqrt(d). With
    every parameter moved by half an ulp (x (1 +- 6e-8)) the reference's
    own zamba2 logits (scale 7.46) move by more than 5e-3 (0.015 to 0.052
    over four sign patterns), while qwen3's smoke config, which has
    qk-norm, moves by less than 5e-4 (2.2e-5 to 3.3e-5) under the same
    perturbation."""
    jcfg, cfg, jp, toks = hybrid
    H = jcfg.num_heads
    wq = np.asarray(jp["shared"][str(jcfg.pattern.index("attn"))]["wq"])
    assert wq.shape == (jcfg.d_model, H, jcfg.head_dim)
    np.testing.assert_allclose(wq.std(), 0.8796 / np.sqrt(H), rtol=0.02)
    qcfg = j_get_smoke_config("qwen3-32b").replace(n_rep=2, **F32)
    for c, p, bound in ((jcfg, jp, None),
                        (qcfg, _init(qcfg, jengine.model_decl, 4), 5e-4)):
        f = jax.jit(lambda p: jengine.forward(
            p, jnp.asarray(toks, jnp.int32), c, tp="head")[0])
        rng = np.random.default_rng(0)
        nudged = jax.tree.map(lambda x: x * (1 + 6e-8 * rng.choice(
            [-1.0, 1.0], size=x.shape).astype(np.float32)), p)
        moved = float(np.abs(np.asarray(f(nudged)) - np.asarray(f(p))).max())
        if bound is None:
            assert moved > 5e-3
        else:
            assert moved < bound


def test_gradient_of_the_tied_block_matches_jax_grad(hybrid):
    """The loss's gradient on every leaf, the weight-tied "shared" attention
    and MLP (used n_rep = 2 times, so their gradients sum over both uses)
    included, against `jax.grad` of the reference's loss: within 1e-1 of
    the leaf's norm (see the module docstring)."""
    jcfg, cfg, jp, toks = hybrid
    jb = {"tokens": jnp.asarray(toks, jnp.int32),
          "labels": jnp.asarray(np.roll(toks, -1, axis=1), jnp.int32)}
    ref = jax.tree.leaves(jax.grad(
        lambda p: j_lm_loss(p, jb, jcfg, "head"))(jp))
    params = _port(jp)
    grads = _loss_grads(params, toks, cfg)
    assert len(grads) == len(ref) == 34
    for g, r in zip(grads, ref):
        assert np.isfinite(np.asarray(r)).all()
        _close_normwise(g, r, 1e-1)
    shared = tree_leaves(tree_unflatten(params, grads)["shared"])
    assert len(shared) == 9 and all(float(g.abs().max()) > 0
                                    for g in shared)


def test_tied_gradient_is_the_sum_over_its_uses(hybrid):
    """The same weights untied (`shared_attn=False`: the attention and MLP
    stacked per repetition, each copy used once) give the same logits,
    and the tied leaves' gradients equal the sum over the repetitions of
    the untied copies' gradients: within 1e-6 of the gradient's largest
    entry (one sum in another order)."""
    jcfg, cfg, jp, toks = hybrid
    params = _port(jp)
    untied = dict(params)
    untied["shared"] = {}
    untied["blocks"] = [
        tree_map(lambda x: torch.stack([x] * cfg.n_rep),
                 params["shared"][str(i)]) if str(i) in params["shared"]
        else blk for i, blk in enumerate(params["blocks"])]
    ucfg = cfg.replace(shared_attn=False)
    assert tree_map(lambda d: d.shape, engine.model_decl(ucfg, "head")) == \
        tree_map(lambda x: tuple(x.shape), untied)
    lt, _ = engine.forward(params, tt(toks), cfg, tp="head")
    lu, _ = engine.forward(untied, tt(toks), ucfg, tp="head")
    assert torch.equal(lt, lu)
    gt = tree_unflatten(params, _loss_grads(params, toks, cfg))
    gu = tree_unflatten(untied, _loss_grads(untied, toks, ucfg))
    for i in params["shared"]:
        for a, b in zip(tree_leaves(gt["shared"][i]),
                        tree_leaves(gu["blocks"][int(i)])):
            _close_scaled(a, b.sum(0), 1e-6)


# ---------------------------------------------------------------------------
# the VFL round and the training entry point
# ---------------------------------------------------------------------------

def test_vfl_round_of_the_hybrid_model_matches_reference():
    """One train step (`make_train_step` with VEDS inline, then
    `make_vfl_round`) of the smoke config (fp32, n_rep 2, V = 4) on a
    reference round: the success mask is the reference's `veds_round`'s,
    and the aggregate matches per-vehicle local SGD of the reference plus
    the masked weighted mean over that mask: each leaf's update (the
    aggregate less the old parameters) within 1e-1 of its norm, as the
    gradients (module docstring)."""
    jcfg, cfg = _cfgs(n_rep=2, num_vehicles=V, grad_accum=1, **F32)
    jp = _init(jcfg, jengine.model_decl, 6)
    jprm, prm = JVeds(Q=2e7, slot=0.1), VedsParams(Q=2e7, slot=0.1)
    rnd = jax.jit(lambda k: j_make_round(
        k, JScenario(n_sov=V, n_opv=8, n_slots=20), JManhattan(), JChannel(),
        jprm))(jax.random.key(9))
    jmask = np.asarray(j_veds_round(rnd, jprm, JChannel())["success"],
                       np.float32)[:V]
    assert 0 < jmask.sum()
    rng = np.random.default_rng(7)
    toks = rng.integers(0, jcfg.vocab_size, (V, BPV, SEQ))
    batch_v = {"tokens": toks, "labels": np.roll(toks, -1, axis=2)}
    weights = np.array([1., 1., 2., 1.], np.float32)
    sgd = jax.jit(lambda p, b: j_local_sgd(p, b, jcfg, "head", j_lm_loss,
                                           LR))
    w = jmask * weights
    locals_ = [sgd(jp, {k: jnp.asarray(x[v], jnp.int32)
                        for k, x in batch_v.items()}) for v in range(V)]
    ref = jax.tree.map(lambda *xs: sum(float(wi) * x for wi, x in
                                       zip(w, xs)) / float(w.sum()),
                       *locals_)
    params = _port(jp)
    step = vfl.make_train_step(cfg, None, "head", lr=LR,
                               inline_scheduler=True, veds_prm=prm,
                               ch_prm=ChannelParams())
    out, stats = step(
        tree_map(lambda x: x.unsqueeze(0).expand(V, *x.shape), params),
        {k: tt(x) for k, x in batch_v.items()}, round_to_torch(rnd),
        tt(weights))
    np.testing.assert_array_equal(tn(stats["mask"]), jmask)
    ol, rl, pl = tree_leaves(out), jax.tree.leaves(ref), jax.tree.leaves(jp)
    assert len(ol) == len(rl) == 34
    for a, b, p0 in zip(ol, rl, pl):
        assert a.shape[0] == V and a.stride(0) == 0
        p0 = np.asarray(p0)
        _close_normwise(tn(a[0]) - p0, np.asarray(b) - p0, 1e-1)


def test_fedavg_agg_tree_walks_shared_and_skips_empty_blocks(monkeypatch):
    """The aggregation of the hybrid tree: one `fedavg_agg` per leaf (the
    "shared" trees included, the empty blocks of the tied positions
    contributing none), each leaf the masked weighted mean of the
    vehicles' copies, and the tree's structure kept."""
    cfg = get_smoke_config(ARCH).replace(n_rep=2, **F32)
    decl = engine.model_decl(cfg, "head")
    rng = np.random.default_rng(8)
    new_v = tree_map(lambda d: tt(rng.normal(size=(V,) + d.shape).astype(
        np.float32)), decl)
    old = tree_map(lambda d: torch.zeros(d.shape), decl)
    w = torch.tensor([1.0, 0.0, 2.0, 1.0])
    calls, orig = [], fedavg_ops.fedavg_agg_plain

    def plain(x, w_, o):
        calls.append(tuple(x.shape))
        return orig(x, w_, o)

    monkeypatch.setattr(fedavg_ops, "fedavg_agg_plain", plain)
    agg = fedavg_ops.fedavg_agg_tree(new_v, w, old)
    assert len(calls) == len(tree_leaves(decl)) == 34
    assert agg["blocks"][2] == {} and agg["blocks"][3] == {}
    assert sorted(agg["shared"]) == ["2", "3"]
    for a, x in zip(tree_leaves(agg), tree_leaves(new_v)):
        want = (x[0] + 2 * x[2] + x[3]) / 4
        torch.testing.assert_close(a, want, atol=1e-6, rtol=1e-6)


def test_train_main_runs_zamba2_on_cpu_with_finite_losses(capsys):
    assert train_mod.main(["--arch", ARCH, "--device", "cpu", "--rounds",
                           "2", "--vehicles", "4", "--batch-per-vehicle",
                           "2", "--seq", "64"]) == 0
    out = capsys.readouterr().out
    assert "arch=zamba2-2.7b" in out
    losses = [float(x) for x in re.findall(r"loss=(\S+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_loop_calls_each_hybrid_kernel_as_the_chip_run_counts(
        monkeypatch):
    """The counts that `chip_smoke.py` asserts for zamba2, checked here on
    the wrappers' calls (the CPU runs the plain versions, uncounted): per
    round `ssd_scan` runs (V x 2 + 1) times per Mamba sub-layer (forward,
    the recompute under remat, the eval forward), and `fedavg_agg` once
    per parameter leaf (the smoke config: 34 leaves)."""
    calls = {"ssd": 0, "fedavg": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(ssd_ops, "ssd_scan_fwd",
                        count("ssd", ssd_ops.ssd_scan_fwd))
    monkeypatch.setattr(fedavg_ops, "fedavg_agg_plain",
                        count("fedavg", fedavg_ops.fedavg_agg_plain))
    cfg = get_smoke_config(ARCH).replace(n_rep=2, num_vehicles=V,
                                         grad_accum=1)
    hist = train_mod.train(cfg, rounds=1, batch_per_vehicle=2, seq=32,
                           lr=0.5, device="cpu", log=lambda s: None)
    assert np.isfinite(hist[0]["loss"])
    n_mamba = cfg.n_rep * cfg.pattern.count("mamba")
    n_leaves = len(tree_leaves(engine.model_decl(cfg, "head")))
    assert n_leaves == 34
    assert calls["ssd"] == n_mamba * (V * 2 + 1)
    assert calls["fedavg"] == n_leaves
