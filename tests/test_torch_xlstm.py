"""The port's xLSTM path (`models/blocks.py`: `_mlstm_gates`,
`mlstm_apply`, `slstm_apply`; the engine with both kinds; the VFL round
and `launch/train.py`) against the reference, at xlstm-1.3b's smoke
config (d_model 256, 4 heads; the mLSTM's head dim 2d/H = 128 and chunk
32, the sLSTM's d/H = 64; pattern (mlstm, mlstm, slstm), vocab 512), in
fp32 with one torch intra-op thread.

Weights are the reference's own init (`materialize` of its declaration,
unchanged) carried over with `llm_params_from_jax`; activations and
tokens are numpy draws fed to both sides. Tolerances:

- the gates, and one `slstm_apply` with its gradients: within 1e-6 and
  1e-5 of the largest entry (measured up to 3.7e-7 and 2.8e-6);
- one `mlstm_apply`: within 5e-5 of the output's largest entry, each
  gradient within 2e-4 of its largest entry. The block divides by
  max(|den|, 1), and at the reference's init (`scaled`, fan_in = H = 4
  for `w_q`, `w_k`, `w_v` [d, H, P], ROADMAP queue 3) the scores q.k
  reach the hundreds and den cancels: with every parameter moved by
  half an ulp (x (1 +- 6e-8)) the reference's own output moves by
  5.8e-6 to 2.1e-5 of its scale and its gradients by 6.2e-6 to 8.1e-5
  over four seeds; the port lands 4.2e-6 to 2.6e-5 and 8.6e-6 to 7.6e-5
  from it. The tolerances are about twice the reference's own worst
  move. In bf16 (the config's own dtypes) the two frameworks round the
  intermediates at other places: within 5e-2 of the output's scale;
- the whole model and its VFL round, within `MODEL_TOL`
  (`tests/torch_ref_vfl.py`) for the same reason.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke_config as j_get_smoke_config
from repro.models import blocks as jB
from repro.models import engine as jengine
from repro.models import layers as jL
from repro.models.module import Declared as JDeclared
from repro.models.module import materialize as j_materialize
from repro.models.module import param_count as j_param_count
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.kernels.fedavg_agg import ops as fedavg_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import train as train_mod
from repro_torch.models import blocks as B
from repro_torch.models import engine
from repro_torch.models.module import (param_count, tree_leaves,
                                       tree_unflatten)
from torch_port_util import tn, tt
from torch_ref_vfl import MODEL_TOL, vfl_round_against_reference

ARCH = "xlstm-1.3b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
BATCH, V = 2, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _grads_against_jax(decl, apply, seed, t, rel):
    """Gradients of sum(apply(p, x) * ct) for every parameter and the
    input against `jax.grad` of the reference, each within `rel` of its
    largest entry."""
    jcfg, cfg = _cfgs(**F32)
    p = j_materialize(jax.random.key(seed), getattr(jB, decl)(jcfg, "head"))
    x = _x((BATCH, t, jcfg.d_model), seed + 10)
    ct = _x((BATCH, t, jcfg.d_model), seed + 20)
    jg = jax.grad(lambda p, x: jnp.sum(getattr(jB, apply)(p, x, jcfg) * ct),
                  argnums=(0, 1))(p, jnp.asarray(x))
    params = _port(p)
    leaves = [a.requires_grad_() for a in tree_leaves(params)]
    xt = tt(x).requires_grad_()
    out = getattr(B, apply)(tree_unflatten(params, leaves), xt, cfg)
    grads = torch.autograd.grad((out * tt(ct)).sum(), leaves + [xt])
    ref = jax.tree.leaves(jg[0]) + [jg[1]]
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        assert np.isfinite(np.asarray(r)).all()
        _close_scaled(g, r, rel)


# ---------------------------------------------------------------------------
# the mLSTM sub-block
# ---------------------------------------------------------------------------

def test_mlstm_gates_match_reference():
    """log sigmoid(f) through jax's softplus (logaddexp(x, 0), no cut-off
    at 20) and the log input gate, in fp32 from bf16 inputs: within 1e-6
    of the largest entry; gate pre-activations beyond +-20 included."""
    jcfg, _ = _cfgs()
    p = j_materialize(jax.random.key(1), jB.mlstm_decl(jcfg, "head"))
    h = jnp.asarray(30.0 * _x((BATCH, 16, jcfg.d_model), 2), jnp.bfloat16)
    ref = jB._mlstm_gates(p, h)
    got = B._mlstm_gates(_port(p), tt(np.asarray(h, np.float32)).to(
        torch.bfloat16))
    gif = np.asarray(h, np.float32) @ np.asarray(p["w_if"], np.float32)
    assert np.abs(gif).max() > 20
    for a, r in zip(got, ref):
        assert a.dtype == torch.float32
        _close_scaled(a, r, 1e-6)


@pytest.mark.parametrize("t", [4 * 32, 16])
def test_mlstm_apply_matches_reference(t):
    """T = 4 chunks of 32 (the carried state matters), and T = 16 below
    the chunk (chunk = min(ssm_chunk, T)). In the first case some
    above-diagonal g = cum_i - cum_j + li_j of the reference's own gates
    passes 20, so the clamp before the mask is exercised (an unclamped
    exp would overflow to inf there and the mask turn it into NaN)."""
    jcfg, cfg = _cfgs(**F32)
    p = j_materialize(jax.random.key(1), jB.mlstm_decl(jcfg, "head"))
    x = _x((BATCH, t, jcfg.d_model), 11)
    ref = np.asarray(jB.mlstm_apply(p, jnp.asarray(x), jcfg))
    assert np.isfinite(ref).all()
    got = B.mlstm_apply(_port(p), tt(x), cfg)
    assert got.dtype == torch.float32 and tuple(got.shape) == x.shape
    _close_scaled(got, ref, 5e-5)
    if t > jcfg.ssm_chunk:
        log_f, log_i = jB._mlstm_gates(p, jL.rmsnorm(p["ln"],
                                                     jnp.asarray(x)))
        c = jcfg.ssm_chunk
        lf = np.asarray(log_f).reshape(BATCH, t // c, c, -1)
        li = np.asarray(log_i).reshape(BATCH, t // c, c, -1)
        cum = np.cumsum(lf, axis=2)
        g = cum[:, :, :, None] - cum[:, :, None, :] + li[:, :, None, :]
        above = np.triu(np.ones((c, c), bool), 1)[None, None, :, :, None]
        assert np.where(above, g, -np.inf).max() > 20


def test_mlstm_apply_bf16_near_reference():
    """The smoke config's own bf16: each chunk's output is rounded to bf16
    before the out-norm, as the reference's `out.astype(x.dtype)`;
    within 5e-2 of the output's scale."""
    jcfg, cfg = _cfgs()
    p = j_materialize(jax.random.key(1), jB.mlstm_decl(jcfg, "head"))
    jx = jnp.asarray(_x((BATCH, 64, jcfg.d_model), 12), jnp.bfloat16)
    ref = np.asarray(jB.mlstm_apply(p, jx, jcfg), np.float32)
    got = B.mlstm_apply(_port(p), tt(np.asarray(jx, np.float32)).to(
        torch.bfloat16), cfg)
    assert got.dtype == torch.bfloat16
    _close_scaled(got.float(), ref, 5e-2)


def test_mlstm_apply_refuses_a_chunk_that_does_not_divide_t():
    """The reference's reshape fails there; the port raises and does not
    pad."""
    _, cfg = _cfgs(**F32)
    jcfg, _ = _cfgs(**F32)
    p = _port(j_materialize(jax.random.key(1), jB.mlstm_decl(jcfg, "head")))
    with pytest.raises(ValueError, match="does not divide"):
        B.mlstm_apply(p, tt(_x((1, 48, cfg.d_model), 3)), cfg)


@pytest.mark.parametrize("t", [4 * 32, 16])
def test_mlstm_apply_gradients_match_jax_grad(t):
    _grads_against_jax("mlstm_decl", "mlstm_apply", 1, t, 2e-4)


# ---------------------------------------------------------------------------
# the sLSTM sub-block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,rel", [("float32", 1e-5),
                                       ("bfloat16", 5e-2)])
def test_slstm_apply_matches_reference(dtype, rel):
    """The recurrence with m starting at 0, h kept in fp32 and cast to
    x's dtype after the loop."""
    jcfg, cfg = _cfgs(param_dtype=dtype, compute_dtype=dtype)
    p = j_materialize(jax.random.key(2), jB.slstm_decl(jcfg, "head"))
    jx = jnp.asarray(_x((BATCH, 48, jcfg.d_model), 13), jcfg.dtype)
    ref = np.asarray(jB.slstm_apply(p, jx, jcfg), np.float32)
    got = B.slstm_apply(_port(p), tt(np.asarray(jx, np.float32)).to(
        cfg.dtype), cfg)
    assert got.dtype == cfg.dtype
    _close_scaled(got.float(), ref, rel)


def test_slstm_apply_gradients_match_jax_grad():
    _grads_against_jax("slstm_decl", "slstm_apply", 2, 48, 1e-5)


# ---------------------------------------------------------------------------
# the engine, the VFL round and the driver
# ---------------------------------------------------------------------------

def _decl_summary(tree, is_port):
    if is_port:
        return [(d.shape, d.axes, d.init, d.scale, str(d.dtype).split(".")[-1])
                for d in tree_leaves(tree)]
    return [(d.shape, d.axes, d.init, d.scale, str(d.dtype))
            for d in jax.tree.leaves(tree, is_leaf=lambda x:
                                     isinstance(x, JDeclared))]


def test_xlstm_model_decl_matches_reference_at_full_width_and_depth():
    """6 x (7 mLSTM + 1 sLSTM) at d_model 2048: 64 leaves and
    2,119,657,472 parameters, with the reference's shapes, axes, inits,
    scales and dtypes (the sLSTM's `r` at scale 0.5, its `b` zeros)."""
    jd = jengine.model_decl(j_get_config(ARCH), "head")
    d = engine.model_decl(get_config(ARCH), "head")
    assert _decl_summary(d, True) == _decl_summary(jd, False)
    assert len(tree_leaves(d)) == 64
    assert param_count(d) == j_param_count(jd) == 2_119_657_472


def test_xlstm_forward_logits_match_reference():
    jcfg, cfg = _cfgs(**F32)
    jp = j_materialize(jax.random.key(3), jengine.model_decl(jcfg, "head"))
    toks = np.random.default_rng(26).integers(0, jcfg.vocab_size,
                                              (BATCH, 64))
    ref, _ = jengine.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                             tp="head")
    params = _port(jp)
    for remat in (True, False):
        logits, aux = engine.forward(params, tt(toks),
                                     cfg.replace(remat=remat), tp="head")
        assert float(aux) == 0.0
        np.testing.assert_allclose(tn(logits), np.asarray(ref),
                                   atol=MODEL_TOL, rtol=0)


def test_vfl_round_matches_reference():
    """Each of the 24 leaves' update within MODEL_TOL of its norm."""
    errs = vfl_round_against_reference(ARCH, 3)
    assert len(errs) == 24
    assert max(errs) <= MODEL_TOL, errs


def test_train_main_runs_xlstm_on_cpu_with_finite_losses(capsys):
    """At lr 1e-2. At the driver's default lr 0.5 (and at 0.1) one round
    grows the first mLSTM's `w_if` about tenfold, its log input gate
    passes 88.7, and the state update's unclamped exp(cum[-1] - cum + li)
    overflows: the eval loss is NaN from round 1 on, as the reference's
    own driver's is (`python -m repro.launch.train --arch xlstm-1.3b
    --devices 4 --vehicles 4 --batch-per-vehicle 2 --seq 64` gives NaN
    from round 0 at 0.5 and from round 1 at 0.1, and finite losses for
    3 rounds at 1e-2)."""
    assert train_mod.main(["--arch", ARCH, "--device", "cpu",
                           "--rounds", "2", "--vehicles", "4",
                           "--batch-per-vehicle", "2", "--seq", "64",
                           "--lr", "1e-2"]) == 0
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out
    losses = [float(x) for x in re.findall(r"loss=(\S+)", out)]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_xlstm_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.main(["--arch", ARCH, "--rounds", "1"])


def test_train_loop_calls_each_kernel_as_the_chip_run_counts(monkeypatch):
    """The counts that `chip_smoke.py` asserts for xlstm-1.3b, checked here
    on the plain versions (which the CPU runs in the kernels' place): no
    attention, so no `flash_attention`; `fedavg_agg` once per leaf
    (embed, lm_head, final_norm, 8 per mLSTM position and 5 per sLSTM
    position: 24 at the smoke config)."""
    calls = {"flash": 0, "fedavg": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(flash_ops, "flash_attention_plain",
                        count("flash", flash_ops.flash_attention_plain))
    monkeypatch.setattr(fedavg_ops, "fedavg_agg_plain",
                        count("fedavg", fedavg_ops.fedavg_agg_plain))
    cfg = get_smoke_config(ARCH).replace(num_vehicles=V, grad_accum=1)
    hist = train_mod.train(cfg, rounds=1, batch_per_vehicle=2, seq=64,
                           lr=1e-2, device="cpu", log=lambda s: None)
    assert np.isfinite(hist[0]["loss"])
    assert calls == {"flash": 0, "fedavg": 24}
