"""The port's source-memory paths (`models/engine.py`: the whisper encoder
`_encode`, the vlm projector, `source_memory`; the `cross` sub-block fed
from them; the VFL round with a `src` batch entry) against the
reference, at whisper-small's smoke config (2 encoder layers, 2 x (attn,
cross, mlp), d_model 256, 4 heads of 64, 32 source frames of 256) and
llama-3.2-vision-90b's (1 x (attn, mlp, cross, mlp), 4 query and 2 KV
heads of 64, 32 patches of 48), in fp32 with one torch intra-op thread.

Weights are the reference's own init (`materialize` of its declaration,
unchanged) carried over with `llm_params_from_jax`; tokens, activations
and `src` (0.1 * N(0, 1), `torch_ref_vfl.src_batch`) are numpy draws fed
to both sides. Neither config has qk-norm, and the reference's `scaled`
init takes fan_in = H for `wq [d, H, Dh]` (ROADMAP queue 3), so the
attention scores reach the tens to hundreds and the models amplify
one-ulp differences. Each tolerance is about twice the reference's own
largest move when every weight moves by half an ulp (x (1 +- 6e-8);
three init seeds, three sign draws each):

- the projector, a matmul: within 1e-5 of the scale (measured 0 for the
  output and up to 8.3e-7 for the gradients);
- one `cross` sub-block with S != T: the output within 5e-5 and each
  gradient within 2e-4 of its largest entry (the reference moves by up
  to 2.9e-5 and 1.4e-4; the port lands up to 1.6e-5 and 5.4e-5 away);
- the whisper encoder (2 bidirectional layers): the memory within
  1.2e-3 and each gradient within 2e-3 of its largest entry (the
  reference moves by up to 6.0e-4 and 1.05e-3; the port lands up to
  3.2e-4 and 6.7e-4 away);
- the logits: vlm within `MODEL_TOL`; whisper within 0.25 absolute
  (scale 7-9; the reference moves by up to 0.115, the port lands up to
  0.141 away);
- the VFL round: each leaf's update within `MODEL_TOL` of its norm,
  vlm at its smoke depth and whisper at one encoder layer and one
  repetition. At the smoke depth (2 encoder layers, n_rep 2) whisper's
  gradients at this init are chaotic: the reference's own per-vehicle
  gradient moves by up to 1.9 of its norm under a half-ulp change of
  the weights, so no tolerance there could tell a right update from a
  wrong one, and that round is held only to be finite, of the right
  shapes and to run. At one layer the reference's own update moves by
  at most 1.72e-2 of a leaf's norm (init seeds 0, 1 and 3, four draws
  each; the test asserts it below 0.1) and the port lands at most
  3.4e-3 from it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke_config as j_get_smoke_config
from repro.models import blocks as jB
from repro.models import engine as jengine
from repro.models.module import Declared as JDeclared
from repro.models.module import materialize as j_materialize
from repro.models.module import param_count as j_param_count
from repro_torch.configs.registry import get_config, get_smoke_config
from repro_torch.data.synthetic import src_lm_batch
from repro_torch.kernels.fedavg_agg import ops as fedavg_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import train as train_mod
from repro_torch.models import blocks as B
from repro_torch.models import engine
from repro_torch.models.module import (param_count, tree_leaves,
                                       tree_unflatten)
from torch_port_util import tn, tt
from torch_ref_vfl import (MODEL_TOL, reference_half_ulp_move, src_batch,
                           vfl_round_against_reference)

WHISPER, VLM = "whisper-small", "llama-3.2-vision-90b"
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


def _cfgs(arch, **kw):
    return (j_get_smoke_config(arch).replace(**kw),
            get_smoke_config(arch).replace(**kw))


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _port(tree):
    return engine.llm_params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _close_scaled(a, b, rel):
    """|a - b| <= rel * max|b|, entry by entry."""
    b = np.asarray(b, np.float32)
    np.testing.assert_allclose(tn(a).astype(np.float32), b,
                               atol=rel * float(np.abs(b).max()), rtol=0)


def _decl_summary(tree, is_port):
    if is_port:
        return [(d.shape, d.axes, d.init, d.scale, str(d.dtype).split(".")[-1])
                for d in tree_leaves(tree)]
    return [(d.shape, d.axes, d.init, d.scale, str(d.dtype))
            for d in jax.tree.leaves(tree, is_leaf=lambda x:
                                     isinstance(x, JDeclared))]


# ---------------------------------------------------------------------------
# declarations and parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,n_leaves,count", [
    (WHISPER, 26, 279_230_976),
    (VLM, 49, 87_677_280_256)])
def test_model_decl_matches_reference_at_full_width_and_depth(arch, n_leaves,
                                                              count):
    """The same leaves as the reference's, the encoder (blocks stacked over
    encoder_layers, `pos` normal 0.02, final_norm) and the projector
    included, each `scaled` and `normal` leaf in the params' dtype."""
    jd = jengine.model_decl(j_get_config(arch), "head")
    d = engine.model_decl(get_config(arch), "head")
    assert _decl_summary(d, True) == _decl_summary(jd, False)
    assert len(tree_leaves(d)) == n_leaves
    assert param_count(d) == j_param_count(jd) == count
    assert ("encoder" in d) == (arch == WHISPER)
    assert ("projector" in d) == (arch == VLM)


def test_cross_sub_block_has_no_qk_norm_even_where_the_config_sets_it():
    jcfg, cfg = _cfgs(VLM, qk_norm=True)
    for kind in ("attn", "cross"):
        want = sorted(jengine._DECLS[kind](jcfg, "head"))
        assert sorted(engine._DECLS[kind](cfg, "head")) == want
    assert "q_norm" not in engine._DECLS["cross"](cfg, "head")
    assert "q_norm" in engine._DECLS["attn"](cfg, "head")


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_llm_params_from_jax_carries_the_encoder_and_projector(arch):
    jp = j_materialize(jax.random.key(0), jengine.model_decl(
        j_get_smoke_config(arch), "head"))
    ours = _port(jp)
    assert sorted(ours) == sorted(jp)
    for a, b in zip(tree_leaves(ours), jax.tree.leaves(jp)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


# ---------------------------------------------------------------------------
# the source memory and the cross sub-block
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,out_tol,grad_tol", [(WHISPER, 1.2e-3, 2e-3),
                                                   (VLM, 1e-5, 1e-5)])
def test_source_memory_and_its_gradients_match_reference(arch, out_tol,
                                                         grad_tol):
    """whisper: the encoder over src + pos, bidirectional, no rope, ending
    with its final norm; vlm: the projector. Gradients of sum(mem * ct)
    for every encoder or projector leaf and for src."""
    jcfg, cfg = _cfgs(arch, **F32)
    jp = j_materialize(jax.random.key(1), jengine.model_decl(jcfg, "head"))
    sub = {k: jp[k] for k in ("encoder", "projector") if k in jp}
    src = src_batch(jcfg, BATCH, 3)
    ct = _x((BATCH, jcfg.num_src_tokens, jcfg.d_model), 4)
    ref = np.asarray(jengine.source_memory(sub, jcfg, jnp.asarray(src),
                                           "head"))
    jg = jax.grad(lambda s, x: jnp.sum(jengine.source_memory(
        s, jcfg, x, "head") * ct), argnums=(0, 1))(sub, jnp.asarray(src))
    params = _port(sub)
    leaves = [a.requires_grad_() for a in tree_leaves(params)]
    xs = tt(src).requires_grad_()
    mem = engine.source_memory(tree_unflatten(params, leaves), cfg, xs,
                               "head")
    assert tuple(mem.shape) == (BATCH, cfg.num_src_tokens, cfg.d_model)
    _close_scaled(mem, ref, out_tol)
    grads = torch.autograd.grad((mem * tt(ct)).sum(), leaves + [xs])
    want = jax.tree.leaves(jg[0]) + [jg[1]]
    assert len(grads) == len(want) == (11 if arch == WHISPER else 2)
    for g, r in zip(grads, want):
        _close_scaled(g, r, grad_tol)


def test_source_memory_without_src_is_none_and_decode_cache_waits():
    """No src, no memory. The decode cache's cross slots are built from
    the memory: each repetition's wk and wv applied to it, in the cache's
    dtype (here bf16 from fp32 params: within half a bf16 ulp), the
    other slots untouched."""
    jcfg, cfg = _cfgs(WHISPER, **F32)
    assert engine.source_memory({}, cfg, None, "head") is None
    params = _port(j_materialize(jax.random.key(5),
                                 jengine.model_decl(jcfg, "head")))
    src = tt(src_batch(jcfg, BATCH, 8))
    cache = engine.zero_cache(engine.cache_decl(
        cfg.replace(compute_dtype="bfloat16"), BATCH, 16), "cpu")
    out = engine.build_cross_cache(cfg, params, cache, src, "head")
    ci = cfg.pattern.index("cross")
    mem = engine.source_memory(params, cfg, src, "head")
    for r in range(cfg.n_rep):
        for key, w in (("k", "wk"), ("v", "wv")):
            want = torch.einsum("bsd,dhk->bshk", mem,
                                params["blocks"][ci][w][r])
            assert out[ci][key].dtype == torch.bfloat16
            torch.testing.assert_close(out[ci][key][r].float(), want,
                                       rtol=2 ** -8, atol=0.0)
    assert all(out[i] is cache[i] for i in range(len(cache)) if i != ci)


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_cross_sub_block_matches_reference(arch):
    """T = 48 queries onto S = 32 memory rows, K and V from the raw memory
    (not normalised by the block's ln), no rope, no mask: the output and
    the gradients of every leaf, of x and of the memory."""
    jcfg, cfg = _cfgs(arch, **F32)
    jp = j_materialize(jax.random.key(2), jengine.model_decl(jcfg, "head"))
    ci = jcfg.pattern.index("cross")
    bp = jax.tree.map(lambda a: a[0], jp["blocks"][ci])
    x = _x((BATCH, 48, jcfg.d_model), 5)
    mem = _x((BATCH, jcfg.num_src_tokens, jcfg.d_model), 6)
    ct = _x(x.shape, 7)

    def jf(p, x, m):
        return jB.attn_apply(p, x, jcfg, tp="head", kind="cross", src=m)
    ref = np.asarray(jf(bp, jnp.asarray(x), jnp.asarray(mem)))
    jg = jax.grad(lambda *a: jnp.sum(jf(*a) * ct), argnums=(0, 1, 2))(
        bp, jnp.asarray(x), jnp.asarray(mem))
    params = _port(bp)
    leaves = [a.requires_grad_() for a in tree_leaves(params)]
    xt, mt = tt(x).requires_grad_(), tt(mem).requires_grad_()
    out = B.attn_apply(tree_unflatten(params, leaves), xt, cfg, tp="head",
                       kind="cross", src=mt, positions=None)
    _close_scaled(out, ref, 5e-5)
    grads = torch.autograd.grad((out * tt(ct)).sum(), leaves + [xt, mt])
    want = jax.tree.leaves(jg[0]) + [jg[1], jg[2]]
    assert len(grads) == len(want) == 7
    for g, r in zip(grads, want):
        _close_scaled(g, r, 2e-4)


# ---------------------------------------------------------------------------
# the whole model, the VFL round and the driver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,atol", [(WHISPER, 0.25), (VLM, MODEL_TOL)])
def test_forward_logits_with_src_match_reference(arch, atol):
    jcfg, cfg = _cfgs(arch, **F32)
    jp = j_materialize(jax.random.key(0), jengine.model_decl(jcfg, "head"))
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (BATCH, 64))
    src = src_batch(jcfg, BATCH, 0)
    ref, _ = jengine.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                             tp="head", src=jnp.asarray(src))
    params = _port(jp)
    for remat in (True, False):
        logits, aux = engine.forward(params, tt(toks),
                                     cfg.replace(remat=remat), tp="head",
                                     src=tt(src))
        assert float(aux) == 0.0
        np.testing.assert_allclose(tn(logits), np.asarray(ref), atol=atol,
                                   rtol=0)


def test_vfl_round_with_src_matches_reference_vlm():
    errs = vfl_round_against_reference(VLM, 3)
    assert len(errs) == 22
    assert max(errs) <= MODEL_TOL, errs


# whisper's round at the depth where the reference is well conditioned
# at its init (module docstring)
ONE_LAYER = dict(encoder_layers=1, n_rep=1)


def test_vfl_round_with_src_matches_reference_whisper():
    """Each of the 26 leaves' update within MODEL_TOL of its norm, at one
    encoder layer and one repetition."""
    errs = vfl_round_against_reference(WHISPER, 3, **ONE_LAYER)
    assert len(errs) == 26
    assert max(errs) <= MODEL_TOL, errs


def test_whisper_reference_round_is_well_conditioned_at_one_layer():
    """The reference's own update at the depth of the round above moves
    by less than 0.1 of a leaf's norm when every weight moves by half an
    ulp (two draws), so MODEL_TOL there tells a right update from a
    wrong one: a zero update would read 1, a sign-flipped one 2."""
    move = reference_half_ulp_move(WHISPER, 3, 2, **ONE_LAYER)
    assert move < 0.1, move


def test_vfl_round_with_src_runs_whisper_at_smoke_depth():
    """At the smoke depth (2 encoder layers, n_rep 2) the reference's
    gradients are chaotic at its init (module docstring), so this round
    is held to no tolerance: the port's aggregate is finite, of the
    reference's shapes and broadcast over the vehicles
    (`vfl_round_against_reference` asserts each), for all 26 leaves."""
    errs = vfl_round_against_reference(WHISPER, 3)
    assert len(errs) == 26
    assert np.isfinite(errs).all()


@pytest.mark.parametrize("arch", [WHISPER, VLM])
def test_train_needs_a_batch_with_src(arch):
    """The driver's LM batches carry no src, as the reference's do not (its
    launch/train.py fails inside `_qkv` for these archs): `train` refuses
    up front, naming src, and runs with a `batch_fn` that adds it."""
    cfg = get_smoke_config(arch).replace(num_vehicles=V, grad_accum=1)
    with pytest.raises(NotImplementedError, match="src"):
        train_mod.train(cfg, rounds=1, batch_per_vehicle=2, seq=32, lr=0.1,
                        device="cpu", log=lambda s: None)
    with pytest.raises(NotImplementedError, match="src"):
        train_mod.main(["--arch", arch, "--device", "cpu", "--rounds", "1"])


def test_train_loop_with_src_calls_each_kernel_as_the_chip_run_counts(
        monkeypatch):
    """The counts that `chip_smoke.py` asserts for whisper-small, on the
    plain versions: per vehicle the encoder's attention once a layer (it
    is not checkpointed) and the decoder's self and cross attention
    twice (forward and remat), plus the eval forward: 4 x (2 + 2 x 4) +
    (2 + 4) = 46 a round at the smoke config; `fedavg_agg` once per leaf,
    26."""
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
    cfg = get_smoke_config(WHISPER).replace(num_vehicles=V, grad_accum=1)
    hist = train_mod.train(cfg, rounds=1, batch_per_vehicle=2, seq=32,
                           lr=1e-2, device="cpu", log=lambda s: None,
                           batch_fn=src_lm_batch(cfg))
    assert np.isfinite(hist[0]["loss"])
    n_dec = cfg.n_rep * 2
    assert calls == {"flash": V * (cfg.encoder_layers + 2 * n_dec)
                     + cfg.encoder_layers + n_dec, "fedavg": 26}
    assert calls["flash"] == 46
