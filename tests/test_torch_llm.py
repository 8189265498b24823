"""The port's LLM path (layers, attention and MLP sub-blocks, the engine)
against the reference, at qwen3-32b's smoke config (d_model 256, 8 query
and 2 KV heads of 32, 2 repetitions, vocab 512, attn_chunk 64) in fp32,
with seq 128 so that the reference's banded attention covers several
chunks.

Weights come from the reference's `materialize` and are carried over
with `llm_params_from_jax`; activations are numpy draws fed to both
sides. Tolerances (fp32 on both sides, sums in other orders): layers
atol 1e-5 / rtol 1e-5; attention cores atol 2e-5 / rtol 2e-5;
sub-blocks rtol 2e-5 with an atol of 2e-6 of the output's largest
magnitude (the reference's `scaled` init takes fan_in = H for `wo`, so
the residual branch reaches |y| ~ 60 and fp32 rounding scales with it);
logits atol 2e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as j_get_smoke_config
from repro.models import blocks as jB
from repro.models import engine as jengine
from repro.models import layers as jL
from repro.models.module import materialize as j_materialize
from repro.models.module import param_bytes as j_param_bytes
from repro.models.module import param_count as j_param_count
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import attention as att
from repro_torch.models import blocks as B
from repro_torch.models import engine
from repro_torch.models import layers as L
from repro_torch.models.module import (param_bytes, param_count,
                                       tree_leaves, tree_map)
from torch_port_util import tn, tt

SEQ, BATCH = 128, 2
F32 = dict(param_dtype="float32", compute_dtype="float32")


def _cfgs(**kw):
    return (j_get_smoke_config("qwen3-32b").replace(**F32, **kw),
            get_smoke_config("qwen3-32b").replace(**F32, **kw))


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)) \
        .astype(np.float32)


def _close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(tn(a), np.asarray(b), atol=atol, rtol=rtol)


def _close_scaled(a, b, rel=2e-6, rtol=2e-5):
    b = np.asarray(b)
    _close(a, b, atol=rel * float(np.abs(b).max()), rtol=rtol)


def _port(tree):
    return engine.llm_params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_rope_embed_match_reference():
    x = _x((2, 16, 4, 32), 0)
    scale = _x((32,), 1, 0.1)
    _close(L.rmsnorm({"scale": tt(scale)}, tt(x)),
           jL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x)),
           atol=1e-5, rtol=1e-5)
    pos = np.arange(16)
    for theta in (10_000.0, 1_000_000.0):
        _close(L.rope(tt(x), L.rope_positions(16), theta),
               jL.rope(jnp.asarray(x), jL.rope_positions(16), theta),
               atol=1e-5, rtol=1e-5)
    table = _x((50, 8), 2)
    toks = np.random.default_rng(3).integers(0, 50, (2, 7))
    _close(L.embed({"table": tt(table)}, tt(toks)),
           jL.embed({"table": jnp.asarray(table)}, jnp.asarray(toks)),
           atol=0)
    assert (tn(L.rope_positions(16, offset=3)) == pos + 3).all()


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False),
                                       ("relu", False)])
def test_mlp_linear_unembed_match_reference(act, gated):
    x = _x((2, 5, 16), 4)
    p = {k: _x(s, 5 + i, 0.2) for i, (k, s) in enumerate(
        [("w_up", (16, 24)), ("w_down", (24, 16))]
        + ([("w_gate", (16, 24))] if gated else []))}
    _close(L.mlp({k: tt(v) for k, v in p.items()}, tt(x), act=act),
           jL.mlp({k: jnp.asarray(v) for k, v in p.items()},
                  jnp.asarray(x), act=act), atol=1e-5, rtol=1e-5)
    lin = {"w": _x((16, 8), 9), "b": _x((8,), 10)}
    _close(L.linear({k: tt(v) for k, v in lin.items()}, tt(x)),
           jL.linear({k: jnp.asarray(v) for k, v in lin.items()},
                     jnp.asarray(x)), atol=1e-5, rtol=1e-5)
    w = _x((16, 40), 11)
    out = L.unembed({"w": tt(w)}, tt(x))
    assert out.dtype == torch.float32
    _close(out, jL.unembed({"w": jnp.asarray(w)}, jnp.asarray(x)),
           atol=1e-5, rtol=1e-5)
    _close(L.unembed_tied({"table": tt(w.T)}, tt(x)),
           jL.unembed_tied({"table": jnp.asarray(w.T)}, jnp.asarray(x)),
           atol=1e-5, rtol=1e-5)


def test_unembed_of_bf16_gives_f32_logits_and_gradients():
    """bf16 inputs: float32 logits (not rounded to bf16) equal to the
    reference's, and bf16 gradients held against `jax.grad` of the
    reference's `unembed` on the same bf16 inputs with a random float32
    cotangent. Tolerance: the logits match to 1e-5; each gradient entry
    equals the reference's bit for bit or lies within one bf16 ulp of it
    (a float32 sum in another order crossing a rounding boundary), or
    within 1e-6 of the largest entry (float32 rounding where the sum
    cancels to near 0); at most 1% of the entries may differ at all."""
    xb = jnp.asarray(_x((2, 32, 96), 12), jnp.bfloat16)
    wb = jnp.asarray(_x((96, 200), 13, 0.1), jnp.bfloat16)
    g = _x((2, 32, 200), 14)
    x = tt(np.asarray(xb, np.float32)).to(torch.bfloat16).requires_grad_()
    w = tt(np.asarray(wb, np.float32)).to(torch.bfloat16).requires_grad_()
    out = L.unembed({"w": w}, x)
    assert out.dtype == torch.float32
    assert torch.equal(out, x.detach().float() @ w.detach().float())
    _close(out, jL.unembed({"w": wb}, xb), atol=1e-5)
    gx, gw = torch.autograd.grad(out, (x, w), tt(g))
    assert gx.dtype == gw.dtype == torch.bfloat16
    rx, rw = jax.grad(
        lambda a, b: jnp.sum(jL.unembed({"w": b}, a) * g),
        argnums=(0, 1))(xb, wb)
    for ours, ref in ((gx, rx), (gw, rw)):
        ours, ref = ours.float().numpy(), np.asarray(ref, np.float32)
        big = np.maximum(np.maximum(np.abs(ours), np.abs(ref)), 1e-30)
        ulp = 2.0 ** (np.floor(np.log2(big)) - 7)
        bad = np.abs(ours - ref) > np.maximum(ulp, 1e-6 * np.abs(ref).max())
        assert not bad.any(), (ours[bad], ref[bad])
        assert (ours != ref).mean() <= 0.01


# ---------------------------------------------------------------------------
# attention and MLP sub-blocks
# ---------------------------------------------------------------------------

def test_attention_core_matches_reference_banded_and_dense():
    """`models.attention.flash_attention` (GQA layout, no KV repeat)
    against the reference's banded and dense jnp paths."""
    q = _x((BATCH, SEQ, 2, 4, 32), 20)
    k = _x((BATCH, SEQ, 2, 32), 21)
    v = _x((BATCH, SEQ, 2, 32), 22)
    for causal, window, skip in [(True, None, True), (True, 48, True),
                                 (False, None, False), (True, None, False)]:
        ours = att.flash_attention(tt(q), tt(k), tt(v), causal=causal,
                                   window=window, q_chunk=64)
        from repro.models.attention import flash_attention as j_fa
        ref = j_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal, window=window, q_chunk=64, kv_chunk=32,
                   skip_masked_blocks=skip)
        _close(ours, ref, atol=2e-5, rtol=2e-5)
    with pytest.raises(NotImplementedError):
        att.decode_attention()
    with pytest.raises(NotImplementedError):
        att.seq_sharded_flash_attention()


@pytest.mark.parametrize("kind", ["attn", "attn_swa", "cross"])
def test_attn_apply_matches_reference(kind):
    jcfg, cfg = _cfgs(window=48)
    p = j_materialize(jax.random.key(1),
                      jB.attn_decl(jcfg, "head", cross=kind == "cross"))
    x = _x((BATCH, SEQ, jcfg.d_model), 23)
    src = _x((BATCH, 40, jcfg.d_model), 24) if kind == "cross" else None
    pos = None if kind == "cross" else jL.rope_positions(SEQ)
    ref = jB.attn_apply(p, jnp.asarray(x), jcfg, tp="head", kind=kind,
                        src=None if src is None else jnp.asarray(src),
                        positions=pos)
    ours = B.attn_apply(_port(p), tt(x), cfg, tp="head", kind=kind,
                        src=None if src is None else tt(src),
                        positions=None if kind == "cross"
                        else L.rope_positions(SEQ))
    # cross attention has no qk-norm: with the reference's init its
    # scores reach ~500, where fp32 softmax is ill-conditioned (the
    # reference itself is 1.6e-3 off a float64 evaluation at |y| ~ 100),
    # so its atol is 2e-5 of the output's scale
    _close_scaled(ours, ref, rel=2e-5 if kind == "cross" else 2e-6)


def test_attn_apply_refuses_row_tp_and_seq_shard():
    _, cfg = _cfgs()
    with pytest.raises(NotImplementedError, match="row"):
        B.attn_apply({}, torch.zeros(1, 4, 256), cfg, tp="row")
    with pytest.raises(NotImplementedError):
        B.attn_apply({}, torch.zeros(1, 4, 256), cfg, tp="head",
                     seq_shard=True)


def test_mlp_apply_matches_reference():
    jcfg, cfg = _cfgs()
    p = j_materialize(jax.random.key(2), jB.mlp_decl(jcfg, "head"))
    x = _x((BATCH, SEQ, jcfg.d_model), 25)
    _close_scaled(B.mlp_apply(_port(p), tt(x), cfg),
                  jB.mlp_apply(p, jnp.asarray(x), jcfg))


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def _decl_summary(tree, is_port):
    if is_port:
        return [(d.shape, d.axes, d.init, d.scale, str(d.dtype).split(".")[-1])
                for d in tree_leaves(tree)]
    from repro.models.module import Declared as JD
    return [(d.shape, d.axes, d.init, d.scale, str(d.dtype))
            for d in jax.tree.leaves(tree, is_leaf=lambda x:
                                     isinstance(x, JD))]


@pytest.mark.parametrize("full", [False, True])
def test_model_decl_matches_reference(full):
    """Same leaves in the same order (shapes, axes, initialisers,
    dtypes), hence the same parameter count and bytes; at full width
    qwen3-32b with 2 repetitions has 14 leaves and 2.53 B parameters."""
    from repro.configs.registry import get_config as j_get_config
    from repro_torch.configs.registry import get_config
    if full:
        jcfg = j_get_config("qwen3-32b").replace(n_rep=2)
        cfg = get_config("qwen3-32b").replace(n_rep=2)
    else:
        jcfg = j_get_smoke_config("qwen3-32b")
        cfg = get_smoke_config("qwen3-32b")
    jd, d = jengine.model_decl(jcfg, "head"), engine.model_decl(cfg, "head")
    assert _decl_summary(d, True) == _decl_summary(jd, False)
    assert param_count(d) == j_param_count(jd)
    assert param_bytes(d) == j_param_bytes(jd)
    if full:
        assert len(tree_leaves(d)) == 14
        assert param_count(d) == 2_531_026_432


def test_forward_logits_match_reference():
    jcfg, cfg = _cfgs()
    jp = j_materialize(jax.random.key(3), jengine.model_decl(jcfg, "head"))
    toks = np.random.default_rng(26).integers(0, jcfg.vocab_size,
                                               (BATCH, SEQ))
    ref, _ = jengine.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                             tp="head")
    params = _port(jp)
    for remat in (True, False):
        logits, aux = engine.forward(params, tt(toks),
                                     cfg.replace(remat=remat), tp="head")
        assert logits.dtype == torch.float32 and float(aux) == 0.0
        assert tuple(logits.shape) == (BATCH, SEQ, 512)
        _close(logits, ref, atol=2e-4)
    last, _ = engine.forward(params, tt(toks), cfg, tp="head",
                             last_logit_only=True)
    _close(last, np.asarray(ref)[:, -1:], atol=2e-4)


def test_llm_params_from_jax_keeps_dtypes_and_values():
    """The smoke config's own dtypes: bf16 weights, fp32 norm scales."""
    jcfg = j_get_smoke_config("qwen3-32b")
    jp = j_materialize(jax.random.key(4), jengine.model_decl(jcfg, "head"))
    ours = _port(jp)
    for a, b in zip(tree_leaves(ours), jax.tree.leaves(jp)):
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        assert tuple(a.shape) == b.shape
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


def test_forward_in_bf16_is_finite_and_near_fp32():
    """The smoke config as it ships (bf16) runs and stays near its fp32
    evaluation on the same weights (bf16 rounding only)."""
    jcfg = j_get_smoke_config("qwen3-32b")
    cfg = get_smoke_config("qwen3-32b")
    jp = j_materialize(jax.random.key(5), jengine.model_decl(jcfg, "head"))
    toks = tt(np.random.default_rng(27).integers(0, 512, (BATCH, 64)))
    params = _port(jp)
    lo, _ = engine.forward(params, toks, cfg, tp="head")
    hi, _ = engine.forward(
        tree_map(lambda x: x.float(), params), toks,
        dataclasses.replace(cfg, **F32), tp="head")
    assert torch.isfinite(lo).all()
    assert float((lo - hi).abs().max()) < 0.1 * float(hi.abs().max())


def test_model_decl_refuses_families_of_later_slices():
    jcfg, cfg = _cfgs()
    with pytest.raises(NotImplementedError, match="encoder"):
        engine.model_decl(cfg.replace(encoder_layers=2), "head")
    for kind in ("moe", "mlstm", "slstm"):
        with pytest.raises(NotImplementedError, match=kind):
            engine.model_decl(cfg.replace(pattern=("attn", kind)), "head")
    for kind, swa in [("attn", True), ("attn", False), ("mlp", True),
                      ("cross", True)]:
        assert engine.effective_kind(kind, swa) == \
            jengine.effective_kind(kind, swa)
