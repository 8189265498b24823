"""The port's decode with caches against the reference's, on the CPU in
fp32 at the smoke configs (`repro/models/attention.py:288-413`, the
`*_cache_decl`/`*_decode` of `repro/models/blocks.py`, `cache_decl`,
`decode_step` and `build_cross_cache` of `repro/models/engine.py`).

Inputs are numpy draws (seeded) fed to both sides; parameters come from
the reference's `materialize` through `llm_params_from_jax`. The port's
`decode_step` runs from a zero cache with `pos` a 0-dim tensor; the
reference's is jitted, as `tests/test_decode_consistency.py` runs it,
once an architecture (a module fixture).

Tolerances, each against the largest magnitude of the reference's
output it is applied to (fp32 on both sides, sums in other orders):
attention cores 1e-5 (bf16 inputs: 2e-3, about half a bf16 ulp, since
one probability may round to the other bf16 neighbour); one decode step
of a sub-block 1e-5; whole-model decode logits and caches over 24 (80)
tokens 1e-3, the reference test's tightest bound, where the port lands
at most 1.6e-4 (whisper, whose encoder output feeds every step) and the
reference's own prefill and decode part by up to 2e-4; the port's own
prefill against its decode at `test_decode_consistency.py`'s bounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_smoke_config as j_get_smoke_config
from repro.models import attention as jatt
from repro.models import blocks as jB
from repro.models import engine as jengine
from repro.models.module import Declared as JDeclared
from repro.models.module import materialize as j_materialize
from repro_torch.configs.base import SHAPES_BY_NAME
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import attention as att
from repro_torch.models import blocks as B
from repro_torch.models import engine
from repro_torch.models.module import tree_leaves
from torch_port_util import tn, tt

F32 = dict(compute_dtype="float32", param_dtype="float32", remat=False,
           ssm_chunk=8, attn_chunk=16, capacity_factor=4.0)
T = 24
ATTN_TOL, BF16_TOL, STEP_TOL, MODEL_TOL = 1e-5, 2e-3, 1e-5, 1e-3
# test_decode_consistency.py's archs and bounds, and qwen3 with its
# attention forced to the window-64 ring over 80 tokens, so that it wraps
PREFILL_TOL = {"zamba2-2.7b": 5e-3, "xlstm-1.3b": 5e-3, "qwen3-32b": 1e-3,
               "granite-moe-1b-a400m": 5e-2, "whisper-small": 5e-3,
               "llama4-scout-17b-a16e": 5e-2, "llama-3.2-vision-90b": 5e-3,
               "qwen3-32b+swa": 1e-3}
RUNS = tuple(PREFILL_TOL)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, so that parallel test workers do not
    oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)) \
        .astype(np.float32)


def _close(a, b, rel, rtol=0.0):
    b = np.asarray(b, np.float32)
    if torch.is_tensor(a):
        a = a.float()
    np.testing.assert_allclose(tn(a), b,
                               atol=rel * float(np.abs(b).max()), rtol=rtol)


def _port(tree):
    return engine.llm_params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


def _cfgs(arch, **kw):
    return (j_get_smoke_config(arch).replace(**F32, **kw),
            get_smoke_config(arch).replace(**F32, **kw))


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------

def _as(x, dtype):
    """numpy fp32 -> (reference array, port tensor) in `dtype`."""
    if dtype == "bfloat16":
        return jnp.asarray(x, jnp.bfloat16), tt(x).to(torch.bfloat16)
    return jnp.asarray(x), tt(x)


@pytest.mark.parametrize("over", [None, "heads", "rows"])
@pytest.mark.parametrize("B_,KV", [(3, 2), (2, 4)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_core_matches_reference(dtype, B_, KV, over):
    """(m, l, o) of the masked scores, products accumulated in fp32 and
    the probabilities cast to the cache's dtype before PV; looped over
    the KV heads or over the rows (by default the KV heads where KV <= B,
    else the rows), each at both shapes."""
    G, D, S = 4, 32, 40
    q, qt = _as(_x((B_, KV, G, D), 0), dtype)
    ck, ckt = _as(_x((B_, S, KV, D), 1), dtype)
    cv, cvt = _as(_x((B_, S, KV, D), 2), dtype)
    valid = np.random.default_rng(3).uniform(size=(B_, S)) < 0.6
    valid[:, 0] = True
    ref = jatt._decode_core(q, ck, cv, jnp.asarray(valid))
    ours = att._decode_core(qt, ckt, cvt, tt(valid), over)
    tol = BF16_TOL if dtype == "bfloat16" else ATTN_TOL
    for a, b in zip(ours, ref):
        assert a.dtype == torch.float32 and tuple(a.shape) == b.shape
        _close(a, b, tol)


def _cache_case(S, seed, dtype="float32"):
    B_, KV, G, D = 2, 2, 3, 16
    q = _as(_x((B_, KV, G, D), seed), dtype)
    ck = _as(_x((B_, S, KV, D), seed + 1), dtype)
    cv = _as(_x((B_, S, KV, D), seed + 2), dtype)
    kn = _as(_x((B_, KV, D), seed + 3), dtype)
    vn = _as(_x((B_, KV, D), seed + 4), dtype)
    return q, ck, cv, kn, vn


@pytest.mark.parametrize("window,S,pos,dtype", [
    (None, 12, 0, "float32"), (None, 12, 5, "float32"),
    (None, 12, 11, "float32"),
    (None, 12, 17, "float32"),          # past S: writes at min(pos, S-1)
    (8, 8, 3, "float32"), (8, 8, 8, "float32"),   # the ring, then wrapped
    (8, 8, 21, "float32"),              # past S and the window
    (16, 8, 5, "float32"),              # S = seq_len < window
    (16, 8, 30, "float32"),
    (None, 12, 17, "bfloat16"), (8, 8, 21, "bfloat16")])
def test_decode_attention_local_matches_reference(window, S, pos, dtype):
    """The output and both caches; the port's caches are its inputs,
    written in place."""
    (q, qt), (ck, ckt), (cv, cvt), (kn, knt), (vn, vnt) = \
        _cache_case(S, 10 + pos, dtype)
    ref = jatt.decode_attention_local(q, ck, cv, kn, vn, jnp.int32(pos),
                                      window=window)
    ours = att.decode_attention_local(qt, ckt, cvt, knt, vnt,
                                      torch.tensor(pos), window=window)
    assert ours[1] is ckt and ours[2] is cvt
    tol = BF16_TOL if dtype == "bfloat16" else ATTN_TOL
    _close(ours[0], ref[0], tol)
    for a, b in zip(ours[1:], ref[1:]):
        np.testing.assert_array_equal(tn(a.float()),
                                      np.asarray(b, np.float32))


def test_decode_cross_attention_matches_reference(single_mesh):
    (q, qt), (ck, ckt), (cv, cvt), _, _ = _cache_case(20, 40)
    ref = jatt.decode_cross_attention(single_mesh, q, ck, cv)
    for mesh in (None, {"model": 1}):
        _close(att.decode_cross_attention(mesh, qt, ckt, cvt), ref,
               ATTN_TOL)


def test_decode_mesh_rule(single_mesh, tmp_path):
    """None and a model axis of 1 (alone or beside a data axis) take the
    local path, as the reference's; a model axis of 2 (a (1, 2) mesh of a
    gloo world) is flash-decode over the sequence-sharded cache, the
    reference's result again, the cache written by its owner only; a
    mapping cannot carry a model axis of 2 (no process group)."""
    import torch_model_axis_cases as MC
    from repro_torch.launch.mesh import run_world
    (q, qt), (ck, ckt), (cv, cvt), (kn, knt), (vn, vnt) = \
        _cache_case(12, 50)
    ref = jatt.decode_attention(single_mesh, q, ck, cv, kn, vn,
                                jnp.int32(4))
    for mesh in (None, {"model": 1}, {"data": 2, "model": 1}, {"data": 4}):
        out, _, _ = att.decode_attention(mesh, qt, ckt.clone(), cvt.clone(),
                                         knt, vnt, torch.tensor(4))
        _close(out, ref[0], ATTN_TOL)
    case = dict(kind="decode", cross=False, window=None, pos=(4,),
                q=qt[None], ck=ckt, cv=cvt, kn=knt[None], vn=vnt[None])
    cross = dict(case, cross=True)
    path, res = str(tmp_path / "in.pt"), str(tmp_path / "out{rank}.pt")
    torch.save({"self": case, "cross": cross}, path)
    run_world(MC.rank_main, 2, path, res, device="cpu", threads=1,
              timeout_s=120, store_dir=str(tmp_path))
    ref_cross = jatt.decode_cross_attention(single_mesh, q, ck, cv)
    for r in range(2):
        out = torch.load(res.format(rank=r), weights_only=False)
        (o, k2, v2), = out["self"]
        _close(o, ref[0], ATTN_TOL)
        np.testing.assert_array_equal(tn(k2), np.asarray(ref[1]))
        np.testing.assert_array_equal(tn(v2), np.asarray(ref[2]))
        _close(out["cross"][0][0], ref_cross, ATTN_TOL)
    with pytest.raises(ValueError, match="DeviceMesh"):
        att.decode_cross_attention({"model": 2}, qt, ckt, cvt)


def test_seq_sharded_flash_attention_is_flash_attention_on_one_device():
    q, k, v = (tt(_x(s, i)) for i, s in enumerate(
        [(2, 48, 2, 3, 16), (2, 48, 2, 16), (2, 48, 2, 16)]))
    for kw in (dict(causal=True), dict(causal=True, window=20),
               dict(causal=False, q_offset=0)):
        assert torch.equal(
            att.seq_sharded_flash_attention(q, k, v, q_chunk=16, **kw),
            att.flash_attention(q, k, v, q_chunk=16, **kw))


# ---------------------------------------------------------------------------
# cache declarations
# ---------------------------------------------------------------------------

def _decl_rows(tree, is_port):
    if is_port:
        return [(d.shape, d.axes, d.init, str(d.dtype).split(".")[-1])
                for d in tree_leaves(tree)]
    return [(d.shape, d.axes, d.init, str(d.dtype))
            for d in jax.tree.leaves(tree, is_leaf=lambda x:
                                     isinstance(x, JDeclared))]


@pytest.mark.parametrize("force_swa", [False, True])
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_decl_matches_reference(arch, force_swa):
    """decode_32k's batch and cache length at full width: every position's
    tree, field for field (shape, axes, init, dtype), Mamba's state and
    every mLSTM/sLSTM entry fp32, the rest in the compute dtype."""
    shape = SHAPES_BY_NAME["decode_32k"]
    jd = jengine.cache_decl(j_get_config(arch), shape.global_batch,
                            shape.seq_len, force_swa=force_swa)
    d = engine.cache_decl(get_config(arch), shape.global_batch,
                          shape.seq_len, force_swa=force_swa)
    assert len(d) == len(jd)
    for ours, ref in zip(d, jd):
        assert sorted(ours) == sorted(ref)
        assert _decl_rows(ours, True) == _decl_rows(ref, False)


def test_zero_cache_materialises_the_declaration():
    _, cfg = _cfgs("zamba2-2.7b")
    decl = engine.cache_decl(cfg, 3, 40, force_swa=True)
    cache = engine.zero_cache(decl, "cpu")
    for d, a in zip(tree_leaves(decl), tree_leaves(cache)):
        assert tuple(a.shape) == d.shape and a.dtype == d.dtype
        assert a.device.type == "cpu" and not a.any()
    attn = cfg.pattern.index("attn")
    assert tuple(cache[attn]["k"].shape)[2] == min(cfg.window, 40)


# ---------------------------------------------------------------------------
# one decode step of each sub-block kind
# ---------------------------------------------------------------------------

def _kind_case(kind):
    """(arch, the block's declaration, its random non-zero cache as
    numpy, pos): attention with a window of 8 over a ring of 8 at
    position 13 (wrapped), the full cache of 16 past its end at 19."""
    if kind in ("attn", "attn_swa"):
        arch, kw = "qwen3-32b", dict(window=8)
    else:
        arch, kw = {"cross": "whisper-small", "mlp": "qwen3-32b",
                    "moe": "llama4-scout-17b-a16e", "mamba": "zamba2-2.7b",
                    "mlstm": "xlstm-1.3b", "slstm": "xlstm-1.3b"}[kind], {}
    jcfg, cfg = _cfgs(arch, **kw)
    decl = {"attn": lambda c: jB.attn_decl(c, "head"),
            "attn_swa": lambda c: jB.attn_decl(c, "head"),
            "cross": lambda c: jB.attn_decl(c, "head", cross=True),
            "mlp": lambda c: jB.mlp_decl(c, "head"),
            "moe": lambda c: jB.moe_decl(c, "head"),
            "mamba": lambda c: jB.mamba_decl(c, "head"),
            "mlstm": lambda c: jB.mlstm_decl(c, "head"),
            "slstm": lambda c: jB.slstm_decl(c, "head")}[kind](jcfg)
    n = 2
    if kind in ("attn", "attn_swa", "cross"):
        cd = jB.attn_cache_decl(jcfg, 1, n, 16, kind, jnp.float32)
    elif kind in ("mamba", "mlstm", "slstm"):
        cd = getattr(jB, f"{kind}_cache_decl")(jcfg, 1, n, jnp.float32)
    else:
        cd = {}
    cache = {}
    for i, key in enumerate(sorted(cd)):
        x = _x(cd[key].shape[1:], 70 + i)
        if kind == "slstm" and key == "n":
            x = np.abs(x) + 0.5                    # a normalizer, > 0
        cache[key] = x
    pos = {"attn": 19, "attn_swa": 13}.get(kind, 5)
    return jcfg, cfg, decl, cache, pos


@pytest.mark.parametrize("kind", ["attn", "attn_swa", "cross", "mlp", "moe",
                                  "mamba", "mlstm", "slstm"])
def test_decode_kind_matches_reference(kind, single_mesh):
    """One step of `<kind>_decode` from a random non-zero cache: the
    output and every entry of the new cache."""
    jcfg, cfg, decl, cache, pos = _kind_case(kind)
    p = j_materialize(jax.random.key(7), decl)
    x = _x((2, jcfg.d_model), 71)
    jfn = jengine._DECODE[kind]
    ofn = engine._DECODE[kind]
    kw = dict(tp="head") if kind in ("attn", "attn_swa", "cross") else {}
    ry, rc = jfn(p, jnp.asarray(x), {k: jnp.asarray(v) for k, v in
                                     cache.items()},
                 jnp.int32(pos), jcfg, single_mesh, **kw)
    oy, oc = ofn(_port(p), tt(x), {k: tt(v) for k, v in cache.items()},
                 torch.tensor(pos), cfg, None, **kw)
    _close(oy, ry, STEP_TOL, rtol=STEP_TOL)
    assert sorted(oc) == sorted(rc)
    for key in rc:
        assert oc[key].dtype == torch.float32
        _close(oc[key], rc[key], STEP_TOL, rtol=STEP_TOL)


def test_slstm_decode_from_zero_cache_starts_m_at_zero():
    """From a zero cache m_new = max(log_f, gi), the step of `slstm_apply`
    at t = 0 (ROADMAP queue 2 F6 keeps m starting at 0)."""
    jcfg, cfg = _cfgs("xlstm-1.3b")
    p = _port(j_materialize(jax.random.key(8), jB.slstm_decl(jcfg, "head")))
    x = tt(_x((2, 1, cfg.d_model), 72))
    H, Pd = cfg.num_heads, cfg.d_model // cfg.num_heads
    cache = {k: torch.zeros(2, H, Pd) for k in ("h", "c", "n", "m")}
    y, _ = B.slstm_decode(p, x[:, 0], cache, torch.tensor(0), cfg, None)
    assert torch.allclose(y, B.slstm_apply(p, x, cfg)[:, 0], atol=1e-6,
                          rtol=1e-6)


# ---------------------------------------------------------------------------
# the engine: build_cross_cache, decode_step, forward(seq_shard=True)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,tol", [("whisper-small", 1.2e-3),
                                      ("llama-3.2-vision-90b", ATTN_TOL)])
def test_build_cross_cache_matches_reference(arch, tol):
    """The cross slots from the source memory (whisper: the encoder, its
    attention through `flash_attention`; vlm: the projector), per
    repetition, in the cache's dtype; the other slots kept. whisper's
    bound is its encoder's (`test_torch_encdec.py`: no qk-norm, so its
    fp32 softmax is ill-conditioned at the reference's init)."""
    jcfg, cfg = _cfgs(arch)
    jp = j_materialize(jax.random.key(9), jengine.model_decl(jcfg, "head"))
    src = 0.1 * _x((2, jcfg.num_src_tokens, jcfg.src_dim), 73)
    jc = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                      jengine.cache_decl(jcfg, 2, T))
    ref = jengine.build_cross_cache(jcfg, jp, jc, jnp.asarray(src), "head")
    cache = engine.zero_cache(engine.cache_decl(cfg, 2, T), "cpu")
    ours = engine.build_cross_cache(cfg, _port(jp), cache, tt(src), "head")
    ci = cfg.pattern.index("cross")
    for i, (a, b) in enumerate(zip(ours, ref)):
        if i != ci:
            assert a is cache[i]
        for key in b:
            assert a[key].dtype == torch.float32
            _close(a[key], b[key], tol)


def _swa_pattern(cfg):
    return cfg.replace(pattern=tuple("attn_swa" if k == "attn" else k
                                     for k in cfg.pattern))


def _run(run, mesh):
    """The reference's prefill and jitted decode of `run`'s smoke config
    (test_decode_consistency.py's inputs), and the port's on the same
    weights and tokens."""
    arch = run.replace("+swa", "")
    swa = run.endswith("+swa")
    steps = 80 if swa else T
    jcfg, cfg = _cfgs(arch)
    params = j_materialize(jax.random.key(0), jengine.model_decl(jcfg,
                                                                 "head"))
    toks = np.asarray(jax.random.randint(jax.random.key(1), (2, steps), 0,
                                         jcfg.vocab_size))
    src = None
    if jcfg.family in ("vlm", "audio"):
        src = np.asarray(0.1 * jax.random.normal(
            jax.random.key(3), (2, jcfg.num_src_tokens, jcfg.src_dim)))
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         jengine.cache_decl(jcfg, 2, steps, force_swa=swa))
    if src is not None:
        cache = jengine.build_cross_cache(jcfg, params, cache, src, "head")
    step = jax.jit(lambda p, c, t, pos: jengine.decode_step(
        p, c, t, pos, jcfg, mesh, tp="head", force_swa=swa))
    outs = []
    for t in range(steps):
        lg, cache = step(params, cache, toks[:, t], jnp.int32(t))
        outs.append(lg)
    ref = dict(decode=np.asarray(jnp.stack(outs, 1)),
               cache=[np.asarray(x) for x in jax.tree.leaves(cache)])

    pp = _port(params)
    psrc = None if src is None else tt(src)
    pcache = engine.zero_cache(engine.cache_decl(cfg, 2, steps,
                                                 force_swa=swa), "cpu")
    if src is not None:
        pcache = engine.build_cross_cache(cfg, pp, pcache, psrc, "head")
    ptr = [a.data_ptr() for a in tree_leaves(pcache)]
    outs = []
    with torch.no_grad():
        prefill, _ = engine.forward(pp, tt(toks),
                                    _swa_pattern(cfg) if swa else cfg,
                                    tp="head", src=psrc)
        for t in range(steps):
            lg, out = engine.decode_step(pp, pcache, tt(toks[:, t]),
                                         torch.tensor(t), cfg, None,
                                         tp="head", force_swa=swa)
            assert out is pcache
            outs.append(lg)
    assert [a.data_ptr() for a in tree_leaves(pcache)] == ptr
    ours = dict(decode=tn(torch.stack(outs, 1)), prefill=tn(prefill),
                cache=[tn(a) for a in tree_leaves(pcache)])
    return ref, ours


@pytest.fixture(scope="module")
def runs(single_mesh):
    done = {}

    def get(run):
        if run not in done:
            done[run] = _run(run, single_mesh)
        return done[run]
    return get


@pytest.mark.parametrize("run", RUNS)
def test_decode_step_matches_reference(run, runs):
    """T steps from a zero cache (whisper and vlm from `build_cross_cache`):
    every step's logits and the final cache, leaf by leaf, within
    MODEL_TOL of their largest magnitude; the cache updated in place."""
    ref, ours = runs(run)
    assert ours["decode"].shape == ref["decode"].shape
    assert np.isfinite(ours["decode"]).all()
    _close(ours["decode"], ref["decode"], MODEL_TOL)
    assert len(ours["cache"]) == len(ref["cache"])
    for a, b in zip(ours["cache"], ref["cache"]):
        assert a.shape == b.shape
        _close(a, b, MODEL_TOL)


@pytest.mark.parametrize("run", RUNS)
def test_prefill_matches_decode(run, runs):
    """The port's own prefill against its decode, at
    test_decode_consistency.py's bounds (qwen3's ring against a forward
    whose attention is the same window)."""
    _, ours = runs(run)
    rel = np.abs(ours["decode"] - ours["prefill"]).max() \
        / (np.abs(ours["prefill"]).max() + 1e-6)
    assert rel < PREFILL_TOL[run], f"{run}: prefill/decode rel={rel}"


def test_forward_seq_shard_matches_reference():
    """`forward(seq_shard=True)`, the reference's serving prefill, on one
    device: the reference's result, and bit for bit the port's
    `forward()`; with `last_logit_only` too."""
    jcfg, cfg = _cfgs("qwen3-32b")
    jp = j_materialize(jax.random.key(4), jengine.model_decl(jcfg, "head"))
    toks = np.random.default_rng(5).integers(0, jcfg.vocab_size, (2, 48))
    params = _port(jp)
    for last in (False, True):
        ref, _ = jengine.forward(jp, jnp.asarray(toks, jnp.int32), jcfg,
                                 tp="head", last_logit_only=last,
                                 seq_shard=True)
        ours, _ = engine.forward(params, tt(toks), cfg, tp="head",
                                 last_logit_only=last, seq_shard=True)
        plain, _ = engine.forward(params, tt(toks), cfg, tp="head",
                                  last_logit_only=last)
        assert torch.equal(ours, plain)
        _close(ours, ref, 2e-5)


def test_llm_params_from_jax_carries_a_reference_cache():
    jcfg, cfg = _cfgs("zamba2-2.7b")
    jc = jax.tree.map(lambda s: jnp.full(s.shape, 0.5, s.dtype),
                      jengine.cache_decl(jcfg, 2, T))
    ours = engine.llm_params_from_jax(jax.tree.map(np.asarray, jc), "cpu")
    want = tree_leaves(engine.cache_decl(cfg, 2, T))
    for a, d in zip(tree_leaves(ours), want):
        assert tuple(a.shape) == d.shape and a.dtype == d.dtype
        assert bool((a == 0.5).all())
