"""The model mesh axis (`sharding/model_axis.py` and the tensor-parallel
layers of `models/{layers,blocks,attention,engine}.py`) on gloo worlds of
2 and 4 ranks, a (1, n) ("data", "model") mesh, against the port on one
process, the reference's one-device functions and, where the reference
writes a shard_map (`seq_sharded_flash_attention`, `decode_attention`,
`decode_cross_attention`), the reference's own on a (1, n) mesh of
forced CPU devices (a subprocess).

Inputs are numpy draws (seeded) and the reference's init, in fp32. One
world of each size runs every case (`tests/torch_model_axis_cases.py`,
the ranks' side), every rank's result is checked. Tolerances, each
against the largest magnitude of the value it is applied to (sums in
other orders): blocks (attention, MLP, MoE, Mamba2, the sLSTM), their
decode steps and caches, their gradients, the cores and the LM head 1e-5
(the reference's own at `tests/test_distributed_paths.py:46` and `:75`);
the mLSTM block 5e-5 and its gradients 2e-4, `tests/test_torch_xlstm.py`'s
bounds: at the reference's init its normalizer cancels, and one process
in fp32 is itself 0.9e-5 to 1.7e-5 of their scale from the same block
in fp64; whole models 1e-4 with qk-norm (qwen3) and
`torch_ref_vfl.MODEL_TOL` without (granite, llama-3.2-vision, whisper,
zamba2, xlstm: ill-conditioned at the reference's init). Integer
decisions (argmax, the MoE's routing through its output) must agree;
replicated leaves' gradients must be equal on every rank bit for bit.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_model_axis_cases as C
from repro.configs.registry import get_smoke_config as j_get_smoke_config
from repro.models import blocks as jB
from repro.models import engine as jengine
from repro.models import layers as jL
from repro.models.module import materialize as j_materialize
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch.mesh import run_world
from repro_torch.models import attention as att
from repro_torch.models import blocks as B
from repro_torch.models import engine
from repro_torch.models import layers as L
from repro_torch.models.module import tree_leaves
from repro_torch.sharding.model_axis import (LOCAL, ModelAxis, model_axis,
                                             shard_params)
from torch_port_util import tn, tt
from torch_ref_vfl import MODEL_TOL

F32 = dict(compute_dtype="float32", param_dtype="float32", remat=False,
           attn_chunk=64, capacity_factor=4.0)
TOL, QWEN3_TOL = 1e-5, 1e-4
# the mLSTM's (output, gradient) bounds (the docstring)
MLSTM_TOL = (5e-5, 2e-4)
BT, T = 2, 64                      # a block's batch and sequence
STEPS = 4                          # whole-model decode steps


def _x(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)) \
        .astype(np.float32)


def _close(a, b, rel):
    b = np.asarray(b, np.float32)
    np.testing.assert_allclose(tn(a), b, rtol=0,
                               atol=rel * float(np.abs(b).max()))


def _cfgs(arch, **kw):
    kw = {**F32, **kw}
    return (j_get_smoke_config(arch).replace(**kw),
            get_smoke_config(arch).replace(**kw))


def _port(tree):
    return engine.llm_params_from_jax(jax.tree.map(np.asarray, tree), "cpu")


# ---------------------------------------------------------------------------
# the cases: (the ranks' case, the reference's result, the one-process
# port's result)
# ---------------------------------------------------------------------------

BLOCKS = {
    # name: (arch, fn, tp, kind, seq_shard, replace)
    "attn_head": ("qwen3-32b", "attn", "head", "attn", False, {}),
    "attn_head_swa": ("qwen3-32b", "attn", "head", "attn_swa", False,
                      {"window": 24}),
    "attn_row": ("qwen3-32b", "attn", "row", "attn", False, {}),
    # T >= 4 q_chunk: the sequence-sharded core
    "attn_row_seq": ("qwen3-32b", "attn", "row", "attn", True,
                     {"attn_chunk": 16}),
    "cross_head": ("llama-3.2-vision-90b", "attn", "head", "cross", False,
                   {}),
    "cross_row": ("llama-3.2-vision-90b", "attn", "row", "cross", False, {}),
    "mlp": ("qwen3-32b", "mlp", "head", None, False, {}),
    "moe": ("granite-moe-1b-a400m", "moe", "head", None, False,
            {"capacity_factor": 1.0}),        # tokens dropped
    # zamba2's 8 SSM heads of 64 (d_inner 512), xlstm's 4 mLSTM heads of
    # 128; with 2 heads of 256 a d_inner block of 128 is half a head at 4
    # ranks
    "mamba": ("zamba2-2.7b", "mamba", "head", None, False, {}),
    "mlstm": ("xlstm-1.3b", "mlstm", "head", None, False, {}),
    "mlstm_h2": ("xlstm-1.3b", "mlstm", "head", None, False,
                 {"num_heads": 2}),
    "slstm": ("xlstm-1.3b", "slstm", "head", None, False, {}),
}
# the recurrent blocks' decode steps from a zero cache (name: block)
BLOCK_DECODES = {"mamba_decode": "mamba", "mlstm_decode": "mlstm",
                 "mlstm_h2_decode": "mlstm_h2", "slstm_decode": "slstm"}
# whole models: (arch, replace); zamba2 at 2 repetitions, so that its
# weight-tied attention and MLP are used twice
MODELS = {"qwen3-32b": ("qwen3-32b", {}),
          "granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}),
          "llama-3.2-vision-90b": ("llama-3.2-vision-90b", {}),
          "whisper-small": ("whisper-small", {}),
          "zamba2-2.7b": ("zamba2-2.7b", {"n_rep": 2}),
          "xlstm-1.3b": ("xlstm-1.3b", {}),
          "xlstm-1.3b+h2": ("xlstm-1.3b", {"num_heads": 2})}
# one case of each kind in the world of 4 (qwen3's 8 heads: 2 a rank,
# fewer than a KV group, so K and V are repeated to the local heads;
# zamba2's 8 SSM heads: 2 a rank; the 2-head mLSTM: half a head a rank)
FOUR = ("attn_head", "attn_row_seq", "mlp", "moe", "mamba", "mlstm_h2",
        "slstm", "lm", "seq_flash", "decode_ring", "cross_decode",
        "mamba_decode", "mlstm_h2_decode", "model_qwen3-32b",
        "model_zamba2-2.7b", "model_xlstm-1.3b+h2")


def _tols(fn):
    """(output, gradient) tolerances of a block."""
    return MLSTM_TOL if fn == "mlstm" else (TOL, TOL)


def _block_case(name, seed):
    arch, fn, tp, kind, seq_shard, rep = BLOCKS[name]
    jcfg, cfg = _cfgs(arch, **rep)
    if fn == "attn":
        jdecl = jB.attn_decl(jcfg, tp, cross=kind == "cross")
        decl = B.attn_decl(cfg, tp, cross=kind == "cross")
    else:
        jdecl = getattr(jB, f"{fn}_decl")(jcfg, tp)
        decl = getattr(B, f"{fn}_decl")(cfg, tp)
    jp = j_materialize(jax.random.key(seed), jdecl)
    x = _x((BT, T, cfg.d_model), seed + 1)
    ct = _x((BT, T, cfg.d_model), seed + 2)
    kw, jkw = {}, {}
    if fn == "attn":
        kw = dict(tp=tp, kind=kind, seq_shard=seq_shard)
        if kind != "cross":
            kw["positions"] = L.rope_positions(T)
            jkw["positions"] = jL.rope_positions(T)
    case = dict(kind="block", fn=fn, cfg=cfg, decl=decl, params=_port(jp),
                x=tt(x), ct=tt(ct), kw=kw)
    args = [jnp.asarray(x)]
    if kind == "cross":
        # the source memory at 0.1 N(0, 1), as `torch_ref_vfl.src_batch`
        # draws it: at N(0, 1) the scores (no qk-norm) reach ~500, where
        # the fp32 softmax is ill-conditioned
        src = _x((BT, cfg.num_src_tokens, cfg.d_model), seed + 3, 0.1)
        case["src"] = tt(src)
        args.append(jnp.asarray(src))
    jfn = getattr(jB, f"{fn}_apply")
    jkw.update({k: v for k, v in kw.items() if k != "positions"})

    def ref_fn(p, x, *src):
        extra = dict(src=src[0]) if src else {}
        return jfn(p, x, jcfg, **jkw, **extra)
    out, vjp = jax.vjp(ref_fn, jp, *args)
    cot = (jnp.asarray(ct), jnp.float32(1.0)) if fn == "moe" \
        else jnp.asarray(ct)
    g = vjp(cot)
    ref = dict(out=out[0] if fn == "moe" else out,
               aux=out[1] if fn == "moe" else None,
               grads=jax.tree.leaves(g[0]), dins=list(g[1:]))
    one = C.block(None, case)
    return case, ref, one


def _block_decode_case(name, seed):
    """4 decode steps of a recurrent block from a zero cache (x [2, d]
    draws), the reference's `*_decode` stepping its own cache."""
    arch, fn, _, _, _, rep_ = BLOCKS[BLOCK_DECODES[name]]
    jcfg, cfg = _cfgs(arch, **rep_)
    jp = j_materialize(jax.random.key(seed),
                       getattr(jB, f"{fn}_decl")(jcfg, "head"))
    cache_decl = getattr(B, f"{fn}_cache_decl")(cfg, 1, BT, torch.float32)
    jcache = jax.tree.map(lambda d: jnp.zeros(d.shape[1:], jnp.float32),
                          getattr(jB, f"{fn}_cache_decl")(jcfg, 1, BT,
                                                          jnp.float32))
    xs = _x((STEPS, BT, cfg.d_model), seed + 1)
    case = dict(kind="block_decode", fn=fn, cfg=cfg,
                decl=getattr(B, f"{fn}_decl")(cfg, "head"), params=_port(jp),
                cache_decl=cache_decl,
                cache=engine.zero_cache(cache_decl, "cpu"), xs=tt(xs))
    jdec = getattr(jB, f"{fn}_decode")
    outs = []
    for t in range(STEPS):
        y, jcache = jdec(jp, jnp.asarray(xs[t]), jcache, jnp.int32(t), jcfg,
                         None)
        outs.append(np.asarray(y))
    ref = dict(outs=np.stack(outs),
               cache={k: np.asarray(v)[None] for k, v in jcache.items()})
    return case, ref, C.block_decode(None, case)


def _lm_case(seed):
    V, d = 512, 64
    decl = {"embed": L.embed_decl(V, d), "lm_head": L.unembed_decl(V, d)}
    jdecl = {"embed": jL.embed_decl(V, d), "lm_head": jL.unembed_decl(V, d)}
    jp = j_materialize(jax.random.key(seed), jdecl)
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, V, (BT, 16))
    labels = rng.integers(0, V, (BT, 16))
    scale = 30.0                     # logits of a few units, not ~0

    def ref_fn(p):
        x = jL.embed(p["embed"], jnp.asarray(tokens)) * scale
        ls = [jL.softmax_cross_entropy(lg, jnp.asarray(labels)) for lg in (
            jL.unembed(p["lm_head"], x), jL.unembed_tied(p["embed"], x))]
        return ls[0] + 2.0 * ls[1], (ls, jL.unembed(p["lm_head"], x),
                                     jL.unembed_tied(p["embed"], x), x)
    (_, (losses, logits, tied, x)), g = jax.value_and_grad(
        ref_fn, has_aux=True)(jp)
    case = dict(kind="lm", decl=decl, params=_port(jp), tokens=tt(tokens),
                labels=tt(labels), scale=scale)
    ref = dict(losses=losses, logits=logits, tied=tied, x=x,
               grads=jax.tree.leaves(g))
    return case, ref, C.lm(None, case)


def _seq_flash_case(seed):
    q = _x((BT, 128, 2, 2, 16), seed)
    k, v = _x((BT, 128, 2, 16), seed + 1), _x((BT, 128, 2, 16), seed + 2)
    case = dict(kind="seq_flash", q=tt(q), k=tt(k), v=tt(v),
                ct=tt(_x(q.shape, seed + 3)), q_chunk=16,
                kw=dict(causal=True))
    return case, dict(q=q, k=k, v=v), C.seq_flash(None, case)


DECODES = {
    # name: (S, window, positions, cross)
    "decode_full": (64, None, (0, 5, 37, 63, 70), False),
    "decode_ring": (16, 16, (3, 15, 16, 21, 40), False),
    "cross_decode": (32, None, (0,), True),
}


def _decode_case(name, seed):
    S, window, pos, cross = DECODES[name]
    Bd, KV, G, D = 2, 2, 2, 16
    n = len(pos)
    case = dict(kind="decode", cross=cross, window=window, pos=pos,
                q=tt(_x((n, Bd, KV, G, D), seed)),
                ck=tt(_x((Bd, S, KV, D), seed + 1)),
                cv=tt(_x((Bd, S, KV, D), seed + 2)),
                kn=tt(_x((n, Bd, KV, D), seed + 3)),
                vn=tt(_x((n, Bd, KV, D), seed + 4)))
    one = C.decode(None, dict(case, ck=case["ck"].clone(),
                              cv=case["cv"].clone()))
    return case, {k: tn(v) for k, v in case.items() if torch.is_tensor(v)}, \
        one


def _model_case(name, seed):
    arch, rep_ = MODELS[name]
    jcfg, cfg = _cfgs(arch, **rep_)
    jp = j_materialize(jax.random.key(seed), jengine.model_decl(jcfg, "head"))
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (2, 24))
    src = None
    if cfg.family in ("vlm", "audio"):
        src = _x((2, cfg.num_src_tokens, cfg.src_dim), seed + 1, 0.1)
    case = dict(kind="model", cfg=cfg, tp="head", params=_port(jp),
                tokens=tt(toks), src=None if src is None else tt(src),
                cache_len=24, steps=STEPS)
    jsrc = None if src is None else jnp.asarray(src)
    logits, _ = jengine.forward(jp, jnp.asarray(toks), jcfg, tp="head",
                                src=jsrc)
    mesh = jax.make_mesh((1,), ("model",),
                         axis_types=(jax.sharding.AxisType.Auto,))
    cache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                         jengine.cache_decl(jcfg, 2, 24))
    if src is not None:
        cache = jengine.build_cross_cache(jcfg, jp, cache, jsrc, "head")
    step = jax.jit(lambda p, c, t, pos: jengine.decode_step(
        p, c, t, pos, jcfg, mesh, tp="head"))
    outs = []
    for t in range(STEPS):
        lg, cache = step(jp, cache, jnp.asarray(toks[:, t]), jnp.int32(t))
        outs.append(lg)
    ref = dict(logits=np.asarray(logits), decode=np.stack(outs, 1))
    return case, ref, C.model(None, case)


def _all_cases():
    out = {name: _block_case(name, 10 * i) for i, name in enumerate(BLOCKS)}
    for i, name in enumerate(BLOCK_DECODES):
        out[name] = _block_decode_case(name, 200 + 10 * i)
    out["lm"] = _lm_case(90)
    out["seq_flash"] = _seq_flash_case(100)
    for i, name in enumerate(DECODES):
        out[name] = _decode_case(name, 110 + 10 * i)
    for i, name in enumerate(MODELS):
        out[f"model_{name}"] = _model_case(name, 150 + i)
    return out


# the reference's shard_map paths on (1, n) meshes of forced CPU devices:
# seq_sharded_flash_attention, and decode_attention / decode_cross_attention
# stepping the cache through the positions, as the ranks do
_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.models.attention import (decode_attention,
        decode_cross_attention, seq_sharded_flash_attention)
    inp = dict(np.load(sys.argv[1]))
    out = {}
    for n in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(1, n),
                    ("data", "model"),
                    axis_types=(jax.sharding.AxisType.Auto,) * 2)
        with jax.set_mesh(mesh):
            out[f"{n}/seq_flash"] = np.asarray(jax.jit(
                lambda q, k, v: seq_sharded_flash_attention(
                    q, k, v, q_chunk=16, kv_chunk=16))(
                inp["seq_flash/q"], inp["seq_flash/k"], inp["seq_flash/v"]))
            for name, (window, pos, cross) in %(DECODES)r.items():
                ck, cv = inp[name + "/ck"], inp[name + "/cv"]
                for i, p in enumerate(pos):
                    q = inp[name + "/q"][i]
                    if cross:
                        o = jax.jit(lambda q, ck, cv: decode_cross_attention(
                            mesh, q, ck, cv))(q, ck, cv)
                    else:
                        o, ck, cv = jax.jit(
                            lambda *a: decode_attention(
                                mesh, *a, window=window))(
                            q, ck, cv, inp[name + "/kn"][i],
                            inp[name + "/vn"][i], jnp.int32(p))
                    out[f"{n}/{name}/{i}/out"] = np.asarray(o)
                    out[f"{n}/{name}/{i}/ck"] = np.asarray(ck)
                    out[f"{n}/{name}/{i}/cv"] = np.asarray(cv)
    np.savez(sys.argv[2], **out)
""")


def _start_reference(cases, tmp):
    arrays = {}
    for name in ("seq_flash",) + tuple(DECODES):
        for k, v in cases[name][1].items():
            arrays[f"{name}/{k}"] = v
    np.savez(str(tmp / "ref_in.npz"), **arrays)
    src = _REFERENCE % dict(DECODES={
        k: (w, p, c) for k, (_, w, p, c) in DECODES.items()})
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    return subprocess.Popen(
        [sys.executable, "-c", src, str(tmp / "ref_in.npz"),
         str(tmp / "ref_out.npz")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Every case on a world of 2 ranks and FOUR on a world of 4 (each
    rank's result), with the reference's and the one-process port's
    results and the reference's shard_map results on (1, 2) and (1, 4)."""
    tmp = tmp_path_factory.mktemp("model_axis")
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cases = _all_cases()
    finally:
        torch.set_num_threads(n_threads)
    proc = _start_reference(cases, tmp)
    out = {}
    try:
        for n, names in ((2, tuple(cases)), (4, FOUR)):
            path = str(tmp / f"in{n}.pt")
            torch.save({k: cases[k][0] for k in names}, path)
            res = str(tmp / f"out{n}_{{rank}}.pt")
            run_world(C.rank_main, n, path, res, device="cpu", threads=1,
                      timeout_s=300, store_dir=str(tmp))
            out[n] = [torch.load(res.format(rank=r), weights_only=False)
                      for r in range(n)]
        log, _ = proc.communicate(timeout=300)
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, log[-3000:]
    with np.load(str(tmp / "ref_out.npz")) as f:
        sharded = dict(f)
    return cases, out, sharded


def _ranks(worlds, name):
    """(n, rank, result) of every rank of every world that ran `name`."""
    _, out, _ = worlds
    return [(n, r, res[name]) for n in out for r, res in enumerate(out[n])
            if name in res]


def _replicated(decl):
    """Which leaves of `decl` no dim of which maps to the model axis."""
    from repro_torch.sharding.rules import default_rules
    rules = default_rules()
    return [all(rules.mesh_axis(a) != "model" for a in d.axes)
            for d in tree_leaves(decl)]


@pytest.mark.parametrize("name", tuple(BLOCKS))
def test_block_matches_one_process_and_reference(worlds, name):
    """attention (head, and row with and without the sequence-sharded
    core; self, sliding-window and cross), the MLP, the MoE block,
    Mamba2, the mLSTM (whole heads a rank, and half a head) and the
    sLSTM: the output and every gradient (split leaves gathered) on each
    rank, against the one-process port and the reference's one-device
    block; replicated leaves' gradients equal on every rank bit for
    bit."""
    cases, _, _ = worlds
    case, ref, one = cases[name]
    runs = _ranks(worlds, name)
    assert {n for n, _, _ in runs} >= {2}
    rep = _replicated(case["decl"])
    tol, gtol = _tols(case["fn"])
    for n, r, res in runs:
        assert res["gathered_equal"]     # the blocks give the whole back
        _close(res["out"], one["out"], tol)
        _close(res["out"], ref["out"], tol)
        if ref["aux"] is not None:
            _close(res["aux"], ref["aux"], TOL)
        for a, b, c in zip(tree_leaves(res["grads"]),
                           tree_leaves(one["grads"]), ref["grads"]):
            _close(a, b, gtol)
            _close(a, c, gtol)
        for a, b, c in zip(res["dins"], one["dins"], ref["dins"]):
            _close(a, b, gtol)
            _close(a, c, gtol)
        first = worlds[1][n][0][name]
        for keep, a, b in zip(rep, res["local_grads"], first["local_grads"]):
            if keep:
                assert torch.equal(a, b), name


class _Coordinate:
    """The geometry of a (1, n) mesh as rank r sees it, for
    `shard_params` outside a world."""

    def __init__(self, n, r):
        self.mesh_dim_names, self.mesh = ("data", "model"), torch.empty(1, n)
        self.r = r

    def get_local_rank(self, axis):
        return self.r if axis == "model" else 0


@pytest.mark.parametrize("name", tuple(BLOCK_DECODES))
def test_block_decode_matches_one_process_and_reference(worlds, name):
    """Mamba2's, the mLSTM's and the sLSTM's decode steps from a zero
    cache of this rank's block: each step's output against one process
    and the reference's `*_decode`, and every rank's cache block after
    the last step against one process's cache as `shard_params` cuts it
    (Mamba2's conv history by d_inner and state by heads, the mLSTM's C
    and n by the head dim, the sLSTM's whole)."""
    cases, _, _ = worlds
    case, ref, one = cases[name]
    runs = _ranks(worlds, name)
    assert {n for n, _, _ in runs} >= {2}
    tol, _ = _tols(case["fn"])
    for n, r, res in runs:
        _close(res["outs"], one["outs"], tol)
        _close(res["outs"], ref["outs"], tol)
        want = shard_params(_Coordinate(n, r), one["cache"],
                            case["cache_decl"])
        for k, v in res["cache"].items():
            assert v.shape == want[k].shape
            _close(v, want[k], tol)
            _close(v, shard_params(_Coordinate(n, r), {k: tt(
                ref["cache"][k])}, {k: case["cache_decl"][k]})[k], tol)
        split = [k for k in want if want[k].shape != one["cache"][k].shape]
        assert set(split) == (set() if case["fn"] == "slstm" else set(want))


def test_embedding_lm_head_and_loss_are_vocab_parallel(worlds):
    """The masked lookup summed over the axis, the local logits gathered,
    the loss from the reduced max, sum of exponentials and target logit
    (untied and tied), and the table's and the head's gradients."""
    cases, _, _ = worlds
    _, ref, one = cases["lm"]
    for n, r, res in _ranks(worlds, "lm"):
        assert torch.equal(res["x"], one["x"])    # one nonzero row a token
        for key in ("logits", "tied"):
            assert res[key].shape == one[key].shape
            _close(res[key], one[key], TOL)
            _close(res[key], ref[key], TOL)
        for a, b, c in zip(res["losses"], one["losses"], ref["losses"]):
            _close(a, b, TOL)
            _close(a, c, TOL)
        for a, b, c in zip(tree_leaves(res["grads"]),
                           tree_leaves(one["grads"]), ref["grads"]):
            _close(a, b, TOL)
            _close(a, c, TOL)


def test_seq_sharded_flash_attention_matches_reference_shard_map(worlds):
    """Each rank's T/n queries at their offset against the whole K and V,
    all-gathered: the reference's shard_map on (1, n) forced CPU devices
    and the one-device core within 1e-5; the gradients as one process's
    (K's and V's summed over the ranks)."""
    cases, _, sharded = worlds
    case, _, one = cases["seq_flash"]
    runs = _ranks(worlds, "seq_flash")
    assert {n for n, _, _ in runs} == {2, 4}
    for n, r, res in runs:
        _close(res["out"], sharded[f"{n}/seq_flash"], TOL)
        _close(res["out"], one["out"], TOL)
        for a, b in zip(res["grads"], one["grads"]):
            _close(a, b, TOL)


@pytest.mark.parametrize("name", tuple(DECODES))
def test_flash_decode_matches_reference_shard_map(worlds, name):
    """Flash-decode over the sequence-sharded cache, step by step (the
    full cache past its end, the ring across its wrap, cross-attention):
    the output against the reference's shard_map and the local path,
    the whole cache (only the owner wrote the row) exactly."""
    cases, _, sharded = worlds
    _, _, one = cases[name]
    for n, r, res in _ranks(worlds, name):
        for i, ((out, ck, cv), (o1, k1, v1)) in enumerate(zip(res, one)):
            key = f"{n}/{name}/{i}"
            _close(out, sharded[key + "/out"], TOL)
            _close(out, o1, TOL)
            assert torch.equal(ck, k1) and torch.equal(cv, v1)
            np.testing.assert_array_equal(tn(ck), sharded[key + "/ck"])
            np.testing.assert_array_equal(tn(cv), sharded[key + "/cv"])


@pytest.mark.parametrize("arch", MODELS)
def test_model_forward_and_decode_match(worlds, arch):
    """The whole model split over the axis (head mode): `forward`'s
    logits and 4 `decode_step`s from a zero cache of this rank's block
    (S/n slots of K/V; Mamba2's d_inner/n channels and H/n heads; the
    mLSTM's P/n rows of C and n), against one process and the
    reference; argmax equal."""
    from repro_torch.sharding.rules import default_rules
    rules = default_rules()
    cases, _, _ = worlds
    case, ref, one = cases[f"model_{arch}"]
    tol = QWEN3_TOL if case["cfg"].qk_norm else MODEL_TOL
    decl = tree_leaves(engine.cache_decl(case["cfg"], 2, case["cache_len"]))
    for n, r, res in _ranks(worlds, f"model_{arch}"):
        assert res["gathered_equal"]
        for key in ("logits", "decode"):
            _close(res[key], one[key], tol)
            _close(res[key], ref[key], tol)
            assert torch.equal(res[key].argmax(-1), one[key].argmax(-1))
        want = [tuple(s // n if rules.mesh_axis(a) == "model" else s
                      for s, a in zip(d.shape, d.axes)) for d in decl]
        assert res["cache_shapes"] == want != one["cache_shapes"]


def test_one_rank_axis_is_the_one_device_path(monkeypatch):
    """A model axis of one rank (None, a mapping, LOCAL) issues no
    collective (every collective of torch.distributed raises here) and is
    the one-device path bit for bit; a mapping with a model axis above 1
    is refused (a world's DeviceMesh is needed)."""
    import torch.distributed as dist

    def no_collective(*a, **k):
        raise AssertionError("a collective ran on a model axis of one rank")
    for name in ("all_reduce", "all_gather", "all_gather_into_tensor",
                 "broadcast"):
        monkeypatch.setattr(dist, name, no_collective)
    assert model_axis(None) is LOCAL
    assert model_axis({"data": 4, "model": 1}) is LOCAL
    with pytest.raises(ValueError, match="DeviceMesh"):
        model_axis({"data": 1, "model": 2})
    jcfg, cfg = _cfgs("qwen3-32b")
    p = _port(j_materialize(jax.random.key(3), jB.attn_decl(jcfg, "row")))
    x = tt(_x((BT, T, cfg.d_model), 4))
    kw = dict(positions=L.rope_positions(T))
    head = B.attn_apply(p, x, cfg, tp="head", **kw)
    for mesh in (None, {"model": 1}, LOCAL):
        assert torch.equal(B.attn_apply(p, x, cfg, tp="row", mesh=mesh,
                                        seq_shard=True, **kw), head)
    q, k, v = (tt(_x(s, i)) for i, s in enumerate(
        [(2, 64, 2, 2, 16), (2, 64, 2, 16), (2, 64, 2, 16)]))
    assert torch.equal(att.seq_sharded_flash_attention(q, k, v, q_chunk=16,
                                                       mesh={"model": 1}),
                       att.flash_attention(q, k, v, q_chunk=16))
    mcfg = get_smoke_config("qwen3-32b").replace(**F32)
    mp = _port(j_materialize(jax.random.key(6), jengine.model_decl(
        _cfgs("qwen3-32b")[0], "head")))
    toks = torch.tensor(np.random.default_rng(7).integers(
        0, mcfg.vocab_size, (2, 16)))
    base = engine.forward(mp, toks, mcfg, tp="head")[0]
    assert torch.equal(engine.forward(mp, toks, mcfg, tp="head",
                                      mesh={"data": 1, "model": 1})[0], base)
    loss = L.softmax_cross_entropy(base, toks, mesh=LOCAL)
    assert torch.equal(loss, L.softmax_cross_entropy(base, toks))


@pytest.mark.parametrize("arch,what", [("zamba2-2.7b", "ssm_heads"),
                                       ("xlstm-1.3b", "row_head_dim")])
def test_ssm_families_refuse_a_model_axis(worlds, arch, what):
    """zamba2 and xlstm run at a model axis of 2 and 4 (their forward and
    decode match one process: `test_model_forward_and_decode_match`); an
    axis that does not divide a dim their declarations split over it
    (zamba2's 8 SSM heads at 16: only that dim; xlstm's mLSTM head dim of
    128, d_inner and vocab of 512 at 3) raises a ValueError naming each
    such dim, up front and at the engine's entries (forward,
    decode_step), before any work."""
    assert {n for name, (a, _) in MODELS.items() if a == arch
            for n, _, _ in _ranks(worlds, f"model_{name}")} == {2, 4}
    cfg = get_smoke_config(arch).replace(**F32)
    n, dims = {"zamba2-2.7b": (16, ["ssm_heads of 8"]),
               "xlstm-1.3b": (3, ["row_head_dim of 128", "mlp of 512",
                                  "vocab of 512"])}[arch]
    assert what in dims[0]
    engine.check_model_axis(cfg, "row", 1)
    for m in (2, 4):
        engine.check_model_axis(cfg, "head", m)
    with pytest.raises(ValueError) as e:
        engine.check_model_axis(cfg, "row", n)
    named = sorted(x.split(" (")[0] for x in str(e.value).split(
        "does not divide ")[1].split("; ")[0].split(", "))
    assert named == sorted(dims), str(e.value)
    ax = ModelAxis(None, 0, n)
    toks = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match=what):
        engine.forward({"embed": None}, toks, cfg, tp="row", mesh=ax)
    with pytest.raises(ValueError, match=what):
        engine.decode_step({"embed": None}, [], toks[:, 0], torch.tensor(0),
                           cfg, ax, tp="row")


def test_zero_cache_cuts_the_sequence_or_raises():
    """Over a model axis of n each rank's cache holds S/n slots of
    `cache_seq`; a cache length that n does not divide raises, as
    `shard_params` does, instead of cutting the sequence short."""
    cfg = get_smoke_config("qwen3-32b").replace(**F32)
    full = engine.zero_cache(engine.cache_decl(cfg, 2, 32), "cpu")
    cut = engine.zero_cache(engine.cache_decl(cfg, 2, 32), "cpu",
                            ModelAxis(None, 1, 2))
    for f, c in zip(tree_leaves(full), tree_leaves(cut)):
        assert c.shape[:2] + c.shape[3:] == f.shape[:2] + f.shape[3:]
        assert c.shape[2] * 2 == f.shape[2]
    with pytest.raises(ValueError, match="does not split"):
        engine.zero_cache(engine.cache_decl(cfg, 2, 33), "cpu",
                          ModelAxis(None, 0, 2))
