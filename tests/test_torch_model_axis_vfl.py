"""The VFL round on a (2, 2) ("data", "model") gloo world (`fl/vfl.py`):
two vehicles, each model split over two ranks (head-parallel attention,
column/row MLP, vocab-parallel embedding, LM head and loss), against the
port's one-process round and the reference's `make_vfl_round` on a
(2, 2) mesh of four forced CPU devices (a subprocess), at qwen3-32b's
smoke config in fp32 on the reference's parameters and batches.

Tolerances are `tests/test_torch_vfl_mesh.py`'s: the aggregated
parameters within 2e-4 absolute (sums in other orders); the all-failed
round keeps the old parameters exactly. Every rank's replicated leaves
(`wk`, `wv`, the norms: used in split form, their gradients summed over
the model axis) are bit for bit equal after a round. The driver's
`--devices 4 --vehicles 2` is tested beside its other layouts, in
`tests/test_torch_vfl_mesh.py`.

The same world runs zamba2-2.7b's smoke config at 2 repetitions (Mamba2
split by heads, the weight-tied attention and MLP used twice) and
xlstm-1.3b's (the mLSTM split by its head dim, the sLSTM replicated), in
fp32 from the port's init, against the port's one-process round: each
leaf's update within `SSM_UPDATE_TOL` (`torch_ref_vfl.MODEL_TOL`) of its
norm, the bound these configurations are held to against the reference
(ill-conditioned at their init, `tests/test_torch_zamba2.py`; measured
here up to 2.0e-3 for zamba2 and 2.6e-4 for xlstm), the all-failed round
the old parameters exactly, and the replicated leaves (`w_bc`, `w_if`,
the sLSTM, the norms) bit for bit equal on every rank.
"""
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import torch_model_axis_cases as MC
from repro.configs.registry import get_smoke_config as j_get_smoke_config
from repro.data.synthetic import lm_batch as j_lm_batch
from repro.models import engine as jengine
from repro.models.module import materialize as j_materialize
from repro_torch.configs.registry import get_smoke_config
from repro_torch.data.synthetic import lm_batch
from repro_torch.fl import vfl
from repro_torch.launch.mesh import run_world
from repro_torch.models import engine
from repro_torch.models.module import materialize, tree_leaves, tree_map
from repro_torch.sharding.policy import attention_tp_mode
from repro_torch.sharding.rules import default_rules
from torch_ref_vfl import MODEL_TOL

V, M, BPV, SEQ, LR, ATOL = 2, 2, 2, 32, 0.1, 2e-4
# the recurrent families' runs: (arch, replace); the update's bound
SSM_RUNS = {"zamba2-2.7b": ("zamba2-2.7b", {"n_rep": 2}),
            "xlstm-1.3b": ("xlstm-1.3b", {})}
SSM_UPDATE_TOL = MODEL_TOL
MASKS = (([1., 1.], [1., 2.]), ([0., 1.], [1., 1.]), ([0., 0.], [1., 1.]))
CASES = tuple((torch.tensor(m), torch.tensor(w)) for m, w in MASKS)
F32 = dict(param_dtype="float32", compute_dtype="float32", num_vehicles=V,
           grad_accum=2)

# the reference's round on a (V, M) ("data", "model") mesh of V * M forced
# CPU devices, on the parameters and batches of jax keys 0 and 1
_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%(N)d"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.registry import get_smoke_config
    from repro.data.synthetic import lm_batch
    from repro.fl.vfl import make_vfl_round
    from repro.models import engine
    from repro.models.module import materialize
    from repro.sharding.policy import attention_tp_mode
    V, M, BPV, SEQ, LR = %(V)d, %(M)d, %(BPV)d, %(SEQ)d, %(LR)r
    cfg = get_smoke_config("qwen3-32b").replace(**%(F32)r)
    tp = attention_tp_mode(cfg.num_heads, M)
    jp = materialize(jax.random.key(0), engine.model_decl(cfg, tp))
    params_v = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (V,) + x.shape), jp)
    batch = lm_batch(jax.random.key(1), V * BPV, SEQ, cfg.vocab_size)
    batch_v = jax.tree.map(lambda x: x.reshape(V, BPV, *x.shape[1:]),
                           batch)
    mesh = jax.make_mesh((V, M), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    with jax.set_mesh(mesh):
        fn = jax.jit(make_vfl_round(cfg, mesh, tp, lr=LR))
        for i, (m, w) in enumerate(%(MASKS)r):
            res = fn(params_v, batch_v, jnp.array(m), jnp.array(w))
            for j, leaf in enumerate(jax.tree.leaves(res)):
                out[f"{i}/{j}"] = np.asarray(leaf)
    np.savez(sys.argv[1], **out)
""")


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    """The three rounds on the (2, 2) world (every rank's result), on one
    process and on the reference's (2, 2) mesh (run beside the ranks)."""
    tmp = tmp_path_factory.mktemp("vfl_tp")
    ref_path = str(tmp / "reference.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    proc = subprocess.Popen(
        [sys.executable, "-c", _REFERENCE % dict(
            N=V * M, V=V, M=M, BPV=BPV, SEQ=SEQ, LR=LR, F32=F32,
            MASKS=MASKS), ref_path], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    jcfg = j_get_smoke_config("qwen3-32b").replace(**F32)
    cfg = get_smoke_config("qwen3-32b").replace(**F32)
    tp = attention_tp_mode(cfg.num_heads, M)
    jp = j_materialize(jax.random.key(0), jengine.model_decl(jcfg, tp))
    params = engine.llm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    b = j_lm_batch(jax.random.key(1), V * BPV, SEQ, jcfg.vocab_size)
    batch_v = {k: torch.as_tensor(np.array(x), dtype=torch.int64).reshape(
        V, BPV, *x.shape[1:]) for k, x in b.items()}
    path = str(tmp / "inputs.pt")
    res = str(tmp / "out{rank}.pt")
    runs = {"qwen3-32b": dict(cfg=cfg, tp=tp, params=params,
                              batch_v=batch_v)}
    for name, (arch, rep) in SSM_RUNS.items():
        scfg = get_smoke_config(arch).replace(**F32, **rep)
        stp = attention_tp_mode(scfg.num_heads, M)
        runs[name] = dict(cfg=scfg, tp=stp, params=materialize(
            torch.Generator().manual_seed(5), engine.model_decl(scfg, stp)),
            batch_v=lm_batch(torch.Generator().manual_seed(6), V * BPV, SEQ,
                             scfg.vocab_size))
        runs[name]["batch_v"] = {k: x.reshape(V, BPV, *x.shape[1:])
                                 for k, x in runs[name]["batch_v"].items()}
    torch.save(dict(model=M, runs=runs, lr=LR, cases=CASES), path)
    try:
        run_world(MC.vfl_rank_main, V * M, path, res, device="cpu",
                  threads=1, timeout_s=300, store_dir=str(tmp))
        one_out = {}
        for name, run in runs.items():
            one = vfl.make_vfl_round(run["cfg"], None, run["tp"], lr=LR)
            stacked = tree_map(lambda x: x.unsqueeze(0).expand(V, *x.shape),
                               run["params"])
            one_out[name] = [one(stacked, run["batch_v"], m, w)
                             for m, w in CASES]
        log, _ = proc.communicate(timeout=300)
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, log[-3000:]
    n_leaves = len(tree_leaves(params))
    with np.load(ref_path) as f:
        ref = [[f[f"{i}/{j}"] for j in range(n_leaves)]
               for i in range(len(CASES))]
    mesh_out = [torch.load(res.format(rank=r), weights_only=False)
                for r in range(V * M)]
    return runs, mesh_out, one_out, ref


@pytest.mark.parametrize("i", range(len(CASES)))
def test_vfl_round_on_a_model_axis_matches(rounds, i):
    """Masks [1, 1], [0, 1] (weights [1, 2], [1, 1]) and all failed, on
    every rank of the (2, 2) world, its vehicle's model gathered whole:
    against the one-process round's vehicle and the reference's round on
    its (2, 2) mesh; the all-failed round keeps the old params exactly."""
    runs, mesh_out, one_out, ref = rounds
    params = runs["qwen3-32b"]["params"]
    for r in range(V * M):
        v = r // M                          # the mesh's data coordinate
        ours = tree_leaves(mesh_out[r]["qwen3-32b"][i]["whole"])
        for a, b, c in zip(ours, tree_leaves(one_out["qwen3-32b"][i]),
                           ref[i]):
            np.testing.assert_allclose(a.numpy(), b[v].numpy(), atol=ATOL,
                                       rtol=0)
            np.testing.assert_allclose(a.numpy(), c[v], atol=ATOL, rtol=0)
        if not CASES[i][0].any():
            for a, p in zip(ours, tree_leaves(params)):
                assert torch.equal(a, p)
        else:
            assert any(not torch.equal(a, p) for a, p in
                       zip(ours, tree_leaves(params)))


def _replicated_equal(runs, mesh_out, name, i):
    """Whether every leaf no dim of which is split over the model axis
    is bit for bit equal on all ranks after round i of run `name`; how
    many such leaves there are."""
    rules = default_rules()
    decl = tree_leaves(engine.model_decl(runs[name]["cfg"],
                                         runs[name]["tp"]))
    rep = [all(rules.mesh_axis(a) != "model" for a in d.axes) for d in decl]
    first = tree_leaves(mesh_out[0][name][i]["local"])
    for r in range(1, V * M):
        for keep, a, b in zip(rep, tree_leaves(
                mesh_out[r][name][i]["local"]), first):
            assert not keep or torch.equal(a, b), (name, r)
    return sum(rep)


@pytest.mark.parametrize("i", range(2))
def test_replicated_leaves_stay_equal_on_every_rank(rounds, i):
    """The leaves no dim of which is split over the model axis (the
    norms, `wk`, `wv`, the qk-norms) are bit for bit equal on all four
    ranks after a round: each took its whole gradient on every rank."""
    runs, mesh_out, _, _ = rounds
    assert _replicated_equal(runs, mesh_out, "qwen3-32b", i) >= 5


@pytest.mark.parametrize("name", tuple(SSM_RUNS))
@pytest.mark.parametrize("i", range(len(CASES)))
def test_recurrent_vfl_round_on_a_model_axis_matches(rounds, name, i):
    """zamba2 (Mamba2 by heads; the tied attention and MLP head-parallel)
    and xlstm (the mLSTM by its head dim; the sLSTM replicated) on the
    (2, 2) world: every rank's vehicle, gathered whole, against the
    one-process round's, each leaf's update within SSM_UPDATE_TOL of its
    norm; the all-failed round keeps the old params exactly; the
    replicated leaves (`w_bc`, `w_if`, the sLSTM, the norms) bit for bit
    equal on every rank."""
    runs, mesh_out, one_out, _ = rounds
    params = tree_leaves(runs[name]["params"])
    for r in range(V * M):
        ours = tree_leaves(mesh_out[r][name][i]["whole"])
        for a, b, p in zip(ours, tree_leaves(one_out[name][i]), params):
            step = b[r // M] - p
            assert float((a - b[r // M]).norm()) <= SSM_UPDATE_TOL * max(
                float(step.norm()), 1e-30)
        if not CASES[i][0].any():
            assert all(torch.equal(a, p) for a, p in zip(ours, params))
        else:
            assert any(not torch.equal(a, p) for a, p in zip(ours, params))
    assert _replicated_equal(runs, mesh_out, name, i) >= 4
