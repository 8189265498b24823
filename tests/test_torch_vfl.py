"""The port's VFL round (`fl/vfl.py`), its LM data and the training
driver (`launch/train.py`) against the reference, at qwen3-32b's smoke
config in fp32.

Weights are the reference's, carried over with `llm_params_from_jax`;
batches are the reference's `lm_batch` draws. Tolerances: local SGD and
the aggregated parameters within 2e-4 absolute (fp32 on both sides;
gradients summed in other orders); the all-fail and mask-0 branches
keep the old parameters exactly; VEDS masks identical.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channel.mobility import ManhattanParams as JManhattan
from repro.channel.v2x import ChannelParams as JChannel
from repro.configs.registry import get_smoke_config as j_get_smoke_config
from repro.core.lyapunov import VedsParams as JVeds
from repro.core.scenario import ScenarioParams as JScenario
from repro.core.scenario import make_round as j_make_round
from repro.core.veds import veds_round as j_veds_round
from repro.data.synthetic import lm_batch as j_lm_batch
from repro.fl.vfl import _local_sgd as j_local_sgd
from repro.fl.vfl import lm_loss as j_lm_loss
from repro.fl.vfl import make_vfl_round as j_make_vfl_round
from repro.models import engine as jengine
from repro.models.module import materialize as j_materialize
from repro_torch.channel.v2x import ChannelParams
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.lyapunov import VedsParams
from repro_torch.data.synthetic import (lm_batch, lm_batch_draws,
                                        lm_batch_from_draws)
from repro_torch.fl import vfl
from repro_torch.kernels.fedavg_agg import ops as fedavg_ops
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.launch import train as train_mod
from repro_torch.models import engine
from repro_torch.models.module import tree_leaves, tree_map
from torch_port_util import round_to_torch, tn, tt

F32 = dict(param_dtype="float32", compute_dtype="float32")
V, BPV, SEQ, LR = 4, 4, 128, 0.1
ATOL = 2e-4


def _cfgs(**kw):
    return (j_get_smoke_config("qwen3-32b").replace(**F32, **kw),
            get_smoke_config("qwen3-32b").replace(**F32, **kw))


@pytest.fixture(scope="module")
def setup():
    jcfg, cfg = _cfgs(num_vehicles=V, grad_accum=2)
    jp = j_materialize(jax.random.key(0), jengine.model_decl(jcfg, "head"))
    batch = j_lm_batch(jax.random.key(1), V * BPV, SEQ, jcfg.vocab_size)
    batch_v = jax.tree.map(lambda x: x.reshape(V, BPV, *x.shape[1:]), batch)
    params = engine.llm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    tbatch_v = {k: tt(v).long() for k, v in batch_v.items()}
    return jcfg, cfg, jp, batch_v, params, tbatch_v


def _close(ours, ref, atol=ATOL):
    ol, rl = tree_leaves(ours), jax.tree.leaves(ref)
    assert len(ol) == len(rl) == 14
    for a, b in zip(ol, rl):
        np.testing.assert_allclose(tn(a), np.asarray(b), atol=atol, rtol=0)


def _stack(params, n):
    return tree_map(lambda x: x.unsqueeze(0).expand(n, *x.shape), params)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,t,vocab,seed", [(4, 32, 101, 0), (3, 17, 512, 5)])
def test_lm_batch_deterministic_step_on_reference_draws(b, t, vocab, seed):
    key = jax.random.key(seed)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = {
        "start": jax.random.randint(k1, (b, 1), 0, vocab),
        "step": jax.random.randint(k2, (b, 1), 1, 7),
        "noise": jax.random.bernoulli(k3, 0.1, (b, t + 1)),
        "rand": jax.random.randint(jax.random.fold_in(key, 7), (b, t + 1),
                                   0, vocab),
    }
    ours = lm_batch_from_draws({k: tt(v) for k, v in draws.items()}, t,
                               vocab)
    ref = j_lm_batch(key, b, t, vocab)
    for k in ("tokens", "labels"):
        assert ours[k].dtype == torch.int64
        np.testing.assert_array_equal(tn(ours[k]), np.asarray(ref[k]))


def test_lm_batch_draws_have_the_reference_distribution():
    gen = torch.Generator().manual_seed(3)
    d = lm_batch_draws(gen, 256, 64, 97)
    assert d["start"].shape == (256, 1) and d["rand"].shape == (256, 65)
    assert int(d["start"].min()) >= 0 and int(d["start"].max()) < 97
    assert int(d["step"].min()) >= 1 and int(d["step"].max()) <= 6
    assert abs(float(d["noise"].float().mean()) - 0.1) < 0.01
    b = lm_batch(torch.Generator().manual_seed(3), 256, 64, 97)
    assert torch.equal(b["tokens"][:, 1:], b["labels"][:, :-1])


# ---------------------------------------------------------------------------
# local SGD and the round
# ---------------------------------------------------------------------------

def test_local_sgd_with_grad_accum_matches_reference(setup):
    jcfg, cfg, jp, batch_v, params, tbatch_v = setup
    assert cfg.grad_accum == 2
    b0 = jax.tree.map(lambda x: x[0], batch_v)
    ref = jax.jit(lambda p, b: j_local_sgd(p, b, jcfg, "head", j_lm_loss,
                                           LR))(jp, b0)
    ours = vfl._local_sgd(params, {k: v[0] for k, v in tbatch_v.items()},
                          cfg, "head", vfl.lm_loss, LR)
    _close(ours, ref)
    loss = vfl.lm_loss(params, {k: v[0] for k, v in tbatch_v.items()}, cfg,
                       "head")
    np.testing.assert_allclose(float(loss), float(j_lm_loss(jp, b0, jcfg,
                                                            "head")),
                               rtol=1e-5)


def _reference_round(jcfg, jp, batch_v, mask, weights):
    """Per-vehicle local SGD plus the masked weighted mean, on one device
    (as tests/test_fl_runtime.py builds its reference)."""
    sgd = jax.jit(lambda p, b: j_local_sgd(p, b, jcfg, "head", j_lm_loss,
                                           LR))
    locals_ = [sgd(jp, jax.tree.map(lambda x: x[v], batch_v))
               for v in range(V)]
    w = np.asarray(mask) * np.asarray(weights)
    return jax.tree.map(
        lambda *xs: sum(float(wi) * x for wi, x in zip(w, xs)) /
        float(w.sum()), *locals_)


def test_vfl_round_matches_reference_masked_weighted_mean(setup):
    jcfg, cfg, jp, batch_v, params, tbatch_v = setup
    mask, weights = [1., 0., 1., 1.], [1., 1., 2., 1.]
    ref = _reference_round(jcfg, jp, batch_v, mask, weights)
    round_fn = vfl.make_vfl_round(cfg, None, "head", lr=LR)
    out = round_fn(_stack(params, V), tbatch_v, torch.tensor(mask),
                   torch.tensor(weights))
    for leaf in tree_leaves(out):
        assert leaf.shape[0] == V and leaf.stride(0) == 0   # broadcast view
    _close(tree_map(lambda x: x[0], out), ref)


def test_vfl_round_all_failed_keeps_old_params(setup):
    jcfg, cfg, jp, batch_v, params, tbatch_v = setup
    stages = []
    round_fn = vfl.make_vfl_round(cfg, None, "head", lr=LR,
                                  stage_hook=stages.append)
    out = round_fn(_stack(params, V), tbatch_v, torch.zeros(V),
                   torch.ones(V))
    assert stages == ["local_sgd", "aggregate"]
    for a, b in zip(tree_leaves(out), tree_leaves(params)):
        assert torch.equal(a[0], b)


@pytest.mark.parametrize("m", [1.0, 0.0])
def test_vfl_round_single_vehicle_branch_matches_reference(setup,
                                                            single_mesh, m):
    jcfg, cfg, jp, batch_v, params, tbatch_v = setup
    jcfg1, cfg1 = jcfg.replace(num_vehicles=1), cfg.replace(num_vehicles=1)
    jb = jax.tree.map(lambda x: x[:1], batch_v)
    ref = jax.jit(j_make_vfl_round(jcfg1, single_mesh, "head", lr=LR))(
        jax.tree.map(lambda x: x[None], jp), jb, jnp.array([m]),
        jnp.array([1.0]))
    out = vfl.make_vfl_round(cfg1, None, "head", lr=LR)(
        _stack(params, 1), {k: v[:1] for k, v in tbatch_v.items()},
        torch.tensor([m]), torch.tensor([1.0]))
    _close(tree_map(lambda x: x[0], out), jax.tree.map(lambda x: x[0], ref))
    if m == 0.0:
        for a, b in zip(tree_leaves(out), tree_leaves(params)):
            assert torch.equal(a[0], b)


def test_train_step_schedules_with_the_reference_decisions(setup):
    """The inline VEDS mask on a reference round is the reference's."""
    jcfg, cfg, jp, batch_v, params, tbatch_v = setup
    jprm, prm = JVeds(Q=2e7, slot=0.1), VedsParams(Q=2e7, slot=0.1)
    sc = JScenario(n_sov=V, n_opv=8, n_slots=20)
    rnd = jax.jit(lambda k: j_make_round(k, sc, JManhattan(), JChannel(),
                                         jprm))(jax.random.key(9))
    ref = j_veds_round(rnd, jprm, JChannel())
    stages = []
    step = vfl.make_train_step(cfg, None, "head", lr=LR,
                               inline_scheduler=True, veds_prm=prm,
                               ch_prm=ChannelParams(),
                               stage_hook=stages.append)
    _, stats = step(_stack(params, V), tbatch_v, round_to_torch(rnd),
                    torch.ones(V))
    np.testing.assert_array_equal(
        tn(stats["mask"]), np.asarray(ref["success"], np.float32)[:V])
    assert int(stats["n_success"]) == int(ref["n_success"])
    assert stages == ["schedule", "local_sgd", "aggregate"]


def test_vfl_refuses_paths_of_later_slices(setup):
    """A model axis that does not divide a dim the model splits over it
    is refused when the round is built (model axes that divide run:
    `tests/test_torch_model_axis_vfl.py`); `stream=` runs
    (`tests/test_torch_fused.py`) and refuses only what the reference
    refuses at build time: more than one cell, and fewer SOVs than
    vehicles."""
    from repro_torch.core.scenario import ScenarioParams
    from repro_torch.core.streaming import StreamConfig
    jcfg, cfg, jp, batch_v, params, tbatch_v = setup
    with pytest.raises(ValueError, match="batch=1"):
        vfl.make_train_step(cfg, None, "head", stream=StreamConfig(batch=2),
                            sc=ScenarioParams(n_sov=V))
    with pytest.raises(ValueError, match="num_vehicles"):
        vfl.make_train_step(cfg, None, "head", stream=StreamConfig(),
                            sc=ScenarioParams(n_sov=V - 1))
    # zamba2's smoke config has 8 SSM heads: an axis of 16 splits every
    # other dim (row-parallel attention) but not them
    with pytest.raises(ValueError, match="model axis of 16 does not "
                                         "divide ssm_heads of 8"):
        vfl.make_vfl_round(get_smoke_config("zamba2-2.7b"),
                           {"data": V, "model": 16}, "row")


# ---------------------------------------------------------------------------
# the training driver
# ---------------------------------------------------------------------------

def test_train_main_runs_on_cpu_with_finite_losses(capsys):
    assert train_mod.main(["--device", "cpu", "--rounds", "2",
                           "--vehicles", "4", "--batch-per-vehicle", "2",
                           "--seq", "32"]) == 0
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"loss=(\S+)", out)]
    succ = re.findall(r"succ=(\d+)/4", out)
    assert len(losses) == 2 and len(succ) == 2
    assert all(np.isfinite(losses))


@pytest.mark.parametrize("argv,err,match", [
    # 4 vehicles x a model axis of 16: zamba2's 8 SSM heads do not split,
    # refused before any rank starts
    (["--arch", "zamba2-2.7b", "--devices", "64"], ValueError,
     "ssm_heads of 8"),
    (["--arch", "llama-3.2-vision-90b"], NotImplementedError, "src"),
    (["--arch", "whisper-small"], NotImplementedError, "src"),
])
def test_train_main_refuses_what_is_not_ported(argv, err, match):
    with pytest.raises(err, match=match):
        train_mod.main(["--device", "cpu", "--rounds", "1"] + argv)


def test_train_main_runs_a_baseline_scheduler(capsys):
    """`--scheduler sa`, which an earlier slice refused, runs one round
    of the smoke config: every name `--scheduler` offers runs."""
    assert train_mod.main(["--device", "cpu", "--rounds", "1",
                           "--vehicles", "4", "--batch-per-vehicle", "2",
                           "--seq", "32", "--scheduler", "sa"]) == 0
    out = capsys.readouterr().out
    losses = [float(x) for x in re.findall(r"loss=(\S+)", out)]
    assert len(losses) == 1 and np.isfinite(losses).all()
    assert re.search(r"succ=[0-4]/4", out)


def test_train_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_mod.main(["--rounds", "1"])


def test_train_loop_calls_each_kernel_as_the_chip_run_counts(monkeypatch):
    """The counts that `chip_smoke.py` asserts on the card, checked here
    on the plain versions (which the CPU runs in the kernels' place):
    per round, `flash_attention` runs V x n_rep x 2 times (each attention
    sub-block's forward and its recompute under remat in the backward)
    plus n_rep for the eval forward, and `fedavg_agg` once per parameter
    leaf (14)."""
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
    cfg = get_smoke_config("qwen3-32b").replace(num_vehicles=V, grad_accum=1)
    rounds = 2
    stages, records = [], []
    hist = train_mod.train(cfg, rounds=rounds, batch_per_vehicle=2, seq=32,
                           lr=0.5, device="cpu", log=lambda s: None,
                           stage_hook=stages.append,
                           on_round=records.append)
    assert records == hist
    assert stages == ["setup"] + rounds * [
        "scenario", "schedule", "local_sgd", "aggregate", "eval"]
    assert [h["round"] for h in hist] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in hist)
    per_round = V * cfg.n_rep * 2 + cfg.n_rep
    assert calls["flash"] == rounds * per_round
    assert calls["fedavg"] == rounds * 14
