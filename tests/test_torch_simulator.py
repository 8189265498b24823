"""The slice as a whole: the port's blocked `run_fl` (scenario -> VEDS ->
client draws -> per-client CNN gradients -> FedAvg -> eval) against the
reference's.

Both sides get the same rounds (the reference's `make_round(fold_in(key,
r))`, handed to the port through its `make_round` lookup), the same
carried initial weights, the same numpy data and the same `FLSimConfig`;
client selection and minibatches come from `default_rng(sim.seed)` on
both sides. `n_success` histories must be identical and the eval metric
(CE loss on a fixed batch, every round) agree to rtol 1e-4: three rounds
of fp32 gradients whose convolutions sum in another order than XLA's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.channel.mobility import ManhattanParams as JManhattan
from repro.channel.v2x import ChannelParams as JChannel
from repro.core.lyapunov import VedsParams as JVeds
from repro.core.scenario import ScenarioParams as JScenario
from repro.core.scenario import make_round as j_make_round
from repro.fl.simulator import FLSimConfig as JFLSimConfig
from repro.fl.simulator import run_fl as j_run_fl
from repro.models.cnn import cnn_decl as j_cnn_decl
from repro.models.cnn import cnn_loss as j_cnn_loss
from repro.models.module import materialize as j_materialize
from repro_torch.fl import simulator
from repro_torch.fl.simulator import FLSimConfig, run_fl
from repro_torch.models.cnn import cnn_loss, cnn_params_from_jax, init_cnn
from torch_port_util import round_to_torch, tt

CFG = dict(n_clients=6, n_sov=3, n_opv=3, n_slots=8, rounds=3,
           batch_size=4, lr=0.07, seed=7)


def _clients():
    """Six clients: ragged sizes, one smaller than the batch (drawn with
    replacement) and one empty (weight 0)."""
    rng = np.random.default_rng(0)
    out = []
    for n in (9, 2, 6, 0, 12, 5):
        if n == 0:
            out.append({})
            continue
        out.append({"x": rng.normal(0, 1, (n, 32, 32, 3)).astype(np.float32),
                    "y": rng.integers(0, 10, n).astype(np.int32)})
    return out


def _eval_batch():
    rng = np.random.default_rng(1)
    return (rng.normal(0, 1, (16, 32, 32, 3)).astype(np.float32),
            rng.integers(0, 10, 16).astype(np.int32))


@pytest.fixture(scope="module")
def reference_rounds():
    """The rounds the reference's blocked path schedules for key(0)."""
    key = jax.random.key(0)
    sc = JScenario(n_sov=3, n_opv=3, n_slots=8, batch_size=4)
    mk = jax.jit(lambda k: j_make_round(k, sc, JManhattan(v_max=10.0),
                                        JChannel(), JVeds()))
    return [mk(jax.random.fold_in(key, r)) for r in range(CFG["rounds"])]


def _port_history(monkeypatch, rounds, round_batch):
    it = iter(rounds)
    monkeypatch.setattr(simulator, "make_round",
                        lambda *a, **k: round_to_torch(next(it)))
    x, y = _eval_batch()
    fixed = {"x": tt(x), "y": tt(y, torch.int64)}
    jparams = j_materialize(jax.random.key(1), j_cnn_decl())
    return run_fl(0, cnn_params_from_jax(jparams), cnn_loss, _clients(),
                  FLSimConfig(round_batch=round_batch, **CFG),
                  eval_fn=lambda p: cnn_loss(p, fixed), eval_every=1,
                  device="cpu")


@pytest.mark.parametrize("round_batch", [1, 2])
def test_run_fl_matches_reference(monkeypatch, reference_rounds,
                                  round_batch):
    x, y = _eval_batch()
    fixed = {"x": jax.numpy.asarray(x), "y": jax.numpy.asarray(y)}
    ref = j_run_fl(jax.random.key(0),
                   j_materialize(jax.random.key(1), j_cnn_decl()),
                   j_cnn_loss, _clients(),
                   JFLSimConfig(round_batch=round_batch, **CFG),
                   eval_fn=jax.jit(lambda p: j_cnn_loss(p, fixed)),
                   eval_every=1)
    ours = _port_history(monkeypatch, reference_rounds, round_batch)
    assert set(ours) == set(ref)
    for k in ("round", "time", "n_success", "scheduled_rounds"):
        assert ours[k] == ref[k], k
    np.testing.assert_allclose(ours["metric"], ref["metric"], rtol=1e-4)
    assert sum(ours["n_success"]) > 0


def test_round_batch_does_not_change_port_history():
    """Each round draws from its own generator, so grouping rounds into
    blocks changes nothing: decisions are identical and the metric agrees
    to fp32 (the [B] axis may change a reduction's order)."""
    x, y = _eval_batch()
    fixed = {"x": tt(x), "y": tt(y, torch.int64)}
    params = {k: v.detach() for k, v in init_cnn(
        torch.Generator().manual_seed(3)).named_parameters()}
    cfg = dict(CFG, rounds=4)
    hist = {}
    for rb in (1, 3):
        hist[rb] = run_fl(5, params, cnn_loss, _clients(),
                          FLSimConfig(round_batch=rb, **cfg),
                          eval_fn=lambda p: cnn_loss(p, fixed),
                          eval_every=2, device="cpu")
    assert hist[1]["round"] == hist[3]["round"] == [0, 2, 3]
    assert hist[1]["n_success"] == hist[3]["n_success"]
    assert hist[1]["scheduled_rounds"] == hist[3]["scheduled_rounds"] == 4
    np.testing.assert_allclose(hist[3]["metric"], hist[1]["metric"],
                               rtol=1e-5)


def test_run_fl_needs_cuda_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fl(0, {}, cnn_loss, _clients(), FLSimConfig(**CFG))


@pytest.mark.parametrize("change", [
    dict(streaming=True, scheduler="sa"),
    dict(streaming=True, fused=False, scheduler="optimal"),
    dict(scheduler="madca")])
def test_run_fl_refuses_paths_of_later_slices(change):
    """The configurations an earlier slice refused (the test keeps its
    name) now run: streaming `sa` (fused), host-gather `optimal` and
    blocked `madca`, one round each on the CPU, with one evaluation."""
    x, y = _eval_batch()
    fixed = {"x": tt(x), "y": tt(y, torch.int64)}
    params = {k: v.detach() for k, v in init_cnn(
        torch.Generator().manual_seed(3)).named_parameters()}
    hist = run_fl(0, params, cnn_loss, _clients(),
                  FLSimConfig(**dict(CFG, rounds=1, **change)),
                  eval_fn=lambda p: cnn_loss(p, fixed), device="cpu")
    assert hist["round"] == [0] and hist["scheduled_rounds"] == 1
    assert 0 <= hist["n_success"][0] <= CFG["n_sov"]
    assert np.isfinite(hist["metric"]).all()


def test_blocked_run_fl_calls_the_stage_hook():
    """The blocked path reports its stages as the fused one does: a
    block's "scenario" and "schedule" with its first round, then every
    round's "train" and "eval" (eval rounds or not)."""
    names = []
    run_fl(0, {k: v.detach() for k, v in init_cnn(
        torch.Generator().manual_seed(3)).named_parameters()},
        cnn_loss, _clients(), FLSimConfig(**dict(CFG, rounds=3,
                                                 round_batch=2,
                                                 scheduler="sa")),
        device="cpu", stage_hook=names.append)
    assert names == ["scenario", "schedule", "train", "eval", "train",
                     "eval", "scenario", "schedule", "train", "eval"]
