"""The port's LaneGCN (`models/lanegcn.py`) and its Argoverse-like data
(`data/synthetic.py` trajectories) against the reference, and the Fig. 12
path, blocked `run_fl` with LaneGCN, against the reference's.

The reference's weights are carried across (`lanegcn_params_from_jax`)
and its batches handed over as numpy, so both sides compute the same
function. Trajectory batches are made from the reference's own draws
(`torch_ref_draws.trajectory_batch`) by the port's deterministic step.

Tolerances: loss and ADE within rtol 1e-5, the forward's entries within
rtol 1e-5 plus 1e-5 of the output's largest entry; gradients within
rtol 1e-4 of `jax.grad` (the key projection's bias has a gradient of
exactly zero in exact arithmetic, since the softmax over map nodes is
invariant to it: both sides give rounding noise there, held to 1e-6 of
the gradient's largest entry); trajectory floats within atol 1e-5 plus
rtol 1e-5 (a cumulative sum of 50 steps of up to 1.5 m, summed in
another order by XLA, then centred: a few ulp of positions up to ~45 m);
`run_fl` decisions identical and the parameter vector within 1e-5 of its
norm after each of two rounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ref_draws as RD
from repro.channel.mobility import ManhattanParams as JManhattan
from repro.channel.v2x import ChannelParams as JChannel
from repro.core.lyapunov import VedsParams as JVeds
from repro.core.scenario import ScenarioParams as JScenario
from repro.core.scenario import make_round as j_make_round
from repro.data.synthetic import make_trajectory_batch as j_make_traj
from repro.fl.simulator import FLSimConfig as JFLSimConfig
from repro.fl.simulator import run_fl as j_run_fl
from repro.models import lanegcn as jl
from repro.models.module import materialize as j_materialize
from repro_torch.data.synthetic import (make_trajectory_batch,
                                        map_node_index,
                                        trajectory_batch_draws,
                                        trajectory_batch_from_draws)
from repro_torch.fl import simulator
from repro_torch.fl.simulator import FLSimConfig, run_fl
from repro_torch.models import lanegcn as pl
from torch_port_util import round_to_torch, tn, tt

KEY = jax.random.key(3)
_j_traj_batch = jax.jit(j_make_traj, static_argnums=(1, 2))


def j_traj_batch(key, b, num_map_nodes=64):
    """The reference's `make_trajectory_batch`, compiled once a shape."""
    return _j_traj_batch(key, b, num_map_nodes)
SIM = dict(n_clients=6, n_sov=3, n_opv=3, n_slots=20, rounds=2,
           batch_size=4, lr=0.02, seed=7, scheduler="sa")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref_batch():
    """A reference batch of 16 tracks and 64 lane nodes."""
    return {k: np.asarray(v) for k, v in j_traj_batch(KEY, 16).items()}


@pytest.fixture(scope="module")
def ref_params():
    return j_materialize(jax.random.key(1), jl.lanegcn_decl())


def _tb(batch):
    return {k: tt(v) for k, v in batch.items()}


# ---- data -----------------------------------------------------------------

@pytest.mark.parametrize("M", [16, 50, 64, 100])
def test_map_node_index_matches_jnp_linspace(M):
    """fp32 linspace truncated to integers picks the same future steps in
    both packages."""
    ref = np.asarray(jnp.linspace(0, jl.FUT - 1, M).astype(jnp.int32))
    np.testing.assert_array_equal(tn(map_node_index(M)), ref)


@pytest.mark.parametrize("b,M", [(16, 64), (8, 24)])
def test_trajectory_batch_matches_reference(b, M):
    """The deterministic step on the reference's draws: floats within
    atol 1e-5 + rtol 1e-5. The adjacency thresholds d2 < 25; an entry
    whose d2 lies within rounding of 25 may flip between XLA's and
    torch's cumulative sums, so flips are counted and each one's
    |d2 - 25| is reported; a flip farther than 1e-4 from the threshold
    fails."""
    key = jax.random.fold_in(KEY, b)
    ref = j_traj_batch(key, b, M)
    ours = trajectory_batch_from_draws(RD.trajectory_batch(key, b, M))
    for k in ("hist", "fut", "map_feats"):
        assert tuple(ours[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(tn(ours[k]), np.asarray(ref[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
    adj, jadj = tn(ours["map_adj"]), np.asarray(ref["map_adj"])
    nodes = tn(ours["map_feats"])[..., :2] / 0.05
    d2 = ((nodes[:, :, None] - nodes[:, None]) ** 2).sum(-1)
    flips = np.argwhere(adj != jadj)
    margins = [abs(float(d2[tuple(i)]) - 25.0) for i in flips]
    print(f"adjacency flips: {len(flips)}, |d2 - 25|: {margins}")
    assert all(m < 1e-4 for m in margins), margins
    assert set(np.unique(adj)) <= {0.0, 1.0}
    np.testing.assert_array_equal(adj, np.swapaxes(adj, 1, 2))


def test_make_trajectory_batch_shapes_and_statistics():
    """The port's own draws: the reference's shapes and ranges; the
    track passes through the origin at the last history step."""
    gen = torch.Generator().manual_seed(0)
    draws = trajectory_batch_draws(gen, 256, 64)
    assert float(draws["speed"].min()) >= 3.0
    assert float(draws["speed"].max()) < 15.0
    assert float(draws["heading0"].max()) < 2 * np.pi
    assert abs(float(draws["off"].std()) - 2.0) < 0.1
    b = make_trajectory_batch(torch.Generator().manual_seed(0), 32)
    assert b["hist"].shape == (32, jl.HIST, 2)
    assert b["fut"].shape == (32, jl.FUT, 2)
    assert b["map_feats"].shape == (32, 64, 4)
    assert b["map_adj"].shape == (32, 64, 64)
    assert float(b["hist"][:, -1].abs().max()) == 0.0
    assert (torch.diagonal(b["map_adj"], dim1=1, dim2=2) == 1).all()


# ---- the model --------------------------------------------------------------

def test_params_from_jax_layout_and_init(ref_params):
    """Carried weights: conv kernels [k, cin, cout] -> [cout, cin, k],
    the rest as it is; the port's own init has the same shapes, zero
    biases and the fan-in scale of the reference's `scaled` init."""
    p = pl.lanegcn_params_from_jax(ref_params)
    w = np.asarray(ref_params["actor"]["c2"]["w"])
    np.testing.assert_array_equal(tn(p["actor.c2.w"]),
                                  w.transpose(2, 1, 0))
    np.testing.assert_array_equal(tn(p["head.w"]),
                                  np.asarray(ref_params["head"]["w"]))
    ours = pl.init_lanegcn(torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in p.items()}
    assert all(not v.any() for k, v in ours.items() if k.endswith(".b"))
    # `scaled`: std / sqrt(fan_in) with fan_in = shape[-2] of the
    # reference's layout (cin for convs and linears); a truncated normal
    # at [-2, 2] has std 0.88
    for k, fan_in in (("map.g1.w", pl.D), ("actor.c2.w", pl.D),
                      ("head.w", pl.D)):
        std = float(ours[k].std()) * np.sqrt(fan_in)
        assert 0.8 < std < 0.96, (k, std)


@pytest.mark.parametrize("fn", ["lanegcn_apply", "lanegcn_loss",
                                "lanegcn_ade"])
def test_lanegcn_matches_reference(ref_params, ref_batch, fn):
    ours = getattr(pl, fn)(pl.lanegcn_params_from_jax(ref_params),
                           _tb(ref_batch))
    ref = getattr(jl, fn)(ref_params, {k: jnp.asarray(v)
                                       for k, v in ref_batch.items()})
    assert tuple(ours.shape) == ref.shape
    # entries of the forward near zero are sums that cancel: they are
    # held to 1e-5 of the output's scale
    scale = float(np.abs(np.asarray(ref)).max())
    np.testing.assert_allclose(tn(ours), np.asarray(ref), rtol=1e-5,
                               atol=1e-5 * scale)


def test_lanegcn_grads_match_reference(ref_params, ref_batch):
    p = pl.lanegcn_params_from_jax(ref_params)
    g = torch.func.grad(pl.lanegcn_loss)(p, _tb(ref_batch))
    jg = pl.lanegcn_params_from_jax(jax.jit(jax.grad(jl.lanegcn_loss))(
        ref_params, {k: jnp.asarray(v) for k, v in ref_batch.items()}))
    assert set(g) == set(jg)
    scale = max(float(v.abs().max()) for v in jg.values())
    for k in g:
        if k == "fusion.k.b":        # zero in exact arithmetic
            assert float(g[k].abs().max()) < 1e-6 * scale
            assert float(jg[k].abs().max()) < 1e-6 * scale
            continue
        np.testing.assert_allclose(tn(g[k]), tn(jg[k]), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=k)


# ---- Fig. 12's path: blocked run_fl with LaneGCN ---------------------------

def _clients():
    """Six clients of ragged size (8 to 13 tracks), from the reference's
    generator (one compiled batch size, cut to each client's)."""
    return [{k: np.asarray(v)[:8 + c] for k, v in j_traj_batch(
        jax.random.fold_in(KEY, 100 + c), 16).items()}
        for c in range(SIM["n_clients"])]


def test_run_fl_lanegcn_matches_reference(monkeypatch, ref_params):
    """Two blocked rounds under `sa`: the same rounds (the reference's
    `make_round(fold_in(key, r))`), weights, clients and client draws on
    both sides; `n_success` identical, the ADE within rtol 1e-5 and the
    parameters after each round within 1e-5 of their norm."""
    key = jax.random.key(0)
    sc = JScenario(n_sov=SIM["n_sov"], n_opv=SIM["n_opv"],
                   n_slots=SIM["n_slots"], batch_size=SIM["batch_size"])
    mk = jax.jit(lambda k: j_make_round(k, sc, JManhattan(v_max=10.0),
                                        JChannel(), JVeds()))
    rounds = iter([round_to_torch(mk(jax.random.fold_in(key, r)))
                   for r in range(SIM["rounds"])])
    test = j_traj_batch(jax.random.fold_in(KEY, 999), 32)
    jseen, seen = [], []

    def j_eval(p):
        jseen.append(pl.lanegcn_params_from_jax(p))
        return jl.lanegcn_ade(p, test)

    ref = j_run_fl(key, ref_params, jl.lanegcn_loss, _clients(),
                   JFLSimConfig(**SIM), eval_fn=j_eval, eval_every=1)
    monkeypatch.setattr(simulator, "make_round",
                        lambda *a, **k: next(rounds))
    ttest = {k: tt(v) for k, v in test.items()}

    def eval_fn(p):
        seen.append({k: v.clone() for k, v in p.items()})
        return pl.lanegcn_ade(p, ttest)

    ours = run_fl(0, pl.lanegcn_params_from_jax(ref_params),
                  pl.lanegcn_loss, _clients(), FLSimConfig(**SIM),
                  eval_fn=eval_fn, eval_every=1, device="cpu")
    for k in ("round", "time", "n_success", "scheduled_rounds"):
        assert ours[k] == ref[k], k
    assert sum(ours["n_success"]) > 0
    np.testing.assert_allclose(ours["metric"], ref["metric"], rtol=1e-5)
    assert len(seen) == len(jseen) == SIM["rounds"]
    for p, jp in zip(seen, jseen):
        err = torch.cat([(p[k] - jp[k]).flatten() for k in p]).norm()
        norm = torch.cat([jp[k].flatten() for k in p]).norm()
        assert float(err) <= 1e-5 * float(norm), (float(err), float(norm))
