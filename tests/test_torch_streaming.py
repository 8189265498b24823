"""The port's streaming path against the reference: warm and adaptive P4,
warm VEDS rounds, batched rounds and persistent fleets, the cross-cell
exchange, and `stream_rounds` (persistent, fresh, chunked).

The port draws from `torch.Generator`s, so every parity test feeds the
port's deterministic steps the reference's own draws, regenerated from
its keys (`torch_ref_draws.py`). Sizes are the reference tests' own
(`tests/test_streaming.py`: S=4, U=3, T=10).

Tolerances: decisions (masks, `n_success`, selections, slot counts) are
identical everywhere. Positions agree to 1e-4 m, gains to rtol 1e-5, P4
powers to 2e-5 W, delivered bits, energies and queues on the cold path to
rtol 1e-4 (as `test_torch_veds.py`). The warm path's floats agree to
rtol 5e-2 only: the reference writes every candidate's optimum into the
warm table, including candidates with no direct link and infeasible ones
whose powers sit at the box floor (1e-9 W); seeded from there, the
barrier Hessian's condition number reaches ~3e15 in fp32, and the
reference's own jitted and eager solves part by ~3e-4 W on such a seed
while XLA's and LAPACK's part by up to 0.1 W (ROADMAP queue 3). The
three warm-start contracts of the solver hold bit for bit inside torch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ref_draws as RD
from repro.channel.mobility import ManhattanParams as JManhattan
from repro.channel.v2x import ChannelParams as JChannel
from repro.core import scenario as jscn
from repro.core.baselines import get_scheduler as j_get_scheduler
from repro.core.lyapunov import VedsParams as JVeds
from repro.core.scheduler import SchedulerCarry as JCarry
from repro.core.solver import p4_seed_table as j_p4_seed_table
from repro.core.solver import solve_p4 as j_solve_p4
from repro.core.streaming import StreamConfig as JStreamConfig
from repro.core.streaming import stream_rounds as j_stream_rounds
from repro.core.veds import veds_round as j_veds_round
from repro_torch.channel.mobility import ManhattanParams
from repro_torch.channel.v2x import ChannelParams
from repro_torch.core import scenario as scn
from repro_torch.core import streaming as stm
from repro_torch.core.baselines import VedsScheduler, get_scheduler
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scheduler import RolloutCarry, SchedulerCarry
from repro_torch.core.solver import p4_seed_table, solve_p4
from repro_torch.core.streaming import (StreamConfig, StreamResult,
                                        cast_sched_state, pack_cells,
                                        promote_sched_state, round_keys,
                                        sched_state0, stream_rounds,
                                        unpack_cell, validate_stream_config,
                                        warm_p4)
from repro_torch.core.veds import veds_round
from torch_port_util import round_to_torch, tn, tt

MOB, JMOB = ManhattanParams(v_max=10.0), JManhattan(v_max=10.0)
CH, JCH = ChannelParams(), JChannel()
PRM, JPRM = VedsParams(), JVeds()
SC = scn.ScenarioParams(n_sov=4, n_opv=3, n_slots=10)
JSC = jscn.ScenarioParams(n_sov=4, n_opv=3, n_slots=10)
# tight budgets, so that the carried queues grow
SC_TIGHT = dataclasses.replace(SC, e_min=0.005, e_max=0.01)
JSC_TIGHT = dataclasses.replace(JSC, e_min=0.005, e_max=0.01)
KEY = jax.random.key(0)
DECISIONS = ("success", "n_success", "n_cot_slots", "n_dt_slots")
FLOATS = ("zeta", "energy_sov", "energy_opv")
WARM_RTOL = 5e-2


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests loop over small tensor ops: one intra-op thread, so
    that parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand_instance(rng, n):
    """The instance generator of `tests/test_solver.py`."""
    a = np.abs(rng.normal(0, 5, n))
    a[rng.random(n) < 0.3] = 0
    a[0] = abs(rng.normal(0, 5)) + 0.1
    q = np.abs(rng.normal(0, 0.1, n)) + 1e-3
    g_min = a[0] * (1 + abs(rng.normal(1, 1)))
    d = a.copy()
    d[0] = a[0] - g_min
    return a, q, d, np.full(n, 0.3), abs(rng.normal(0.5, 0.5)) + 0.01


def _instances(seed, n=4, k=48):
    """k feasible P4 instances and interior warm seeds: the cold optimum
    moved by up to 20% (a correlated next instance's start)."""
    rng = np.random.default_rng(seed)
    inst = [_rand_instance(rng, n) for _ in range(k)]
    a, q, d, pm = (np.stack([x[i] for x in inst]).astype(np.float32)
                   for i in range(4))
    cw = np.array([x[4] for x in inst], np.float32)
    p_cold, _ = solve_p4(tt(cw), tt(a), tt(q), tt(d), tt(pm))
    seed_p = np.clip(tn(p_cold) * rng.uniform(0.8, 1.2, a.shape), 1e-3,
                     0.29).astype(np.float32)
    return cw, a, q, d, pm, seed_p


def _port(cw, a, q, d, pm, **kw):
    return solve_p4(tt(cw), tt(a), tt(q), tt(d), tt(pm), **kw)


def _ref(cw, a, q, d, pm, p_init, **kw):
    f = jax.jit(jax.vmap(lambda c, a_, q_, d_, m, p0: j_solve_p4(
        c, a_, q_, d_, m, p_init=p0, **kw)))
    return f(*(jnp.asarray(x) for x in (cw, a, q, d, pm, p_init)))


# ---- warm and adaptive P4 -----------------------------------------------

def test_p4_seed_table_is_the_cold_start():
    tab = p4_seed_table((2, 3, 4), 0.3, device="cpu")
    np.testing.assert_array_equal(tn(tab),
                                  np.asarray(j_p4_seed_table((2, 3, 4),
                                                             0.3)))


def test_warm_from_seed_table_at_full_budget_is_bit_for_bit_cold():
    cw, a, q, d, pm, _ = _instances(0)
    seed_t = p4_seed_table(a.shape, 0.3, device="cpu")
    cold = _port(cw, a, q, d, pm)
    for w in (0, 25):
        warm = _port(cw, a, q, d, pm, p_init=seed_t, warm_iters=w)
        assert torch.equal(warm[0], cold[0]) and torch.equal(warm[1],
                                                             cold[1])


def _split_tol(cw, a, q, d, pm, seed_p):
    """A `far_grad_tol` in the widest gap of the seeds' gradient norms
    around their median, so no lane sits at the threshold; returns it
    and the far mask."""
    from repro_torch.core.solver import _project_feasible
    p = _project_feasible(tt(seed_p), tt(d), tt(pm), margin=0.5)
    s = 1.0 + (tt(a) * p).sum(-1, keepdim=True)
    g0 = np.sort(tn(torch.linalg.vector_norm(
        tt(cw)[:, None] * tt(a) / s - tt(q), dim=-1)))
    mid = len(g0) // 2
    lo, hi = mid - len(g0) // 4, mid + len(g0) // 4
    j = lo + int(np.argmax(np.diff(g0[lo:hi + 1])))
    tol = float(0.5 * (g0[j] + g0[j + 1]))
    assert g0[j + 1] - g0[j] > 1e-3 * tol      # a real margin
    g_all = tn(torch.linalg.vector_norm(
        tt(cw)[:, None] * tt(a) / s - tt(q), dim=-1))
    return tol, g_all > tol


@pytest.mark.parametrize("warm_iters", [5, 10])
def test_adaptive_p4_lanes_are_bit_for_bit_their_plain_solves(warm_iters):
    """Near lanes equal the plain `warm_iters` solve, far lanes with
    `far_iters == iters` the full-budget solve from the same seed."""
    cw, a, q, d, pm, seed_p = _instances(1)
    tol, far = _split_tol(cw, a, q, d, pm, seed_p)
    assert far.any() and (~far).any()
    ad = _port(cw, a, q, d, pm, p_init=tt(seed_p), warm_iters=warm_iters,
               far_iters=25, far_grad_tol=tol)
    near = _port(cw, a, q, d, pm, p_init=tt(seed_p), warm_iters=warm_iters)
    full = _port(cw, a, q, d, pm, p_init=tt(seed_p), warm_iters=25)
    far_t = torch.as_tensor(far)
    assert torch.equal(ad[0][far_t], full[0][far_t])
    assert torch.equal(ad[0][~far_t], near[0][~far_t])
    assert torch.equal(ad[1][~far_t], near[1][~far_t])


@pytest.mark.parametrize("kw", [
    dict(warm_iters=5), dict(warm_iters=10), dict(warm_iters=25),
    dict(warm_iters=5, far_iters=15, far_grad_tol=None)])
def test_warm_p4_matches_reference_from_interior_seeds(kw):
    """Warm (and adaptive) solves from interior seeds against the
    reference's: powers within 2e-5 W and values within rtol 1e-4 on
    every lane whose reference optimum is not the box's vertex (every
    power at p_max). On a vertex lane the last steps' barrier Hessian has
    diagonal entries ~mu / (1e-9 W)^2 and LAPACK's and XLA's fp32 solves
    part (1 lane of 48 at warm_iters 5: 0.3 against 0.2555 W in one
    entry; ROADMAP queue 3); there the port's powers stay in the box."""
    cw, a, q, d, pm, seed_p = _instances(2)
    if "far_grad_tol" in kw:
        kw = dict(kw, far_grad_tol=_split_tol(cw, a, q, d, pm, seed_p)[0])
    p, v = _port(cw, a, q, d, pm, p_init=tt(seed_p), **kw)
    jp, jv = _ref(cw, a, q, d, pm, seed_p, **kw)
    vertex = (np.asarray(jp) >= pm - 1e-5).all(-1)
    assert vertex.sum() <= 2
    np.testing.assert_allclose(tn(p)[~vertex], np.asarray(jp)[~vertex],
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(tn(v)[~vertex], np.asarray(jv)[~vertex],
                               rtol=1e-4, atol=1e-9)
    assert ((tn(p) >= 0) & (tn(p) <= pm)).all()


@pytest.fixture(scope="module")
def rounds3():
    """Three hetero-fleet reference cells, S=4, U=4, T=10."""
    sc = jscn.ScenarioParams(n_sov=4, n_opv=4, n_slots=10)
    return jax.jit(lambda k: jscn.make_round_batch(
        k, sc, JMOB, JCH, JPRM, 3, hetero_fleet=True))(jax.random.key(4))


@pytest.mark.parametrize("warm_iters,far", [(5, 0), (25, 0), (5, 25)])
def test_warm_veds_round_matches_reference(rounds3, warm_iters, far):
    """A warm round from a carried table: decisions identical and floats
    within WARM_RTOL over the whole round; over one slot (every candidate
    from the given seeds) the table within 2e-5 W on the feasible
    candidates."""
    B, S, U = 3, 4, 4
    tab = np.random.default_rng(5).uniform(
        0.0, 0.3, (B, S, U, U + 1)).astype(np.float32)
    kw = dict(ipm_warm_iters=warm_iters, ipm_far_iters=far,
              ipm_far_grad_tol=0.05 if far else 0.0)
    jprm, prm = JVeds(**kw), VedsParams(**kw)

    def both(rnd):
        ref = jax.jit(lambda r_, c_: j_veds_round(r_, jprm, JCH, carry=c_))(
            rnd, JCarry(qs=jnp.zeros((B, S)), qu=jnp.zeros((B, U)),
                        p4=jnp.asarray(tab)))
        out = veds_round(round_to_torch(rnd), prm, CH, carry=SchedulerCarry(
            qs=torch.zeros(B, S), qu=torch.zeros(B, U), p4=tt(tab)))
        return out, ref

    out, ref = both(rounds3)
    for k in DECISIONS:
        np.testing.assert_array_equal(tn(out[k]), np.asarray(ref[k]),
                                      err_msg=k)
    for k in FLOATS:
        np.testing.assert_allclose(tn(out[k]), np.asarray(ref[k]),
                                   rtol=WARM_RTOL, atol=1e-9, err_msg=k)
    one = jax.tree.map(lambda x: x[:, :1] if x.ndim >= 3 else x, rounds3)
    out, ref = both(one)
    g_sr = np.asarray(one.g_sr)[:, 0]
    g_so = -np.sort(-np.asarray(one.g_so)[:, 0], axis=-1)
    feasible = g_sr[..., None] < g_so                        # [B,S,U]
    np.testing.assert_allclose(tn(out.carry.p4)[feasible],
                               np.asarray(ref.carry.p4)[feasible],
                               rtol=0, atol=2e-5)


# ---- batched rounds, fleets, exchange ----------------------------------

def _assert_rounds_match(ours, ref):
    for f in dataclasses.fields(ours):
        a, b = tn(getattr(ours, f.name)), np.asarray(getattr(ref, f.name))
        if b.dtype == bool:
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=0,
                                       err_msg=f.name)


@pytest.mark.parametrize("hetero", [True, False])
def test_make_round_batch_matches_reference_on_its_draws(hetero):
    key = jax.random.key(5)
    ref = jax.jit(lambda k: jscn.make_round_batch(
        k, JSC, JMOB, JCH, JPRM, 3, hetero_fleet=hetero))(key)
    ours = scn.make_round_batch(RD.round_batch(key, JSC, JMOB, 3), SC, MOB,
                                CH, PRM, 3, hetero_fleet=hetero)
    _assert_rounds_match(ours, ref)
    assert ours.g_sr.shape == (3, SC.n_slots, SC.n_sov)


def test_make_round_batch_layout_from_a_generator():
    r = scn.make_round_batch(11, SC, MOB, CH, PRM, 4, device="cpu")
    assert r.g_so.shape == (4, SC.n_slots, SC.n_sov, SC.n_opv)
    vs = r.valid_sov
    assert (vs.sum(1) >= (SC.n_sov + 1) // 2).all()
    assert not r.e_sov[~vs].any() and not r.g_sr.permute(0, 2, 1)[~vs].any()
    again = scn.make_round_batch(11, SC, MOB, CH, PRM, 4, device="cpu")
    assert torch.equal(r.g_sr, again.g_sr)


@pytest.fixture(scope="module")
def fleets():
    """The reference's fleet of key(1) (B=2) and the port's from the same
    draws."""
    key = jax.random.key(1)
    return (jax.jit(lambda k: jscn.init_fleet(k, JSC, JMOB, 2))(key),
            scn.init_fleet(RD.init_fleet(key, JSC, JMOB, 2), SC, MOB, 2))


def _assert_fleets_equal(ours, ref, exact=True):
    for f in dataclasses.fields(ref):
        a, b = tn(getattr(ours, f.name)), np.asarray(getattr(ref, f.name))
        if exact or b.dtype.kind != "f" or f.name != "pos":
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4,
                                       err_msg=f.name)


def test_init_fleet_matches_reference_on_its_draws(fleets):
    ref, ours = fleets
    _assert_fleets_equal(ours, ref)
    N = 2 * (SC.n_sov + SC.n_opv)
    assert ours.batch_size == 2 and ours.n_vehicles == N
    assert torch.isinf(ours.energy).all() and not ours.queue.any()
    b = scn.init_fleet(3, SC, MOB, 2, energy_horizon=5.0, device="cpu")
    torch.testing.assert_close(b.energy, b.allowance * 5.0, rtol=1e-6,
                               atol=0)
    with pytest.raises(ValueError):
        scn.init_fleet(3, SC, MOB, 1, n_fleet=3, device="cpu")


@pytest.mark.parametrize("delay,handoff", [(False, False), (True, False),
                                           (False, True)])
def test_fleet_round_matches_reference_on_its_draws(fleets, delay, handoff):
    ref0, ours0 = fleets
    if delay:                 # half the pool entered coverage last round
        cov = np.asarray(ref0.covered).copy()
        cov[:, ::2] = False
        ref0 = dataclasses.replace(ref0, covered=jnp.asarray(cov))
        ours0 = dataclasses.replace(ours0, covered=tt(cov))
    if handoff:               # a parked vehicle per row
        cid = np.asarray(ref0.cell_id).copy()
        cid[:, 0] = -1
        ref0 = dataclasses.replace(ref0, cell_id=jnp.asarray(cid))
        ours0 = dataclasses.replace(ours0, cell_id=tt(cid, torch.int64))
    key = jax.random.key(4)
    jf, jr, js = jax.jit(lambda k, f: jscn.fleet_round(
        k, f, JSC, JMOB, JCH, JPRM, handover_delay=delay,
        handoff=handoff))(key, ref0)
    f, r, s = scn.fleet_round(RD.fleet_round(key, JSC, 2, ours0.n_vehicles),
                              ours0, SC, MOB, CH, PRM,
                              handover_delay=delay, handoff=handoff)
    np.testing.assert_array_equal(tn(s.sov_idx), np.asarray(js.sov_idx))
    np.testing.assert_array_equal(tn(s.opv_idx), np.asarray(js.opv_idx))
    _assert_rounds_match(r, jr)
    _assert_fleets_equal(f, jf, exact=False)


def test_rollout_rounds_is_the_loop_of_fleet_round(fleets):
    _, ours = fleets
    keys = [101, 102, 103]
    fl_s, rnds, sels = scn.rollout_rounds(keys, ours, SC, MOB, CH, PRM, 3)
    assert rnds.g_sr.shape == (3, 2, SC.n_slots, SC.n_sov)
    fl = ours
    for i, k in enumerate(keys):
        fl, rnd, sel = scn.fleet_round(k, fl, SC, MOB, CH, PRM)
        assert torch.equal(rnd.g_sr, rnds.g_sr[i])
        assert torch.equal(sel.sov_idx, sels.sov_idx[i])
    assert torch.equal(fl.pos, fl_s.pos)
    # time-correlated: the pool moved at most v_max * slot * T per round
    step = torch.linalg.vector_norm(fl_s.pos - ours.pos, dim=-1)
    assert step.max() <= MOB.v_max * PRM.slot * SC.n_slots * 3 + 1e-3


@pytest.mark.parametrize("B,crowd", [(4, False), (4, True), (3, True),
                                     (1, False)])
def test_exchange_fleet_is_the_reference_permutation(B, crowd):
    """No randomness: every field equals the reference's exactly, for a
    crowded network (cells over capacity, overflow parked) too."""
    key = jax.random.key(7 + B)
    rsu = jscn.rsu_grid(B, JMOB)
    ref = jax.jit(lambda k: jscn.init_fleet(k, JSC, JMOB, B,
                                            rsu_xy=rsu))(key)
    if crowd:                 # everyone near the last RSU
        pos = np.asarray(ref.pos).copy()
        pos[..., :] = np.asarray(rsu[-1]) + np.random.default_rng(
            B).uniform(-30, 30, pos.shape)
        ref = dataclasses.replace(ref, pos=jnp.asarray(pos, jnp.float32))
    ours = scn.init_fleet(RD.init_fleet(key, JSC, JMOB, B), SC, MOB, B,
                          rsu_xy=scn.rsu_grid(B, MOB, device="cpu"))
    ours = dataclasses.replace(ours, pos=tt(ref.pos))
    np.testing.assert_array_equal(tn(scn.rsu_grid(B, MOB, device="cpu")), np.asarray(rsu))
    jx = jax.jit(lambda f: jscn.exchange_fleet(f, JMOB))(ref)
    x = scn.exchange_fleet(ours, MOB)
    _assert_fleets_equal(x, jx)
    if crowd and B > 1:
        assert (tn(x.cell_id) == -1).any()
        assert 0.0 < scn.migrated_fraction(ours, x) == pytest.approx(
            jscn.migrated_fraction(ref, jx))
    if B == 1:
        _assert_fleets_equal(x, ref)


def test_handover_delay_one_round_lag():
    """A pool parked at the RSU whose coverage memory says 'entered last
    round' sits out exactly one round with `handover_delay`."""
    fl = scn.init_fleet(20, SC, MOB, 1, device="cpu")
    fl = dataclasses.replace(
        fl, pos=fl.rsu_xy[:, None].expand_as(fl.pos).clone(),
        speed=torch.zeros_like(fl.speed),
        covered=torch.zeros_like(fl.covered))
    for delay in (False, True):
        fl1, rnd1, _ = scn.fleet_round(21, fl, SC, MOB, CH, PRM,
                                       handover_delay=delay)
        assert bool(rnd1.valid_sov.all()) == (not delay)
        assert fl1.covered.all()
        _, rnd2, _ = scn.fleet_round(22, fl1, SC, MOB, CH, PRM,
                                     handover_delay=delay)
        assert rnd2.valid_sov.all()


# ---- stream_rounds -------------------------------------------------------

def _stream_both(sc, jsc, R, B, prm_kw, sched="veds", **cfg_kw):
    """The reference's persistent stream of KEY and the port's on the
    reference's draws."""
    jcfg = JStreamConfig(n_rounds=R, batch=B, **cfg_kw)
    cfg = StreamConfig(n_rounds=R, batch=B, **cfg_kw)
    ref = jax.jit(lambda k: j_stream_rounds(
        k, j_get_scheduler(sched), jsc, JMOB, JCH, JVeds(**prm_kw),
        jcfg))(KEY)
    fd, rds = RD.stream_persistent(KEY, jsc, JMOB, B, R)
    fleet = scn.init_fleet(fd, sc, MOB, B,
                           energy_horizon=cfg_kw.get("energy_horizon"))
    out = stream_rounds(0, get_scheduler(sched), sc, MOB, CH,
                        VedsParams(**prm_kw), cfg, fleet, keys=rds,
                        device="cpu")
    return out, ref


@pytest.fixture(scope="module")
def cold_stream():
    return _stream_both(SC_TIGHT, JSC_TIGHT, 4, 2, {}, carry_queues=True,
                        energy_horizon=8.0)


def test_stream_persistent_matches_reference_and_scatters(cold_stream):
    """Persistent VEDS with carried queues and batteries, 4 rounds of 2
    cells: decisions identical, floats, queues and batteries within rtol
    1e-4; the table untouched (cold path)."""
    out, ref = cold_stream
    assert isinstance(out, StreamResult) and out.fleet is not None
    for k in DECISIONS:
        np.testing.assert_array_equal(tn(out.outputs[k]),
                                      np.asarray(ref.outputs[k]), err_msg=k)
    for k in FLOATS:
        np.testing.assert_allclose(tn(out.outputs[k]),
                                   np.asarray(ref.outputs[k]), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    for k in ("queue", "energy"):
        np.testing.assert_allclose(tn(getattr(out.fleet, k)),
                                   np.asarray(getattr(ref.fleet, k)),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    np.testing.assert_allclose(tn(out.outputs.carry.qs),
                               np.asarray(ref.outputs.carry.qs), rtol=1e-4,
                               atol=1e-7)
    assert out.outputs.carry.qs.shape == (4, 2, SC.n_sov)
    assert float(out.fleet.queue.max()) > 0
    assert float(out.fleet.energy.min()) >= 0
    assert float(out.fleet.energy.min()) < float(
        (out.fleet.allowance * 8.0).max())
    assert torch.equal(out.fleet.p4_tab, p4_seed_table(
        out.fleet.p4_tab.shape, CH.p_max, device="cpu"))
    assert int(tn(out.outputs.n_cot_slots).sum()) > 0


def test_stream_freeze_rule_writes_only_played_slots(cold_stream):
    """Round by round: queues change only at fleet slots that played (a
    valid selection) and unselected vehicles keep their frozen queue."""
    out, _ = cold_stream
    fd, rds = RD.stream_persistent(KEY, JSC_TIGHT, JMOB, 2, 4)
    fl = scn.init_fleet(fd, SC_TIGHT, MOB, 2, energy_horizon=8.0)
    cfg = StreamConfig(n_rounds=1, batch=2, carry_queues=True,
                       energy_horizon=8.0)
    for k in rds:
        before = fl.queue.clone()
        _, rnd, sel = scn.fleet_round(k, fl, SC_TIGHT, MOB, CH, PRM)
        fl, o = stm.sched_round_step(fl, k, get_scheduler("veds"), SC_TIGHT,
                                     MOB, CH, PRM, cfg)
        played = torch.zeros_like(before, dtype=torch.bool)
        rows = torch.arange(2)[:, None]
        played[rows, sel.sov_idx] = rnd.valid_sov
        played[rows, sel.opv_idx] = rnd.valid_opv
        assert torch.equal(fl.queue[~played], before[~played])
    assert torch.equal(fl.queue, out.fleet.queue)


@pytest.mark.parametrize("warm_iters", [5, 12])
def test_warm_stream_matches_reference_decisions(warm_iters):
    """Persistent VEDS+COT with the warm table, 4 rounds: decisions
    identical, floats within WARM_RTOL, the table refreshed."""
    out, ref = _stream_both(SC_TIGHT, JSC_TIGHT, 4, 2,
                            {"ipm_warm_iters": warm_iters},
                            carry_queues=True)
    for k in DECISIONS:
        np.testing.assert_array_equal(tn(out.outputs[k]),
                                      np.asarray(ref.outputs[k]), err_msg=k)
    for k in FLOATS:
        np.testing.assert_allclose(tn(out.outputs[k]),
                                   np.asarray(ref.outputs[k]),
                                   rtol=WARM_RTOL, atol=1e-9, err_msg=k)
    np.testing.assert_allclose(tn(out.fleet.queue),
                               np.asarray(ref.fleet.queue), rtol=WARM_RTOL,
                               atol=1e-6)
    assert not torch.equal(out.fleet.p4_tab, p4_seed_table(
        out.fleet.p4_tab.shape, CH.p_max, device="cpu"))
    tab = out.fleet.p4_tab
    assert torch.isfinite(tab).all() and (tab >= 0).all()
    assert (tab <= CH.p_max + 1e-6).all()


def test_warm_stream_full_budget_keeps_cold_success():
    """At the full budget from the seed table the warm rollout's masks
    are the cold rollout's, and the table is consumed and refreshed
    (`tests/test_streaming.py:432`, port side)."""
    sc = scn.ScenarioParams(n_sov=3, n_opv=2, n_slots=8)
    prm = VedsParams(ipm_iters=8)
    fleet = scn.init_fleet(30, sc, MOB, 1, n_fleet=8, device="cpu")
    cfg = StreamConfig(n_rounds=3, batch=1, carry_queues=True)
    cold = stream_rounds(5, get_scheduler("veds"), sc, MOB, CH, prm, cfg,
                         fleet)
    warm = stream_rounds(5, get_scheduler("veds"), sc, MOB, CH,
                         dataclasses.replace(prm, ipm_warm_iters=8), cfg,
                         fleet)
    assert torch.equal(warm.outputs.success, cold.outputs.success)
    assert not torch.equal(warm.fleet.p4_tab, fleet.p4_tab)
    assert torch.equal(cold.fleet.p4_tab, fleet.p4_tab)
    half = stream_rounds(5, get_scheduler("veds"), sc, MOB, CH,
                         dataclasses.replace(prm, ipm_warm_iters=4), cfg,
                         fleet)
    tab = half.fleet.p4_tab
    assert torch.isfinite(tab).all() and (tab >= 0).all()
    assert (tab <= CH.p_max + 1e-6).all()
    q = half.outputs.carry.qs
    assert torch.isfinite(q).all() and (q >= 0).all()
    assert half.outputs.zeta.sum() >= 0.9 * cold.outputs.zeta.sum()


def test_warm_budget_is_ignored_without_cot():
    """ipm_warm_iters > 0 with a scheduler that solves no P4 (VEDS with
    COT off) is a no-op: identical rollouts, untouched table."""
    fleet = scn.init_fleet(32, SC, MOB, 1, n_fleet=8, device="cpu")
    cfg = StreamConfig(n_rounds=2, batch=1, carry_queues=True)
    dt_only = VedsScheduler(enable_cot=False)
    assert not warm_p4(dt_only, VedsParams(ipm_warm_iters=4))
    base = stream_rounds(1, dt_only, SC, MOB, CH, PRM, cfg, fleet)
    warm = stream_rounds(1, dt_only, SC, MOB, CH,
                         VedsParams(ipm_warm_iters=4), cfg, fleet)
    assert torch.equal(base.outputs.success, warm.outputs.success)
    assert torch.equal(warm.fleet.p4_tab, fleet.p4_tab)


@pytest.mark.parametrize("sched", ["madca", "optimal", "sa", "v2i_only"])
def test_stream_baseline_matches_reference(sched):
    """Each baseline through a persistent stream with carried queues and
    batteries, 3 rounds of 2 cells, on the reference's draws: decisions
    identical, floats, queues and batteries within rtol 1e-4; no P4
    table is touched."""
    out, ref = _stream_both(SC_TIGHT, JSC_TIGHT, 3, 2, {}, sched=sched,
                            carry_queues=True, energy_horizon=8.0)
    for k in DECISIONS:
        np.testing.assert_array_equal(tn(out.outputs[k]),
                                      np.asarray(ref.outputs[k]), err_msg=k)
    for k in FLOATS:
        np.testing.assert_allclose(tn(out.outputs[k]),
                                   np.asarray(ref.outputs[k]), rtol=1e-4,
                                   atol=1e-9, err_msg=k)
    for k in ("queue", "energy"):
        np.testing.assert_allclose(tn(getattr(out.fleet, k)),
                                   np.asarray(getattr(ref.fleet, k)),
                                   rtol=1e-4, atol=1e-7, err_msg=k)
    assert torch.equal(out.fleet.p4_tab, p4_seed_table(
        out.fleet.p4_tab.shape, CH.p_max, device="cpu"))
    assert not out.outputs.n_cot_slots.any()


@pytest.mark.parametrize("sched", ["madca", "optimal", "sa", "v2i_only"])
def test_warm_solver_ignored_by_non_cot_schedulers(sched):
    """ipm_warm_iters > 0 with a scheduler that never solves P4 is a
    no-op: identical rollouts, untouched table
    (`tests/test_streaming.py:469`, port side)."""
    s = get_scheduler(sched)
    prm_w = dataclasses.replace(PRM, ipm_warm_iters=4)
    assert not warm_p4(s, prm_w)
    fleet = scn.init_fleet(32, SC, MOB, 1, n_fleet=8, device="cpu")
    cfg = StreamConfig(n_rounds=2, batch=1, carry_queues=True)
    base = stream_rounds(1, s, SC, MOB, CH, PRM, cfg, fleet)
    warm = stream_rounds(1, s, SC, MOB, CH, prm_w, cfg, fleet)
    for k in DECISIONS + FLOATS:
        assert torch.equal(base.outputs[k], warm.outputs[k]), k
    assert torch.equal(warm.fleet.p4_tab, fleet.p4_tab)
    assert torch.equal(warm.fleet.queue, base.fleet.queue)


def test_queues_grow_under_infeasible_budget():
    """SA spends kappa * p_max per scheduled slot against a budget orders
    of magnitude smaller: the carried queues strictly increase round over
    round (`tests/test_streaming.py:493`, port side)."""
    sc = dataclasses.replace(SC, e_min=1e-4, e_max=2e-4)
    cfg = StreamConfig(n_rounds=6, batch=1, fresh_fleet=True,
                       carry_queues=True)
    res = stream_rounds(2, get_scheduler("sa"), sc, MOB, CH, PRM, cfg,
                        device="cpu")
    q = tn(res.outputs.carry.qs).mean(axis=(1, 2))           # [R]
    assert (np.diff(q) > 0).all(), q
    assert q[-1] > 5 * q[0]


def test_queues_stable_under_feasible_budget():
    """With budgets far above anything a round can spend (T kappa p_max
    << e_min), `v2i_only`'s carried queues stay near zero with no
    round-over-round build-up (`tests/test_streaming.py:507`, port
    side)."""
    sc = dataclasses.replace(SC, e_min=0.5, e_max=1.0)
    cfg = StreamConfig(n_rounds=6, batch=1, fresh_fleet=True,
                       carry_queues=True)
    res = stream_rounds(2, get_scheduler("v2i_only"), sc, MOB, CH, PRM,
                        cfg, device="cpu")
    q = tn(res.outputs.carry.qs)                             # [R,1,S]
    assert q.max() < 1e-3, q.max()
    assert q[-1].max() <= q[0].max() + 1e-6


@pytest.mark.parametrize("B", [1, 3])
def test_stream_fresh_matches_blocked(B):
    """Fresh fleets without queue carry: round for round the blocked
    `make_round_batch` -> `solve_round` of the same round key, bit for
    bit; and on the reference's draws the reference's fresh stream's
    decisions."""
    R = 2
    cfg = StreamConfig(n_rounds=R, batch=B, fresh_fleet=True)
    res = stream_rounds(9, get_scheduler("veds"), SC, MOB, CH, PRM, cfg,
                        device="cpu")
    assert res.fleet is None
    for r, k in enumerate(round_keys(9, cfg, R)):
        ref = get_scheduler("veds").solve_round(scn.make_round_batch(
            k, SC, MOB, CH, PRM, B, hetero_fleet=False, device="cpu"),
            PRM, CH)
        for f in DECISIONS + FLOATS:
            assert torch.equal(res.outputs[f][r], ref[f]), f
    jcfg = JStreamConfig(n_rounds=R, batch=B, fresh_fleet=True)
    jres = jax.jit(lambda k: j_stream_rounds(
        k, j_get_scheduler("veds"), JSC, JMOB, JCH, JPRM, jcfg))(KEY)
    keys = [RD.round_batch(jax.random.fold_in(KEY, r), JSC, JMOB, B)
            for r in range(R)]
    ours = stream_rounds(0, get_scheduler("veds"), SC, MOB, CH, PRM, cfg,
                         keys=keys, device="cpu")
    for f in DECISIONS:
        np.testing.assert_array_equal(tn(ours.outputs[f]),
                                      np.asarray(jres.outputs[f]))
    for f in FLOATS:
        np.testing.assert_allclose(tn(ours.outputs[f]),
                                   np.asarray(jres.outputs[f]), rtol=1e-4,
                                   atol=1e-9)


def test_round_chunk_matches_unchunked():
    """Chunks of rounds solved as one widened batch: decisions identical,
    floats within 2e-5 (the [C*B] batch may reorder reductions)."""
    base = StreamConfig(n_rounds=4, batch=1, fresh_fleet=True)
    res_u = stream_rounds(3, get_scheduler("veds"), SC, MOB, CH, PRM, base,
                          device="cpu")
    res_c = stream_rounds(3, get_scheduler("veds"), SC, MOB, CH, PRM,
                          dataclasses.replace(base, round_chunk=2),
                          device="cpu")
    for f in DECISIONS:
        assert torch.equal(res_c.outputs[f], res_u.outputs[f]), f
    for f in FLOATS:
        torch.testing.assert_close(res_c.outputs[f], res_u.outputs[f],
                                   rtol=2e-5, atol=1e-7)


def test_stream_config_validation_is_centralized():
    validate_stream_config(StreamConfig(n_rounds=4, fresh_fleet=True,
                                        round_chunk=2))
    for cfg in (
        StreamConfig(n_rounds=4, round_chunk=0),
        StreamConfig(n_rounds=4, fresh_fleet=True, round_chunk=3),
        StreamConfig(n_rounds=4, fresh_fleet=True, round_chunk=2,
                     carry_queues=True),
        StreamConfig(n_rounds=4, fresh_fleet=False, round_chunk=2),
        StreamConfig(n_rounds=0, fresh_fleet=False, round_chunk=2),
        StreamConfig(n_rounds=4, fresh_fleet=True, handover_delay=True),
        StreamConfig(n_rounds=4, fresh_fleet=True, handoff=True),
    ):
        with pytest.raises(ValueError):
            validate_stream_config(cfg)
    cfg = StreamConfig(n_rounds=4, fresh_fleet=True, round_chunk=2)
    with pytest.raises(ValueError, match="threads params"):
        validate_stream_config(cfg, threads_params=True)
    with pytest.raises(ValueError):
        stream_rounds(0, get_scheduler("veds"), SC, MOB, CH, PRM,
                      StreamConfig(n_rounds=3, fresh_fleet=True,
                                   round_chunk=2), device="cpu")


def test_segmented_keys_are_the_one_loop_keys():
    """Round keys depend on (seed, r) alone: a run resumed from its
    returned fleet with the next keys equals the one-loop run."""
    cfg = StreamConfig(n_rounds=3, batch=1, carry_queues=True)
    whole = stream_rounds(4, get_scheduler("veds"), SC, MOB, CH, PRM, cfg,
                          device="cpu")
    assert round_keys(4, cfg, 2, r0=1) == round_keys(4, cfg, 3)[1:]
    a = stream_rounds(4, get_scheduler("veds"), SC, MOB, CH, PRM,
                      dataclasses.replace(cfg, n_rounds=1), device="cpu")
    b = stream_rounds(4, get_scheduler("veds"), SC, MOB, CH, PRM,
                      dataclasses.replace(cfg, n_rounds=2), a.fleet,
                      keys=round_keys(4, cfg, 2, r0=1))
    assert torch.equal(b.fleet.queue, whole.fleet.queue)
    assert torch.equal(torch.cat([a.outputs.zeta, b.outputs.zeta]),
                       whole.outputs.zeta)


def test_cast_promote_and_pack_cells():
    fl = sched_state0(6, SC, MOB, StreamConfig(batch=2), device="cpu")
    low = cast_sched_state(fl, torch.bfloat16)
    assert low.p4_tab.dtype == torch.bfloat16 and low.pos.dtype == \
        torch.float32
    assert promote_sched_state(low).p4_tab.dtype == torch.float32
    carry = SchedulerCarry(qs=torch.ones(2, 4), qu=torch.ones(2, 3))
    assert cast_sched_state(carry, torch.bfloat16) is carry
    assert cast_sched_state(fl, None) is fl
    cells = [unpack_cell(fl, b) for b in range(2)]
    packed = pack_cells(cells)
    for f in dataclasses.fields(fl):
        assert torch.equal(getattr(packed, f.name), getattr(fl, f.name))
    padded = pack_cells(cells[:1], pad_to=2)
    assert padded.batch_size == 2
    with pytest.raises(ValueError):
        pack_cells(cells, pad_to=1)
    rc = RolloutCarry(sched=fl, params={"w": torch.zeros(2, 3)})
    assert unpack_cell(rc, 1).params["w"].shape == (1, 3)
    fresh = sched_state0(6, SC, MOB, StreamConfig(batch=2, fresh_fleet=True),
                         device="cpu")
    assert isinstance(fresh, SchedulerCarry) and not fresh.qs.any()
