"""The port's Section VI schedulers (`core/baselines.py`) against the
reference, and the reference's scheduler properties on the port.

Inputs are the reference's own rounds: a heterogeneous `make_round_batch`
of three cells (padded vehicles included) and single rounds of
`make_round`, exported to numpy and fed to both sides, with and without a
non-zero queue carry. The reference's VEDS runs its kernel path (the
Pallas `veds_score` kernel in interpret mode).

Tolerances: success masks, `n_success` and slot counts identical; the
delivered bits, energies and round-end queues within rtol 1e-5 for
`optimal`, `madca` and `sa` (closed forms and a few fp32 products a
slot), and within rtol 1e-4 for `veds` and `v2i_only`, whose slots
accumulate interior-point and `veds_score` results (the cold standard of
`tests/test_torch_veds.py`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channel.mobility import ManhattanParams as JManhattan
from repro.channel.v2x import ChannelParams as JChannel
from repro.core import lyapunov as jlyp
from repro.core.baselines import get_scheduler as j_get_scheduler
from repro.core.lyapunov import VedsParams as JVeds
from repro.core.scenario import ScenarioParams as JScenario
from repro.core.scenario import make_round as j_make_round
from repro.core.scenario import make_round_batch as j_make_round_batch
from repro.core.scheduler import SchedulerCarry as JCarry
from repro.core.veds import RoundInputs as JRoundInputs
from repro_torch.channel.v2x import ChannelParams
from repro_torch.core import baselines
from repro_torch.core import lyapunov as lyp
from repro_torch.core.baselines import (FnScheduler, VedsScheduler,
                                        get_scheduler)
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scheduler import (RoundOutputs, Scheduler,
                                        SchedulerCarry)
from repro_torch.core.veds import RoundInputs
from torch_port_util import round_to_torch, tn, tt

PRM, JPRM = VedsParams(), JVeds()
CH, JCH = ChannelParams(), JChannel()
SC = JScenario(n_sov=5, n_opv=4, n_slots=20)
DECISIONS = ("success", "n_success", "n_cot_slots", "n_dt_slots")
FLOATS = ("zeta", "energy_sov", "energy_opv")
FIELDS = DECISIONS + FLOATS
# The scheduler parity matrix: every name of the port's registry,
# spelled out and pinned against the live registry below. Its
# parameter is `sched`, not `name`: reprolint's parity-coverage rule
# reads `name` matrices of every test file for both packages' registries
# alike, and the reference's tests pin its registry to the reference's
# own matrix (`tests/test_analysis.py`).
PARITY_SCHEDULERS = ("madca", "optimal", "sa", "v2i_only", "veds")
RTOL = {"madca": 1e-5, "optimal": 1e-5, "sa": 1e-5, "v2i_only": 1e-4,
        "veds": 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests loop over small tensor ops: one intra-op thread, so
    that parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def hetero():
    """Three heterogeneous reference cells (padded vehicles included)."""
    return jax.jit(lambda k: j_make_round_batch(
        k, SC, JManhattan(), JCH, JPRM, 3, hetero_fleet=True))(
            jax.random.key(4))


@pytest.fixture(scope="module")
def singles():
    """Three single reference rounds (whole fleets, no padding)."""
    mk = jax.jit(lambda k: j_make_round(k, SC, JManhattan(v_max=10.0), JCH,
                                        JPRM))
    return [round_to_torch(mk(jax.random.key(s))) for s in range(3)]


def _carry(shape_s, shape_u, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 0.02, shape_s).astype(np.float32),
            rng.uniform(0, 0.02, shape_u).astype(np.float32))


def test_parity_matrix_covers_scheduler_registry():
    assert set(PARITY_SCHEDULERS) == set(baselines.SCHEDULERS)


@pytest.mark.parametrize("with_carry", [False, True])
@pytest.mark.parametrize("layout", ["single", "batched"])
@pytest.mark.parametrize("sched", PARITY_SCHEDULERS)
def test_scheduler_matches_reference(hetero, sched, layout, with_carry):
    """Each scheduler, on one cell and on the three-cell batch, cold
    queues and a carried non-zero pair: decisions identical, floats and
    the round-end queues within the scheduler's tolerance."""
    jr = hetero if layout == "batched" else jax.tree.map(lambda x: x[0],
                                                         hetero)
    jc, c = None, None
    if with_carry:
        qs, qu = _carry(jr.e_sov.shape, jr.e_opv.shape)
        jc = JCarry(qs=jnp.asarray(qs), qu=jnp.asarray(qu))
        c = SchedulerCarry(qs=tt(qs), qu=tt(qu))
    ref = jax.jit(lambda r, c_: j_get_scheduler(sched).solve_round(
        r, JPRM, JCH, c_))(jr, jc)
    out = get_scheduler(sched).solve_round(round_to_torch(jr), PRM, CH, c)
    assert isinstance(out, RoundOutputs)
    assert out.batched == (layout == "batched")
    for k in DECISIONS:
        np.testing.assert_array_equal(tn(out[k]), np.asarray(ref[k]),
                                      err_msg=k)
    rtol = RTOL[sched]
    for k in FLOATS:
        np.testing.assert_allclose(tn(out[k]), np.asarray(ref[k]),
                                   rtol=rtol, atol=1e-9, err_msg=k)
    for k in ("qs", "qu"):
        np.testing.assert_allclose(tn(getattr(out.carry, k)),
                                   np.asarray(getattr(ref.carry, k)),
                                   rtol=rtol, atol=1e-9, err_msg=k)
    assert out.carry.p4 is None


def test_madca_spends_budgets_to_their_end_as_the_compiled_reference(
        singles):
    """`madca` gives a vehicle full power while its budget lasts and the
    rest, e_left / slot, in its last slot; the sign of what that leaves,
    e_left - slot p, decides whether the vehicle takes one more slot. The
    reference's compiled round computes the quotient as XLA rewrites it,
    a product with the float32 1 / slot. Over 64 cells of budgets that
    run out mid-round: slot counts and successes identical, and every
    cell's energy and round-end queue within `RTOL`."""
    rnd = singles[0]
    rng = np.random.default_rng(5)
    B = 64
    tile = {f.name: None if getattr(rnd, f.name) is None else
            tn(getattr(rnd, f.name))[None].repeat(B, 0)
            for f in dataclasses.fields(RoundInputs)}
    tile["e_sov"] = (tile["e_cp"] + rng.uniform(
        0.0, 0.12, tile["e_cp"].shape)).astype(np.float32)
    ours = RoundInputs(**{k: None if v is None else tt(v)
                          for k, v in tile.items()})
    ref = jax.jit(lambda r: j_get_scheduler("madca").solve_round(
        r, JPRM, JCH, None))(JRoundInputs(
            **{k: None if v is None else jnp.asarray(v)
               for k, v in tile.items()}))
    out = get_scheduler("madca").solve_round(ours, PRM, CH, None)
    for k in DECISIONS:
        np.testing.assert_array_equal(tn(out[k]), np.asarray(ref[k]),
                                      err_msg=k)
    for k in ("energy_sov", "zeta"):
        np.testing.assert_allclose(tn(out[k]), np.asarray(ref[k]),
                                   rtol=RTOL["madca"], atol=1e-9, err_msg=k)
    np.testing.assert_allclose(tn(out.carry.qs), np.asarray(ref.carry.qs),
                               rtol=RTOL["madca"], atol=1e-9)


def test_registry_schedulers_follow_the_protocol():
    """The five names of the reference, each a frozen `Scheduler` that
    `get_scheduler` returns; `v2i_only` is VEDS without cooperation."""
    assert sorted(baselines.SCHEDULERS) == sorted(PARITY_SCHEDULERS)
    for name in PARITY_SCHEDULERS:
        s = get_scheduler(name)
        assert isinstance(s, Scheduler) and s.name == name
        assert s is baselines.SCHEDULERS[name]
    assert get_scheduler("v2i_only") == VedsScheduler(name="v2i_only",
                                                      enable_cot=False)
    assert isinstance(get_scheduler("sa"), FnScheduler)
    with pytest.raises(dataclasses.FrozenInstanceError):
        get_scheduler("sa").name = "x"


@pytest.mark.parametrize("sched", PARITY_SCHEDULERS)
def test_batched_matches_single_cell(sched, singles):
    """B-stacked rounds reproduce the per-cell single-round outputs
    (`tests/test_batched_scheduling.py:53`, port side)."""
    s = get_scheduler(sched)
    out_b = s(RoundInputs.stack(singles), PRM, CH)
    assert out_b.batched and out_b.batch_size == len(singles)
    for j, rnd in enumerate(singles):
        out_1 = s(rnd, PRM, CH)
        assert not out_1.batched
        for f in FIELDS:
            np.testing.assert_allclose(
                tn(out_1[f]).astype(np.float64),
                tn(out_b[f][j]).astype(np.float64), rtol=2e-5, atol=1e-7,
                err_msg=f"{sched}/{f}/cell{j}")


@pytest.mark.parametrize("sched", PARITY_SCHEDULERS)
def test_success_respects_validity_masks(sched, hetero):
    """No padded SOV succeeds; `optimal` succeeds on every real one
    (`tests/test_batched_scheduling.py:110`, port side)."""
    rb = round_to_torch(hetero)
    out = get_scheduler(sched).solve_round(rb, PRM, CH)
    assert not (out.success & ~rb.valid_sov).any(), sched
    assert torch.equal(out.n_success, out.success.sum(-1))
    if sched == "optimal":
        assert torch.equal(out.n_success, rb.valid_sov.sum(-1))
    # padded vehicles are charged no energy
    assert not out.energy_sov[~rb.valid_sov].any()


def test_sa_energy_attributed_per_vehicle(singles):
    """SA's transmit energy lands on the scheduled vehicle, one quantum
    of slot * p_max per scheduled slot (`tests/test_batched_scheduling.py
    :121`, port side)."""
    out = get_scheduler("sa")(singles[0], PRM, CH)
    tx = tn(out.energy_sov) - tn(singles[0].e_cp)
    quanta = tx / (PRM.slot * CH.p_max)
    np.testing.assert_allclose(quanta, np.round(quanta), atol=1e-5)
    assert int(out.n_dt_slots) == int(np.round(quanta.sum()))
    # the round robin cannot put every slot on one vehicle
    assert quanta.max() < SC.n_slots


def test_optimal_upper_bounds_all(singles, hetero):
    """`optimal` succeeds at least as often as every other scheduler on
    the same round, and SA's and MADCA's COT counts are zero
    (`tests/test_veds.py:36`, port side)."""
    rounds = singles + [round_to_torch(hetero)]
    for rnd in rounds:
        best = get_scheduler("optimal")(rnd, PRM, CH).n_success
        for name in ("veds", "v2i_only", "madca", "sa"):
            out = get_scheduler(name)(rnd, PRM, CH)
            assert (out.n_success <= best).all(), name
            if name != "veds":
                assert not out.n_cot_slots.any(), name


def test_relax_queue_and_psi_match_reference():
    rng = np.random.default_rng(3)
    q = rng.uniform(0, 0.05, 64).astype(np.float32)
    e = rng.uniform(-0.05, 0.05, 64).astype(np.float32)
    np.testing.assert_array_equal(
        tn(lyp.relax_queue(tt(q), tt(e))),
        np.asarray(jlyp.relax_queue(jnp.asarray(q), jnp.asarray(e))))
    for alpha in (0.5, 2.0, 6.0):
        assert lyp.psi(VedsParams(alpha=alpha)) == \
            jlyp.psi(JVeds(alpha=alpha))


@pytest.mark.parametrize("sched", ["madca", "optimal", "sa"])
def test_loops_read_nothing_back_to_the_host(monkeypatch, hetero, sched):
    """The three loops are device ops only, so the streaming engine's
    rounds never stall on the host: no `.item()`, no `bool`, `int` or
    `float` of a tensor inside a round."""
    rb = round_to_torch(hetero)
    qs, qu = _carry(rb.e_sov.shape, rb.e_opv.shape)
    c = SchedulerCarry(qs=tt(qs), qu=tt(qu))

    def refuse(*a, **k):
        raise AssertionError("a value read back to the host")

    for attr in ("item", "tolist", "__bool__", "__int__", "__float__",
                 "__index__"):
        monkeypatch.setattr(torch.Tensor, attr, refuse)
    out = get_scheduler(sched).solve_round(rb, PRM, CH, c)
    monkeypatch.undo()
    assert out.n_success.shape == (3,)
