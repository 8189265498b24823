"""The port's VEDS round (Algorithm 2, cold P4) against the reference.

Inputs are reference rounds from `make_round_batch(hetero_fleet=True)`,
exported to numpy and fed to both sides. The reference runs its kernel
path (`use_kernel=True`: the Pallas `veds_score` kernel in interpret
mode). Decisions (`success`, `n_success`, COT/DT slot counts) must be
identical; floats agree within fp32 tolerance: rtol 1e-4 on delivered
bits, energies and queues, which accumulate 10 slots of interior-point
results (the solver alone agrees to rtol 1e-4, see test_torch_solver).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channel.mobility import ManhattanParams as JManhattan
from repro.channel.v2x import ChannelParams as JChannel
from repro.core.lyapunov import VedsParams as JVeds
from repro.core.scenario import ScenarioParams as JScenario
from repro.core.scenario import make_round_batch
from repro.core.scheduler import SchedulerCarry as JCarry
from repro.core.veds import _dt_candidates as j_dt_candidates
from repro.core.veds import _select_slot as j_select_slot
from repro.core.veds import solve_slot as j_solve_slot
from repro.core.veds import veds_round as j_veds_round
from repro_torch.channel.v2x import ChannelParams
from repro_torch.core import veds as port_veds
from repro_torch.core.baselines import (SCHEDULERS, VedsScheduler,
                                        get_scheduler)
from repro_torch.core.lyapunov import VedsParams, sigmoid_weight
from repro_torch.core.scheduler import (SchedulerCarry, divisors,
                                        init_queues, masked_e_cp)
from repro_torch.core.veds import (NEG, RoundInputs, _dt_candidates,
                                   _select_slot, _slot_start, solve_slot,
                                   veds_round)
from torch_port_util import round_to_torch, tn, tt

PRM, JPRM = VedsParams(), JVeds()
CH, JCH = ChannelParams(), JChannel()
SC = JScenario(n_sov=4, n_opv=4, n_slots=10)
DECISIONS = ("success", "n_success", "n_cot_slots", "n_dt_slots")
FLOATS = ("zeta", "energy_sov", "energy_opv")


@pytest.fixture(scope="module")
def rounds3():
    """Three hetero-fleet reference cells (padded vehicles included)."""
    return jax.jit(lambda k: make_round_batch(
        k, SC, JManhattan(), JCH, JPRM, 3, hetero_fleet=True))(
            jax.random.key(4))


def _carry(B, seed):
    rng = np.random.default_rng(seed)
    shape_s = (SC.n_sov,) if B == 1 else (B, SC.n_sov)
    shape_u = (SC.n_opv,) if B == 1 else (B, SC.n_opv)
    return (rng.uniform(0, 0.02, shape_s).astype(np.float32),
            rng.uniform(0, 0.02, shape_u).astype(np.float32))


@pytest.mark.parametrize("B,enable_cot,with_carry", [
    (1, True, False), (1, True, True), (1, False, False),
    (3, True, False), (3, True, True), (3, False, True)])
def test_veds_round_matches_reference(rounds3, B, enable_cot, with_carry):
    jr = rounds3 if B == 3 else rounds3.cell(0)
    jc = c = None
    if with_carry:
        qs, qu = _carry(B, seed=B)
        jc = JCarry(qs=jnp.asarray(qs), qu=jnp.asarray(qu))
        c = SchedulerCarry(qs=tt(qs), qu=tt(qu))
    ref = jax.jit(lambda r, c_: j_veds_round(
        r, JPRM, JCH, enable_cot=enable_cot, carry=c_))(jr, jc)
    out = veds_round(round_to_torch(jr), PRM, CH, enable_cot=enable_cot,
                     carry=c)
    assert out.batched == (B == 3)
    for k in DECISIONS:
        np.testing.assert_array_equal(tn(out[k]), np.asarray(ref[k]),
                                      err_msg=k)
    for k in FLOATS:
        np.testing.assert_allclose(tn(out[k]), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-9, err_msg=k)
    for k in ("qs", "qu"):
        np.testing.assert_allclose(tn(getattr(out.carry, k)),
                                   np.asarray(getattr(ref.carry, k)),
                                   rtol=1e-4, atol=1e-9, err_msg=k)
    if enable_cot and B == 3:
        assert int(tn(out.n_cot_slots).sum()) > 0     # COT path exercised
    if not enable_cot:
        assert int(tn(out.n_cot_slots).sum()) == 0


def test_dt_candidates_match_reference_kernel_path(rounds3):
    """The [B, S] DT grid of one slot through the port's wrapper (plain
    version on the CPU) against the reference's Pallas kernel path."""
    rng = np.random.default_rng(0)
    g = np.array(rounds3.g_sr[:, 5])
    zeta = rng.uniform(0, 1e7, g.shape).astype(np.float32)
    qs = rng.uniform(0, 0.05, g.shape).astype(np.float32)
    elig = rng.random(g.shape) < 0.8
    w = sigmoid_weight(tt(zeta), PRM)
    ours = _dt_candidates(w, tt(qs), tt(g), tt(elig), PRM, CH)
    ref = j_dt_candidates(jnp.asarray(tn(w)), jnp.asarray(qs),
                          jnp.asarray(g), jnp.asarray(elig), JPRM, JCH,
                          use_kernel=True)
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(tn(a), np.asarray(b), rtol=2e-6, atol=0)


def test_select_slot_matches_reference_including_ties():
    """Argmax takes the first maximum on both sides, including all-NEG
    rows (nothing eligible) and exact ties between candidates."""
    rng = np.random.default_rng(1)
    B, S, U = 4, 5, 3
    y_dt = rng.normal(0, 1, (B, S)).astype(np.float32)
    y_cot = rng.normal(0, 1, (B, S, U)).astype(np.float32)
    y_dt[0] = NEG
    y_cot[0] = NEG                       # cell 0: nothing to schedule
    y_dt[1, [1, 3]] = 5.0                # tie inside the DT grid
    y_cot[2, 0, 1] = y_cot[2, 4, 2] = 7.0    # tie inside the COT grid
    y_cot[3] = NEG                       # cell 3: DT only
    p_dt, z_dt = (rng.uniform(0, 0.3, (B, S)).astype(np.float32)
                  for _ in range(2))
    pm, z_cot = (rng.uniform(0, 0.3, (B, S, U)).astype(np.float32)
                 for _ in range(2))
    po = rng.uniform(0, 0.3, (B, S, U, U)).astype(np.float32)
    order = np.argsort(rng.random((B, S, U)), axis=-1)
    ours = _select_slot(tt(y_dt), tt(p_dt), tt(z_dt), tt(y_cot), tt(pm),
                        tt(po), tt(order), tt(z_cot), PRM)
    ref = jax.vmap(lambda *a: j_select_slot(*a, prm=JPRM))(
        *(jnp.asarray(x) for x in (y_dt, p_dt, z_dt, y_cot, pm, po, order,
                                   z_cot)))
    for a, b in zip(ours[:3], ref[:3]):             # m_sel, use_dt, use_cot
        np.testing.assert_array_equal(tn(a), np.asarray(b))
    for a, b in zip(ours[3:], ref[3:]):             # z, e_sov, e_opv
        np.testing.assert_array_equal(tn(a), np.asarray(b))
    assert not tn(ours[1])[0] and not tn(ours[2])[0]


def test_round_inputs_stack_and_cell(rounds3):
    r = round_to_torch(rounds3)
    cells = [r.cell(b) for b in range(3)]
    stacked = RoundInputs.stack(cells)
    for k in ("g_sr", "g_so", "e_sov", "valid_sov"):
        assert torch.equal(getattr(stacked, k), getattr(r, k))
    one = cells[0].with_batch_axis()
    assert one.batched and one.batch_size == 1
    assert torch.equal(one.g_sr[0], cells[0].g_sr)


def test_init_queues_and_masked_e_cp(rounds3):
    r = round_to_torch(rounds3)
    qs, qu = init_queues(r, None)
    assert not qs.any() and not qu.any() and qs.shape == r.e_sov.shape
    c = SchedulerCarry(qs=torch.ones(SC.n_sov), qu=torch.ones(SC.n_opv))
    qs, qu = init_queues(r, c)
    assert qs.shape == r.e_sov.shape and (qs == 1).all()
    e = masked_e_cp(r)
    assert (e[~r.valid_sov] == 0).all()


def test_scheduler_registry_has_veds_only():
    """The registry now holds the reference's five schedulers (the test
    keeps the name of the slice that held VEDS only); an unknown name
    raises a KeyError that names them."""
    s = get_scheduler("veds")
    assert isinstance(s, VedsScheduler) and s.name == "veds"
    assert sorted(SCHEDULERS) == ["madca", "optimal", "sa", "v2i_only",
                                  "veds"]
    for name in SCHEDULERS:
        assert get_scheduler(name).name == name
    assert get_scheduler("v2i_only").enable_cot is False
    with pytest.raises(KeyError, match="have \\['madca', 'optimal'"):
        get_scheduler("nope")


def test_warm_p4_is_not_ported(rounds3):
    """Warm P4 is ported (the test keeps the name of the slice that
    refused it): a warm budget with a carried P4 table runs the
    reference's warm round, decisions identical and floats within rtol
    1e-4; the returned table is refreshed and stays in the box (its
    entries of infeasible candidates are ill-conditioned solves, compared
    only where feasible, in `test_torch_streaming.py`). Without a table
    the reference runs cold, and so does the port."""
    r = round_to_torch(rounds3)
    warm = VedsParams(ipm_warm_iters=5)
    B, S, U = 3, SC.n_sov, SC.n_opv
    tab = np.random.default_rng(5).uniform(
        0.0, 0.3, (B, S, U, U + 1)).astype(np.float32)
    table = SchedulerCarry(qs=torch.zeros(B, S), qu=torch.zeros(B, U),
                           p4=tt(tab))
    ref = jax.jit(lambda r_, c_: j_veds_round(
        r_, dataclasses.replace(JPRM, ipm_warm_iters=5), JCH,
        carry=c_))(rounds3, JCarry(qs=jnp.zeros((B, S)),
                                   qu=jnp.zeros((B, U)),
                                   p4=jnp.asarray(tab)))
    out = veds_round(r, warm, CH, carry=table)
    for k in DECISIONS:
        np.testing.assert_array_equal(tn(out[k]), np.asarray(ref[k]),
                                      err_msg=k)
    for k in FLOATS:
        np.testing.assert_allclose(tn(out[k]), np.asarray(ref[k]),
                                   rtol=1e-4, atol=1e-9, err_msg=k)
    p4 = tn(out.carry.p4)
    assert p4.shape == tab.shape and not np.array_equal(p4, tab)
    assert ((p4 >= 0) & (p4 <= CH.p_max)).all()
    cold, plain = veds_round(r, warm, CH), veds_round(r, PRM, CH)
    for k in DECISIONS + FLOATS:
        assert torch.equal(cold[k], plain[k])
    assert cold.carry.p4 is None


@pytest.mark.parametrize("t", [0, 3, 7, 9])
def test_solve_slot_at_a_device_index_matches_reference(rounds3, t):
    """One slot with `t` a 0-dim int64 tensor against the reference's
    jitted `solve_slot` at a traced index, from a mid-round state. In cell
    0 one SOV's t_cp lies exactly on the slot's start t * slot (eligible:
    `<=` in fp32 on both sides), with a strong link and an empty queue,
    the next SOV's one fp32 step above it, and every other SOV's far
    later: cell 0 transmits at slot t only if the start time is the fp32
    product."""
    B, S = 3, SC.n_sov
    rng = np.random.default_rng(t)
    t_cp, g_sr = np.array(rounds3.t_cp), np.array(rounds3.g_sr)
    start = np.float32(t) * np.float32(JPRM.slot)
    v0, v1 = np.flatnonzero(np.array(rounds3.valid_sov[0]))[:2]
    t_cp[0] = 1e3
    t_cp[0, v0] = start
    t_cp[0, v1] = np.nextafter(start, np.float32(1))
    g_sr[0, t, v0] = 1e-11
    jr = dataclasses.replace(rounds3, t_cp=jnp.asarray(t_cp),
                             g_sr=jnp.asarray(g_sr))
    zeta = rng.uniform(0, 1.2 * JPRM.Q, (B, S)).astype(np.float32)
    qs = rng.uniform(0, 0.02, (B, S)).astype(np.float32)
    zeta[0, v0] = qs[0, v0] = 0.0
    qu = rng.uniform(0, 0.02, (B, SC.n_opv)).astype(np.float32)
    T = float(SC.n_slots)
    ref_state, ref_info = jax.jit(lambda t_, st: j_solve_slot(
        t_, st, jr, JPRM, JCH, enable_cot=True, use_kernel=True))(
            jnp.asarray(t, jnp.int32),
            {"zeta": jnp.asarray(zeta), "qs": jnp.asarray(qs),
             "qu": jnp.asarray(qu), "T": jnp.asarray(T)})
    rb = round_to_torch(jr)
    state, info = solve_slot(
        torch.tensor(t), {"zeta": tt(zeta), "qs": tt(qs), "qu": tt(qu),
                          **divisors(rb, PRM, CH)}, rb, PRM, CH)
    for k in ("m", "use_dt", "use_cot"):
        np.testing.assert_array_equal(tn(info[k]), np.asarray(ref_info[k]),
                                      err_msg=k)
    for k in ("z", "e_sov", "e_opv"):
        np.testing.assert_allclose(tn(info[k]), np.asarray(ref_info[k]),
                                   rtol=1e-4, atol=1e-9, err_msg=k)
    for k in ("zeta", "qs", "qu"):
        np.testing.assert_allclose(tn(state[k]), np.asarray(ref_state[k]),
                                   rtol=1e-4, atol=1e-9, err_msg=k)
    assert int(info["m"][0]) == v0
    assert bool(info["use_dt"][0] | info["use_cot"][0])


@pytest.mark.parametrize("slot", [0.1, 0.05, 0.3])
def test_slot_start_is_the_fp32_product(slot):
    """The slot's start time is computed on the device as one fp32
    product, equal to the reference's fp32(t) * fp32(slot) for every slot
    of a round (0.1 is the slot of `run_fl` and of the VFL rounds)."""
    for t in range(60):
        got = _slot_start(torch.tensor(t), slot)
        assert got.dtype == torch.float32 and got.ndim == 0
        assert got.item() == np.float32(t) * np.float32(slot), t


@pytest.fixture
def replayed_step(monkeypatch):
    """The slot graph with each replay run as the captured step itself
    (the CPU has no CUDA graphs), and an empty cache of graphs."""
    class Replay:
        def __init__(self, step):
            self.replay = step

    def capture(self):
        self.graph = Replay(self._step)
        port_veds._SlotGraph.captures += 1

    monkeypatch.setattr(port_veds._SlotGraph, "_capture", capture)
    monkeypatch.setattr(port_veds, "_SLOT_GRAPHS", {})
    monkeypatch.setattr(port_veds, "_PINS", {})


def test_slot_graph_bookkeeping_matches_eager_loop(rounds3, replayed_step):
    """The slot graph's buffers, with each replay run as the captured step
    itself: inputs copied in, the slot index advanced by the step, one
    row of decisions written per slot, outputs copied out. Bit for bit
    the eager loop's, for two rounds of one shape through one graph, the
    first round's outputs untouched by the second, padding masks and a
    carry included."""
    r = round_to_torch(rounds3)
    other = port_veds.map_tensors(lambda x: x.flip(0), r)   # cells reversed
    qs, qu = _carry(3, seed=9)
    c = SchedulerCarry(qs=tt(qs), qu=tt(qu))
    n0 = port_veds._SlotGraph.captures
    for cot in (True, False):
        runs = [(x, port_veds._veds_round(x, PRM, CH, enable_cot=cot,
                                          carry=c, graphed=True))
                for x in (r, other)]
        for x, got in runs:
            want = veds_round(x, PRM, CH, enable_cot=cot, carry=c)
            for k in DECISIONS + FLOATS:
                assert torch.equal(got[k], want[k]), k
            assert torch.equal(got.carry.qs, want.carry.qs)
            assert torch.equal(got.carry.qu, want.carry.qu)
    assert port_veds._SlotGraph.captures == n0 + 2


def _first_slots(r, T):
    """The round cut to its first T slots."""
    return dataclasses.replace(r, **{k: getattr(r, k)[:, :T].contiguous()
                                     for k in ("g_sr", "g_or", "g_so")})


def test_slot_graph_cache_is_bounded_and_takes_float32_queues(
        rounds3, replayed_step):
    """At most `_MAX_SLOT_GRAPHS` graphs are kept, the oldest evicted
    first: a round of its shape captures again, the newest shapes replay.
    A carry in another dtype than float32 is refused, not copied into the
    graph's float32 buffers (on the card `veds_score` refuses it too)."""
    r = round_to_torch(rounds3)
    cap = port_veds._MAX_SLOT_GRAPHS
    n0 = port_veds._SlotGraph.captures

    def run(x, carry=None):
        return port_veds._veds_round(x, PRM, CH, enable_cot=False,
                                     carry=carry, graphed=True)

    for T in range(1, cap + 2):
        run(_first_slots(r, T))
    assert port_veds._SlotGraph.captures == n0 + cap + 1
    assert len(port_veds._SLOT_GRAPHS) == cap
    run(_first_slots(r, cap + 1))                  # newest: a replay
    assert port_veds._SlotGraph.captures == n0 + cap + 1
    run(_first_slots(r, 1))                        # evicted: captured anew
    assert port_veds._SlotGraph.captures == n0 + cap + 2
    assert len(port_veds._SLOT_GRAPHS) == cap

    qs, qu = _carry(3, seed=2)
    c64 = SchedulerCarry(qs=torch.from_numpy(qs).double(), qu=tt(qu))
    with pytest.raises(TypeError, match="float32"):
        run(_first_slots(r, cap + 1), c64)
    assert port_veds._SlotGraph.captures == n0 + cap + 2


def test_pinned_slot_graphs_outlive_eviction_until_unpinned(
        rounds3, replayed_step, monkeypatch):
    """Graphs used inside `pin_slot_graphs` are never evicted, however
    many other shapes are captured after them (the cap then applies to
    the unpinned ones); released by every holder, they are evictable
    again. (The cap is cut to 3 here: the round's 10 slots give 10
    shapes.)"""
    r = round_to_torch(rounds3)
    cap = 3
    monkeypatch.setattr(port_veds, "_MAX_SLOT_GRAPHS", cap)

    def run(T):
        port_veds._veds_round(_first_slots(r, T), PRM, CH, enable_cot=False,
                              carry=None, graphed=True)

    with port_veds.pin_slot_graphs() as a:
        run(1)
        run(2)
    with port_veds.pin_slot_graphs() as b:
        run(2)                                     # a second holder
    assert len(a) == 2 and len(b) == 1
    n0 = port_veds._SlotGraph.captures
    for T in range(3, cap + 5):
        run(T)
    assert len(port_veds._SLOT_GRAPHS) == cap + 2
    run(1)
    run(2)
    assert port_veds._SlotGraph.captures == n0 + cap + 2   # both replayed
    port_veds.unpin_slot_graphs(a)
    run(cap + 5)                           # T = 1 evicted, 2 still pinned
    assert port_veds._SlotGraph.captures == n0 + cap + 3
    assert len(port_veds._SLOT_GRAPHS) == cap + 1
    run(2)
    assert port_veds._SlotGraph.captures == n0 + cap + 3
    port_veds.unpin_slot_graphs(b)
    assert not port_veds._PINS
