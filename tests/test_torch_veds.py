"""The port's VEDS round (Algorithm 2, cold P4) against the reference.

Inputs are reference rounds from `make_round_batch(hetero_fleet=True)`,
exported to numpy and fed to both sides. The reference runs its kernel
path (`use_kernel=True`: the Pallas `veds_score` kernel in interpret
mode). Decisions (`success`, `n_success`, COT/DT slot counts) must be
identical; floats agree within fp32 tolerance: rtol 1e-4 on delivered
bits, energies and queues, which accumulate 10 slots of interior-point
results (the solver alone agrees to rtol 1e-4, see test_torch_solver).
"""
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
from repro.core.veds import veds_round as j_veds_round
from repro_torch.channel.v2x import ChannelParams
from repro_torch.core.baselines import VedsScheduler, get_scheduler
from repro_torch.core.lyapunov import VedsParams, sigmoid_weight
from repro_torch.core.scheduler import (SchedulerCarry, init_queues,
                                        masked_e_cp)
from repro_torch.core.veds import (NEG, RoundInputs, _dt_candidates,
                                   _select_slot, veds_round)
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
    s = get_scheduler("veds")
    assert isinstance(s, VedsScheduler) and s.name == "veds"
    for name in ("optimal", "v2i_only", "madca", "sa"):
        with pytest.raises(NotImplementedError, match="not ported"):
            get_scheduler(name)
    with pytest.raises(KeyError):
        get_scheduler("nope")


def test_warm_p4_is_not_ported(rounds3):
    """A warm budget with a carried P4 table raises; without a table the
    reference runs cold, and so does the port."""
    r = round_to_torch(rounds3)
    warm = VedsParams(ipm_warm_iters=5)
    table = SchedulerCarry(qs=torch.zeros(SC.n_sov),
                           qu=torch.zeros(SC.n_opv),
                           p4=torch.zeros(SC.n_sov, SC.n_opv, SC.n_opv + 1))
    with pytest.raises(NotImplementedError, match="warm"):
        veds_round(r, warm, CH, carry=table)
    cold, plain = veds_round(r, warm, CH), veds_round(r, PRM, CH)
    for k in DECISIONS + FLOATS:
        assert torch.equal(cold[k], plain[k])
