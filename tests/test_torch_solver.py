"""The port's P4 solver, Prop. 1 closed form and drift-plus-penalty math
against the reference, on the instance grids of `tests/test_solver.py`.

Tolerances: fp32 throughout. The Newton iteration amplifies ulp-level
differences between XLA's and PyTorch's `solve`/reductions a little, so
powers agree to 2e-5 W absolute (p_max is 0.3 W) and values to rtol 1e-4;
the closed forms and elementwise updates agree to rtol 2e-6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import lyapunov as jlyp
from repro.core.solver import (_phi_grad_hess as j_phi_grad_hess,
                               _project_feasible as j_project,
                               dt_power_opt as j_dt_power_opt,
                               solve_p4 as j_solve_p4)
from repro_torch.core import lyapunov as lyp
from repro_torch.core.solver import (_phi_grad_hess, _polish_count,
                                     _project_feasible, barrier_schedule,
                                     dt_power_opt, solve_p4)
from torch_port_util import tn, tt


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


def _batch(seed, n, k):
    rng = np.random.default_rng(seed)
    inst = [_rand_instance(rng, n) for _ in range(k)]
    a, q, d, pm = (np.stack([x[i] for x in inst]).astype(np.float32)
                   for i in range(4))
    cw = np.array([x[4] for x in inst], np.float32)
    return cw, a, q, d, pm


# ---- barrier schedule ----------------------------------------------------

@pytest.mark.parametrize("iters", [8, 12, 16, 25])
def test_barrier_schedule_pinned(iters):
    """The schedule is the float64 geometric sequence rounded once to
    fp32, element for element. XLA's fp32 `jnp.geomspace` is not
    correctly rounded, and its eager and in-`jit` (constant-folded)
    evaluations disagree with each other; the reference's solver runs
    with the in-`jit` values. Against both, the schedule agrees within 32
    ulp (22 measured at worst); see ROADMAP.md queue 3."""
    mus = np.array(barrier_schedule(iters, 1e-3), np.float32)
    np.testing.assert_array_equal(
        mus, np.geomspace(1e-1, 1e-3, iters).astype(np.float32))
    assert len(mus) == iters and mus[0] == np.float32(0.1) \
        and mus[-1] == np.float32(1e-3)
    assert (np.diff(mus) < 0).all()
    for ref in (jnp.geomspace(1e-1, 1e-3, iters),
                jax.jit(lambda: jnp.geomspace(1e-1, 1e-3, iters))()):
        ulp = np.abs(mus.view(np.int32) - np.asarray(ref).view(np.int32))
        assert ulp.max() <= 32, ulp


def test_polish_count_matches_reference():
    from repro.core.solver import _polish_count as j_polish_count
    for iters in (8, 12, 25):
        for n_it in range(1, iters + 1):
            assert _polish_count(n_it, iters) == j_polish_count(n_it, iters)


# ---- closed forms and building blocks -------------------------------------

def test_dt_power_opt_matches_reference():
    rng = np.random.default_rng(0)
    cw = (np.abs(rng.normal(1.0, 1.0, 256)) + 1e-3).astype(np.float32)
    q = (np.abs(rng.normal(0.1, 0.1, 256)) + 1e-3).astype(np.float32)
    gain = (10.0 ** rng.uniform(-13, -11, 256)).astype(np.float32)
    ours = tn(dt_power_opt(tt(cw), tt(q), tt(gain), 8e-14, 0.3))
    ref = np.asarray(j_dt_power_opt(jnp.asarray(cw), jnp.asarray(q),
                                    jnp.asarray(gain), 8e-14, 0.3))
    np.testing.assert_allclose(ours, ref, rtol=2e-6, atol=0)
    assert ((ours == 0) == (ref == 0)).all()


@pytest.mark.parametrize("n", [2, 5, 9])
def test_phi_grad_hess_and_projection_match_reference(n):
    cw, a, q, d, pm = _batch(10 + n, n, 6)
    rng = np.random.default_rng(n)
    p = (rng.uniform(0.01, 0.29, (6, n))).astype(np.float32)
    for margin in (0.999, 0.5):
        pm_ = tn(_project_feasible(tt(p), tt(d), tt(pm), margin=margin))
        for i in range(6):
            jp = np.asarray(j_project(jnp.asarray(p[i]), jnp.asarray(d[i]),
                                      jnp.asarray(pm[i]), margin=margin))
            np.testing.assert_allclose(pm_[i], jp, rtol=2e-6, atol=0)
    # the barrier terms at the cold start's margin-0.5 interior point
    # (at the 0.999 margin the slack -d.p cancels to a few ulp of its
    # terms, and both sides' rounding of it dominates)
    pp = pm_
    g, h = _phi_grad_hess(tt(pp), tt(a), tt(q), tt(cw), tt(d), tt(pm), 0.01)
    for i in range(6):
        jg, jh = j_phi_grad_hess(jnp.asarray(pp[i]), jnp.asarray(a[i]),
                                 jnp.asarray(q[i]), cw[i], jnp.asarray(d[i]),
                                 jnp.asarray(pm[i]), jnp.float32(0.01))
        scale = np.abs(np.asarray(jg)).max()
        np.testing.assert_allclose(tn(g[i]), np.asarray(jg), rtol=1e-5,
                                   atol=1e-6 * scale)
        hs = np.abs(np.asarray(jh)).max()
        np.testing.assert_allclose(tn(h[i]), np.asarray(jh), rtol=1e-5,
                                   atol=1e-6 * hs)


# ---- cold P4 ---------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 5, 8, 9])
def test_solve_p4_cold_matches_reference(n):
    """One batched port solve of 8 instances against the reference
    solve vmapped over them, as the reference's scheduler runs it."""
    cw, a, q, d, pm = _batch(100 + n, n, 8)
    p, v = solve_p4(tt(cw), tt(a), tt(q), tt(d), tt(pm))
    jp, jv = jax.jit(jax.vmap(j_solve_p4))(
        *(jnp.asarray(x) for x in (cw, a, q, d, pm)))
    np.testing.assert_allclose(tn(p), np.asarray(jp), rtol=0, atol=2e-5)
    np.testing.assert_allclose(tn(v), np.asarray(jv), rtol=1e-4, atol=1e-7)


def test_solve_p4_leading_dims_are_independent():
    """A [2, 4] batch gives what its rows give alone (the candidate grid
    of a slot is [B, S, U])."""
    cw, a, q, d, pm = _batch(7, 6, 8)
    p, v = solve_p4(*(tt(x).reshape((2, 4) + x.shape[1:])
                      for x in (cw, a, q, d, pm)))
    p1, v1 = solve_p4(tt(cw), tt(a), tt(q), tt(d), tt(pm))
    np.testing.assert_allclose(tn(p).reshape(8, 6), tn(p1), rtol=1e-6,
                               atol=1e-9)
    np.testing.assert_allclose(tn(v).reshape(8), tn(v1), rtol=1e-6,
                               atol=1e-9)


@settings(max_examples=20, deadline=None, database=None)
@given(st.integers(2, 9), st.integers(0, 10_000))
def test_solve_p4_always_feasible_property(n, seed):
    """Property: output satisfies box + decodability, never worse than
    not transmitting."""
    cw, a, q, d, pm = _batch(seed, n, 4)
    p, v = solve_p4(tt(cw), tt(a), tt(q), tt(d), tt(pm))
    p, v = tn(p), tn(v)
    assert (p >= -1e-6).all() and (p <= 0.3 + 1e-6).all()
    assert (np.einsum("bn,bn->b", d, p) <= 1e-5).all()
    assert (v >= -1e-6).all()


# ---- drift-plus-penalty (eqs. 16-20) ---------------------------------------

def test_lyapunov_matches_reference():
    rng = np.random.default_rng(3)
    prm, jprm = lyp.VedsParams(), jlyp.VedsParams()
    zeta = rng.uniform(0, 2e7, 64).astype(np.float32)
    z = rng.uniform(0, 5e6, 64).astype(np.float32)
    q, e_cm, e, e_cp = (rng.uniform(0, 0.2, 64).astype(np.float32)
                        for _ in range(4))
    pairs = [
        (lyp.sigmoid_shifted(tt(zeta), prm),
         jlyp.sigmoid_shifted(jnp.asarray(zeta), jprm)),
        (lyp.sigmoid_weight(tt(zeta), prm),
         jlyp.sigmoid_weight(jnp.asarray(zeta), jprm)),
        (lyp.update_zeta(tt(zeta), tt(z), prm),
         jlyp.update_zeta(jnp.asarray(zeta), jnp.asarray(z), jprm)),
        (lyp.update_queue_sov(tt(q), tt(e_cm), tt(e), tt(e_cp), 60.0),
         jlyp.update_queue_sov(jnp.asarray(q), jnp.asarray(e_cm),
                               jnp.asarray(e), jnp.asarray(e_cp),
                               jnp.float32(60.0))),
        (lyp.update_queue_opv(tt(q), tt(e_cm), tt(e), 60.0),
         jlyp.update_queue_opv(jnp.asarray(q), jnp.asarray(e_cm),
                               jnp.asarray(e), jnp.float32(60.0))),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(tn(ours), np.asarray(ref), rtol=2e-6,
                                   atol=1e-30)


@settings(max_examples=50, deadline=None, database=None)
@given(st.floats(0.0, 5e7, width=32), st.floats(0.0, 5e7, width=32))
def test_update_zeta_saturates_property(zeta, z):
    """Inputs are fp32-representable, so the property tests the update
    and not the rounding of its input (ROADMAP.md queue 3)."""
    prm = lyp.VedsParams()
    out = float(lyp.update_zeta(torch.tensor(zeta), torch.tensor(z), prm))
    assert out <= prm.Q
    assert out >= min(zeta, prm.Q)
