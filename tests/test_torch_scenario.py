"""The port's channel model, mobility and scenario against the reference.

The port draws from `torch.Generator`s, so its numbers differ from the
reference's `jax.random` draws. Each random function is therefore held in
two ways: its deterministic half, fed the reference's own draws
(regenerated here from the same keys), must match the reference's output;
and `make_round` as a whole must match the reference's statistics over
many rounds.

Tolerances: initial states and headings are exact; positions agree to
1e-4 m (an fp32 ulp at 1000 m is 6e-5 m); gains agree to rtol 1e-5
(10**(-dB/10) of a ~100 dB pathloss turns an ulp of dB into ~2e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.channel import mobility as jmob
from repro.channel import v2x as jv2x
from repro.core.lyapunov import VedsParams as JVeds
from repro.core.scenario import ScenarioParams as JScenario
from repro.core.scenario import compute_model as j_compute_model
from repro.core.scenario import make_round as j_make_round
from repro_torch.channel import mobility as mob
from repro_torch.channel import v2x
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scenario import (ScenarioParams, compute_model,
                                       make_round, round_generator)
from torch_port_util import tn, tt

CH = v2x.ChannelParams()


def test_channel_gain_deterministic_half_matches_reference():
    key = jax.random.key(11)
    d = np.random.default_rng(0).uniform(0, 700, (20, 7)).astype(np.float32)
    in_range = d < 450
    ref = jv2x.channel_gain(key, jnp.asarray(d), jv2x.ChannelParams(),
                            in_range=jnp.asarray(in_range))
    # the reference's draws, from its own keys (bernoulli(k, p) is
    # uniform(k) < p)
    k1, k2, k3, k4, k5 = jax.random.split(key, 5)
    draws = {"u_los": jax.random.uniform(k1, d.shape),
             "u_blocked": jax.random.uniform(k2, d.shape),
             "z_block": jax.random.normal(k3, d.shape),
             "z_shadow": jax.random.normal(k4, d.shape),
             "fading": jax.random.exponential(k5, d.shape)}
    ours = v2x.gain_from_draws(tt(d), CH, {k: tt(v) for k, v in
                                           draws.items()}, tt(in_range))
    np.testing.assert_allclose(tn(ours), np.asarray(ref), rtol=1e-5,
                               atol=0)
    assert ((tn(ours) > 0) == (np.asarray(ref) > 0)).all()


def test_channel_draws_shapes_and_ranges():
    gen = torch.Generator().manual_seed(0)
    dr = v2x.channel_draws(gen, (50, 3), "cpu")
    assert set(dr) == {"u_los", "u_blocked", "z_block", "z_shadow",
                       "fading"}
    assert all(v.shape == (50, 3) for v in dr.values())
    assert (dr["u_los"] >= 0).all() and (dr["u_los"] < 1).all()
    assert (dr["fading"] >= 0).all()
    g = v2x.channel_gain(gen, torch.full((4,), 100.0), CH,
                         in_range=torch.tensor([True, False, True, True]))
    assert g[1] == 0 and (g[[0, 2, 3]] > 0).all()


def test_rates_and_pathloss_match_reference():
    rng = np.random.default_rng(1)
    d = rng.uniform(0.5, 800, 64).astype(np.float32)
    los, blk = rng.random(64) < 0.5, rng.random(64) < 0.3
    bl = rng.uniform(0, 9, 64).astype(np.float32)
    p = rng.uniform(0, 0.3, 64).astype(np.float32)
    g = (10.0 ** rng.uniform(-13, -11, 64)).astype(np.float32)
    jch = jv2x.ChannelParams()
    pairs = [
        (v2x.pathloss_db(tt(d), CH, tt(los), tt(blk), tt(bl)),
         jv2x.pathloss_db(jnp.asarray(d), jch, jnp.asarray(los),
                          jnp.asarray(blk), jnp.asarray(bl))),
        (v2x.snr(tt(p), tt(g), CH), jv2x.snr(jnp.asarray(p),
                                             jnp.asarray(g), jch)),
        (v2x.rate_dt(tt(p), tt(g), CH), jv2x.rate_dt(jnp.asarray(p),
                                                     jnp.asarray(g), jch)),
        (v2x.rate_cot(tt(p[:8]), tt(g[:8]), tt(p.reshape(8, 8)),
                      tt(g.reshape(8, 8)), CH),
         jv2x.rate_cot(jnp.asarray(p[:8]), jnp.asarray(g[:8]),
                       jnp.asarray(p.reshape(8, 8)),
                       jnp.asarray(g.reshape(8, 8)), jch)),
    ]
    for ours, ref in pairs:
        np.testing.assert_allclose(tn(ours), np.asarray(ref), rtol=2e-6,
                                   atol=0)
    assert CH.noise_power == jch.noise_power


def _step_draws(key, n):
    """The reference's draws inside one `step_mobility(key, ...)`."""
    return {"u_turn": tt(jax.random.uniform(key, (n,))),
            "bit_h": tt(jax.random.randint(jax.random.fold_in(key, 1),
                                           (n,), 0, 2), torch.int64),
            "bit_v": tt(jax.random.randint(jax.random.fold_in(key, 2),
                                           (n,), 0, 2), torch.int64)}


def test_mobility_deterministic_halves_match_reference():
    """init and 40 steps at a high speed (many intersection crossings,
    turns and boundary bounces) fed the reference's draws."""
    jprm = jmob.ManhattanParams(v_max=30.0)
    prm = mob.ManhattanParams(v_max=30.0)
    n, key = 24, jax.random.key(3)
    jst = jmob.init_mobility(key, n, jprm)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    n_lines = int(jprm.extent // jprm.block) + 1
    st = mob.init_from_draws({
        "line": tt(jax.random.randint(k1, (n,), 0, n_lines), torch.int64),
        "offset": tt(jax.random.uniform(k2, (n,), minval=0.0,
                                        maxval=jprm.extent)),
        "horiz": tt(jax.random.uniform(k3, (n,)) < 0.5),
        "d_bit": tt(jax.random.randint(k4, (n,), 0, 2), torch.int64),
        "speed": tt(jax.random.uniform(
            jax.random.fold_in(key, 9), (n,), minval=0.3 * jprm.v_max,
            maxval=jprm.v_max))}, prm)
    for k in ("pos", "dir", "speed"):
        np.testing.assert_array_equal(tn(st[k]), np.asarray(jst[k]))
    turned = bounced = 0
    for k in jax.random.split(jax.random.key(5), 40):
        jnew = jmob.step_mobility(k, jst, jprm, 1.0)
        new = mob.step_from_draws(st, prm, 1.0, _step_draws(k, n))
        np.testing.assert_allclose(tn(new["pos"]), np.asarray(jnew["pos"]),
                                   rtol=1e-6, atol=1e-4)
        np.testing.assert_array_equal(tn(new["dir"]),
                                      np.asarray(jnew["dir"]))
        turned += int((tn(new["dir"]) // 2 != tn(st["dir"]) // 2).sum())
        bounced += int((tn(new["dir"]) // 2 == tn(st["dir"]) // 2).sum()
                       - (tn(new["dir"]) == tn(st["dir"])).sum())
        # continue from the reference's positions, so ulp-level drift
        # cannot compound over the steps
        jst = jnew
        st = {k_: v if k_ != "pos" else tt(jnew["pos"])
              for k_, v in new.items()}
    assert turned > 0 and bounced > 0


def test_step_and_rollout_shapes_and_bounds():
    gen = torch.Generator().manual_seed(2)
    prm = mob.ManhattanParams()
    st = mob.init_mobility(gen, 8, prm)
    one = mob.step_mobility(gen, st, prm, 0.1)
    assert one["pos"].shape == (8, 2) and torch.equal(one["speed"],
                                                      st["speed"])
    end, traj = mob.rollout_positions(gen, st, prm, 30, 0.1)
    assert traj.shape == (30, 8, 2)
    assert torch.equal(end["pos"], traj[-1])
    assert (traj >= 0).all() and (traj <= prm.extent).all()
    # every vehicle stays on a street: one coordinate on the grid
    on_grid = (torch.remainder(traj, prm.block) == 0).any(-1)
    assert on_grid.all()


def _round_stats(g_sr, g_so):
    """Coverage fraction and covered-gain log10 mean/spread, each with the
    standard error of its per-round mean (rounds are independent)."""
    cov = g_sr > 0
    per_round = cov.reshape(cov.shape[0], -1).mean(1)
    lg = np.where(cov, np.log10(np.where(cov, g_sr, 1.0)), np.nan)
    lg_round = np.nanmean(lg.reshape(lg.shape[0], -1), 1)
    ls = np.log10(g_so)
    se = lambda x: np.nanstd(x) / np.sqrt(np.sum(~np.isnan(x)))  # noqa
    return {"cov": (per_round.mean(), se(per_round)),
            "log_g_sr": (np.nanmean(lg_round), se(lg_round)),
            "log_g_sr_std": np.nanstd(lg),
            "log_g_so": (ls.mean(), se(ls.reshape(ls.shape[0], -1)
                                          .mean(1))),
            "log_g_so_std": ls.std()}


def test_make_round_statistics_match_reference():
    """200 independent rounds on each side (S=U=6, T=20). Means agree
    within 5 standard errors of their difference; spreads within 15%."""
    S, U, T, R = 6, 6, 20, 200
    jsc = JScenario(n_sov=S, n_opv=U, n_slots=T)
    ref = jax.jit(jax.vmap(lambda k: j_make_round(
        k, jsc, jmob.ManhattanParams(), jv2x.ChannelParams(), JVeds())))(
            jax.random.split(jax.random.key(0), R))
    sc = ScenarioParams(n_sov=S, n_opv=U, n_slots=T)
    ours = [make_round(round_generator(1, r, "cpu"), sc,
                       mob.ManhattanParams(), CH, VedsParams())
            for r in range(R)]
    a = _round_stats(np.asarray(ref.g_sr), np.asarray(ref.g_so))
    b = _round_stats(torch.stack([r.g_sr for r in ours]).numpy(),
                     torch.stack([r.g_so for r in ours]).numpy())
    for k in ("cov", "log_g_sr", "log_g_so"):
        (ma, sa), (mb, sb) = a[k], b[k]
        assert abs(ma - mb) < 5 * np.hypot(sa, sb), (k, a[k], b[k])
    for k in ("log_g_sr_std", "log_g_so_std"):
        assert abs(a[k] / b[k] - 1) < 0.15, (k, a[k], b[k])
    assert 0.2 < b["cov"][0] < 0.9
    # budgets and compute model are uniform draws in the same ranges
    for k in ("e_sov", "e_opv"):
        x = torch.stack([getattr(r, k) for r in ours]).numpy()
        assert (x >= sc.e_min).all() and (x <= sc.e_max).all()
    t_cp = torch.stack([r.t_cp for r in ours]).numpy()
    t0, _ = compute_model(sc)
    assert (t_cp >= t0 / 1.2 - 1e-6).all() and (t_cp <= t0 / 0.8 + 1e-6).all()


def test_compute_model_and_round_generator():
    assert compute_model(ScenarioParams()) == j_compute_model(JScenario())
    a = torch.rand(4, generator=round_generator(7, 3, "cpu"))
    b = torch.rand(4, generator=round_generator(7, 3, "cpu"))
    c = torch.rand(4, generator=round_generator(7, 4, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)


@pytest.mark.parametrize("S,U,T", [(3, 2, 5), (10, 10, 60)])
def test_make_round_layout(S, U, T):
    sc = ScenarioParams(n_sov=S, n_opv=U, n_slots=T)
    r = make_round(round_generator(0, 0, "cpu"), sc, mob.ManhattanParams(),
                   CH, VedsParams())
    assert r.g_sr.shape == (T, S) and r.g_or.shape == (T, U)
    assert r.g_so.shape == (T, S, U) and r.t_cp.shape == (S,)
    assert r.e_opv.shape == (U,) and r.valid_sov is None
    assert all(getattr(r, k).dtype == torch.float32
               for k in ("g_sr", "g_or", "g_so", "t_cp", "e_cp"))
    assert (r.g_so > 0).all()
