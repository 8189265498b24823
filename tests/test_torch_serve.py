"""The port's scheduling service (`repro_torch/launch/serve.py`) and the
per-cell round keys under it, against the reference's
`repro/launch/serve.py` and against its own contract.

Against the reference: the tier ladders and routing over a grid of
configs, `fleet_round` with [B] per-cell keys fed the reference's draws,
and `SchedulingService.run_batch` on the reference's `default_problem`
arrays and draws (`RefDrawService` feeds the port each session's fleet
draws and each request's round draws, selections and minibatch uniforms
as the reference consumed them), under `madca` and under `veds` with the
warm P4 table, at `tests/test_serve.py`'s small shapes.

Tolerances: masks and `n_success` identical; losses within rtol
`LOSS_RTOL`, each session's params within `PARAM_RTOL` of their largest
entry, queues within `QUEUE_TOL`, the P4 table within `TABLE_ATOL` W
(with the same entries moved off the seed), the other fleet fields equal
(positions within 1e-4 m), each well above the fp32 rounding these
shapes show. Each tolerance has a test showing that a plausible wrong
port fails it (`test_reference_tolerances_fail_on_a_wrong_port`).

The port's own contract mirrors `tests/test_serve.py`: packed equals
solo bit for bit, padding inert, warm P4 across requests, tier routing,
validation, the LRU store's bitwise spill and restore (bf16 leaves
included), each with a mutant that the check catches.
"""
import dataclasses
import zlib

import jax
import numpy as np
import pytest
import torch

import torch_ref_draws as RD
from repro.core import scenario as jscn
from repro.launch import serve as J
from repro_torch.channel.mobility import ManhattanParams
from repro_torch.channel.v2x import ChannelParams
from repro_torch.core import scenario as scn
from repro_torch.core.baselines import get_scheduler
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scheduler import RolloutCarry, map_tree, zip_tree
from repro_torch.core.solver import p4_seed_table
from repro_torch.core.streaming import (StreamConfig, _zero_carry,
                                        pack_cells, sched_round_step,
                                        unpack_cell)
from repro_torch.fl.engine import ClientShards, fused_rollout, init_carry
from repro_torch.launch import serve as P
from torch_port_util import tn, tt

L = 3
LOSS_RTOL = PARAM_RTOL = 1e-5
QUEUE_TOL = dict(rtol=1e-4, atol=1e-6)
TABLE_ATOL = 2e-5
MADCA = dict(max_rounds=L, scheduler="madca", ipm_iters=4, ipm_warm_iters=2)
VEDS = dict(max_rounds=2, scheduler="veds", n_sov=3, n_opv=2, n_slots=6,
            ipm_iters=4, ipm_warm_iters=2)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests loop over small tensor ops: one intra-op thread, so
    that parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _svc(B, **kw):
    kw.setdefault("max_rounds", L)
    return P.SchedulingService(P.ServeConfig(batch=B, **kw), device="cpu")


def _assert_same(a, b):
    """Two responses bit for bit equal (the serving contract)."""
    assert a.n_rounds == b.n_rounds
    np.testing.assert_array_equal(a.success, b.success)
    np.testing.assert_array_equal(a.n_success, b.n_success)
    np.testing.assert_array_equal(a.loss, b.loss)


def _assert_carry_equal(a, b):
    """Two trees of tensors equal leaf by leaf: dtype, shape and bits."""
    def eq(x, y):
        assert x.dtype == y.dtype and x.shape == y.shape, (x.dtype, y.dtype)
        assert torch.equal(x.cpu(), y.cpu())
    zip_tree(eq, a, b)


def _solo_replay(schedule, **cfg_kw):
    """Replay per-session request sequences on a fresh B=1 service: what
    every packed response must equal bit for bit."""
    svc = _svc(1, **cfg_kw)
    return svc, {s: [svc.run_batch([r])[0] for r in reqs]
                 for s, reqs in schedule.items()}


# ---- per-cell round keys -------------------------------------------------

SC = scn.ScenarioParams(n_sov=4, n_opv=3, n_slots=10)
MOB, CH, PRM = ManhattanParams(v_max=10.0), ChannelParams(), VedsParams()
KEYS = [11, 12, 13]
CPU_CELL_RTOL = 1e-5


def _assert_cells_are_solo(fleet, keys):
    """Cell b of a packed `fleet_round` with per-cell keys draws what the
    B=1 call with `keys[b]` draws, bit for bit, and gives its outputs:
    selections, masks and every integer and boolean field bit for bit,
    floats within rtol `CPU_CELL_RTOL`. On the CPU an element's last bits
    depend on where it falls in the batch: ATen's loops run a vectorized
    body and a scalar tail whose exp, log10 and pow part by an ulp, and
    one ulp of a ~100 dB path loss (7.6e-6 dB) is 1.75e-6 of the gain its
    power of ten gives. On the card each element is one thread's, and
    `tests/test_torch_cuda.py` holds the cells bit for bit."""
    N = fleet.n_vehicles
    draws = scn._fleet_round_draws_of(keys, SC, len(keys), N, "cpu")
    packed = scn.fleet_round(keys, fleet, SC, MOB, CH, PRM)
    for b, k in enumerate(keys):
        gen = torch.Generator().manual_seed(k)
        _assert_carry_equal(unpack_cell(draws, b),
                            scn.fleet_round_draws(gen, SC, 1, N, "cpu"))
        solo = scn.fleet_round(k, unpack_cell(fleet, b), SC, MOB, CH, PRM)
        for p, s in zip(packed, solo):
            zip_tree(_cell_close, unpack_cell(p, b), s)


def _cell_close(x, y):
    assert x.dtype == y.dtype and x.shape == y.shape
    if x.is_floating_point():
        torch.testing.assert_close(x, y, rtol=CPU_CELL_RTOL, atol=0)
    else:
        assert torch.equal(x, y)


def test_fleet_round_per_cell_keys_match_solo():
    fleet = scn.init_fleet(5, SC, MOB, 3, device="cpu")
    _assert_cells_are_solo(fleet, KEYS)
    with pytest.raises(ValueError, match="per-cell keys"):
        scn.fleet_round(KEYS[:2], fleet, SC, MOB, CH, PRM)


def test_fleet_round_per_cell_mutant_shared_generator_fails(monkeypatch):
    """A port drawing every cell from one shared generator (the first
    cell's key) fails the per-cell check."""
    fleet = scn.init_fleet(5, SC, MOB, 3, device="cpu")
    monkeypatch.setattr(scn, "_fleet_round_draws_of", lambda key, sc, B, N,
                        dev: scn._draws_of(key[0], scn.fleet_round_draws,
                                           dev, sc, B, N, dev))
    with pytest.raises(AssertionError):
        _assert_cells_are_solo(fleet, KEYS)


def test_fleet_round_per_cell_draws_match_reference():
    """Fed the reference's per-cell draws (cell b's `split(k_b, 1)[0]`),
    the port's packed round is the reference's `fleet_round` with [B]
    keys."""
    from repro.channel.mobility import ManhattanParams as JMob
    from repro.channel.v2x import ChannelParams as JCh
    from repro.core.lyapunov import VedsParams as JPrm
    jsc = jscn.ScenarioParams(n_sov=4, n_opv=3, n_slots=10)
    jmob = JMob(v_max=10.0)
    B = 3
    N = 2 * (SC.n_sov + SC.n_opv)
    fkey = jax.random.key(2)
    jf0 = jax.jit(lambda k: jscn.init_fleet(k, jsc, jmob, B))(fkey)
    f0 = scn.init_fleet(RD.init_fleet(fkey, jsc, jmob, B), SC, MOB, B)
    keys = jax.random.split(jax.random.key(3), B)
    jf, jr, js = jax.jit(lambda k, f: jscn.fleet_round(
        k, f, jsc, jmob, JCh(), JPrm()))(keys, jf0)
    f, r, s = scn.fleet_round([RD.fleet_round(k, jsc, 1, N) for k in keys],
                              f0, SC, MOB, CH, PRM)
    np.testing.assert_array_equal(tn(s.sov_idx), np.asarray(js.sov_idx))
    np.testing.assert_array_equal(tn(s.opv_idx), np.asarray(js.opv_idx))
    for name in ("valid_sov", "valid_opv"):
        np.testing.assert_array_equal(tn(getattr(r, name)),
                                      np.asarray(getattr(jr, name)))
    for name in ("g_sr", "g_or", "g_so", "t_cp", "e_cp", "e_sov", "e_opv"):
        np.testing.assert_allclose(tn(getattr(r, name)),
                                   np.asarray(getattr(jr, name)),
                                   rtol=1e-5, atol=0, err_msg=name)
    np.testing.assert_allclose(tn(f.pos), np.asarray(jf.pos), rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(tn(f.covered), np.asarray(jf.covered))


def test_per_cell_keys_rejected_in_fresh_fleet_mode_and_with_handoff():
    """Per-cell keys need the persistent fleet's per-cell draws, and
    neither per-cell keys nor per-cell active masks compose with the
    cross-cell exchange: the engine rejects them, it does not silently
    reinterpret them."""
    svc = _svc(2)
    fresh = dataclasses.replace(svc._stream, fresh_fleet=True)
    with pytest.raises(ValueError, match="per-cell keys"):
        sched_round_step(_zero_carry(svc.sc, 2, "cpu"), [1, 2],
                         get_scheduler("madca"), svc.sc, svc.mob, svc.ch,
                         svc.prm, fresh)
    cfg = dataclasses.replace(svc._stream, handoff=True)
    carry = init_carry(0, svc.sc, svc.mob, cfg, svc.params0, ch=svc.ch,
                       device="cpu")
    keys, sel, mb_u = P.request_draws(0, 2, 10, 4, 8, "cpu")
    sel2, mb2 = sel[:, None].repeat(1, 2, 1), mb_u[:, None].repeat(1, 2, 1, 1)
    args = (get_scheduler("madca"), svc.sc, svc.mob, svc.ch, svc.prm, cfg,
            svc.loss_fn, svc.shards, carry)
    with pytest.raises(ValueError, match="handoff"):
        fused_rollout(keys, sel2, mb2, *args, active=np.ones((2, 2), bool))
    with pytest.raises(ValueError, match="handoff"):
        fused_rollout([[k, k + 1] for k in keys], sel2, mb2, *args)


# ---- the ladder and routing against the reference ------------------------

@pytest.mark.parametrize("kw", [
    dict(batch=1), dict(batch=4), dict(batch=8, tiers=(2, 4, 8)),
    dict(batch=3, tiers=(1, L), batch_tiers=(1, 3)),
    dict(batch=6, tiers=(8, 2)), dict(batch=8, max_rounds=5),
    dict(batch=5, batch_tiers=(2, 5))])
def test_ladders_and_route_match_reference(kw):
    ours, ref = P.ServeConfig(**kw), J.ServeConfig(**kw)
    assert ours.horizons == ref.horizons
    assert ours.occupancies == ref.occupancies
    svc = P.SchedulingService(ours, device="cpu")
    jsvc = J.SchedulingService(ref)
    for n in range(1, ours.batch + 1):
        for R in ours.horizons + (1,):
            reqs = [P.ServeRequest(f"s{i}", R if i == 0 else 1)
                    for i in range(n)]
            jreqs = [J.ServeRequest(r.session, r.n_rounds) for r in reqs]
            assert svc.route(reqs) == jsvc.route(jreqs)


# ---- run_batch against the reference's SchedulingService ----------------

class RefDrawService(P.SchedulingService):
    """The port's service fed the reference's data and draws: the
    reference's `default_problem` arrays, each session's fleet from the
    reference's session key, and each request's round draws, selections
    and minibatch uniforms from the reference's `_padded_draws`.
    `mb_shift` rolls a request's minibatch draws by that many rounds (a
    wrong port, for the tolerance tests)."""

    def __init__(self, cfg, jsvc, mb_shift=0):
        self.jsvc, self.mb_shift = jsvc, mb_shift
        _, _, shards = J.default_problem(cfg.n_clients)
        data = {k: tt(v, torch.int64 if k == "y" else None)
                for k, v in shards.data.items()}
        super().__init__(
            cfg, params={"w": torch.zeros(8, 3)},
            loss_fn=P._linear_softmax_loss,
            client_data=ClientShards(data, tt(shards.n_samples)),
            device="cpu")
        self.N = cfg.n_fleet or 2 * (cfg.n_sov + cfg.n_opv)

    def _new_carry(self, session):
        k = jax.random.fold_in(jax.random.key(self.cfg.seed),
                               zlib.crc32(session.encode()))
        draws = RD.init_fleet(jax.random.fold_in(k, 0xF1EE7), self.jsvc.sc,
                              self.jsvc.mob, 1, self.cfg.n_fleet)
        return init_carry(draws, self.sc, self.mob,
                          dataclasses.replace(self._stream, batch=1),
                          self.params0, ch=self.ch, device="cpu")

    def _column(self, req, L):
        keys, sel, mb_u, act = J._padded_draws(
            int(req.n_rounds), L, self.shards.n_clients, self.cfg.n_sov,
            self.cfg.batch_size)(int(req.seed))
        mb_u = torch.roll(tt(mb_u), self.mb_shift, 0)
        return ([RD.fleet_round(k, self.jsvc.sc, 1, self.N) for k in keys],
                tt(sel, torch.int64), mb_u, np.asarray(act))


def _waves(kw, B):
    if kw["scheduler"] == "madca":
        return [[(f"s{i}", 1 + (i + w) % L, 10 * w + i) for i in range(B)]
                for w in range(2)]
    return [[(s, 2, i + 7 * w) for i, s in enumerate("xy")]
            for w in range(2)]


def _serve(svc, req_cls, waves):
    return [svc.run_batch([req_cls(*r) for r in w]) for w in waves]


PARITY = {"madca": (MADCA, 3), "veds": (VEDS, 2)}


@pytest.fixture(scope="module")
def reference_runs():
    """The reference's services after two waves of requests, per case."""
    out = {}
    for name, (kw, B) in PARITY.items():
        jsvc = J.SchedulingService(J.ServeConfig(batch=B, **kw))
        out[name] = (jsvc, _serve(jsvc, J.ServeRequest, _waves(kw, B)))
    return out


def _port_run(name, reference_runs, mb_shift=0, **cfg_kw):
    kw, B = PARITY[name]
    jsvc = reference_runs[name][0]
    svc = RefDrawService(P.ServeConfig(batch=B, **{**kw, **cfg_kw}), jsvc,
                         mb_shift)
    return svc, _serve(svc, P.ServeRequest, _waves(kw, B))


def _check_decisions(ref, ours):
    for rw, ow in zip(ref, ours):
        for r, o in zip(rw, ow):
            np.testing.assert_array_equal(o.success, r.success)
            np.testing.assert_array_equal(o.n_success, r.n_success)


def _check_loss(ref, ours):
    for rw, ow in zip(ref, ours):
        for r, o in zip(rw, ow):
            np.testing.assert_allclose(o.loss, r.loss, rtol=LOSS_RTOL,
                                       atol=0)


def _check_params(jsvc, svc):
    for s in jsvc.sessions:
        a = np.asarray(jsvc.sessions[s].params["w"])
        b = tn(svc.sessions[s].params["w"])
        assert np.max(np.abs(a - b)) <= PARAM_RTOL * np.max(np.abs(a)), s


def _check_queues(jsvc, svc):
    for s in jsvc.sessions:
        np.testing.assert_allclose(tn(svc.sessions[s].sched.queue),
                                   np.asarray(jsvc.sessions[s].sched.queue),
                                   **QUEUE_TOL, err_msg=s)


def _check_table(jsvc, svc):
    """The P4 table as ROADMAP queue 3 holds it: the same entries moved
    off the seed, each within TABLE_ATOL W of the reference's."""
    for s in jsvc.sessions:
        a = np.asarray(jsvc.sessions[s].sched.p4_tab)
        b = tn(svc.sessions[s].sched.p4_tab)
        seed = tn(p4_seed_table(b.shape, svc.ch.p_max, device="cpu"))
        np.testing.assert_array_equal(b != seed, a != seed, err_msg=s)
        np.testing.assert_allclose(b, a, rtol=0, atol=TABLE_ATOL,
                                   err_msg=s)


def _check_fleet(jsvc, svc):
    for s in jsvc.sessions:
        ref, ours = jsvc.sessions[s].sched, svc.sessions[s].sched
        for f in ("dir", "speed", "jitter", "allowance", "energy", "rsu_xy",
                  "covered", "cell_id"):
            np.testing.assert_array_equal(tn(getattr(ours, f)),
                                          np.asarray(getattr(ref, f)),
                                          err_msg=f)
        np.testing.assert_allclose(tn(ours.pos), np.asarray(ref.pos),
                                   rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", sorted(PARITY))
def test_run_batch_matches_reference(name, reference_runs):
    """Two waves of ragged requests (the second resuming every session)
    through the port's and the reference's services: decisions identical,
    floats within the stated tolerances, every stored carry compared."""
    jsvc, ref = reference_runs[name]
    svc, ours = _port_run(name, reference_runs)
    _check_decisions(ref, ours)
    _check_loss(ref, ours)
    _check_params(jsvc, svc)
    _check_queues(jsvc, svc)
    _check_table(jsvc, svc)
    _check_fleet(jsvc, svc)
    assert set(svc.sessions) == set(jsvc.sessions)
    assert [[o.tier for o in w] for w in ours] == \
        [[r.tier for r in w] for w in ref]
    if name == "veds":
        tab = tn(svc.sessions["x"].sched.p4_tab)
        assert not np.array_equal(tab, tn(p4_seed_table(
            tab.shape, svc.ch.p_max, device="cpu"))), "table never moved"


def _split_from_cell_0(state, n):
    return tuple(map_tree(torch.clone, unpack_cell(state, 0))
                 for _ in range(n))


@pytest.mark.parametrize("mutant,checks", [
    ("minibatch_off_by_one_round", (_check_loss, _check_params)),
    ("queues_not_carried", (_check_queues,)),
    ("warm_table_not_threaded", (_check_table,)),
    ("every_cell_split_from_cell_0", (_check_fleet,))])
def test_reference_tolerances_fail_on_a_wrong_port(mutant, checks,
                                                   reference_runs,
                                                   monkeypatch):
    """Each tolerance of `test_run_batch_matches_reference` fails for a
    plausible wrong port: minibatch draws one round off (loss and
    params), queues reset every round (queues), the warm P4 table not
    threaded (the table), every session stored from the batch's first
    cell (the fleet)."""
    name = ("madca" if mutant in ("queues_not_carried",
                                  "every_cell_split_from_cell_0")
            else "veds")
    kw = {"minibatch_off_by_one_round": dict(mb_shift=1),
          "queues_not_carried": dict(carry_queues=False),
          "warm_table_not_threaded": dict(ipm_warm_iters=0)}.get(mutant, {})
    if mutant == "every_cell_split_from_cell_0":
        monkeypatch.setattr(P, "_split_cells", _split_from_cell_0)
    jsvc, ref = reference_runs[name]
    svc, ours = _port_run(name, reference_runs, **kw)
    for check in checks:
        args = (ref, ours) if check is _check_loss else (jsvc, svc)
        with pytest.raises(AssertionError):
            check(*args)


# ---- the port's own serving contract -------------------------------------

@pytest.mark.parametrize("name", ["madca", "veds"])
def test_packed_ragged_requests_match_solo(name):
    """Ragged requests packed into [B] cells, and a second wave resuming
    every session's state, are bit for bit the solo B=1 runs."""
    kw, B = PARITY[name]
    svc = _svc(B, **kw)
    waves = [[P.ServeRequest(*r) for r in w] for w in _waves(kw, B)]
    packed = [svc.run_batch(w) for w in waves]
    _, solo = _solo_replay({r.session: [w[i] for w in waves]
                            for i, r in enumerate(waves[0])}, **kw)
    for w, resps in enumerate(packed):
        for r in resps:
            _assert_same(r, solo[r.session][w])


def test_packed_mutant_swapped_key_columns_fails(monkeypatch):
    """A port that hands two sessions each other's round keys fails the
    packed-equals-solo check."""
    orig = P._assemble

    def swapped(carries, cols, actives):
        carry, keys, sel, mb_u, active = orig(carries, cols, actives)
        return (carry, [[k[1], k[0]] + k[2:] for k in keys], sel, mb_u,
                active)

    monkeypatch.setattr(P, "_assemble", swapped)
    svc = _svc(3)
    reqs = [P.ServeRequest(f"s{i}", L, seed=i) for i in range(3)]
    packed = svc.run_batch(reqs)
    monkeypatch.setattr(P, "_assemble", orig)
    _, solo = _solo_replay({r.session: [r] for r in reqs})
    with pytest.raises(AssertionError):
        for r in packed:
            _assert_same(r, solo[r.session][0])


def test_padding_cells_never_perturb_real_cells():
    """A request served at occupancy 1 of B=3 (2 padding cells) is the
    same request at B=1, and the padding leaves nothing in the store."""
    svc = _svc(3)
    reqs = [P.ServeRequest("only", L, seed=5), P.ServeRequest("only", 2,
                                                              seed=6)]
    got = [svc.run_batch([r])[0] for r in reqs]
    _, solo = _solo_replay({"only": reqs})
    for g, s in zip(got, solo["only"]):
        _assert_same(g, s)
    assert set(svc.sessions) == {"only"}
    assert svc.metrics.summary()["pad_frac_cells"] == pytest.approx(2 / 3)


def test_repeat_session_rides_warm_p4():
    """VEDS with COT and a warm budget: a session's P4 table moves on its
    first request, unpacking and re-packing the sessions is the
    dispatch's packed fleet bit for bit, and the second requests are the
    solo B=1 warm runs bit for bit."""
    kw = dict(VEDS)
    svc = P.SchedulingService(P.ServeConfig(batch=2, **kw), device="cpu")
    tab0 = svc.session_carry("x").sched.p4_tab.clone()
    reqs = {s: [P.ServeRequest(s, 2, seed=i), P.ServeRequest(s, 2,
                                                             seed=i + 7)]
            for i, s in enumerate("xy")}
    captured = []
    orig = svc._seg[2]
    svc._seg[2] = lambda *a, **kw: captured.append(orig(*a, **kw)) \
        or captured[-1]
    p1 = svc.run_batch([reqs["x"][0], reqs["y"][0]])
    assert not torch.equal(svc.sessions["x"].sched.p4_tab, tab0)
    _assert_carry_equal(pack_cells([svc.sessions[s].sched for s in "xy"]),
                        captured[-1].fleet)
    p2 = svc.run_batch([reqs["x"][1], reqs["y"][1]])
    ref = P.SchedulingService(P.ServeConfig(batch=1, **kw), device="cpu")
    for i, s in enumerate("xy"):
        _assert_same(p1[i], ref.run_batch([reqs[s][0]])[0])
    for i, s in enumerate("xy"):
        _assert_same(p2[i], ref.run_batch([reqs[s][1]])[0])
    _assert_carry_equal(svc.sessions["x"], ref.sessions["x"])


def test_tiered_routing_picks_smallest_tier_and_stays_bitwise():
    """With a (1, L) horizon ladder and (1, 3) occupancy buckets each
    batch routes to the smallest rung that fits, every response (a
    session resuming across tiers included) is the single-tier solo
    replay bit for bit, and the padding shares are the reference's."""
    svc = _svc(3, tiers=(1, L), batch_tiers=(1, 3))
    r1 = P.ServeRequest("a", 1, seed=1)
    wave = [P.ServeRequest("a", L, seed=2), P.ServeRequest("b", 2, seed=3),
            P.ServeRequest("c", 1, seed=4)]
    p1, p2 = svc.run_batch([r1]), svc.run_batch(wave)
    assert dict(svc.metrics.tier_hits) == {"L1xB1": 1, f"L{L}xB3": 1}
    assert p1[0].tier == "L1xB1" and {r.tier for r in p2} == {f"L{L}xB3"}
    _, solo = _solo_replay({"a": [r1, wave[0]], "b": [wave[1]],
                            "c": [wave[2]]})
    _assert_same(p1[0], solo["a"][0])
    _assert_same(p2[0], solo["a"][1])
    _assert_same(p2[1], solo["b"][0])
    _assert_same(p2[2], solo["c"][0])
    s = svc.metrics.summary()
    assert s["pad_frac_rounds"] == pytest.approx(1 - 7 / 10)
    assert s["pad_frac_cells"] == 0.0 and s["n_captures"] == 0


def test_run_batch_stage_hook_sees_every_stage_of_every_round():
    svc = _svc(2)
    seen = []
    svc.run_batch([P.ServeRequest("a", 2, seed=1)], stage_hook=seen.append)
    assert seen == ["scenario", "schedule", "train", "eval"] * L


def _store_state(svc):
    """What warm-up must not touch: the LRU order of the device-resident
    and the spilled sessions, their carries, and the metrics."""
    st = svc.sessions
    return (list(st._hot), list(st._spilled),
            {s: map_tree(torch.clone, c)
             for s, c in list(st._hot.items()) + list(st._spilled.items())},
            dataclasses.asdict(svc.metrics))


@pytest.mark.parametrize("busy", [False, True])
def test_warmup_leaves_metrics_and_sessions_untouched(busy):
    """Warm-up stores nothing, also on a full store that holds a session
    named like the warm-up request: nothing spills, nothing moves in the
    LRU order, no carry changes and no metric counts."""
    svc = _svc(4, tiers=(1, L), max_sessions=2)
    if busy:
        for i, s in enumerate(("warmup", "a", "b")):
            svc.run_batch([P.ServeRequest(s, 1 + i % 2, seed=i)])
        assert svc.sessions.n_device == 2 and svc.metrics.n_spills == 1
    hot, spilled, carries, metrics = _store_state(svc)
    svc.warmup()
    hot2, spilled2, carries2, metrics2 = _store_state(svc)
    assert (hot2, spilled2, metrics2) == (hot, spilled, metrics)
    for s in carries:
        _assert_carry_equal(carries2[s], carries[s])
    assert len(svc.sessions) == 3 * busy and svc.warmup_captures == 0
    svc.close()


def test_run_batch_and_ladder_validation():
    svc = _svc(2)
    with pytest.raises(ValueError, match="cell slots"):
        svc.run_batch([P.ServeRequest(f"s{i}", 1) for i in range(3)])
    with pytest.raises(ValueError, match="duplicate sessions"):
        svc.run_batch([P.ServeRequest("s", 1), P.ServeRequest("s", 2)])
    for n in (L + 1, 0):
        with pytest.raises(ValueError, match="tier horizons"):
            svc.run_batch([P.ServeRequest("s", n)])
    with pytest.raises(ValueError, match="batch_tiers"):
        _svc(3, batch_tiers=(1, 2))
    with pytest.raises(ValueError, match="tiers"):
        _svc(3, tiers=(0, 3))
    with pytest.raises(ValueError, match="batch and max_rounds"):
        _svc(0)


# ---- the bounded session store -------------------------------------------

def _store_carry(v):
    return RolloutCarry(sched={"t": torch.full((2, 3), v)},
                        params={"w": torch.full((1, 4), 10.0 * v + 0.1,
                                                dtype=torch.bfloat16)},
                        opt_state={"n": torch.full((1,), int(v))})


def _exercise_store():
    """Three sessions through a store of two: returns what each restore
    gave beside what was put."""
    store = P.SessionStore(max_sessions=2, device="cpu")
    vals = {s: _store_carry(float(i)) for i, s in enumerate("abc")}
    for s in "abc":
        store.put(s, vals[s])
    assert (store.n_device, store.n_spilled, len(store)) == (2, 1, 3)
    assert list(store._hot) == ["b", "c"] and "a" in store
    got_a = store.get("a")                 # restore -> evicts b
    assert list(store._hot) == ["c", "a"] and "b" in store
    store.get("c")                          # refresh c -> LRU is now a
    store.put("d", _store_carry(3.0))
    assert list(store._hot) == ["c", "d"]
    return [(got_a, vals["a"]), (store["a"], vals["a"]),
            (store["b"], vals["b"])], store


def test_session_store_lru_spill_and_bitwise_restore():
    """The LRU carry past `max_sessions` spills to CPU tensors of its own
    dtype; a touch restores it bit for bit (bf16 leaves included) and
    re-evicts the new LRU."""
    pairs, store = _exercise_store()
    for got, want in pairs:
        _assert_carry_equal(got, want)
    assert store.pop("zzz", None) is None
    assert store.pop("d") is not None and "d" not in store
    assert set(store) == {"a", "b", "c"}
    with pytest.raises(ValueError, match="max_sessions"):
        P.SessionStore(max_sessions=0, device="cpu")


def test_session_store_mutant_fp32_spill_fails(monkeypatch):
    """A spill that goes through fp32 (numpy has no bf16) fails the
    bitwise restore."""
    monkeypatch.setattr(P, "_to_host", lambda x: x.detach().to(
        "cpu", torch.float32 if x.is_floating_point() else x.dtype))
    pairs, _ = _exercise_store()
    with pytest.raises(AssertionError):
        for got, want in pairs:
            _assert_carry_equal(got, want)


def test_evicted_session_resumes_bitwise_with_warm_p4():
    """Evict -> restore through real dispatches on VEDS with a live warm
    table: x's carry spills when y and z arrive, and x's next request,
    served from the restored carry, responds and stores bit for bit like
    a service that never evicted it."""
    reqs = {s: [P.ServeRequest(s, 2, seed=i), P.ServeRequest(s, 1,
                                                             seed=i + 7)]
            for i, s in enumerate("xyz")}
    svc = P.SchedulingService(P.ServeConfig(batch=1, max_sessions=1,
                                            **VEDS), device="cpu")
    ref = P.SchedulingService(P.ServeConfig(batch=1, **VEDS), device="cpu")
    for s in "xyz":
        svc.run_batch([reqs[s][0]])
        ref.run_batch([reqs[s][0]])
    assert svc.sessions.n_device == 1 and svc.sessions.n_spilled == 2
    _assert_carry_equal(svc.sessions._spilled["x"], ref.sessions["x"])
    _assert_same(svc.run_batch([reqs["x"][1]])[0],
                 ref.run_batch([reqs["x"][1]])[0])
    _assert_carry_equal(svc.sessions["x"], ref.sessions["x"])
    assert svc.metrics.n_spills >= 3 and svc.metrics.n_restores == 1
    assert ref.metrics.n_spills == 0 and ref.metrics.n_restores == 0


def test_request_draws_are_the_streaming_loops():
    """A request's draws are `run_fl(streaming=True)`'s for its seed:
    round keys, selections and minibatch uniforms, each from (seed,
    stream, round) alone, so a prefix of a longer request is the shorter
    one."""
    from repro_torch.fl.simulator import FLSimConfig, _stream_draws
    sim = FLSimConfig(n_clients=10, rounds=3, n_sov=4, batch_size=8)
    keys, _, sel, mb_u = _stream_draws(7, sim, "cpu")
    k2, s2, m2 = P.request_draws(7, 3, 10, 4, 8, "cpu")
    assert k2 == keys and torch.equal(s2, sel) and torch.equal(m2, mb_u)
    k1, s1, m1 = P.request_draws(7, 2, 10, 4, 8, "cpu")
    assert k1 == keys[:2] and torch.equal(s1, sel[:2])
    pk, ps, pm, act = P._padded_draws(7, 2, 4, 10, 4, 8,
                                      torch.device("cpu"))
    assert pk == k1 + [k1[-1]] * 2 and torch.equal(ps[2], s1[-1])
    assert torch.equal(pm[3], m1[-1])
    np.testing.assert_array_equal(act, [True, True, False, False])


@pytest.mark.parametrize("mutant, stage", [
    ("dt_scores", "the DT candidates"),
    ("p4_tab", "the COT candidates"),
    (None, None)])
def test_chip_smoke_first_parting_names_the_stage(monkeypatch, mutant,
                                                   stage):
    """`chip_smoke.py first_parting`, which the card runs only where a
    packed cell parts from its solo run, rehearsed on a forced difference
    in round 0's slot step on the packed side: its DT scores negated, or
    its carry's P4 table (which only the COT solves read) perturbed.
    Each is named. Unperturbed, packed equals solo (one cell at the
    B = 1 rung) and it finds nothing."""
    import itertools
    from pathlib import Path
    from repro_torch.core import streaming, veds
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    if mutant == "dt_scores":
        real_dt, calls = veds._dt_candidates, itertools.count()

        def wrong(*a, **k):
            # first_parting steps the packed cell, then the solo one: the
            # even calls are the packed side's
            y, p, z = real_dt(*a, **k)
            return (-y if next(calls) % 2 == 0 else y), p, z
        monkeypatch.setattr(veds, "_dt_candidates", wrong)
    elif mutant == "p4_tab":
        real_pack = streaming.pack_cells

        def wrong(states, *a, **k):
            st = real_pack(states, *a, **k)
            return dataclasses.replace(st, p4_tab=st.p4_tab + 0.5)
        monkeypatch.setattr(streaming, "pack_cells", wrong)
    cfg = P.ServeConfig(batch=2, batch_tiers=(1, 2), **VEDS)
    found = chip_smoke.first_parting(cfg, [P.ServeRequest("a", 2, seed=1)],
                                     [None], 0, "cpu")
    if mutant is None:
        assert found is None
    else:
        assert found[0] == 0 and "schedule: slot" in found[1] \
            and stage in found[1], found


def test_default_problem_shapes_and_loss():
    params, loss_fn, shards = P.default_problem(10, device="cpu")
    assert shards.n_clients == 10 and shards.n_max == 32
    np.testing.assert_array_equal(tn(shards.n_samples),
                                  [24 + 4 * (i % 3) for i in range(10)])
    b = {k: v[0, :24] for k, v in shards.data.items()}
    assert float(loss_fn(params, b)) == pytest.approx(np.log(3), rel=1e-6)
    again = P.default_problem(10, device="cpu")[2]
    assert torch.equal(again.data["x"], shards.data["x"])
