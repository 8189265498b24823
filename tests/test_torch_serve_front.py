"""The port's asyncio front end of the scheduling service
(`repro_torch/launch/serve.py`: `BatchServer`, `closed_loop_load`,
`poisson_load`, `drive`, `main`) against the reference's
`repro/launch/serve.py` and against its own contract.

Against the reference: the reference's `BatchServer` over its
`SchedulingService(ServeConfig())` and the port's over `RefDrawService`
(the port fed the reference's data and draws, `torch_ref_draws.py`) take
the same waves of requests, each wave submitted at once into a 0.25 s
window, so that how the batches form does not depend on timing. The
batches' occupancies, the tiers and the decisions must be the
reference's, the losses and every stored carry within the `check_*`
tolerances of `torch_ref_draws.py`, but for one queue entry, named in
`REFERENCE_PARTS`, which must part: there the reference's served step
parts from its own `madca` compiled alone, and the port follows the
latter (`test_reference_parts_from_its_own_scheduler_at_a_budget_edge`).
The load generators must send the
reference's requests (sessions, round counts, seeds) after the
reference's Poisson gaps, recorded through a stub server and a recorded
`asyncio.sleep`.

The port's own contract mirrors the front-end tests of
`tests/test_serve.py`: window packing and metrics, duplicate sessions
deferred to the next batch and served FIFO-first there, round bucketing
by horizon rung, a failed batch failing every future, `max_sessions`
under concurrent submits, and `main` in process. Every response of a
packed dispatch is held to the same request's solo B = 1 replay bit for
bit (masks, counts and losses), as `tests/test_torch_serve.py` holds
packed against solo on the CPU. Two wrong collectors (a deferred request
requeued at the tail, a window never split by rung) fail their checks.
"""
import asyncio
import json
import math
import sys

import jax
import numpy as np
import pytest
import torch

from repro.core.baselines import get_scheduler as j_get_scheduler
from repro.core.scenario import fleet_round as j_fleet_round
from repro.launch import serve as J
from repro_torch.launch import serve as P
from torch_port_util import tn
from torch_ref_draws import (QUEUE_TOL, RefDrawService, check_decisions,
                             check_fleet, check_loss, check_params,
                             check_queues, check_table)

L = 3
WINDOW_S = 0.25


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


def _serve(svc, coro_fn, server=P.BatchServer, **server_kw):
    async def go():
        async with server(svc, **server_kw) as srv:
            return await coro_fn(srv)
    return asyncio.run(go())


def _assert_same(a, b):
    """Two responses bit for bit equal (the serving contract)."""
    assert a.n_rounds == b.n_rounds
    np.testing.assert_array_equal(a.success, b.success)
    np.testing.assert_array_equal(a.n_success, b.n_success)
    np.testing.assert_array_equal(a.loss, b.loss)


def _solo_replay(schedule, **cfg_kw):
    """Replay per-session request sequences on a fresh B=1 service: what
    every packed response must equal bit for bit."""
    svc = _svc(1, **cfg_kw)
    return {s: [svc.run_batch([r])[0] for r in reqs]
            for s, reqs in schedule.items()}


def _gather(reqs):
    async def load(srv):
        return await asyncio.gather(*(srv.submit(r) for r in reqs))
    return load


# ---- the port's front-end contract ---------------------------------------

def test_batch_server_packs_within_window_and_records_metrics():
    """Five concurrent clients against B=3 under a wide window pack into
    two dispatches (occupancy 3 + 2); every response is the solo replay
    bit for bit, and the latency decomposition is sane."""
    svc = _svc(3)
    svc.warmup()
    reqs = [P.ServeRequest(f"c{i}", 1 + i % L, seed=i) for i in range(5)]
    got = _serve(svc, _gather(reqs), window_s=WINDOW_S)
    assert svc.metrics.occupancy == [3, 2]
    solo = _solo_replay({r.session: [r] for r in reqs})
    for r, g in zip(reqs, got):
        _assert_same(g, solo[r.session][0])
        assert g.total_s >= g.compute_s >= 0
        assert g.queue_wait_s >= 0
    s = svc.metrics.summary()
    assert s["n_requests"] == 5 and s["n_batches"] == 2
    assert s["mean_occupancy"] == pytest.approx(2.5)
    for k in ("p50_ms", "p99_ms", "rounds_per_s", "mean_queue_wait_ms",
              "mean_compute_ms", "p50_compute_ms", "p99_compute_ms",
              "p99_queue_wait_ms"):
        assert math.isfinite(s[k]) and s[k] > 0, (k, s)
    assert s["n_captures"] == 0


def test_batch_server_defers_duplicate_session_to_next_batch():
    """Two in-flight requests of one session never share a batch: the
    duplicate is deferred, and the pair chains as the solo sequential
    replay does."""
    svc = _svc(3)
    svc.warmup()
    r1 = P.ServeRequest("dup", L, seed=1)
    r2 = P.ServeRequest("dup", 2, seed=2)
    other = P.ServeRequest("other", 1, seed=3)
    g1, g2, go_ = _serve(svc, _gather([r1, r2, other]), window_s=WINDOW_S)
    assert svc.metrics.occupancy == [2, 1]        # dup deferred
    solo = _solo_replay({"dup": [r1, r2], "other": [other]})
    _assert_same(g1, solo["dup"][0])
    _assert_same(g2, solo["dup"][1])
    _assert_same(go_, solo["other"][0])


BUCKET_KW = dict(tiers=(1, L), batch_tiers=(1, 3))
BUCKET_REQS = [P.ServeRequest("a", 1, seed=1), P.ServeRequest("b", L, seed=2),
               P.ServeRequest("c", 1, seed=3)]


def _bucketed_run():
    svc = _svc(3, **BUCKET_KW)
    svc.warmup(rounds=(1, L))
    return svc, _serve(svc, _gather(BUCKET_REQS), window_s=WINDOW_S)


def _check_bucketed(svc, got):
    assert svc.metrics.occupancy == [2, 1]      # rung 1 first, then L
    assert [g.tier for g in got] == ["L1xB3", f"L{L}xB1", "L1xB3"]
    assert svc.metrics.summary()["pad_frac_rounds"] == 0.0


def test_batch_server_buckets_rounds_by_horizon_rung():
    """A window mixing 1-round and L-round requests on a (1, L) ladder
    splits by horizon rung before routing, shortest first, so the short
    requests pay no padded tail (pad_frac_rounds 0 for an exact fit);
    `bucket_rounds=False` routes the same window whole to the top rung
    and pays the reference's padding share. Every response is the solo
    replay bit for bit either way."""
    svc, got = _bucketed_run()
    _check_bucketed(svc, got)
    solo = _solo_replay({r.session: [r] for r in BUCKET_REQS})
    for r, g in zip(BUCKET_REQS, got):
        _assert_same(g, solo[r.session][0])

    flat = _svc(3, bucket_rounds=False, **BUCKET_KW)
    flat.warmup(rounds=(1, L))
    got_flat = _serve(flat, _gather(BUCKET_REQS), window_s=WINDOW_S)
    assert flat.metrics.occupancy == [3]        # one top-rung dispatch
    assert {g.tier for g in got_flat} == {f"L{L}xB3"}
    assert flat.metrics.summary()["pad_frac_rounds"] == \
        pytest.approx(1 - (1 + L + 1) / (3 * L))
    for r, g in zip(BUCKET_REQS, got_flat):
        _assert_same(g, solo[r.session][0])


def test_bucketing_mutant_whole_window_fails(monkeypatch):
    """A collector that never splits a window by rung fails the
    bucketing check."""
    monkeypatch.setattr(P.BatchServer, "_round_buckets",
                        lambda self, batch: [batch])
    with pytest.raises(AssertionError):
        _check_bucketed(*_bucketed_run())


def test_batch_server_failed_batch_fails_every_future():
    """A dispatch that raises fails every future of its batch, the
    collector goes on to serve the next request, and a load that meets
    the error raises it (no `return_exceptions`)."""
    svc = _svc(2)
    svc.warmup()
    real = svc.run_batch

    def boom(reqs):
        raise RuntimeError("scheduler down")

    async def load(srv):
        svc.run_batch = boom
        failed = await asyncio.gather(srv.submit(P.ServeRequest("a", 1)),
                                      srv.submit(P.ServeRequest("b", 1)),
                                      return_exceptions=True)
        svc.run_batch = real
        return failed, await srv.submit(P.ServeRequest("c", 1, seed=4))

    failed, ok = _serve(svc, load, window_s=0.1)
    assert len(failed) == 2
    assert all(isinstance(e, RuntimeError) for e in failed)
    assert svc.metrics.occupancy == [1]
    _assert_same(ok, _solo_replay({"c": [P.ServeRequest("c", 1,
                                                        seed=4)]})["c"][0])
    svc.run_batch = boom
    with pytest.raises(RuntimeError, match="scheduler down"):
        _serve(svc, lambda srv: P.closed_loop_load(
            srv, n_clients=2, n_requests=1, n_rounds=1), window_s=0.01)


def test_max_sessions_enforced_under_concurrent_submits():
    """Device-resident sessions stay bounded while many concurrent
    clients hammer the server, and every spilled session still answers
    as an unbounded solo service does when it comes back."""
    svc = _svc(3, max_sessions=2)
    svc.warmup()
    got = _serve(svc, lambda srv: P.closed_loop_load(
        srv, n_clients=6, n_requests=2, n_rounds=2, seed=3), window_s=0.01)
    assert len(got) == 12
    assert svc.sessions.n_device <= 2
    assert len(svc.sessions) == 6
    assert svc.metrics.n_spills >= 4
    solo = _solo_replay({
        s: [P.ServeRequest(s, 2, seed=3 + 1000 * c + i) for i in range(2)]
        for c, s in [(0, "client-0"), (5, "client-5")]})
    by_sess = {}
    for r in got:
        by_sess.setdefault(r.session, []).append(r)
    for s in ("client-0", "client-5"):
        for g, w in zip(by_sess[s], solo[s]):
            _assert_same(g, w)


class _TailRequeueServer(P.BatchServer):
    """A wrong collector: a deferred request goes back to the tail of the
    queue, behind the requests that arrived after it."""

    async def _run(self):
        loop = asyncio.get_running_loop()
        while True:
            item = await self._queue.get()
            if item is None:
                return
            batch, sessions, deferred = [item], {item[0].session}, []
            deadline = loop.time() + self.window_s
            while len(batch) < self.max_batch:
                timeout = deadline - loop.time()
                try:
                    nxt = (self._queue.get_nowait() if timeout <= 0 else
                           await asyncio.wait_for(self._queue.get(),
                                                  timeout))
                except (asyncio.QueueEmpty, asyncio.TimeoutError):
                    break
                if nxt is None:
                    self._queue.put_nowait(None)
                    break
                if nxt[0].session in sessions:
                    deferred.append(nxt)
                    continue
                sessions.add(nxt[0].session)
                batch.append(nxt)
            for it in deferred:
                self._queue.put_nowait(it)
            for group in self._round_buckets(batch):
                await self._dispatch(loop, group)


FIFO_A = [P.ServeRequest("A", 1, seed=1), P.ServeRequest("A", 1, seed=2)]
FIFO_OTHERS = [P.ServeRequest(f"o{i}", 1, seed=3 + i) for i in range(4)]


def _fifo_run(server):
    svc = _svc(3)
    svc.warmup()
    batches = []
    real = svc.run_batch
    svc.run_batch = lambda reqs: batches.append(
        [r.session for r in reqs]) or real(reqs)
    got = _serve(svc, _gather(FIFO_A + FIFO_OTHERS), server=server,
                 window_s=WINDOW_S, max_batch=2)
    return batches, got


def _check_fifo(batches):
    # batch 1 takes A#1 + o0 (A#2 deferred); the deferred A#2 leads
    # batch 2, ahead of o1..o3
    assert batches[0] == ["A", "o0"]
    assert batches[1][0] == "A"
    assert [len(b) for b in batches] == [2, 2, 2]


def test_deferred_request_is_served_fifo_first_next_batch():
    """A deferred duplicate-session request seeds the NEXT batch, ahead
    of newer arrivals, and every response is the solo replay."""
    batches, got = _fifo_run(P.BatchServer)
    _check_fifo(batches)
    solo = _solo_replay({"A": FIFO_A,
                         **{o.session: [o] for o in FIFO_OTHERS}})
    _assert_same(got[0], solo["A"][0])
    _assert_same(got[1], solo["A"][1])
    for o, g in zip(FIFO_OTHERS, got[2:]):
        _assert_same(g, solo[o.session][0])


def test_fifo_mutant_tail_requeue_fails():
    """The collector that requeues a deferred request at the tail serves
    o1 and o2 first: the FIFO check fails."""
    batches, _ = _fifo_run(_TailRequeueServer)
    assert batches[1] == ["o1", "o2"]
    with pytest.raises(AssertionError):
        _check_fifo(batches)


def test_batch_server_rejects_max_batch_outside_the_service():
    svc = _svc(2)
    for mb in (0, 3):
        with pytest.raises(ValueError, match="max_batch"):
            P.BatchServer(svc, max_batch=mb)


# ---- the load generators against the reference ---------------------------

class _StubServer:
    """Records each request and answers at once, never yielding to the
    event loop, so every client runs its requests through in turn."""

    def __init__(self, events):
        self.events = events

    async def submit(self, req):
        self.events.append(("submit", req.session, req.n_rounds, req.seed))
        return req


def _recorded(load, monkeypatch, **kw):
    events = []

    async def sleep(delay):
        events.append(("sleep", delay))

    monkeypatch.setattr(asyncio, "sleep", sleep)
    out = asyncio.run(load(_StubServer(events), **kw))
    monkeypatch.undo()
    return events, [(r.session, r.n_rounds, r.seed) for r in out]


@pytest.mark.parametrize("n_rounds", [3, (2, 4, 8, 2, 4)])
@pytest.mark.parametrize("kind", ["closed", "poisson"])
def test_loads_send_the_reference_requests(kind, n_rounds, monkeypatch):
    """The closed loop and the Poisson load send the reference's request
    sequence (sessions `client-c`, `_rounds_of`'s round counts, seeds
    `seed + 1000 c + i`), the Poisson load after the reference's gaps,
    each drawn from `default_rng(seed + c).exponential(n_clients /
    rate_hz)`."""
    kw = dict(n_clients=3, n_requests=4, n_rounds=n_rounds, seed=7)
    if kind == "poisson":
        kw["rate_hz"] = 5.0
    name = f"{'closed_loop' if kind == 'closed' else 'poisson'}_load"
    ours = _recorded(getattr(P, name), monkeypatch, **kw)
    ref = _recorded(getattr(J, name), monkeypatch, **kw)
    assert ours == ref
    events, sent = ours
    seq = [n_rounds] * 4 if isinstance(n_rounds, int) else n_rounds[:4]
    assert sent == [(f"client-{c}", seq[i], 7 + 1000 * c + i)
                    for c in range(3) for i in range(4)]
    gaps = [e[1] for e in events if e[0] == "sleep"]
    if kind == "closed":
        assert gaps == []
    else:
        want = [float(np.random.default_rng(7 + c).exponential(3 / 5.0, 4)[i])
                for c in range(3) for i in range(4)]
        np.testing.assert_allclose(gaps, want, rtol=1e-15)
    assert [P._rounds_of(n_rounds, i) for i in range(7)] == \
        [J._rounds_of(n_rounds, i) for i in range(7)]


# ---- the slice as a whole against the reference --------------------------

# ServeConfig(): B 4, L 4, madca. Wave 1 fills a batch of 4 and defers
# s0's second request, which seeds the next batch; wave 2 defers s1's.
# One stored queue entry parts, where the reference's served step parts
# from its own scheduler (`test_reference_parts_from_its_own_scheduler_
# at_a_budget_edge`): session s5's vehicle 7.
REFERENCE_PARTS = (("s5", 7),)
FRONT_WAVES = (
    (("s0", 4, 0), ("s0", 2, 1), ("s1", 1, 2), ("s2", 3, 3), ("s3", 4, 4),
     ("s4", 2, 5)),
    (("s1", 3, 10), ("s4", 1, 11), ("s5", 2, 12), ("s1", 2, 13)))
FRONT_OCCUPANCY = [4, 2, 3, 1]


def _front_run(mod, svc):
    async def go():
        async with mod.BatchServer(svc, window_s=WINDOW_S) as srv:
            return [await asyncio.gather(*(srv.submit(mod.ServeRequest(*r))
                                           for r in wave))
                    for wave in FRONT_WAVES]
    return asyncio.run(go())


@pytest.fixture(scope="module")
def reference_front():
    """The reference's front end over its `ServeConfig()` service."""
    jsvc = J.SchedulingService(J.ServeConfig())
    return jsvc, _front_run(J, jsvc)


def test_front_end_matches_reference(reference_front):
    """The same waves through the reference's and the port's
    `BatchServer`: the same batches (occupancies, tiers), decisions
    identical, losses and every stored carry within the shared
    tolerances."""
    jsvc, ref = reference_front
    svc = RefDrawService(P.ServeConfig(), jsvc)
    svc.warmup()
    ours = _front_run(P, svc)
    assert jsvc.metrics.occupancy == FRONT_OCCUPANCY
    assert svc.metrics.occupancy == jsvc.metrics.occupancy
    assert dict(svc.metrics.tier_hits) == dict(jsvc.metrics.tier_hits)
    assert [[o.tier for o in w] for w in ours] == \
        [[r.tier for r in w] for w in ref]
    assert [[o.session for o in w] for w in ours] == \
        [[r[0] for r in w] for w in FRONT_WAVES]
    check_decisions(ref, ours)
    check_loss(ref, ours)
    check_params(jsvc, svc)
    check_queues(jsvc, svc, parted=REFERENCE_PARTS)
    check_table(jsvc, svc)
    check_fleet(jsvc, svc)
    assert set(svc.sessions) == set(jsvc.sessions)


def test_reference_parts_from_its_own_scheduler_at_a_budget_edge():
    """The queue entry the whole-slice comparison lets part: session
    s5's first round under `ServeConfig()`. The reference's served step
    compiles the scenario and `madca` into one program, in which XLA
    recomputes e_cp inside e_sov - e_cp as a fused multiply-add, one ulp
    above the difference of the two rounded values. SOV 0's last partial
    slot (p = e_left / slot) then leaves 9.3e-10 J, SOV 0 takes one more
    slot at 9.3e-9 W, and SOV 1 (vehicle 7) moves one slot later, where
    its virtual queue ends 1/8 higher. The reference's `madca` compiled
    on that step's own round inputs leaves nothing, and neither does the
    port: the port's queue is that one's within `QUEUE_TOL`, and the
    served one parts from both."""
    jsvc = J.SchedulingService(J.ServeConfig(batch=1))
    fleet = jsvc.session_carry("s5").sched
    keys = J._padded_draws(1, 1, jsvc.shards.n_clients, jsvc.cfg.n_sov,
                           jsvc.cfg.batch_size)(12)[0]
    _, rnd, sel = jax.jit(lambda k, f: j_fleet_round(
        k, f, jsvc.sc, jsvc.mob, jsvc.ch, jsvc.prm))(keys[:1], fleet)
    alone = jax.jit(lambda r: j_get_scheduler("madca").solve_round(
        r, jsvc.prm, jsvc.ch, None))(rnd)
    slot = list(np.asarray(sel.sov_idx)[0]).index(7)
    want = np.asarray(alone.carry.qs)[0, slot]
    jsvc.run_batch([J.ServeRequest("s5", 1, 12)])
    svc = RefDrawService(P.ServeConfig(batch=1), jsvc)
    svc.run_batch([P.ServeRequest("s5", 1, 12)])
    np.testing.assert_allclose(tn(svc.sessions["s5"].sched.queue)[0, 7],
                               want, **QUEUE_TOL)
    served = np.asarray(jsvc.sessions["s5"].sched.queue)[0, 7]
    assert not np.allclose(served, want, **QUEUE_TOL)
    assert served / want == pytest.approx(8 / 7, rel=1e-4)


# ---- drive and main -------------------------------------------------------

DRIVE_CFG = P.ServeConfig(batch=2, tiers=(1, 2), n_slots=4)


def test_drive_runs_the_sequential_baseline():
    """`drive` on the CPU at a tiny size: the batched service packs, the
    sequential one dispatches every request alone (occupancy 1 at tier
    B 1), no slot graph is captured in either load, and the speedup is
    the ratio of their finite rounds/s."""
    out = P.drive(DRIVE_CFG, n_clients=3, n_requests=2, n_rounds=(1, 2),
                  device="cpu")
    b, s = out["batched"], out["sequential"]
    assert b["n_requests"] == s["n_requests"] == 6
    assert s["n_batches"] == 6 and s["mean_occupancy"] == 1.0
    assert all(k.endswith("xB1") for k in s["tier_hits"])
    assert b["mean_occupancy"] > 1.0
    assert b["n_captures"] == s["n_captures"] == 0
    assert math.isfinite(out["speedup"]) and out["speedup"] > 0
    assert out["speedup"] == b["rounds_per_s"] / s["rounds_per_s"]


def test_drive_poisson_without_baseline():
    out = P.drive(DRIVE_CFG, n_clients=2, n_requests=2, n_rounds=1,
                  rate_hz=200.0, baseline=False, device="cpu")
    assert set(out) == {"batched"}
    assert out["batched"]["n_requests"] == 4
    assert math.isfinite(out["batched"]["p99_ms"])


def test_serve_main_in_process(capsys):
    """The entry point takes explicit argv (sys.argv untouched) and its
    --json output carries finite metrics."""
    argv_before = list(sys.argv)
    rc = P.main(["--batch", "3", "--max-rounds", str(L), "--clients", "3",
                 "--requests", "1", "--window-ms", "1", "--device", "cpu",
                 "--json"])
    assert rc == 0
    assert sys.argv == argv_before
    out = json.loads(capsys.readouterr().out)
    assert out["batched"]["n_requests"] == 3
    assert math.isfinite(out["speedup"]) and out["speedup"] > 0
    for k in ("p50_ms", "p99_ms", "rounds_per_s", "mean_occupancy"):
        assert math.isfinite(out["batched"][k]), out


def test_serve_main_refuses_to_fall_back_to_the_cpu(monkeypatch, capsys):
    """Without --device the entry point runs on CUDA; where there is
    none it raises before serving anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        P.main(["--clients", "1", "--requests", "1", "--json"])
    assert capsys.readouterr().out == ""
