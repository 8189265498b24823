"""The port's fused engine (`fl/engine.py`), optimizers, client padding,
`run_fl(streaming=True)` and `make_train_step(stream=...)` against the
reference.

The problem is the linear `problem` fixture of
`tests/test_fused_engine.py` (8 ragged clients, 6 features, 3 classes)
with the reference's data, on the reference tests' sizes (S=4, U=3,
T=10). Parity runs feed the port the reference's draws: each round's
scenario draws (`torch_ref_draws.py`), the client permutation `sel` and
the minibatch uniforms `mb_u`.

Tolerances: masks, `n_success`, selections and rounds identical; losses
and parameters within rtol 1e-4 against the reference (fp32 on both
sides, reductions in other orders) and rtol 2e-5 between two paths of
the port; histories of the port's streaming modes agree to rtol 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_ref_draws as RD
from repro.channel.mobility import ManhattanParams as JManhattan
from repro.core import scenario as jscn
from repro.data.synthetic import pad_client_shards_np as j_pad_np
from repro.fl.engine import minibatch_indices as j_minibatch_indices
from repro.fl.simulator import FLSimConfig as JFLSimConfig
from repro.fl.simulator import _stream_draws as j_stream_draws
from repro.fl.simulator import run_fl as j_run_fl
from repro.optim import optimizers as jopt
from repro_torch.channel.mobility import ManhattanParams
from repro_torch.channel.v2x import ChannelParams
from repro_torch.core import scenario as scn
from repro_torch.core.baselines import get_scheduler
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.streaming import StreamConfig, round_keys
from repro_torch.data.synthetic import pad_client_shards, pad_client_shards_np
from repro_torch.fl import simulator
from repro_torch.fl.engine import (ClientShards, FusedResult, fedavg_apply,
                                   fused_rollout, fused_segment, init_carry,
                                   local_grads, minibatch_indices, replicate)
from repro_torch.fl.simulator import FLSimConfig, run_fl
from repro_torch.optim import optimizers as opt
from torch_port_util import tn, tt

MOB = ManhattanParams(v_max=10.0)
CH = ChannelParams()
PRM = VedsParams()
SC = scn.ScenarioParams(n_sov=4, n_opv=3, n_slots=10)
N_CLIENTS, DIM, CLASSES, BS = 8, 6, 3, 4
DECISIONS = ("success", "n_success", "n_cot_slots", "n_dt_slots")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests loop over small tensor ops: one intra-op thread, so
    that parallel test workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loss_fn(p, b):
    logp = torch.log_softmax(b["x"] @ p["w"], -1)
    return -torch.gather(logp, -1, b["y"][:, None]).mean()


@pytest.fixture(scope="module")
def problem():
    """The reference fixture's clients (ragged sizes 5, 8, 11), as numpy."""
    ks = jax.random.split(jax.random.key(1), N_CLIENTS + 1)
    protos = jax.random.normal(ks[-1], (CLASSES, DIM))
    data = []
    for i in range(N_CLIENTS):
        n = 5 + 3 * (i % 3)
        y = jax.random.randint(ks[i], (n,), 0, CLASSES)
        x = protos[y] + 0.5 * jax.random.normal(jax.random.fold_in(ks[i], 1),
                                                (n, DIM))
        data.append({"x": np.asarray(x), "y": np.asarray(y, np.int64)})
    xt = protos[jnp.arange(CLASSES).repeat(8)] + 0.5 * jax.random.normal(
        jax.random.key(9), (CLASSES * 8, DIM))
    yt = np.arange(CLASSES).repeat(8)
    return data, np.asarray(xt), yt


def _shards(data):
    return ClientShards.from_ragged(data, "cpu")


def _draws(R, B, seed=2):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.integers(0, N_CLIENTS, (R, B, SC.n_sov))),
            torch.as_tensor(rng.random((R, B, SC.n_sov, BS)),
                            dtype=torch.float32))


def _w0():
    return {"w": torch.zeros(DIM, CLASSES)}


# ---- layout, indices, optimizers ----------------------------------------

def test_pad_client_shards_layout(problem):
    data, _, _ = problem
    ragged = [{}] + data[1:]
    ours, n = pad_client_shards_np(ragged)
    ref, jn = j_pad_np(ragged)
    np.testing.assert_array_equal(n, jn)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k])
    td, tn_ = pad_client_shards(ragged, "cpu")
    assert td["x"].shape == (N_CLIENTS, 11, DIM) and int(tn_[0]) == 0
    shards = _shards(data)
    assert shards.n_clients == N_CLIENTS and shards.n_max == 11


def test_minibatch_indices_are_the_fp32_product_truncated():
    """Against the reference on uniforms that land on the boundaries
    (u * n one ulp either side of an integer), and for empty clients."""
    rng = np.random.default_rng(0)
    n = np.array([0, 1, 3, 5, 7, 11, 13, 1000], np.int32)
    u = rng.random((8, 64)).astype(np.float32)
    for i, ni in enumerate(n[1:], 1):
        k = np.arange(1, ni, dtype=np.float32)[:16]
        edge = (k / np.float32(ni)).astype(np.float32)
        u[i, :len(k)] = edge
        u[i, 16:16 + len(k)] = np.nextafter(edge, np.float32(0))
    u[:, -1] = np.nextafter(np.float32(1), np.float32(0))
    ours = minibatch_indices(tt(u), tt(n, torch.int32))
    ref = j_minibatch_indices(jnp.asarray(u), jnp.asarray(n))
    np.testing.assert_array_equal(tn(ours), np.asarray(ref))
    assert (tn(ours)[0] == 0).all()


@pytest.mark.parametrize("name", ["sgd", "momentum", "adam"])
def test_optimizers_match_reference(name):
    rng = np.random.default_rng(1)
    p = {"a": rng.normal(size=(3, 4)).astype(np.float32),
         "b": rng.normal(size=(5,)).astype(np.float32)}
    lr = opt.cosine_schedule(0.1, 10, warmup_steps=3, floor=0.01)
    jlr = jopt.cosine_schedule(0.1, 10, warmup_steps=3, floor=0.01)
    o, jo = getattr(opt, name)(lr), getattr(jopt, name)(jlr)
    tp = {k: tt(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    st, jst = o[0](tp), jo[0](jp)
    for step in range(6):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in p.items()}
        tp, st = o[1](tp, {k: tt(v) for k, v in g.items()}, st, step)
        jp, jst = jo[1](jp, {k: jnp.asarray(v) for k, v in g.items()}, jst,
                        step)
    for k in p:
        np.testing.assert_allclose(tn(tp[k]), np.asarray(jp[k]), rtol=1e-5,
                                   atol=1e-7)


def test_schedules_match_reference():
    for s in range(12):
        np.testing.assert_allclose(
            float(opt.linear_warmup(0.5, 4)(s)),
            float(jopt.linear_warmup(0.5, 4)(s)), rtol=1e-6)
        np.testing.assert_allclose(
            float(opt.cosine_schedule(0.5, 10, 3, 0.05)(s)),
            float(jopt.cosine_schedule(0.5, 10, 3, 0.05)(s)), rtol=1e-6)


# ---- fused_rollout -------------------------------------------------------

def _blocked(cfg, shards, sel, mb_u, lr, keys, name="veds"):
    """The blocked path in the port: per round, the cell batch of the same
    key, the scheduler, then per cell gather, local SGD, aggregation."""
    R, B = sel.shape[:2]
    ps = [_w0() for _ in range(B)]
    succ, losses = [], []
    for r in range(R):
        rnd = scn.make_round_batch(keys[r], SC, MOB, CH, PRM, B,
                                   hetero_fleet=False, device="cpu")
        out = get_scheduler(name).solve_round(rnd, PRM, CH)
        mask = out.success.to(torch.float32)
        loss_r = []
        for b in range(B):
            ls, grads, nf = local_grads(ps[b], _loss_fn, shards, sel[r, b],
                                        mb_u[r, b])
            ps[b], _ = fedavg_apply(ps[b], grads, mask[b], nf, lr=lr)
            w = mask[b] * nf
            loss_r.append(torch.sum(torch.where(w > 0, ls * w, 0.0))
                          / torch.clamp_min(w.sum(), 1e-9))
        succ.append(out.success)
        losses.append(torch.stack(loss_r))
    return (torch.stack([p["w"] for p in ps]), torch.stack(succ),
            torch.stack(losses))


# the fused-against-blocked matrix: every scheduler of the registry,
# spelled out (`tests/test_fused_engine.py:116-120`; the parameter is
# `sched`, as in `tests/test_torch_baselines.py`, which says why)
PARITY_SCHEDULERS = ("madca", "optimal", "sa", "v2i_only", "veds")


@pytest.mark.parametrize("sched,B", [(n, b) for n in PARITY_SCHEDULERS
                                     for b in (1, 3)])
def test_fused_matches_blocked(problem, sched, B):
    """The fused loop reproduces the blocked per-round path under each
    scheduler: masks identical, losses and params within rtol 2e-5."""
    shards = _shards(problem[0])
    R = 3
    cfg = StreamConfig(n_rounds=R, batch=B, fresh_fleet=True)
    sel, mb_u = _draws(R, B)
    keys = round_keys(8, cfg, R)
    res = fused_rollout(keys, sel, mb_u, get_scheduler(sched), SC, MOB, CH,
                        PRM, cfg, _loss_fn, shards,
                        init_carry(0, SC, MOB, cfg, _w0(), device="cpu"),
                        lr=0.1)
    assert isinstance(res, FusedResult) and res.fleet is None
    w, succ, loss = _blocked(cfg, shards, sel, mb_u, 0.1, keys, sched)
    assert torch.equal(res.outputs.success, succ)
    torch.testing.assert_close(res.loss, loss, rtol=2e-5, atol=1e-6)
    torch.testing.assert_close(res.params["w"], w, rtol=2e-5, atol=1e-6)
    if sched != "optimal":
        assert int(res.outputs.n_dt_slots.sum()) > 0
    # MADCA spends these budgets (Table I's 0.05-0.10 J) at full power in
    # a few slots and delivers no whole model, in the reference too
    if sched != "madca":
        assert int(res.outputs.n_success.sum()) > 0


def test_fused_rollout_matches_reference(problem):
    """The reference's fused rollout (fresh fleets, VEDS) against the
    port's on the reference's round draws, `sel` and `mb_u`."""
    from repro.core.baselines import get_scheduler as j_get
    from repro.core.streaming import StreamConfig as JCfg
    from repro.core.streaming import round_keys as j_round_keys
    from repro.fl.engine import ClientShards as JShards
    from repro.fl.engine import fused_rollout as j_fused
    from repro.fl.engine import init_carry as j_init_carry
    from repro.channel.v2x import ChannelParams as JCh
    from repro.core.lyapunov import VedsParams as JV
    data, _, _ = problem
    R, B = 3, 1
    jsc = jscn.ScenarioParams(n_sov=4, n_opv=3, n_slots=10)
    key = jax.random.key(0)
    jcfg = JCfg(n_rounds=R, batch=B, fresh_fleet=True)
    sel, mb_u = _draws(R, B)
    jdata = [{k: jnp.asarray(v) for k, v in d.items()} for d in data]

    def jloss(p, b):
        logp = jax.nn.log_softmax(b["x"] @ p["w"])
        return -jnp.mean(logp[jnp.arange(b["y"].shape[0]), b["y"]])

    ref = jax.jit(lambda c, k, s, u: j_fused(
        k, s, u, j_get("veds"), jsc, JManhattan(), JCh(), JV(), jcfg, jloss,
        JShards.from_ragged(jdata), c, lr=0.1))(
            j_init_carry(key, jsc, JManhattan(), jcfg,
                         {"w": jnp.zeros((DIM, CLASSES))}),
            j_round_keys(key, jcfg, R), jnp.asarray(tn(sel), jnp.int32),
            jnp.asarray(tn(mb_u)))
    keys = [RD.round_batch(jax.random.fold_in(key, r), jsc, JManhattan(), B)
            for r in range(R)]
    cfg = StreamConfig(n_rounds=R, batch=B, fresh_fleet=True)
    res = fused_rollout(keys, sel, mb_u, get_scheduler("veds"), SC, MOB, CH,
                        PRM, cfg, _loss_fn, _shards(data),
                        init_carry(0, SC, MOB, cfg, _w0(), device="cpu"),
                        lr=0.1)
    for k in DECISIONS:
        np.testing.assert_array_equal(tn(res.outputs[k]),
                                      np.asarray(ref.outputs[k]), err_msg=k)
    np.testing.assert_allclose(tn(res.loss), np.asarray(ref.loss),
                               rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tn(res.params["w"]),
                               np.asarray(ref.params["w"]), rtol=1e-4,
                               atol=1e-6)


def test_padded_zero_sample_client_never_moves_model(problem):
    """A client with 0 samples has weight 0: even NaN poison in its padded
    rows cannot reach the global model."""
    data, _, _ = problem
    ragged = [d if i != 2 else {"x": np.zeros((0, DIM), np.float32),
                                "y": np.zeros((0,), np.int64)}
              for i, d in enumerate(data)]
    clean = _shards(ragged)
    assert int(clean.n_samples[2]) == 0
    poisoned = ClientShards(data=dict(clean.data, x=clean.data["x"].clone()),
                            n_samples=clean.n_samples)
    poisoned.data["x"][2] = float("nan")
    R, B = 2, 1
    cfg = StreamConfig(n_rounds=R, batch=B, fresh_fleet=True)
    sel, mb_u = _draws(R, B)
    sel = torch.clamp_min(sel, 3)
    sel[:, :, 0] = 2                 # the empty client in slot 0 each round
    outs = {tag: fused_rollout(
        round_keys(1, cfg, R), sel, mb_u, get_scheduler("veds"), SC, MOB,
        CH, PRM, cfg, _loss_fn, s,
        init_carry(0, SC, MOB, cfg, _w0(), device="cpu"), lr=0.1)
        for tag, s in (("clean", clean), ("poisoned", poisoned))}
    w = outs["poisoned"].params["w"]
    assert torch.isfinite(w).all()
    assert torch.equal(w, outs["clean"].params["w"])
    assert torch.isfinite(outs["poisoned"].loss).all()
    assert int(outs["clean"].outputs.success[:, :, 0].sum()) > 0


def test_all_empty_selection_keeps_params(problem):
    data, _, _ = problem
    ragged = list(data)
    ragged[0] = {"x": np.zeros((0, DIM), np.float32),
                 "y": np.zeros((0,), np.int64)}
    cfg = StreamConfig(n_rounds=1, batch=1, fresh_fleet=True)
    sel = torch.zeros((1, 1, SC.n_sov), dtype=torch.int64)
    _, mb_u = _draws(1, 1)
    w0 = {"w": torch.full((DIM, CLASSES), 0.25)}
    res = fused_rollout(round_keys(2, cfg, 1), sel, mb_u,
                        get_scheduler("veds"), SC, MOB, CH, PRM, cfg,
                        _loss_fn, _shards(ragged),
                        init_carry(0, SC, MOB, cfg, w0, device="cpu"),
                        lr=0.1)
    assert torch.equal(res.params["w"][0], w0["w"])


def test_optimizer_state_threads_through_carry(problem):
    """Momentum rides the carry: the fused run equals the same rounds
    applied one by one."""
    shards = _shards(problem[0])
    R, B = 3, 1
    mom = opt.momentum(0.05)
    cfg = StreamConfig(n_rounds=R, batch=B, fresh_fleet=True)
    sel, mb_u = _draws(R, B)
    keys = round_keys(3, cfg, R)
    res = fused_rollout(keys, sel, mb_u, get_scheduler("veds"), SC, MOB, CH,
                        PRM, cfg, _loss_fn, shards,
                        init_carry(0, SC, MOB, cfg, _w0(), opt=mom,
                                   device="cpu"), opt=mom)
    assert res.opt_state is not None
    p, os_ = _w0(), mom[0](_w0())
    for r in range(R):
        rnd = scn.make_round_batch(keys[r], SC, MOB, CH, PRM, B,
                                   hetero_fleet=False, device="cpu")
        mask = get_scheduler("veds").solve_round(rnd, PRM, CH).success[0]
        _, grads, nf = local_grads(p, _loss_fn, shards, sel[r, 0],
                                   mb_u[r, 0])
        p, os_ = fedavg_apply(p, grads, mask.float(), nf, lr=0.0, opt=mom,
                              opt_state=os_, step=r)
    torch.testing.assert_close(res.params["w"][0], p["w"], rtol=2e-5,
                               atol=1e-6)


def test_inactive_rounds_history_chunk_and_state_dtype(problem):
    """Inactive tail rounds pass the carry through bit for bit; chunked
    history and bf16 storage of the P4 table and momentum change
    nothing on rounds that count (bf16: masks identical)."""
    shards = _shards(problem[0])
    R = 4
    cfg = StreamConfig(n_rounds=R, batch=1, carry_queues=True)
    sel, mb_u = _draws(R, 1)
    keys = round_keys(4, cfg, R)
    prm = VedsParams(ipm_warm_iters=5)
    mom = opt.momentum(0.05)

    def run(active=None, **kw):
        return fused_rollout(
            keys, sel, mb_u, get_scheduler("veds"), SC, MOB, CH, prm, cfg,
            _loss_fn, shards, init_carry(5, SC, MOB, cfg, _w0(), opt=mom,
                                         device="cpu"),
            opt=mom, active=active, **kw)

    full = run()
    short = dataclasses.replace(cfg, n_rounds=2)
    head = fused_rollout(keys[:2], sel[:2], mb_u[:2], get_scheduler("veds"),
                         SC, MOB, CH, prm, short, _loss_fn, shards,
                         init_carry(5, SC, MOB, cfg, _w0(), opt=mom,
                                    device="cpu"), opt=mom)
    padded = run(active=np.arange(R) < 2)
    assert torch.equal(padded.params["w"], head.params["w"])
    assert torch.equal(padded.fleet.queue, head.fleet.queue)
    assert torch.equal(padded.fleet.p4_tab, head.fleet.p4_tab)
    assert torch.equal(padded.carry.qs, head.outputs.carry.qs[1])
    chunked = run(history_chunk=2)
    assert torch.equal(chunked.params["w"], full.params["w"])
    assert torch.equal(chunked.outputs.zeta, full.outputs.zeta)
    assert torch.equal(chunked.loss, full.loss)
    low = run(state_dtype=torch.bfloat16)
    assert low.fleet.p4_tab.dtype == torch.float32
    assert torch.equal(low.outputs.success, full.outputs.success)
    with pytest.raises(ValueError, match="history_chunk"):
        fused_rollout(keys[:3], sel[:3], mb_u[:3], get_scheduler("veds"),
                      SC, MOB, CH, prm, cfg, _loss_fn, shards,
                      init_carry(5, SC, MOB, cfg, _w0(), device="cpu"),
                      history_chunk=2)


def test_per_cell_active_mask_passes_inactive_cells_through(problem):
    shards = _shards(problem[0])
    R, B = 2, 2
    cfg = StreamConfig(n_rounds=R, batch=B, carry_queues=True)
    sel, mb_u = _draws(R, B)
    carry = init_carry(6, SC, MOB, cfg, _w0(), device="cpu")
    act = np.array([[True, False], [True, False]])
    res = fused_rollout(round_keys(6, cfg, R), sel, mb_u,
                        get_scheduler("veds"), SC, MOB, CH, PRM, cfg,
                        _loss_fn, shards, carry, active=act,
                        eval_fn=lambda p: p["w"].sum(),
                        eval_mask=np.ones(R, bool))
    assert torch.equal(res.params["w"][1], carry.params["w"][1])
    assert torch.equal(res.fleet.pos[1], carry.sched.pos[1])
    assert not torch.equal(res.fleet.pos[0], carry.sched.pos[0])
    assert torch.isnan(res.metric[:, 1]).all()
    assert torch.isfinite(res.metric[:, 0]).all()
    with pytest.raises(ValueError, match="handoff"):
        fused_rollout(round_keys(6, cfg, R), sel, mb_u,
                      get_scheduler("veds"), SC, MOB, CH, PRM,
                      dataclasses.replace(cfg, handoff=True), _loss_fn,
                      shards, carry, active=act)


def test_replicate_and_segment(problem):
    """`replicate` adds the [B] cell axis; a segment of `fused_segment` is
    `fused_rollout` at its settings, bit for bit."""
    rep = replicate({"w": torch.ones(2, 3)}, 4)
    assert rep["w"].shape == (4, 2, 3)
    shards = _shards(problem[0])
    R = 2
    cfg = StreamConfig(n_rounds=0, batch=1, carry_queues=True)
    sel, mb_u = _draws(R, 1)
    keys = round_keys(8, cfg, R)
    act, ev = np.ones(R, bool), np.zeros(R, bool)
    carry = init_carry(8, SC, MOB, cfg, _w0(), device="cpu")
    seg = fused_segment(_loss_fn, "veds", SC, MOB, CH, PRM, cfg, 0.1, 1)
    a = seg(carry, keys, sel, mb_u, shards, range(R), act, ev)
    b = fused_rollout(keys, sel, mb_u, get_scheduler("veds"), SC, MOB, CH,
                      PRM, cfg, _loss_fn, shards, carry, lr=0.1,
                      steps=range(R), active=act, eval_mask=ev)
    assert torch.equal(a.params["w"], b.params["w"])
    assert torch.equal(a.outputs.success, b.outputs.success)
    assert torch.equal(a.fleet.queue, b.fleet.queue)


# ---- run_fl(streaming=True) ---------------------------------------------

def _sim(**kw):
    return dict(dict(n_clients=N_CLIENTS, rounds=6, n_slots=10, n_sov=4,
                     n_opv=3, batch_size=BS, streaming=True), **kw)


def _eval(problem):
    _, xt, yt = problem
    x, y = tt(xt), torch.as_tensor(yt)
    return lambda p: ((x @ p["w"]).argmax(-1) == y).float().mean()


def _go(problem, **kw):
    return run_fl(7, _w0(), _loss_fn, problem[0], FLSimConfig(**_sim(**kw)),
                  eval_fn=_eval(problem), eval_every=2, device="cpu")


def test_streaming_modes_agree(problem):
    """Fused with eval in the loop (one segment), segmented, chunked,
    host-gather and prepadded shards: the same history (4 rounds)."""
    hf = _go(problem, rounds=4)
    hs = _go(problem, rounds=4, eval_in_scan=False)
    hc = _go(problem, rounds=4, eval_in_scan=False, fused_history_chunk=4)
    hg = _go(problem, rounds=4, fused=False)
    hp = run_fl(7, _w0(), _loss_fn, _shards(problem[0]),
                FLSimConfig(**_sim(rounds=4)), eval_fn=_eval(problem),
                eval_every=2, device="cpu")
    assert hf["round"] == [0, 2, 3] and hf["dispatches"] == 1
    assert hs["dispatches"] == len(hs["round"]) == 3
    assert hc == hs and hp == hf
    for h in (hs, hg):
        assert h["round"] == hf["round"]
        assert h["n_success"] == hf["n_success"]
        assert h["time"] == hf["time"]
        np.testing.assert_allclose(h["metric"], hf["metric"], rtol=1e-5)
    assert hf["scheduled_rounds"] == hg["scheduled_rounds"] == 4
    assert _go(problem, rounds=4, round_batch=4) == hf


@pytest.mark.parametrize("sched", ["madca", "optimal", "sa", "v2i_only"])
def test_streaming_modes_agree_for_every_scheduler(problem, sched):
    """Each baseline through `run_fl(streaming=True)`, fused (eval in the
    loop), segmented (`eval_in_scan=False`) and host-gather
    (`fused=False`): the same history; and through the blocked path with
    `round_batch` 1 and 2: the same history for both. Three rounds."""
    hf = _go(problem, rounds=3, scheduler=sched, ipm_warm_iters=4)
    hs = _go(problem, rounds=3, scheduler=sched, eval_in_scan=False)
    hg = _go(problem, rounds=3, scheduler=sched, fused=False)
    assert hf["round"] == [0, 2] and hf["dispatches"] == 1
    for h in (hs, hg):
        assert h["round"] == hf["round"] and h["time"] == hf["time"]
        assert h["n_success"] == hf["n_success"]
        np.testing.assert_allclose(h["metric"], hf["metric"], rtol=1e-5)
    hb = [_go(problem, rounds=3, scheduler=sched, streaming=False,
              round_batch=rb) for rb in (1, 2)]
    assert hb[0]["n_success"] == hb[1]["n_success"]
    assert hb[0]["scheduled_rounds"] == hb[1]["scheduled_rounds"] == 3
    np.testing.assert_allclose(hb[1]["metric"], hb[0]["metric"], rtol=1e-5)
    if sched == "optimal":      # whole fleets: every SOV in coverage
        assert all(n > 0 for n in hf["n_success"] + hb[0]["n_success"])


@pytest.fixture(scope="module")
def reference_streams(problem):
    """The reference's fused `run_fl(streaming=True)` of key(7), cold and
    warm (ipm_warm_iters 5), with the draws it consumed."""
    data, xt, yt = problem
    x, y = jnp.asarray(xt), jnp.asarray(yt)
    eval_fn = jax.jit(lambda p: jnp.mean((x @ p["w"]).argmax(-1) == y))

    def jloss(p, b):
        logp = jax.nn.log_softmax(b["x"] @ p["w"])
        return -jnp.mean(logp[jnp.arange(b["y"].shape[0]), b["y"]])

    jdata = [{k: jnp.asarray(v) for k, v in d.items()} for d in data]
    out = {}
    for warm in (0, 5):
        jsim = JFLSimConfig(**_sim(ipm_warm_iters=warm))
        hist = j_run_fl(jax.random.key(7), {"w": jnp.zeros((DIM, CLASSES))},
                        jloss, jdata, jsim, eval_fn=eval_fn, eval_every=2)
        k_sched, sel, mb_u = j_stream_draws(jax.random.key(7), jsim)
        jsc = jscn.ScenarioParams(n_sov=4, n_opv=3, n_slots=10,
                                  batch_size=BS)
        fd, rds = RD.stream_persistent(k_sched, jsc, JManhattan(), 1,
                                       jsim.rounds)
        out[warm] = (hist, (rds, fd, tt(sel, torch.int64), tt(mb_u)))
    return out


@pytest.mark.parametrize("warm", [0, 5])
@pytest.mark.parametrize("mode", [{}, {"eval_in_scan": False},
                                  {"fused": False}])
def test_run_fl_streaming_matches_reference(problem, reference_streams,
                                            monkeypatch, warm, mode):
    """`run_fl(streaming=True)` in each mode on the reference's draws:
    rounds, times and `n_success` identical, the metric (accuracy) to
    rtol 1e-4."""
    ref, draws = reference_streams[warm]
    monkeypatch.setattr(simulator, "_stream_draws",
                        lambda seed, sim, device: draws)
    ours = _go(problem, ipm_warm_iters=warm, **mode)
    for k in ("round", "time", "n_success", "scheduled_rounds"):
        assert ours[k] == ref[k], k
    np.testing.assert_allclose(ours["metric"], ref["metric"], rtol=1e-4)
    assert sum(ours["n_success"]) > 0


def test_empty_dict_first_client_keeps_schema(problem):
    ragged = [{}] + list(problem[0][1:])
    for streaming in (False, True):
        h = run_fl(7, _w0(), _loss_fn, ragged,
                   FLSimConfig(**dict(_sim(), rounds=2,
                                      streaming=streaming)), device="cpu")
        assert h["scheduled_rounds"] == 2


# ---- make_train_step(stream=...) ----------------------------------------

def test_make_train_step_streaming_whole_run_matches_reference(monkeypatch):
    """The whole-run step at qwen3's smoke config (fp32, V=1, the
    reference test's degenerate mesh): the
    reference's fresh-fleet schedule of key(3) on its draws, then two
    VFL rounds: masks and `n_success` identical, parameters within 2e-4
    (the VFL tests' tolerance); and the two build-time refusals."""
    from jax.sharding import Mesh
    from repro.channel.v2x import ChannelParams as JCh
    from repro.configs.registry import get_smoke_config as j_smoke
    from repro.core.baselines import get_scheduler as j_get
    from repro.core.lyapunov import VedsParams as JV
    from repro.core.streaming import StreamConfig as JCfg
    from repro.data.synthetic import lm_batch as j_lm_batch
    from repro.fl.vfl import make_train_step as j_make_train_step
    from repro.models import engine as jengine
    from repro.models.module import materialize as j_materialize
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.core import streaming as stm
    from repro_torch.fl.vfl import make_train_step
    from repro_torch.models import engine
    from repro_torch.models.module import tree_leaves, tree_map

    f32 = dict(param_dtype="float32", compute_dtype="float32",
               num_vehicles=1)
    jcfg = j_smoke("qwen3-32b").replace(**f32)
    cfg = get_smoke_config("qwen3-32b").replace(**f32)
    R, sc_kw = 2, dict(n_sov=2, n_opv=2, n_slots=6)
    jsc, sc = jscn.ScenarioParams(**sc_kw), scn.ScenarioParams(**sc_kw)
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1,), ("model",))
    jp = j_materialize(jax.random.key(0), jengine.model_decl(jcfg, "head"))
    jp_v = jax.tree.map(lambda x: x[None], jp)
    batch = j_lm_batch(jax.random.key(1), R * 2, 16, jcfg.vocab_size)
    jb = jax.tree.map(lambda x: x.reshape(R, 1, 2, *x.shape[1:]), batch)
    jrun = j_make_train_step(jcfg, mesh, "head", lr=0.05,
                             stream=JCfg(n_rounds=R, batch=1,
                                         fresh_fleet=True),
                             sc=jsc, mob=JManhattan(), veds_prm=JV(),
                             ch_prm=JCh(), sched=j_get("veds"))
    ref, jstats = jax.jit(jrun)(jp_v, jb, jnp.ones((1,)), jax.random.key(3))

    draws = [RD.round_batch(jax.random.fold_in(jax.random.key(3), r), jsc,
                            JManhattan(), 1) for r in range(R)]
    monkeypatch.setattr(stm, "round_keys", lambda *a, **k: draws)
    stream = StreamConfig(n_rounds=R, batch=1, fresh_fleet=True)
    run = make_train_step(cfg, None, "head", lr=0.05, stream=stream, sc=sc,
                          mob=MOB, veds_prm=PRM, ch_prm=CH)
    params = engine.llm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    params_v = tree_map(lambda x: x[None], params)
    tb = {k: tt(v).long() for k, v in jb.items()}
    out, stats = run(params_v, tb, torch.ones(1), 3)
    np.testing.assert_array_equal(tn(stats["mask"]),
                                  np.asarray(jstats["mask"]))
    np.testing.assert_array_equal(tn(stats["n_success"]),
                                  np.asarray(jstats["n_success"]))
    assert stats["mask"].shape == (R, 1)
    for a, b in zip(tree_leaves(out), jax.tree.leaves(ref)):
        np.testing.assert_allclose(tn(a), np.asarray(b), rtol=0, atol=2e-4)
    with pytest.raises(ValueError, match="batch=1"):
        make_train_step(cfg, None, "head", stream=StreamConfig(batch=2),
                        sc=sc, mob=MOB, veds_prm=PRM, ch_prm=CH)
    with pytest.raises(ValueError, match="num_vehicles"):
        make_train_step(cfg, None, "head", stream=stream,
                        sc=scn.ScenarioParams(n_sov=0), mob=MOB,
                        veds_prm=PRM, ch_prm=CH)
