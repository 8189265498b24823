"""Tests of the port that need an NVIDIA GPU: the CUDA kernels
(`veds_score`, `p4_solve`, `flash_attention`, `fedavg_agg`, `ssd_scan`;
the last two in their fp32 CUDA-core and bf16 tensor-core variants)
against their plain PyTorch versions on the card, the VEDS round's CUDA
graph of the slot step (cold, with the warm P4 table, and without COT
for `v2i_only`) against the same step run eagerly, VEDS rounds and the
streaming `run_fl` with the `p4_solve` kernel against the slot step with
the plain P4, the streaming `run_fl`, the five
Section VI schedulers (their queues bit for bit), LaneGCN's forward and
the xLSTM smoke model's forward and backward on the card against the
CPU, the MoE block's bitwise determinism, and the scheduling service
(`launch/serve.py`): the same dispatch twice and a cell beside other
neighbours bit for bit, packed and solo masks identical, spill and
restore bit for bit, no slot graph captured after `warmup()`, and its
front end (`BatchServer`) dispatching on one thread with no capture and
its dispatch log replayed bit for bit; and the cell-sharded rollout and
stream with handoff on a one-rank NCCL world against the one-device
loops, bit for bit; and a model split over two ranks that share the
card over gloo (`run_world(shared_card=True)`) against one rank.
Marked
`cuda`; each skips
itself where no card is present. This file imports no jax, so it also
runs on a machine without the reference package's toolchain:

    PYTHONPATH=src python -m pytest --noconftest -m cuda \
        tests/test_torch_cuda.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.kernels.fedavg_agg.ops import fedavg_agg, fedavg_agg_plain
from repro_torch.kernels.p4_solve.ops import (
    _project_feasible as _p4_project, p4_solve, p4_solve_plain,
    seed_grad_norms, split_far_tol)
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_fwd,
                                                     flash_attention_plain)
from repro_torch.kernels.ssd_scan.ops import (ssd_scan, ssd_scan_fwd,
                                              ssd_scan_naive, ssd_scan_plain)
from repro_torch.kernels.veds_score.ops import (veds_dt_score,
                                                veds_dt_score_plain)
from repro_torch.channel.mobility import ManhattanParams
from repro_torch.channel.v2x import ChannelParams
from repro_torch.core import veds as port_veds
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scenario import (ScenarioParams, make_round,
                                       round_generator)
from repro_torch.core.scheduler import SchedulerCarry
from torch_port_util import p4_candidates, p4_table, require_cuda

KW = dict(V=0.2, kappa=0.1, bw=20e6, noise=8.007e-14, p_max=0.3)


def _inputs(shape, seed, device):
    rng = np.random.default_rng(seed)
    g = (10.0 ** rng.uniform(-13, -11, shape)).astype(np.float32)
    g[rng.random(shape) < 0.2] = 0.0
    q = np.abs(rng.normal(0, 0.1, shape)).astype(np.float32)
    w = (np.abs(rng.normal(0, 1, shape)) * 1e-7).astype(np.float32)
    e = rng.random(shape) < 0.75
    return tuple(torch.from_numpy(x).to(device) for x in (g, q, w, e))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 10), (1 << 20,), (0,)])
def test_veds_score_kernel_matches_plain_version(shape):
    """The kernel and the plain version run the same fp32 ops in the same
    order, with IEEE division and CUDA's log1pf, so they agree to the
    bit. One launch per call, none for an empty grid."""
    require_cuda()
    g, q, w, e = _inputs(shape, 3, "cuda")
    before = veds_dt_score.launches
    outs = veds_dt_score(g, q, w, e, **KW)
    torch.cuda.synchronize()
    assert veds_dt_score.launches == before + (g.numel() > 0)
    for a, b in zip(outs, veds_dt_score_plain(g, q, w, e, **KW)):
        assert a.shape == g.shape and a.device == g.device
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_veds_score_wrapper_checks_its_inputs():
    require_cuda()
    g, q, w, e = _inputs((64,), 4, "cuda")
    with pytest.raises(ValueError, match="contiguous"):
        veds_dt_score(g[::2], q[::2], w[::2], e[::2], **KW)
    with pytest.raises(ValueError, match="float32"):
        veds_dt_score(g, q.double(), w, e, **KW)
    with pytest.raises(ValueError, match="shape"):
        veds_dt_score(g, q[:32], w, e, **KW)
    with pytest.raises(ValueError, match="cuda"):
        veds_dt_score(g, q.cpu(), w, e, **KW)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(3, 10), (1, 4)])
def test_veds_score_in_a_cuda_graph_matches_plain_version(shape):
    """The launch is capture-safe: recorded into a CUDA graph and
    replayed, it gives the plain version's outputs to the bit. The kernel
    counts its own runs: the capture adds nothing to `launches`, each
    replay adds one, and the warm-up under `uncounted()` nothing."""
    require_cuda()
    g, q, w, e = _inputs(shape, 5, "cuda")
    veds_dt_score.launches = 0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), veds_dt_score.uncounted():
        veds_dt_score(g, q, w, e, **KW)         # warm-up outside capture
    torch.cuda.current_stream().wait_stream(side)
    assert veds_dt_score.launches == 0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = veds_dt_score(g, q, w, e, **KW)
    assert veds_dt_score.launches == 0
    for x in outs:
        x.fill_(float("nan"))
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert veds_dt_score.launches == 3
    for a, b in zip(outs, veds_dt_score_plain(g, q, w, e, **KW)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the VEDS round: slot graph against the eager step
# ---------------------------------------------------------------------------

def _rounds(n_sov, n_opv, n_slots, B, seed, device="cuda"):
    sc = ScenarioParams(n_sov=n_sov, n_opv=n_opv, n_slots=n_slots)
    return port_veds.RoundInputs.stack([
        make_round(round_generator(seed, r, device), sc, ManhattanParams(),
                   ChannelParams(), VedsParams()) for r in range(B)])


def _with_masks(rnd):
    """Mark the last SOV of every cell and the first OPV of cell 0 as
    padding."""
    valid_sov = torch.ones_like(rnd.t_cp, dtype=torch.bool)
    valid_sov[:, -1] = False
    valid_opv = torch.ones_like(rnd.e_opv, dtype=torch.bool)
    valid_opv[0, 0] = False
    return dataclasses.replace(rnd, valid_sov=valid_sov, valid_opv=valid_opv)


def _assert_rounds_equal(a, b):
    for k in a.keys():
        assert torch.equal(a[k], b[k]), k
    assert torch.equal(a.carry.qs, b.carry.qs)
    assert torch.equal(a.carry.qu, b.carry.qu)


@pytest.mark.cuda
@pytest.mark.parametrize("case,masks,enable_cot,carry", [
    ("fig10", False, True, False),      # run_fl's block: B 3, S=U=10, T 60
    ("fig10", False, False, True),
    ("reference", False, True, False),  # chip_smoke's reference input
    ("reference", True, True, True),
    ("reference", True, False, False),
])
def test_veds_round_graph_equals_eager_step(case, masks, enable_cot, carry):
    """The slot graph's round equals the eager loop's bit for bit: every
    output, the queues carried out included. A second round of the same
    shape replays the same graph on new inputs, and the first round's
    outputs stay as they were."""
    require_cuda()
    shape = (10, 10, 60) if case == "fig10" else (4, 4, 12)
    rnds = [_rounds(*shape, B=3, seed=s) for s in (11, 12)]
    if masks:
        rnds = [_with_masks(r) for r in rnds]
    prm, ch = VedsParams(), ChannelParams()
    c = None
    if carry:
        gen = torch.Generator(device="cuda").manual_seed(3)
        c = SchedulerCarry(
            qs=0.02 * torch.rand((3, shape[0]), generator=gen,
                                 device="cuda"),
            qu=0.02 * torch.rand((3, shape[1]), generator=gen,
                                 device="cuda"))
    graphed = [port_veds.veds_round(r, prm, ch, enable_cot=enable_cot,
                                    carry=c) for r in rnds]
    eager = [port_veds._veds_round(r, prm, ch, enable_cot=enable_cot,
                                   carry=c, graphed=False) for r in rnds]
    for g, e in zip(graphed, eager):
        _assert_rounds_equal(g, e)
    if enable_cot and case == "fig10":
        assert int(eager[0].n_cot_slots.sum()) > 0


@pytest.mark.cuda
def test_slot_graph_is_captured_once_per_shape_key():
    """One capture for the first round of a key; none for more rounds of
    it; one more for a new shape, for COT off, and for padding masks."""
    require_cuda()
    prm, ch = VedsParams(), ChannelParams()
    rnd = _rounds(4, 3, 7, B=2, seed=5)
    port_veds._SLOT_GRAPHS.clear()
    n0 = port_veds._SlotGraph.captures
    for _ in range(3):
        port_veds.veds_round(rnd, prm, ch)
    assert port_veds._SlotGraph.captures == n0 + 1
    port_veds.veds_round(rnd.cell(0), prm, ch)              # B 1
    port_veds.veds_round(_rounds(4, 3, 8, B=2, seed=5), prm, ch)   # T 8
    port_veds.veds_round(rnd, prm, ch, enable_cot=False)
    port_veds.veds_round(_with_masks(rnd), prm, ch)
    assert port_veds._SlotGraph.captures == n0 + 5
    port_veds.veds_round(rnd, prm, ch)
    assert port_veds._SlotGraph.captures == n0 + 5
    assert len(port_veds._SLOT_GRAPHS) == 5


@pytest.mark.cuda
def test_veds_score_launches_count_one_per_slot_of_a_graphed_round():
    """`veds_dt_score.launches` counts the kernel's runs on the card, as
    the kernel itself counts them: T per round block, the round that
    captures the graph included (its warm-up and its capture run no slot
    of a round and count nothing)."""
    require_cuda()
    prm, ch = VedsParams(), ChannelParams()
    port_veds._SLOT_GRAPHS.clear()
    for T in (9, 9, 13):
        rnd = _rounds(5, 4, T, B=3, seed=T)
        before = veds_dt_score.launches
        port_veds.veds_round(rnd, prm, ch)
        assert veds_dt_score.launches == before + T
    before = veds_dt_score.launches
    port_veds._veds_round(rnd, prm, ch, enable_cot=True, carry=None,
                          graphed=False)
    assert veds_dt_score.launches == before + 13


# ---------------------------------------------------------------------------
# the streaming path: warm P4 in the slot graph, run_fl(streaming=True)
# ---------------------------------------------------------------------------

def _warm_table(B, S, U, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return 0.3 * torch.rand((B, S, U, U + 1), generator=gen, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,B,far", [((10, 10, 60), 1, 0),
                                         ((4, 4, 12), 3, 0),
                                         ((4, 4, 12), 3, 25)])
def test_warm_slot_graph_equals_eager_step(shape, B, far):
    """With a carried P4 table the graph holds one more static buffer:
    masks, zeta, queues and the returned table equal the eager step's
    bit for bit, on two rounds of the shape (the second replays)."""
    require_cuda()
    S, U, _ = shape
    prm = VedsParams(ipm_warm_iters=10, ipm_far_iters=far,
                     ipm_far_grad_tol=0.05 if far else 0.0)
    ch = ChannelParams()
    rnds = [_rounds(*shape, B=B, seed=s) for s in (21, 22)]
    c = SchedulerCarry(qs=torch.zeros((B, S), device="cuda"),
                       qu=torch.zeros((B, U), device="cuda"),
                       p4=_warm_table(B, S, U, 4))
    n0 = port_veds._SlotGraph.captures
    graphed = [port_veds.veds_round(r, prm, ch, carry=c) for r in rnds]
    assert port_veds._SlotGraph.captures <= n0 + 1
    eager = [port_veds._veds_round(r, prm, ch, enable_cot=True, carry=c,
                                   graphed=False) for r in rnds]
    for g, e in zip(graphed, eager):
        _assert_rounds_equal(g, e)
        assert torch.equal(g.carry.p4, e.carry.p4)
        assert not torch.equal(g.carry.p4, c.p4)


def _linear_problem():
    rng = np.random.default_rng(0)
    protos = rng.normal(size=(3, 6)).astype(np.float32)
    data = []
    for i in range(8):
        n = 5 + 3 * (i % 3)
        y = rng.integers(0, 3, n)
        data.append({"x": (protos[y] + 0.5 * rng.normal(size=(n, 6)))
                     .astype(np.float32), "y": y.astype(np.int64)})
    xt = protos[np.arange(3).repeat(8)] + 0.5 * rng.normal(size=(24, 6))
    return data, xt.astype(np.float32), np.arange(3).repeat(8)


def _linear_loss(p, b):
    logp = torch.log_softmax(b["x"] @ p["w"], -1)
    return -torch.gather(logp, -1, b["y"][:, None]).mean()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", [{}, {"fused": False}])
def test_streaming_run_fl_on_card_matches_cpu(mode):
    """`run_fl(streaming=True)` with warm P4 and carried queues, 3 rounds
    at S=U=4, T=10, on the card and on the CPU from the same seed (the
    draws are made on the CPU and moved across): rounds and `n_success`
    identical, the eval loss within rtol 1e-4."""
    require_cuda()
    from repro_torch.core.scenario import fleet_round_draws, init_fleet_draws
    from repro_torch.fl import simulator
    from repro_torch.fl.simulator import FLSimConfig, run_fl
    data, xt, yt = _linear_problem()
    sim = FLSimConfig(n_clients=8, rounds=3, n_slots=10, n_sov=4, n_opv=4,
                      batch_size=4, lr=0.1, streaming=True,
                      ipm_warm_iters=10, **mode)
    sc = ScenarioParams(n_sov=4, n_opv=4, n_slots=10, batch_size=4)
    real = simulator._stream_draws
    keys, fleet_key, sel, mb_u = real(7, sim, torch.device("cpu"))
    # the integer keys as the draws they seed on the CPU
    round_draws = [fleet_round_draws(torch.Generator().manual_seed(k), sc,
                                     1, 16, "cpu") for k in keys]
    fleet_draws = init_fleet_draws(torch.Generator().manual_seed(fleet_key),
                                   ManhattanParams(), sc, 1, 16, "cpu")

    def to(tree, device):
        if isinstance(tree, dict):
            return {k: to(v, device) for k, v in tree.items()}
        return tree.to(device)

    def draws(seed, sim_, device):
        return ([to(d, device) for d in round_draws],
                to(fleet_draws, device), sel.to(device), mb_u.to(device))

    hist = {}
    for dev in ("cpu", "cuda"):
        x, y = torch.as_tensor(xt, device=dev), torch.as_tensor(yt,
                                                                 device=dev)
        simulator._stream_draws = draws
        try:
            hist[dev] = run_fl(7, {"w": torch.zeros(6, 3)}, _linear_loss,
                               data, sim, eval_fn=lambda p: _linear_loss(
                                   p, {"x": x, "y": y}), eval_every=1,
                               device=dev)
        finally:
            simulator._stream_draws = real
    assert hist["cuda"]["round"] == hist["cpu"]["round"] == [0, 1, 2]
    assert hist["cuda"]["n_success"] == hist["cpu"]["n_success"]
    np.testing.assert_allclose(hist["cuda"]["metric"], hist["cpu"]["metric"],
                               rtol=1e-4)


@pytest.mark.cuda
def test_veds_score_launches_count_one_per_slot_of_streaming_rounds():
    """A persistent warm stream of R rounds runs `veds_score` R x T times
    on the card, from the slot graph."""
    require_cuda()
    from repro_torch.core.baselines import get_scheduler
    from repro_torch.core.streaming import StreamConfig, stream_rounds
    sc = ScenarioParams(n_sov=4, n_opv=4, n_slots=10)
    cfg = StreamConfig(n_rounds=3, batch=1, carry_queues=True)
    before = veds_dt_score.launches
    res = stream_rounds(2, get_scheduler("veds"), sc, ManhattanParams(),
                        ChannelParams(), VedsParams(ipm_warm_iters=10), cfg)
    assert res.outputs.success.is_cuda
    assert veds_dt_score.launches == before + 3 * 10


# ---------------------------------------------------------------------------
# the p4_solve kernel: against its plain version, in the slot step
# ---------------------------------------------------------------------------

P4_CASES = {"cold": {}, "warm": dict(warm_iters=10),
            "adaptive": dict(warm_iters=10, far_iters=25),
            "floor": dict(warm_iters=10)}
P4_RTOL = {"cold": 1e-4, "warm": 5e-2, "adaptive": 5e-2, "floor": 5e-2}


def _p4_args(shape, seed, slot=5, carry=None, prm=None):
    """`solve_p4`'s arguments at slot `slot` of an eager VEDS round of
    `shape` = (B, S, U) on the card (`_rounds`), recorded as the slot step
    makes them, the plain P4 solving every slot: contiguous (cw, a, q,
    d, p_max) and the warm table the slot step carried there (None
    cold)."""
    from unittest import mock
    B, S, U = shape
    calls = []

    def record(cw, a, q, d, p_max, *, p_init=None, **kw):
        calls.append(([x.contiguous() for x in (cw, a, q, d, p_max)],
                      p_init))
        return p4_solve_plain(cw, a, q, d, p_max, p_init, **kw)
    rnd = _rounds(S, U, slot + 1, B=B, seed=seed)
    with mock.patch.object(port_veds, "solve_p4", record):
        port_veds._veds_round(rnd, prm or VedsParams(), ChannelParams(),
                              enable_cot=True, carry=carry, graphed=False)
    return calls[slot]


def _seed_norms(cand, p_init):
    """The plain version's gradient norm of each projected seed, which
    it holds to `far_grad_tol`."""
    cw, a, q, d, pm = cand
    return seed_grad_norms(cw, a, q, _p4_project(p_init, d, pm, margin=0.5))


def _p4_case(case, shape, seed):
    """A slot's candidates and the arguments of one P4 `case`: cold, or
    warm (and adaptive, its far threshold split at the seeds' median)
    from interior seeds, a table drawn in (0, 0.3) W as the warm tests
    of `tests/test_torch_streaming.py` draw theirs, or ("floor") warm
    from a table with 30% of its entries at the box floor of 1e-9 W,
    the ill-conditioned seeds of infeasible candidates' optima
    (`torch_port_util.p4_table`)."""
    cand, _ = _p4_args(shape, seed)
    kw = dict(P4_CASES[case])
    p_init = None
    if case == "floor":
        p_init = p4_table(tuple(cand[1].shape), seed, device="cuda")
    elif case != "cold":
        p_init = _warm_table(*shape, seed)
    if case == "adaptive":
        kw["far_grad_tol"] = split_far_tol(_seed_norms(cand, p_init))
    return cand, p_init, kw


@pytest.mark.cuda
@pytest.mark.parametrize("case", tuple(P4_CASES))
@pytest.mark.parametrize("shape", [(1, 10, 10), (8, 10, 10), (8, 4, 3)])
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_p4_solve_kernel_matches_plain_version(seed, shape, case):
    """The kernel against its plain version on the card at fig10's
    [B, 10, 10, 11] (B 1 and 8) and the service's n = 4, on a VEDS
    slot's candidates: powers within 2e-5 W plus the case's rtol and
    values within the case's rtol (1e-4 cold, 5e-2 warm), in the box and
    finite. Adaptive: the kernel's tier of each candidate (its result is
    bit for bit its near-tier or its far-tier solve) is the plain
    version's far mask. (Measured on an NVIDIA H100: bit for bit.)"""
    require_cuda()
    cand, p_init, kw = _p4_case(case, shape, seed)
    rtol = P4_RTOL[case]
    before = p4_solve.launches
    p, v = p4_solve(*cand, p_init, **kw)
    torch.cuda.synchronize()
    assert p4_solve.launches == before + 1
    rp, rv = p4_solve_plain(*cand, p_init, **kw)
    assert torch.isfinite(p).all() and torch.isfinite(v).all()
    assert ((p >= 0) & (p <= cand[4])).all()
    torch.testing.assert_close(v, rv, rtol=rtol, atol=1e-9)
    torch.testing.assert_close(p, rp, rtol=rtol, atol=2e-5)
    if case != "adaptive":
        return
    near = p4_solve(*cand, p_init, warm_iters=kw["warm_iters"])[0]
    far = p4_solve(*cand, p_init, warm_iters=kw["far_iters"])[0]
    is_near = (p == near).all(-1)
    is_far = (p == far).all(-1)
    assert (is_near | is_far).all()
    told = ~(is_near & is_far)
    g0 = _seed_norms(cand, p_init)
    want = g0 > kw["far_grad_tol"]
    assert want.any() and (~want).any()
    parted = told & (is_far != want)
    assert not parted.any(), (
        "the kernel's tier parts from the plain version's far mask",
        seed, shape, kw["far_grad_tol"], g0[parted].tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("case", tuple(P4_CASES))
def test_p4_solve_is_batch_invariant(case):
    """A packed [8, 10, 10] batch gives each cell the bits of its B = 1
    solve: no work is shared across candidates."""
    require_cuda()
    cand, p_init, kw = _p4_case(case, (8, 10, 10), 4)
    p, v = p4_solve(*cand, p_init, **kw)
    for b in range(8):
        one = [x[b:b + 1].contiguous() for x in cand]
        pb, vb = p4_solve(*one, None if p_init is None
                          else p_init[b:b + 1].contiguous(), **kw)
        assert torch.equal(pb[0], p[b]) and torch.equal(vb[0], v[b])


@pytest.mark.cuda
def test_p4_solve_in_a_cuda_graph_matches_its_eager_launch():
    """Captured into a CUDA graph and replayed, the launch gives its
    eager launch's bits; the barrier weights travel in the captured
    arguments. The kernel counts its own runs: the capture adds nothing,
    each replay one, the warm-up under `uncounted()` nothing."""
    require_cuda()
    cand, tab, kw = _p4_case("adaptive", (3, 10, 10), 5)
    eager = p4_solve(*cand, tab, **kw)
    p4_solve.launches = 0
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side), p4_solve.uncounted():
        p4_solve(*cand, tab, **kw)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = p4_solve(*cand, tab, **kw)
    assert p4_solve.launches == 0
    for x in outs:
        x.fill_(float("nan"))
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert p4_solve.launches == 3
    for a, b in zip(outs, eager):
        assert torch.equal(a, b)


# the register layout's edges: n at the width buckets' edges (a lane's
# row is instantiated at n rounded up to a multiple of 4, a sum spans 4,
# 8, 16 or 32 lanes), an odd candidate count, exact pivot ties
P4_EDGES = {"n2": (2, 4, 1), "n16": (2, 4, 15), "n17": (2, 4, 16),
            "n32": (1, 4, 31), "odd": (1, 3, 3), "ties": (1, 10, 10)}


def _p4_edge(edge, case, seed):
    """A VEDS slot's candidates at `P4_EDGES[edge]` = (B, S, U) and the
    arguments of `case` (`_p4_case`'s cold, warm and floor tables).
    "ties": every OPV a copy of OPV 1 (its gain, weight, load and box),
    so that rows of the Newton system tie exactly in the pivot search."""
    shape = P4_EDGES[edge]
    cand, _ = _p4_args(shape, seed)
    p_init = None
    if case == "floor":
        p_init = p4_table(tuple(cand[1].shape), seed, device="cuda")
    elif case == "warm":
        p_init = _warm_table(*shape, seed)
    if edge == "ties":
        for x in cand[1:] + ([] if p_init is None else [p_init]):
            x[..., 2:] = x[..., 1:2]
    return cand, p_init, dict(P4_CASES[case])


def _pivot_ties(cand, p_init):
    """Candidates whose first Newton system ties exactly for the first
    pivot: the largest |H[i][0]| at two rows or more."""
    cw, a, q, d, pm = cand
    p0 = p_init if p_init is not None else torch.cat(
        [0.5 * pm[..., :1], 0.25 * pm[..., 1:]], -1)
    p = _p4_project(p0, d, pm, margin=0.5)
    from repro_torch.kernels.p4_solve.ops import _phi_grad_hess
    col = _phi_grad_hess(p, a, q, cw, d, pm, 0.1)[1][..., :, 0].abs()
    return (col == col.amax(-1, keepdim=True)).sum(-1) > 1


def _p4_parted(p, v, rp, rv, rtol):
    """Candidates on which two solves part: one finite and the other not,
    or both finite and apart beyond `test_p4_solve_kernel_matches_plain_
    version`'s tolerance (2e-5 W + rtol |p|, 1e-9 + rtol |value|)."""
    ok, rok = (torch.isfinite(x).all(-1) & torch.isfinite(y)
               for x, y in ((p, v), (rp, rv)))
    far = (((p - rp).abs() > 2e-5 + rtol * rp.abs()).any(-1)
           | ((v - rv).abs() > 1e-9 + rtol * rv.abs()))
    return (ok != rok) | (ok & rok & far)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("cold", "warm", "floor"))
@pytest.mark.parametrize("edge", tuple(P4_EDGES))
def test_p4_solve_kernel_matches_plain_version_at_the_layout_edges(edge,
                                                                   case):
    """The kernel against its plain version on the card where its layout
    could break: n = 2, 16, 17 and 32 (VEDS slot inputs at U = 1, 15, 16,
    31), 9 candidates, and exact pivot ties. With tied rows an infeasible
    candidate's system can be singular in fp32 (its rank-one barrier
    term swamps the diagonal, and the elimination cancels a pivot to
    zero): the candidates that the plain version leaves non-finite are
    the kernel's non-finite ones, and elsewhere every candidate is
    finite. The finite ones lie in the box and are held as
    `test_p4_solve_kernel_matches_plain_version` holds them. At n = 32
    the systems are conditioned so badly that the plain version on the
    card parts from itself on the CPU on some candidates (an NVIDIA H100:
    4 of 124 from seed 1's floor table, 4 to 12 cold); there the kernel
    may part from the plain version on no more candidates than that."""
    require_cuda()
    cand, p_init, kw = _p4_edge(edge, case, 1)
    if edge == "ties":
        assert bool(_pivot_ties(cand, p_init).any())
    rtol = P4_RTOL[case]
    before = p4_solve.launches
    p, v = p4_solve(*cand, p_init, **kw)
    torch.cuda.synchronize()
    assert p4_solve.launches == before + 1
    rp, rv = p4_solve_plain(*cand, p_init, **kw)
    ok = torch.isfinite(p).all(-1) & torch.isfinite(v)
    assert ok.any() and (edge == "ties" or ok.all())
    assert ((p[ok] >= 0) & (p[ok] <= cand[4][ok])).all()
    parted = _p4_parted(p, v, rp, rv, rtol)
    if edge == "n32" and bool(parted.any()):
        cp, cv = p4_solve_plain(*(x.cpu() for x in cand),
                                None if p_init is None else p_init.cpu(),
                                **kw)
        witness = _p4_parted(rp, rv, cp.cuda(), cv.cuda(), rtol)
        assert int(parted.sum()) <= int(witness.sum()), (
            int(parted.sum()), int(witness.sum()))
        return
    assert torch.equal(ok, torch.isfinite(rp).all(-1) & torch.isfinite(rv))
    torch.testing.assert_close(v[ok], rv[ok], rtol=rtol, atol=1e-9)
    torch.testing.assert_close(p[ok], rp[ok], rtol=rtol, atol=2e-5)


@pytest.mark.cuda
def test_p4_solve_adaptive_tiers_mixed_within_a_block():
    """Under the adaptive budget the two tiers meet in one block of the
    launch (`WARPS_PER_BLOCK` candidates, one a warp): each candidate's
    result is, bit for bit, its own tier's solve (the near tier's warm
    budget or the far tier's), the tier the plain version's far mask
    gives it."""
    require_cuda()
    from repro_torch.kernels.p4_solve.ops import WARPS_PER_BLOCK
    cand, p_init, kw = _p4_case("adaptive", (1, 10, 10), 2)
    far = (_seed_norms(cand, p_init) > kw["far_grad_tol"]).flatten()
    whole = far[:far.numel() // WARPS_PER_BLOCK * WARPS_PER_BLOCK]
    blocks = whole.reshape(-1, WARPS_PER_BLOCK)
    assert (blocks.any(-1) & ~blocks.all(-1)).any()
    p, v = p4_solve(*cand, p_init, **kw)
    near = p4_solve(*cand, p_init, warm_iters=kw["warm_iters"])
    far_solve = p4_solve(*cand, p_init, warm_iters=kw["far_iters"])
    mask = far.reshape(v.shape)
    assert torch.equal(p, torch.where(mask[..., None], far_solve[0],
                                      near[0]))
    assert torch.equal(v, torch.where(mask, far_solve[1], near[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 4, 1), (2, 4, 15), (2, 4, 16),
                                   (1, 4, 31), (1, 3, 3)])
def test_veds_round_decides_as_with_the_plain_p4_at_the_layout_edges(
        shape, monkeypatch):
    """A VEDS round of 20 slots at the layout's edges (n = 2, 16, 17, 32;
    9 candidates a slot), eagerly with the kernel and with the plain P4:
    every slot's chosen SOV, DT or COT and prefix identical, the queues
    within rtol 1e-4; `p4_solve` launched once a slot."""
    require_cuda()
    B, S, U = shape
    rnd = _rounds(S, U, 20, B=B, seed=7)
    prm, ch = VedsParams(), ChannelParams()
    gen = torch.Generator(device="cuda").manual_seed(7)
    c = SchedulerCarry(
        qs=0.02 * torch.rand((B, S), generator=gen, device="cuda"),
        qu=0.02 * torch.rand((B, U), generator=gen, device="cuda"))
    before = p4_solve.launches
    kernel, k_state = _slot_decisions(rnd, prm, ch, c)
    assert p4_solve.launches == before + 20
    with monkeypatch.context() as m:
        m.setattr(port_veds, "solve_p4", _plain_solve_p4)
        plain, p_state = _slot_decisions(rnd, prm, ch, c)
    for a, b in zip(kernel, plain):
        assert torch.equal(a, b)
    for k in ("qs", "qu"):
        torch.testing.assert_close(k_state[k], p_state[k], rtol=1e-4,
                                   atol=1e-9)


@pytest.mark.cuda
def test_p4_solve_refuses_what_the_kernel_does_not_take_on_the_card():
    require_cuda()
    cand = [x.contiguous() for x in p4_candidates(3, 6, device="cuda")]
    with pytest.raises(ValueError, match="q must be torch.float32 on cuda"):
        p4_solve(cand[0], cand[1], cand[2].cpu(), *cand[3:])
    with pytest.raises(ValueError, match="Newton steps"):
        p4_solve(*cand, iters=80)


def _plain_solve_p4(cw, a, q, d, p_max, *, p_init=None, **kw):
    """`core/solver.py solve_p4` through the plain version, for the slot
    step on the card with the P4 of before the kernel."""
    return p4_solve_plain(cw, a, q, d, p_max, p_init, **kw)


def _slot_decisions(rnd, prm, ch, carry):
    """Every slot's decisions of an eager VEDS round: the SOV chosen,
    DT or COT, and the OPVs given power (the prefix), stacked [T, B,
    ...], with the round's outputs."""
    rb = rnd.with_batch_axis()
    state = port_veds._round_state(rb, prm, ch, True, carry)
    ts = torch.arange(rb.g_sr.shape[1], device=rb.g_sr.device)
    rows = []
    for t in ts:
        state, info = port_veds.solve_slot(t, state, rb, prm, ch)
        rows.append((info["m"], info["use_dt"], info["use_cot"],
                     info["e_opv"] > 0))
    return [torch.stack(x) for x in zip(*rows)], state


@pytest.mark.cuda
@pytest.mark.parametrize("table", [None, "prior", "floor"])
@pytest.mark.parametrize("seed", [11, 12, 13])
def test_veds_round_with_the_kernel_decides_as_with_the_plain_p4(
        seed, table, monkeypatch):
    """Whole fig10 rounds (three cells, S = U = 10, T = 60, a carry) with
    the kernel, from the slot graph and eagerly, against the slot step
    run with the plain P4: cold, and warm with the adaptive budget from
    the table that a warm round before left, as the streaming path
    carries it ("prior"), or from a table with 30% of its entries at
    1e-9 W ("floor", `torch_port_util.p4_table`). Every slot's chosen
    SOV, DT or COT and prefix, the success masks and `n_cot_slots`
    identical; delivered bits, energies and queues within rtol 1e-4
    (5e-2 warm); `p4_solve` launched once a slot."""
    require_cuda()
    from repro_torch.core.solver import p4_seed_table
    rnd = _hetero_round(seed=seed)
    ch = ChannelParams()
    warm = table is not None
    prm = VedsParams(ipm_warm_iters=10, ipm_far_iters=25,
                     ipm_far_grad_tol=0.05) if warm else VedsParams()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c = SchedulerCarry(
        qs=0.02 * torch.rand((3, 10), generator=gen, device="cuda"),
        qu=0.02 * torch.rand((3, 10), generator=gen, device="cuda"))
    if table == "prior":
        seeded = dataclasses.replace(
            c, p4=p4_seed_table((3, 10, 10, 11), ch.p_max, "cuda"))
        c = port_veds.veds_round(_hetero_round(seed=seed + 100), prm, ch,
                                 carry=seeded).carry
    elif table == "floor":
        c = dataclasses.replace(c, p4=p4_table((3, 10, 10, 11), seed,
                                               device="cuda"))
    before = p4_solve.launches
    graphed = port_veds.veds_round(rnd, prm, ch, carry=c)
    assert p4_solve.launches == before + 60
    kernel, k_state = _slot_decisions(rnd, prm, ch, c)
    with monkeypatch.context() as m:
        m.setattr(port_veds, "solve_p4", _plain_solve_p4)
        plain, p_state = _slot_decisions(rnd, prm, ch, c)
        eager_plain = port_veds._veds_round(rnd, prm, ch, enable_cot=True,
                                            carry=c, graphed=False)
    for a, b in zip(kernel, plain):
        assert torch.equal(a, b)
    assert bool(kernel[2].any())                  # COT chosen somewhere
    for k in ("success", "n_success", "n_cot_slots", "n_dt_slots"):
        assert torch.equal(graphed[k], eager_plain[k]), k
    rtol = 5e-2 if warm else 1e-4
    for k in ("zeta", "energy_sov", "energy_opv"):
        torch.testing.assert_close(graphed[k], eager_plain[k], rtol=rtol,
                                   atol=1e-9)
    for k in ("qs", "qu"):
        torch.testing.assert_close(k_state[k], p_state[k], rtol=rtol,
                                   atol=1e-9)
        assert torch.equal(getattr(graphed.carry, k), k_state[k])


@pytest.mark.cuda
def test_streaming_run_fl_with_the_kernel_decides_as_with_the_plain_p4(
        monkeypatch):
    """A short `run_fl(streaming=True)` (5 rounds at S = U = 4, T = 10,
    warm P4 at 10 steps) with the kernel and with the plain
    P4 in the slot graph, from the same seed: rounds and `n_success`
    identical, the eval loss within rtol 1e-4; `p4_solve` launched
    rounds x T times with the kernel and no time with the plain P4."""
    require_cuda()
    from repro_torch.fl.simulator import FLSimConfig, run_fl
    data, xt, yt = _linear_problem()
    sim = FLSimConfig(n_clients=8, rounds=5, n_slots=10, n_sov=4, n_opv=4,
                      batch_size=4, lr=0.1, streaming=True,
                      ipm_warm_iters=10)
    x, y = torch.as_tensor(xt, device="cuda"), torch.as_tensor(yt,
                                                                device="cuda")

    def run():
        port_veds._SLOT_GRAPHS.clear()
        before = p4_solve.launches
        hist = run_fl(7, {"w": torch.zeros(6, 3)}, _linear_loss, data, sim,
                      eval_fn=lambda p: _linear_loss(p, {"x": x, "y": y}),
                      eval_every=1, device="cuda")
        return hist, p4_solve.launches - before

    kernel, n_kernel = run()
    with monkeypatch.context() as m:
        m.setattr(port_veds, "solve_p4", _plain_solve_p4)
        plain, n_plain = run()
    port_veds._SLOT_GRAPHS.clear()
    assert (n_kernel, n_plain) == (5 * 10, 0)
    assert kernel["round"] == plain["round"] == list(range(5))
    assert kernel["n_success"] == plain["n_success"]
    np.testing.assert_allclose(kernel["metric"], plain["metric"], rtol=1e-4)


# ---------------------------------------------------------------------------
# the Section VI schedulers and LaneGCN
# ---------------------------------------------------------------------------

def _hetero_round(B=3, seed=5, device="cuda"):
    """fig10's sizes (S = U = 10, T = 60), B heterogeneous cells with
    padded vehicles, made on the CPU and moved to `device`."""
    from repro_torch.core.scenario import make_round_batch
    sc = ScenarioParams(n_sov=10, n_opv=10, n_slots=60)
    return make_round_batch(seed, sc, ManhattanParams(), ChannelParams(),
                            VedsParams(), B, hetero_fleet=True,
                            device="cpu").to(device)


@pytest.mark.cuda
def test_v2i_only_slot_graph_equals_eager_step():
    """`v2i_only` (VEDS without COT) from its slot graph equals its eager
    loop bit for bit on a heterogeneous fig10 batch with a carry, and
    launches `veds_score` once a slot."""
    require_cuda()
    from repro_torch.core.baselines import get_scheduler
    rnd = _hetero_round()
    prm, ch = VedsParams(), ChannelParams()
    gen = torch.Generator(device="cuda").manual_seed(8)
    c = SchedulerCarry(qs=0.02 * torch.rand((3, 10), generator=gen,
                                            device="cuda"),
                       qu=0.02 * torch.rand((3, 10), generator=gen,
                                            device="cuda"))
    before = veds_dt_score.launches
    graphed = get_scheduler("v2i_only").solve_round(rnd, prm, ch, c)
    assert veds_dt_score.launches == before + 60
    eager = port_veds._veds_round(rnd, prm, ch, enable_cot=False, carry=c,
                                  graphed=False)
    _assert_rounds_equal(graphed, eager)
    assert not graphed.n_cot_slots.any()


@pytest.mark.cuda
@pytest.mark.parametrize("sched", ["madca", "optimal", "sa", "v2i_only",
                                   "veds"])
def test_scheduler_round_on_card_matches_cpu(sched):
    """One fig10 round of three heterogeneous cells with a carry, on the
    card and on the CPU: masks, `n_success` and slot counts identical,
    delivered bits, energies and queues within rtol 1e-4."""
    require_cuda()
    from repro_torch.core.baselines import get_scheduler
    rnd = _hetero_round(device="cpu")
    rng = np.random.default_rng(2)
    qs = torch.from_numpy(rng.uniform(0, 0.02, (3, 10)).astype(np.float32))
    qu = torch.from_numpy(rng.uniform(0, 0.02, (3, 10)).astype(np.float32))
    prm, ch = VedsParams(), ChannelParams()
    cpu = get_scheduler(sched).solve_round(rnd, prm, ch,
                                           SchedulerCarry(qs=qs, qu=qu))
    card = get_scheduler(sched).solve_round(
        rnd.to("cuda"), prm, ch, SchedulerCarry(qs=qs.cuda(), qu=qu.cuda()))
    assert card.success.is_cuda
    for k in ("success", "n_success", "n_cot_slots", "n_dt_slots"):
        assert torch.equal(card[k].cpu(), cpu[k]), k
    for k in ("zeta", "energy_sov", "energy_opv"):
        torch.testing.assert_close(card[k].cpu(), cpu[k], rtol=1e-4,
                                   atol=1e-9)
    for k in ("qs", "qu"):
        torch.testing.assert_close(getattr(card.carry, k).cpu(),
                                   getattr(cpu.carry, k), rtol=1e-4,
                                   atol=1e-9)


def _round_on_card_and_cpu(sched, seed):
    """One round of `sched` on a fig10 batch (three heterogeneous cells,
    a non-zero carry), on the card and on the CPU."""
    from repro_torch.core.baselines import get_scheduler
    from repro_torch.core.scenario import make_round_batch
    sc = ScenarioParams(n_sov=10, n_opv=10, n_slots=60)
    prm, ch = VedsParams(), ChannelParams()
    rnd = make_round_batch(seed, sc, ManhattanParams(), ch, prm, 3,
                           hetero_fleet=True, device="cpu")
    rng = np.random.default_rng(seed)
    qs = torch.from_numpy(rng.uniform(0, 0.02, (3, 10)).astype(np.float32))
    qu = torch.from_numpy(rng.uniform(0, 0.02, (3, 10)).astype(np.float32))
    cpu = get_scheduler(sched).solve_round(rnd, prm, ch,
                                           SchedulerCarry(qs=qs, qu=qu))
    card = get_scheduler(sched).solve_round(
        rnd.to("cuda"), prm, ch, SchedulerCarry(qs=qs.cuda(), qu=qu.cuda()))
    for k in ("success", "n_success", "n_cot_slots", "n_dt_slots"):
        assert torch.equal(card[k].cpu(), cpu[k]), k
    return [(name, a.cpu(), b) for name, a, b in (
        ("zeta", card.zeta, cpu.zeta), ("qs", card.carry.qs, cpu.carry.qs),
        ("qu", card.carry.qu, cpu.carry.qu))]


@pytest.mark.cuda
@pytest.mark.parametrize("sched", ["madca", "optimal", "sa", "v2i_only"])
@pytest.mark.parametrize("seed", [5, 6, 7, 8])
def test_scheduler_queues_on_card_equal_cpu_bit_for_bit(sched, seed):
    """After one round, the virtual energy queues qs and qu and the
    delivered bits zeta are the CPU's bit for bit: every division on the
    decision path is by a 0-dim device tensor (`repro_torch.device_scalar`,
    `core/scheduler.py divisors`) and `madca`'s and `sa`'s rates take
    their log2 in float64 (`core/baselines.py _log2`), each correctly
    rounded on both."""
    require_cuda()
    for name, a, b in _round_on_card_and_cpu(sched, seed):
        assert torch.equal(a, b), (name, int((a != b).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [5, 6, 7, 8])
def test_veds_queues_on_card_within_ulps_of_cpu(seed):
    """VEDS's decisions are the CPU's, and its queues and delivered bits
    lie within 4 ulp of the CPU's (measured: up to 2): its cooperative
    powers come from the P4 solves (the `p4_solve` kernel's LU on the
    card, LAPACK's through `torch.linalg.solve_ex` on the CPU), whose
    linear solves and sums round in other orders, so they are not bit
    for bit."""
    require_cuda()
    for name, a, b in _round_on_card_and_cpu("veds", seed):
        ulps = (a.view(torch.int32).long() - b.view(torch.int32).long()
                ).abs().max()
        assert int(ulps) <= 4, (name, int(ulps))


@pytest.mark.cuda
def test_moe_apply_is_bitwise_deterministic_on_card():
    """One MoE sub-block at granite-moe-1b-a400m's width (32 experts
    top-8, expert d_ff 512, d_model 1024, bf16) on 2 x 512 tokens:
    forward and backward twice from the same inputs give the same bits
    (the combine and the dispatch's backward add each token's slots in
    expert order; no atomics)."""
    require_cuda()
    from repro_torch.configs.registry import get_config
    from repro_torch.models import blocks as B
    from repro_torch.models import engine
    from repro_torch.models.module import (materialize, tree_leaves,
                                           tree_map, tree_unflatten)
    cfg = get_config("granite-moe-1b-a400m").replace(n_rep=1)
    params = materialize(torch.Generator(device="cuda").manual_seed(0),
                         engine.model_decl(cfg, "head"))
    p = tree_map(lambda a: a[0], params["blocks"][1])
    g = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn((2, 512, 1024), generator=g, device="cuda").bfloat16()
    ct = torch.randn(x.shape, generator=g, device="cuda").bfloat16()

    def run():
        leaves = [a.detach().clone().requires_grad_() for a in tree_leaves(p)]
        xx = x.clone().requires_grad_()
        y, aux = B.moe_apply(tree_unflatten(p, leaves), xx, cfg)
        return [y, aux, *torch.autograd.grad(
            (y.float() * ct.float()).sum() + aux, leaves + [xx])]

    first, second = run(), run()
    assert len(first) == 8
    for a, b in zip(first, second):
        assert torch.isfinite(a).all()
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_xlstm_smoke_forward_and_backward_on_card_matches_cpu():
    """xlstm-1.3b's smoke config (mLSTM, mLSTM, sLSTM) in fp32, TF32 off:
    the LM loss and the logits on the card within 2e-2 absolute of the
    CPU's, and each leaf's gradient within 2e-2 of its norm: the whole
    model's tolerance of the CPU tests against the reference
    (`tests/torch_ref_vfl.py MODEL_TOL`), since the mLSTM divides by a
    normaliser that cancels at this init."""
    require_cuda()
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.fl.vfl import lm_loss
    from repro_torch.models import engine
    from repro_torch.models.module import (materialize, tree_leaves,
                                           tree_unflatten)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_smoke_config("xlstm-1.3b").replace(
            param_dtype="float32", compute_dtype="float32")
        params = materialize(torch.Generator().manual_seed(0),
                             engine.model_decl(cfg, "head"))
        batch = lm_batch(torch.Generator().manual_seed(1), 2, 128,
                         cfg.vocab_size)

        def run(dev):
            leaves = [a.to(dev).requires_grad_() for a in tree_leaves(params)]
            b = {k: x.to(dev) for k, x in batch.items()}
            p = tree_unflatten(params, leaves)
            loss = lm_loss(p, b, cfg, "head")
            logits, _ = engine.forward(p, b["tokens"], cfg, tp="head")
            grads = torch.autograd.grad(loss, leaves)
            return loss.detach().cpu(), logits.detach().cpu(), \
                [g.cpu() for g in grads]

        (lc, oc, gc), (lg, og, gg) = run("cpu"), run("cuda")
        assert torch.isfinite(lg) and abs(float(lg - lc)) <= 2e-2
        assert float((og - oc).abs().max()) <= 2e-2
        assert len(gg) == 24
        for a, b in zip(gg, gc):
            assert torch.isfinite(a).all()
            assert float((a - b).norm()) <= 2e-2 * float(b.norm())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
def test_lanegcn_forward_on_card_matches_cpu():
    """LaneGCN at its full width (D 64) on one batch of 128 tracks and 64
    lane nodes: forward and ADE on the card within rtol 1e-5 of the CPU's
    (TF32 off), the forward's entries within 1e-5 of its scale."""
    require_cuda()
    from repro_torch.data.synthetic import make_trajectory_batch
    from repro_torch.models.lanegcn import (init_lanegcn, lanegcn_ade,
                                            lanegcn_apply)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        params = init_lanegcn(torch.Generator().manual_seed(0))
        batch = make_trajectory_batch(torch.Generator().manual_seed(1), 128)
        gp = {k: v.cuda() for k, v in params.items()}
        gb = {k: v.cuda() for k, v in batch.items()}
        out, gout = lanegcn_apply(params, batch), lanegcn_apply(gp, gb)
        scale = float(out.abs().max())
        torch.testing.assert_close(gout.cpu(), out, rtol=1e-5,
                                   atol=1e-5 * scale)
        torch.testing.assert_close(lanegcn_ade(gp, gb).cpu(),
                                   lanegcn_ade(params, batch), rtol=1e-5,
                                   atol=0)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


# ---------------------------------------------------------------------------
# flash_attention and fedavg_agg
# ---------------------------------------------------------------------------

def _qkv(B, T, S, H, KV, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(shape, generator=g, device="cuda").to(dtype)
                 for shape in ((B, T, H, D), (B, S, KV, D), (B, S, KV, D)))


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,H,KV,D,causal,window,off,dtype", [
    (128, 128, 4, 2, 32, True, None, 0, torch.float32),
    (256, 256, 4, 4, 64, True, 64, 0, torch.float32),
    (64, 256, 8, 2, 32, False, None, 0, torch.float32),
    (100, 200, 4, 1, 16, True, None, 100, torch.float32),
    (128, 128, 2, 2, 64, True, None, 0, torch.bfloat16),
    (1000, 1000, 16, 2, 128, True, None, 0, torch.bfloat16),
    (77, 131, 8, 8, 128, True, 50, 54, torch.float32),
    # zamba2's head dim: 3 columns a lane, the third only for lanes < 16
    (256, 256, 4, 4, 80, True, None, 0, torch.bfloat16),
    (100, 150, 4, 2, 80, False, 70, 0, torch.float32),
])
def test_flash_attention_kernel_matches_plain_version(
        T, S, H, KV, D, causal, window, off, dtype):
    """Kernel vs plain version on the card: out within 2e-5 (fp32) or
    2e-2 (bf16; both round the fp32 result to bf16 once), lse within
    1e-4. One launch per call."""
    require_cuda()
    q, k, v = _qkv(2, T, S, H, KV, D, dtype, T + S)
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal,
                                         window=window, q_offset=off)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("T,S,H,KV,D,causal,window,off", [
    (256, 256, 4, 2, 16, True, None, 0),
    (200, 260, 4, 2, 32, False, 90, 0),
    (300, 300, 8, 2, 64, True, 100, 0),
    (256, 256, 4, 4, 80, True, None, 0),
    (333, 333, 8, 4, 128, True, None, 0),
    # ragged T and S, window and q_offset: rows t >= 50 (qpos >= 170 =
    # S - 1 + window) see no key and average v over all S keys
    (77, 131, 8, 8, 80, True, 40, 120),
    # GQA with 8 query heads per KV head, as qwen3
    (256, 256, 16, 2, 128, True, None, 0),
])
def test_flash_attention_bf16_kernel_matches_plain_version(
        T, S, H, KV, D, causal, window, off):
    """The bf16 tensor-core kernel (wgmma, TMA) at every head dim it is
    built for against the plain version on the card: out within atol =
    rtol = 2e-2 (P is rounded to bf16 before P V, and both round the
    output once), lse within 1e-4 (and 1e-5 relative: a row that sees no
    key has lse -1e30). One launch per call, through the bf16 entry
    point."""
    require_cuda()
    q, k, v = _qkv(2, T, S, H, KV, D, torch.bfloat16, T + S + D)
    before = flash_attention_fwd.launches
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   q_offset=off)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert flash_attention_fwd.entry == "flash_attention_fwd_bf16_sm90"
    ref, ref_lse = flash_attention_plain(q, k, v, causal=causal,
                                         window=window, q_offset=off)
    assert bool(torch.isfinite(out).all())
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    if window is not None and off + T > S - 1 + window:
        blind = slice(S - 1 + window - off, T)
        assert bool((ref_lse[:, :, blind] == -1e30).all())
        mean_v = v.float().mean(1).repeat_interleave(H // KV, dim=1)
        torch.testing.assert_close(
            out[:, blind].float(),
            mean_v[:, None].expand_as(out[:, blind]), atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
def test_bf16_runs_the_tensor_core_kernels_and_fp32_the_cuda_core_ones():
    """Dispatch by dtype only: bf16 CUDA tensors reach the sm90 entry
    points, fp32 ones the CUDA-core kernels; one launch each."""
    require_cuda()
    for dtype, fa_entry, ssd_entry in (
            (torch.bfloat16, "flash_attention_fwd_bf16_sm90",
             "ssd_scan_fwd_bf16_sm90"),
            (torch.float32, "flash_attention_fwd_f32", "ssd_scan_fwd_f32")):
        q, k, v = _qkv(1, 64, 64, 2, 1, 64, dtype, 2)
        before = flash_attention_fwd.launches
        flash_attention_fwd(q, k, v)
        assert flash_attention_fwd.launches == before + 1
        assert flash_attention_fwd.entry == fa_entry
        vv, b, c, la = _ssd(1, 64, 2, dtype, 3)
        before = ssd_scan_fwd.launches
        ssd_scan_fwd(vv, b, c, la, 32)
        assert ssd_scan_fwd.launches == before + 1
        assert ssd_scan_fwd.entry == ssd_entry
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_flash_attention_bf16_function_gradients_on_card():
    """The Function with the bf16 kernel forward (whose out and lse the
    backward reads) against autograd through the plain version in float32
    on the same bf16 inputs: within atol = rtol = 2e-2, the forward's
    bf16 tolerance."""
    require_cuda()
    q, k, v = _qkv(2, 160, 160, 8, 2, 80, torch.bfloat16, 6)
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    out = flash_attention(q, k, v, causal=True, window=96, bwd_chunk=64)
    ct = torch.randn(out.shape, device="cuda").bfloat16()
    got = torch.autograd.grad(out, (q, k, v), ct)
    qf, kf, vf = (x.detach().float().requires_grad_() for x in (q, k, v))
    ref, _ = flash_attention_plain(qf, kf, vf, causal=True, window=96)
    want = torch.autograd.grad(ref, (qf, kf, vf), ct.float())
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b, atol=2e-2, rtol=2e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_writes_every_column_at_head_dim_80(dtype):
    """zamba2's head dim, 80, is not a multiple of 32: each lane holds
    three output columns (lane, lane + 32, lane + 64), the third only for
    lanes < 16. Columns 64-79 are the ones a kernel with two columns a lane
    would leave unwritten; the output's memory is filled with NaN before
    the launch (the caching allocator hands the same block back), so an
    unwritten column shows as NaN. Columns 64-79 within 2e-5 (fp32) or
    2e-2 (bf16) of the plain version."""
    require_cuda()
    q, k, v = _qkv(2, 192, 192, 4, 4, 80, dtype, 80)
    torch.full_like(q, float("nan"))            # freed, then reused below
    torch.cuda.synchronize()
    out, _ = flash_attention_fwd(q, k, v, causal=True)
    torch.cuda.synchronize()
    ref, _ = flash_attention_plain(q, k, v, causal=True)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    tail = out[..., 64:].float()
    assert bool(torch.isfinite(tail).all())
    torch.testing.assert_close(tail, ref[..., 64:].float(), atol=tol,
                               rtol=tol)
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)


@pytest.mark.cuda
def test_flash_attention_function_gradients_on_card():
    """The Function (kernel forward, PyTorch-ops backward) against
    autograd through the plain version, both on the card, fp32."""
    require_cuda()
    q, k, v = (x.requires_grad_() for x in
               _qkv(2, 96, 96, 6, 2, 32, torch.float32, 5))
    out = flash_attention(q, k, v, causal=True, bwd_chunk=32)
    ct = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), ct)
    ref, _ = flash_attention_plain(q, k, v, causal=True)
    want = torch.autograd.grad(ref, (q, k, v), ct)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=2e-5, rtol=2e-5)


@pytest.mark.cuda
def test_unembed_of_bf16_on_card_matches_cpu():
    """`layers.unembed` on bf16 inputs, card against CPU: float32 logits
    within 1e-5 of the largest; bf16 gradients from a float32 cotangent
    within one bf16 ulp (or 1e-6 of the largest entry where a sum
    cancels), with at most 1% of the entries differing at all."""
    require_cuda()
    from repro_torch.models import layers as L
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(64, 96, generator=gen).bfloat16()
    w = (0.1 * torch.randn(96, 200, generator=gen)).bfloat16()
    g = torch.randn(64, 200, generator=gen)
    res = []
    for dev in ("cpu", "cuda"):
        xd, wd = (t.to(dev).requires_grad_() for t in (x, w))
        out = L.unembed({"w": wd}, xd)
        assert out.dtype == torch.float32
        res.append((out, *torch.autograd.grad(out, (xd, wd), g.to(dev))))
    for ours, ref in zip(res[1], res[0]):
        ours, ref = ours.float().cpu(), ref.float()
        if ours.shape == (64, 200):
            torch.testing.assert_close(
                ours, ref, atol=1e-5 * float(ref.abs().max()), rtol=0)
            continue
        big = torch.maximum(ours.abs(), ref.abs()).clamp_min(1e-30)
        ulp = torch.exp2(torch.floor(torch.log2(big)) - 7)
        tol = torch.clamp_min(ulp, 1e-6 * float(ref.abs().max()))
        assert bool(((ours - ref).abs() <= tol).all())
        assert float((ours != ref).float().mean()) <= 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("V,L,dtype,dead,offset", [
    (4, 1 << 20, torch.bfloat16, False, 0),
    (4, 1 << 20, torch.float32, False, 0),
    (3, 1001, torch.bfloat16, False, 0),    # ragged L: scalar path
    (4, 4096, torch.float32, True, 0),      # every upload failed
    (4, 4096, torch.bfloat16, False, 1),    # misaligned: scalar path
])
def test_fedavg_agg_kernel_matches_plain_version(V, L, dtype, dead, offset):
    """Kernel vs plain version on the card: fp32 within 2e-5; bf16
    within 2e-2 (the fp32 sums may round to neighbouring bf16 values);
    Sigma w = 0 returns `old` exactly."""
    require_cuda()
    g = torch.Generator(device="cuda").manual_seed(V * L)
    x = torch.randn((V * L + offset,), generator=g, device="cuda").to(
        dtype)[offset:].reshape(V, L)
    old = torch.randn((L,), generator=g, device="cuda").to(dtype)
    w = torch.rand((V,), generator=g, device="cuda") * 3
    if dead:
        w = torch.zeros_like(w)
    before = fedavg_agg.launches
    out = fedavg_agg(x, w, old)
    torch.cuda.synchronize()
    assert fedavg_agg.launches == before + 1
    assert out.dtype == dtype and out.shape == (L,)
    if dead:
        assert torch.equal(out, old)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(out.float(),
                               fedavg_agg_plain(x, w, old).float(),
                               atol=tol, rtol=tol)


@pytest.mark.cuda
def test_new_kernel_wrappers_check_their_inputs():
    require_cuda()
    q, k, v = _qkv(1, 16, 16, 2, 1, 32, torch.float32, 1)
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_fwd(q[..., :24].contiguous(),
                            k[..., :24].contiguous(),
                            v[..., :24].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd(q.transpose(1, 2), k, v)
    with pytest.raises(ValueError, match="must be"):
        flash_attention_fwd(q, k.double(), v)
    x = torch.zeros((2, 8), device="cuda")
    with pytest.raises(ValueError, match="float32"):
        fedavg_agg(x, torch.zeros(2, device="cuda", dtype=torch.float64),
                   x[0])
    with pytest.raises(ValueError, match="contiguous"):
        fedavg_agg(x[:, ::2], torch.zeros(2, device="cuda"), x[0, ::2])


# ---------------------------------------------------------------------------
# ssd_scan
# ---------------------------------------------------------------------------

def _ssd(B, T, H, dtype, seed, decay=1.0):
    """v [B,T,H,64] and b/c [B,T,64] in `dtype`, log_a [B,T,H] =
    -decay * softplus(normal) float32, on the card."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    la = -decay * torch.nn.functional.softplus(rn(B, T, H))
    return (rn(B, T, H, 64).to(dtype), rn(B, T, 64).to(dtype),
            rn(B, T, 64).to(dtype), la)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,chunk,dtype,state0", [
    (2, 512, 4, 128, torch.float32, False),
    (2, 512, 4, 128, torch.bfloat16, False),
    (1, 333, 3, 128, torch.float32, True),    # ragged T: pad path
    (3, 256, 1, 128, torch.float32, False),   # H = 1: the Pallas layout
    (2, 96, 2, 32, torch.bfloat16, True),     # the smoke config's chunk
])
def test_ssd_scan_kernel_matches_plain_version(B, T, H, chunk, dtype,
                                               state0):
    """Kernel vs plain version on the card, y and the final state: fp32
    within atol = rtol = 2e-4 (the kernel's products and cumsum sum in
    other orders over chunks of up to 128 steps), bf16 y within 5e-2
    (both round the fp32 result to bf16 once). The decay of a chunk of 128
    reaches ~100, past where exp overflows above the diagonal. One launch
    per call."""
    require_cuda()
    v, b, c, la = _ssd(B, T, H, dtype, T + H)
    s0 = torch.randn((B, H, 64, 64), device="cuda") if state0 else None
    before = ssd_scan_fwd.launches
    y, s = ssd_scan_fwd(v, b, c, la, chunk, s0)
    torch.cuda.synchronize()
    assert ssd_scan_fwd.launches == before + 1
    assert y.dtype == dtype and y.shape == v.shape
    ry, rs = ssd_scan_plain(v, b, c, la, chunk, s0)
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    assert bool(torch.isfinite(y).all())
    torch.testing.assert_close(y.float(), ry.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(s, rs, atol=2e-4, rtol=2e-4)
    if T <= 333 and dtype == torch.float32:
        ny, ns = ssd_scan_naive(v, b, c, la, s0)
        torch.testing.assert_close(y, ny, atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(s, ns, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,chunk,state0,dt07", [
    (2, 512, 8, 128, False, False),
    (2, 1000, 8, 128, True, False),    # ragged T: pad path
    (2, 256, 8, 32, True, False),      # the smoke config's chunk
    (1, 333, 3, 32, False, False),
    (2, 512, 8, 128, False, True),     # decays of a chunk pass 88
])
def test_ssd_scan_bf16_kernel_matches_plain_version(B, T, H, chunk, state0,
                                                    dt07):
    """The bf16 tensor-core kernel against the plain version on the card:
    y entry by entry within 2^-7 of the plain version's entry plus 1e-3
    of max|y| (both round an fp32 result to bf16 once; the kernel's
    products keep ~16 bits of W, S and the decayed b), the fp32 final state
    within 5e-5 of max|state|. At dt ~ 0.7 (zamba2's init) the exponent
    above the diagonal reaches past exp(88): y stays finite. One launch
    per call, through the bf16 entry point."""
    require_cuda()
    v, b, c, la = _ssd(B, T, H, torch.bfloat16, T + H + chunk)
    if dt07:
        g = torch.Generator(device="cuda").manual_seed(7)
        la = -0.7 * (1.0 + 0.01 * torch.randn((B, T, H), generator=g,
                                              device="cuda"))
        span = -la.reshape(B, T // chunk, chunk, H)[:, :, 1:].sum(2)
        assert bool(torch.isinf(torch.exp(span)).any())
    s0 = torch.randn((B, H, 64, 64), device="cuda") if state0 else None
    before = ssd_scan_fwd.launches
    y, s = ssd_scan_fwd(v, b, c, la, chunk, s0)
    torch.cuda.synchronize()
    assert ssd_scan_fwd.launches == before + 1
    assert ssd_scan_fwd.entry == "ssd_scan_fwd_bf16_sm90"
    assert y.dtype == torch.bfloat16 and y.shape == v.shape
    ry, rs = ssd_scan_plain(v, b, c, la, chunk, s0)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(s).all())
    ys = float(ry.float().abs().max())
    diff = (y.float() - ry.float()).abs()
    assert bool((diff <= 2.0 ** -7 * ry.float().abs() + 1e-3 * ys).all())
    assert float((s - rs).abs().max()) <= 5e-5 * float(rs.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("T,chunk,dtype", [(64, 128, torch.bfloat16),
                                           (24, 32, torch.float32)])
def test_ssd_scan_short_sequence_runs_one_padded_kernel_chunk(T, chunk,
                                                             dtype):
    """T below the chunk: the reference's min(chunk, T) (64, 24) is no
    kernel chunk, so the kernel runs one chunk of `chunk` over the
    sequence padded with steps that change neither y nor the state; held
    to the plain version at min(chunk, T) as the other cases of its
    dtype are."""
    require_cuda()
    v, b, c, la = _ssd(2, T, 8, dtype, 31)
    before = ssd_scan_fwd.launches
    y, s = ssd_scan_fwd(v, b, c, la, chunk)
    torch.cuda.synchronize()
    assert ssd_scan_fwd.launches == before + 1 and y.shape == v.shape
    ry, rs = ssd_scan_plain(v, b, c, la, chunk)
    ys = float(ry.float().abs().max())
    if dtype == torch.bfloat16:
        diff = (y.float() - ry.float()).abs()
        assert bool((diff <= 2.0 ** -7 * ry.float().abs() + 1e-3 * ys).all())
        assert float((s - rs).abs().max()) <= 5e-5 * float(rs.abs().max())
    else:
        torch.testing.assert_close(y, ry, atol=2e-4, rtol=2e-4)
        torch.testing.assert_close(s, rs, atol=2e-4, rtol=2e-4)


@pytest.mark.cuda
def test_ssd_scan_function_gradients_on_card():
    """The Function (kernel forward, backward by autograd through the
    plain version) against autograd through the plain version, both on
    the card, fp32, with cotangents on y and the state: atol = rtol =
    1e-4."""
    require_cuda()
    ins = [x.requires_grad_() for x in _ssd(2, 256, 3, torch.float32, 7,
                                            decay=0.5)]
    y, s = ssd_scan(*ins, 128)
    cy, cs = torch.randn_like(y), torch.randn_like(s)
    got = torch.autograd.grad((y * cy).sum() + (s * cs).sum(), ins)
    ry, rs = ssd_scan_plain(*ins, 128)
    want = torch.autograd.grad((ry * cy).sum() + (rs * cs).sum(), ins)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_ssd_scan_wrapper_checks_its_inputs():
    require_cuda()
    v, b, c, la = _ssd(1, 64, 2, torch.float32, 1)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_scan_fwd(v.transpose(1, 2).contiguous().transpose(1, 2), b, c,
                     la, 32)
    with pytest.raises(ValueError, match="must be"):
        ssd_scan_fwd(v, b.bfloat16(), c, la, 32)
    with pytest.raises(ValueError, match="must be"):
        ssd_scan_fwd(v, b, c, la.double(), 32)
    with pytest.raises(ValueError, match="chunk"):
        ssd_scan_fwd(v, b, c, la, 16)
    with pytest.raises(ValueError, match="N = 64"):
        ssd_scan_fwd(v[..., :32].contiguous(), b, c, la, 32)


# ---------------------------------------------------------------------------
# the scheduling service (`launch/serve.py`) on the card
# ---------------------------------------------------------------------------

SERVE_KW = dict(scheduler="veds", n_sov=4, n_opv=3, n_slots=10, n_fleet=14,
                ipm_iters=8, ipm_warm_iters=4, batch_size=4, max_rounds=2)


def _service(B, **kw):
    from repro_torch.launch.serve import SchedulingService, ServeConfig
    return SchedulingService(ServeConfig(batch=B, **{**SERVE_KW, **kw}),
                             device="cuda")


def _req(session, n_rounds, seed):
    from repro_torch.launch.serve import ServeRequest
    return ServeRequest(session, n_rounds, seed=seed)


def _same_response(a, b):
    assert a.tier == b.tier
    np.testing.assert_array_equal(a.success, b.success)
    np.testing.assert_array_equal(a.n_success, b.n_success)
    np.testing.assert_array_equal(a.loss, b.loss)


def _same_carry(a, b):
    from repro_torch.core.scheduler import zip_tree

    def eq(x, y):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)
    zip_tree(eq, a, b)


def _wave(n, seed0=0):
    return [_req(f"s{i}", 1 + i % 2, seed0 + i) for i in range(n)]


@pytest.mark.cuda
def test_serve_same_dispatch_twice_is_bitwise():
    """Two fresh services given the same dispatches (a second wave
    resuming every session) answer and store the same bits."""
    require_cuda()
    runs = []
    for _ in range(2):
        svc = _service(4)
        runs.append((svc, [svc.run_batch(_wave(4)),
                           svc.run_batch(_wave(4, 10))]))
    (a, ra), (b, rb) = runs
    for wa, wb in zip(ra, rb):
        for x, y in zip(wa, wb):
            _same_response(x, y)
    for s in a.sessions:
        _same_carry(a.sessions[s], b.sessions[s])


@pytest.mark.cuda
def test_serve_cell_is_bitwise_whatever_its_neighbours():
    """A cell's response and stored carry at a given B do not depend on
    the requests packed beside it."""
    require_cuda()
    a, b = _service(4), _service(4)
    ra = a.run_batch(_wave(4))
    rb = b.run_batch([_wave(4)[0]] + [_req(f"n{i}", 2, 100 + i)
                                      for i in range(3)])
    _same_response(ra[0], rb[0])
    _same_carry(a.sessions["s0"], b.sessions["s0"])


@pytest.mark.cuda
def test_serve_packed_and_solo_masks_are_identical():
    """Packed at B 4 against each request alone at B 1 on a fresh
    service, two waves: every success mask and count identical (the
    floats' distance is measured by `chip_smoke.py phase_serve`)."""
    require_cuda()
    svc, solo = _service(4), _service(1)
    for wave in (_wave(4), _wave(4, 10)):
        for p in svc.run_batch(wave):
            r = solo.run_batch([next(q for q in wave
                                     if q.session == p.session)])[0]
            np.testing.assert_array_equal(p.success, r.success)
            np.testing.assert_array_equal(p.n_success, r.n_success)


@pytest.mark.cuda
def test_serve_spill_and_restore_on_card_are_bitwise():
    """A carry with a bf16 leaf spilled to the host and restored comes
    back on the card in its own dtype, bit for bit; a bounded service's
    sessions answer as an unbounded one's after spilling."""
    require_cuda()
    from repro_torch.core.scheduler import RolloutCarry
    from repro_torch.launch.serve import SessionStore
    gen = torch.Generator(device="cuda").manual_seed(3)
    carries = {s: RolloutCarry(
        sched={"t": torch.randn((2, 3), generator=gen, device="cuda")},
        params={"w": torch.randn((1, 4), generator=gen, device="cuda")
                .bfloat16()}, opt_state=None) for s in "abc"}
    store = SessionStore(max_sessions=1, device="cuda")
    for s, c in carries.items():
        store.put(s, c)
    assert store._spilled["a"].params["w"].device.type == "cpu"
    for s, c in carries.items():
        _same_carry(store[s], c)
    bounded, free = _service(2, max_sessions=1), _service(2)
    for seed0 in (0, 10):
        for x, y in zip(bounded.run_batch(_wave(2, seed0)),
                        free.run_batch(_wave(2, seed0))):
            _same_response(x, y)
    assert bounded.metrics.n_spills > 0 and bounded.metrics.n_restores > 0
    for s in free.sessions:
        _same_carry(bounded.sessions[s], free.sessions[s])


@pytest.mark.cuda
def test_serve_load_captures_no_slot_graph_after_warmup():
    """`warmup()` captures one slot graph a rung of the occupancy ladder
    and pins it: more other round shapes than the cache keeps are
    captured next, and then a load that touches every rung captures
    none."""
    require_cuda()
    port_veds._SLOT_GRAPHS.clear()
    svc = _service(4, tiers=(1, 2), n_slots=7)
    svc.warmup()
    assert svc.warmup_captures == len(svc.cfg.occupancies) == 3
    prm, ch = VedsParams(), ChannelParams()
    for T in range(1, port_veds._MAX_SLOT_GRAPHS + 3):
        port_veds.veds_round(_rounds(4, 3, T, B=1, seed=T), prm, ch)
    n0 = port_veds._SlotGraph.captures
    for n in (1, 2, 3, 4):
        svc.run_batch([_req(f"s{i}", 1 + i % 2, 20 * n + i)
                       for i in range(n)])
    assert port_veds._SlotGraph.captures == n0
    assert svc.metrics.n_captures == 0
    assert set(svc.metrics.tier_hits) >= {"L1xB1", "L2xB2", "L2xB4"}
    svc.close()


@pytest.mark.cuda
def test_serve_batch_server_on_card_runs_dispatches_on_one_thread():
    """After `warmup()`, a closed-loop load through `BatchServer` captures
    no slot graph, runs every `run_batch` on one thread that is not the
    event loop's, and the server's own dispatch log, replayed through
    `run_batch` on a fresh service, gives every response and every stored
    carry bit for bit."""
    require_cuda()
    import asyncio
    import threading
    from repro_torch.launch.serve import BatchServer, closed_loop_load
    svc = _service(4, tiers=(1, 2))
    svc.warmup()
    log, real = [], svc.run_batch

    def logged(reqs):
        out = real(reqs)
        log.append((threading.get_ident(), list(reqs), out))
        return out

    svc.run_batch = logged
    n0 = port_veds._SlotGraph.captures
    loop_threads = []

    async def go():
        loop_threads.append(threading.get_ident())
        async with BatchServer(svc, window_s=0.01) as srv:
            return await closed_loop_load(srv, n_clients=6, n_requests=3,
                                          n_rounds=(1, 2), seed=5)

    got = asyncio.run(go())
    assert port_veds._SlotGraph.captures == n0
    assert svc.metrics.n_captures == 0
    threads = {t for t, _, _ in log}
    assert len(threads) == 1 and loop_threads[0] not in threads
    assert len(got) == 18 == sum(len(reqs) for _, reqs, _ in log)
    fresh = _service(4, tiers=(1, 2))
    fresh.warmup()
    for _, reqs, resps in log:
        for a, b in zip(fresh.run_batch(reqs), resps):
            _same_response(a, b)
    assert set(fresh.sessions) == set(svc.sessions)
    for s in svc.sessions:
        _same_carry(fresh.sessions[s], svc.sessions[s])
    svc.close()
    fresh.close()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("fused", "veds", "port"),
                                  ("stream", "madca", "port")],
                         ids="-".join)
def test_mesh_on_one_rank_nccl_world_is_the_one_device_loop(case, tmp_path):
    """`mesh_fused_rollout` / `mesh_stream_rounds` with handoff at
    `tests/test_mesh_exec.py`'s setting on a one-rank NCCL world: the
    collectives run (the exchange's all-gathers, `gather_result`) and
    the result is the one-device loop's bit for bit."""
    import torch.distributed as dist
    import torch_mesh_cases as C
    from repro_torch.launch.mesh import init_world
    from repro_torch.sharding import mesh_exec
    require_cuda()
    rng = np.random.default_rng(0)
    inp = {"params": {"w": torch.zeros(6, 3)},
           "data": [{"x": rng.standard_normal((5 + 3 * (i % 3), 6))
                     .astype(np.float32),
                     "y": rng.integers(0, 3, 5 + 3 * (i % 3))}
                    for i in range(8)],
           "sel": torch.as_tensor(rng.integers(0, 8, (C.R, C.B, 4))),
           "mb_u": torch.as_tensor(rng.random((C.R, C.B, 4, 4)),
                                   dtype=torch.float32)}
    init_world(0, 1, str(tmp_path / "store"), "cuda")
    try:
        assert dist.get_backend() == "nccl"
        got = C.run_one(inp, case, mesh_exec.fleet_mesh(1), device="cuda")
        one = C.run_one(inp, case, device="cuda")
    finally:
        dist.destroy_process_group()
    for f in dataclasses.fields(one.fleet):
        assert torch.equal(getattr(got.fleet, f.name),
                           getattr(one.fleet, f.name)), f.name
    for k in one.outputs.keys():
        assert torch.equal(got.outputs[k], one.outputs[k]), k
    if case[0] == "fused":
        assert torch.equal(got.params["w"], one.params["w"])
        assert torch.equal(got.loss, one.loss)


@pytest.mark.cuda
@pytest.mark.parametrize("run", [
    "qwen3-32b", "zamba2-2.7b", "xlstm-1.3b", "granite-moe-1b-a400m",
    "whisper-small+enc1", "llama4-scout-17b-a16e", "llama-3.2-vision-90b",
    "qwen3-32b+swa"])
def test_decode_step_on_card_matches_cpu(run, monkeypatch):
    """`decode_step` over a smoke config in fp32 as `chip_smoke.py
    phase_decode_reference` runs it (`smoke_decode`; qwen3's forced ring
    over 80 tokens, so that it wraps; whisper's and vlm's cross slots
    from `build_cross_cache`), card against CPU within 1e-3 of the
    largest logit (`tests/test_torch_decode.py`'s bound against the
    reference); on the card the prefill (through the fp32 kernels)
    against the decode within `tests/test_decode_consistency.py`'s
    bound. whisper at one encoder layer: at its smoke depth its encoder
    is chaotic at the init (the CPU's own logits move by 1.6e-3 under a
    half-ulp change of the weights), as `tests/test_torch_encdec.py`
    holds its VFL round at one encoder layer."""
    from pathlib import Path
    from repro_torch.models import engine
    from repro_torch.models.module import materialize
    require_cuda()
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    tol, cpu_tol = chip_smoke.DECODE_SMOKE[run]
    cfg, _, _ = chip_smoke.smoke_decode_config(run)
    params = materialize(torch.Generator().manual_seed(0),
                         engine.model_decl(cfg, "head"))
    cpu, _ = chip_smoke.smoke_decode(run, "cpu", params)
    dec, prefill = chip_smoke.smoke_decode(run, "cuda", params)
    scale = float(cpu.abs().max())
    assert bool(torch.isfinite(dec).all())
    torch.testing.assert_close(dec, cpu, atol=cpu_tol * scale, rtol=0)
    rel = float((dec - prefill).abs().max()) / float(prefill.abs().max())
    assert rel < tol, f"{run}: prefill/decode rel={rel}"


@pytest.mark.cuda
def test_decode_step_appends_in_place_without_host_sync():
    """One bf16 step of the qwen3 smoke config on the card: the K/V cache
    leaves keep their storage (the new row is written in place, not the
    cache copied), the row at `pos` is written, and the step makes no
    host sync (it runs under `torch.cuda.set_sync_debug_mode("error")`);
    a zamba2 step (Mamba2 states, the tied attention) too."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import engine
    from repro_torch.models.module import materialize, tree_leaves
    require_cuda()
    for arch in ("qwen3-32b", "zamba2-2.7b", "granite-moe-1b-a400m"):
        cfg = get_smoke_config(arch)
        params = materialize(torch.Generator(device="cuda").manual_seed(0),
                             engine.model_decl(cfg, "head"))
        cache = engine.zero_cache(engine.cache_decl(cfg, 2, 32), "cuda")
        toks = torch.randint(0, cfg.vocab_size, (3, 2), device="cuda")
        pos = [torch.tensor(t, device="cuda") for t in range(3)]
        ptrs = [a.data_ptr() for a in tree_leaves(cache)]
        with torch.no_grad():
            engine.decode_step(params, cache, toks[0], pos[0], cfg, None,
                               tp="head")
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                for t in (1, 2):
                    logits, out = engine.decode_step(
                        params, cache, toks[t], pos[t], cfg, None,
                        tp="head")
            finally:
                torch.cuda.set_sync_debug_mode("default")
        assert out is cache
        assert [a.data_ptr() for a in tree_leaves(cache)] == ptrs
        attn = cfg.pattern.index("attn")
        k = cache[attn]["k"]
        assert bool(k[:, :, :3].abs().amax(dim=(0, 1, 3, 4)).gt(0).all())
        assert not bool(k[:, :, 3:].any())
        assert bool(torch.isfinite(logits).all())


@pytest.mark.cuda
def test_model_axis_on_two_ranks_of_one_card_matches_one_rank(tmp_path):
    """qwen3's smoke config in fp32 split over a (1, 2) mesh of two ranks
    on the one card (gloo, `run_world(shared_card=True)`): `forward`'s
    logits and 4 decode steps from a sequence-sharded cache within 1e-4
    of max|logit| of the one-rank path on the card, argmax equal."""
    require_cuda()
    import torch_model_axis_cases as MC
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.mesh import run_world
    from repro_torch.models import engine
    from repro_torch.models.module import materialize
    dev = torch.device("cuda", 0)
    cfg = get_smoke_config("qwen3-32b").replace(
        param_dtype="float32", compute_dtype="float32", remat=False,
        attn_chunk=16)
    params = materialize(torch.Generator(device=dev).manual_seed(0),
                         engine.model_decl(cfg, "head"))
    toks = torch.randint(0, cfg.vocab_size, (2, 24), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    case = dict(kind="model", cfg=cfg, tp="head", params=params,
                tokens=toks, src=None, cache_len=24, steps=4)
    one = MC.model(None, case)
    path, res = str(tmp_path / "in.pt"), str(tmp_path / "out{rank}.pt")
    torch.save({"model": case}, path)
    run_world(MC.rank_main, 2, path, res, device="cuda", shared_card=True,
              timeout_s=300)
    for r in range(2):
        got = torch.load(res.format(rank=r), weights_only=False)["model"]
        for k in ("logits", "decode"):
            scale = float(one[k].abs().max())
            assert float((got[k] - one[k]).abs().max()) <= 1e-4 * scale
            assert torch.equal(got[k].argmax(-1), one[k].argmax(-1))
