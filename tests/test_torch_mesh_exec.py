"""The port's mesh execution (`repro_torch.sharding.mesh_exec`) on gloo
worlds of 2 and 4 CPU processes, against the port on one process and
against the reference's `mesh_fused_rollout` / `mesh_stream_rounds` on
`fleet_mesh(1)`.

The setting is `tests/test_mesh_exec.py`'s: R 4 rounds of B 8 cells,
S 4, U 3, T 10, persistent fleets with carried queues and handoff on
the `rsu_grid`, its linear-softmax problem. Each world runs every case
of `torch_mesh_cases.CASES` (fused `madca` and `veds`, the handoff
stream) on the port's draws and on the reference's, and gathers the
results; spawning a world costs a few seconds, so the cases share one.

Tolerances: success masks, decisions, `cell_id`, `covered` and every
fleet field bit for bit between N ranks and one process (the cells'
work is the same; the exchange is the one-device permutation on the
all-gathered fleet); params and losses within rtol 2e-5 / atol 1e-6,
the reference's own 1-vs-8-device bound. Against the reference (fp32
on both sides, reductions in other orders): decisions and `cell_id`
identical, positions within 1e-4 m, losses and params within rtol 1e-4
(`tests/test_torch_fused.py`'s bound).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as C
import torch_ref_draws as RD
from repro.channel.mobility import ManhattanParams as JManhattan
from repro.channel.v2x import ChannelParams as JChannel
from repro.core import scenario as jscn
from repro.core.baselines import get_scheduler as j_get
from repro.core.lyapunov import VedsParams as JVeds
from repro.core.streaming import StreamConfig as JStreamConfig
from repro.core.streaming import round_keys as j_round_keys
from repro.fl.engine import ClientShards as JShards
from repro.fl.engine import init_carry as j_init_carry
from repro.sharding import mesh_exec as jmx
from repro_torch.core import scenario as scn
from repro_torch.core.scheduler import map_tree
from repro_torch.core.streaming import StreamResult
from repro_torch.launch.mesh import init_world, make_host_mesh, run_world
from repro_torch.sharding import mesh_exec
from repro_torch.sharding.rules import mesh_shape
from torch_port_util import tn

JMOB, JCH = JManhattan(v_max=10.0), JChannel()
JPRM = JVeds(alpha=2.0, V=0.2, Q=1e7, slot=0.1)
JSC = jscn.ScenarioParams(n_sov=4, n_opv=3, n_slots=10)
JCFG = JStreamConfig(n_rounds=C.R, batch=C.B, fresh_fleet=False,
                     carry_queues=True, handoff=True)
KEY = jax.random.key(0)
DECISIONS = ("success", "n_success", "n_cot_slots", "n_dt_slots")
WORLDS = (2, 4)
WORLD_TIMEOUT_S = 240


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jloss(p, b):
    return -jnp.mean(jax.nn.log_softmax(b["x"] @ p["w"])[
        jnp.arange(b["y"].shape[0]), b["y"]])


@pytest.fixture(scope="module")
def problem():
    """`tests/test_mesh_exec.py`'s problem, sel and mb_u, and the
    reference's draws of its key, as the reference and the port take
    them."""
    ks = jax.random.split(jax.random.key(1), 8 + 1)
    protos = jax.random.normal(ks[-1], (3, 6))
    data = []
    for i in range(8):
        n = 5 + 3 * (i % 3)
        y = jax.random.randint(ks[i], (n,), 0, 3)
        x = protos[y] + 0.5 * jax.random.normal(jax.random.fold_in(ks[i], 1),
                                                (n, 6))
        data.append({"x": x, "y": y})
    sel = jax.random.randint(jax.random.key(2), (C.R, C.B, C.SC.n_sov), 0, 8)
    mb_u = jax.random.uniform(jax.random.key(3), (C.R, C.B, C.SC.n_sov, 4))
    N = 2 * (C.SC.n_sov + C.SC.n_opv)
    inp = {"params": {"w": torch.zeros(6, 3)},
           "data": [{"x": np.asarray(d["x"]),
                     "y": np.asarray(d["y"], np.int64)} for d in data],
           "sel": torch.as_tensor(np.asarray(sel, np.int64)),
           "mb_u": torch.as_tensor(np.array(mb_u)),
           "ref_fleet": RD.init_fleet(jax.random.fold_in(KEY, 0xF1EE7), JSC,
                                      JMOB, C.B),
           "ref_rounds": [RD.fleet_round(k, JSC, C.B, N)
                          for k in jax.random.split(KEY, C.R)]}
    jdata = {"data": JShards.from_ragged(data), "sel": sel, "mb_u": mb_u}
    return inp, jdata


@pytest.fixture(scope="module")
def runs(problem, tmp_path_factory):
    """Every case on one process and on worlds of 2 and 4 ranks."""
    inp, _ = problem
    tmp = tmp_path_factory.mktemp("mesh")
    path = str(tmp / "inputs.pt")
    torch.save(inp, path)
    out = {1: {case: C.run_one(inp, case) for case in C.CASES}}
    for n in WORLDS:
        res = str(tmp / f"world{n}.pt")
        run_world(C.rank_main, n, path, res, device="cpu", threads=1,
                  timeout_s=WORLD_TIMEOUT_S, store_dir=str(tmp))
        out[n] = torch.load(res, weights_only=False)
    return out


@pytest.fixture(scope="module")
def reference(problem):
    """The reference's `mesh_fused_rollout` (madca, veds) and
    `mesh_stream_rounds` on `fleet_mesh(1)`."""
    _, jd = problem
    mesh = jmx.fleet_mesh(1)
    keys = j_round_keys(KEY, JCFG, C.R)
    out = {}
    for name in ("madca", "veds"):
        carry = j_init_carry(KEY, JSC, JMOB, JCFG, {"w": jnp.zeros((6, 3))},
                             ch=JCH)
        out[("fused", name, "ref")] = jmx.mesh_fused_rollout(
            mesh, keys, jd["sel"], jd["mb_u"], j_get(name), JSC, JMOB, JCH,
            JPRM, JCFG, _jloss, jd["data"], carry, lr=C.LR)
    out[("stream", "madca", "ref")] = jmx.mesh_stream_rounds(
        mesh, KEY, j_get("madca"), JSC, JMOB, JCH, JPRM, JCFG)
    return out


def _assert_fleet_equal(a, b):
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name


def _assert_same_run(ours, one):
    """N ranks against one process: decisions and the fleet bit for bit,
    params and losses within the reference's 1-vs-8 bound."""
    for k in DECISIONS:
        assert torch.equal(ours.outputs[k], one.outputs[k]), k
    _assert_fleet_equal(ours.fleet, one.fleet)
    if isinstance(one, StreamResult):
        for k in ("zeta", "energy_sov", "energy_opv"):
            assert torch.equal(ours.outputs[k], one.outputs[k]), k
        return
    torch.testing.assert_close(ours.params["w"], one.params["w"], rtol=2e-5,
                               atol=1e-6)
    torch.testing.assert_close(ours.loss, one.loss, rtol=2e-5, atol=1e-6)


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("case", C.CASES, ids="-".join)
def test_mesh_run_matches_one_process(problem, runs, n, case):
    """The tentpole contract: splitting the cells over n ranks changes
    where they run, not what they compute."""
    ours, one = runs[n][case], runs[1][case]
    assert ours.outputs.success.shape == (C.R, C.B, C.SC.n_sov)
    assert ours.fleet.pos.shape[0] == C.B and ours.fleet.rsu_xy.shape[0] \
        == C.B
    _assert_same_run(ours, one)
    if case[0] == "fused":
        assert ours.params["w"].shape == (C.B, 6, 3)
        assert ours.carry.qs.shape == (C.B, C.SC.n_sov)
    # handoff moved vehicles between the ranks' blocks (a vehicle is
    # known by its persistent jitter)
    j0 = tn(C._setup(problem[0], case[2])[1].sched.jitter)
    j1 = tn(ours.fleet.jitter)
    rank_of = {float(t): b // (C.B // n) for b in range(C.B) for t in j1[b]}
    assert any(rank_of[float(t)] != b // (C.B // n)
               for b in range(C.B) for t in j0[b])


@pytest.mark.parametrize("case", (C.CASES[0], C.CASES[2]), ids="-".join)
def test_mesh_run_on_a_data_by_model_mesh_matches_one_process(runs, case):
    """On a (2, 2) ("data", "model") mesh of 4 ranks the rollout's
    collectives run over the data group of each model coordinate: each
    pair of ranks holds the cells, and the run is one process's."""
    _assert_same_run(runs[4][("2x2",) + case], runs[1][case])


@pytest.mark.parametrize("case", [c for c in C.CASES if c[2] == "ref"],
                         ids="-".join)
def test_mesh_run_on_reference_draws_matches_reference(runs, reference,
                                                       case):
    """Each world's run on the reference's draws against the reference's
    mesh run on one device."""
    ref = reference[case]
    for n in WORLDS:
        ours = runs[n][case]
        for k in DECISIONS:
            np.testing.assert_array_equal(tn(ours.outputs[k]),
                                          np.asarray(ref.outputs[k]),
                                          err_msg=k)
        for f in ("cell_id", "covered", "dir", "jitter", "allowance",
                  "rsu_xy"):
            np.testing.assert_array_equal(tn(getattr(ours.fleet, f)),
                                          np.asarray(getattr(ref.fleet, f)),
                                          err_msg=f)
        np.testing.assert_allclose(tn(ours.fleet.pos),
                                   np.asarray(ref.fleet.pos), rtol=0,
                                   atol=1e-4)
        if case[0] == "fused":
            np.testing.assert_allclose(tn(ours.loss), np.asarray(ref.loss),
                                       rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(tn(ours.params["w"]),
                                       np.asarray(ref.params["w"]),
                                       rtol=1e-4, atol=1e-6)
    assert int(tn(ref.outputs.n_success).sum()) > 0


def test_bf16_state_on_4_ranks_keeps_fp32_masks(runs):
    """The levers compose: bf16 storage of the P4 table and optimizer
    state on 4 ranks keeps the one-process fp32 masks, and the returned
    state is promoted back to fp32."""
    b16, f32 = runs[4]["bf16"], runs[1][C.CASES[0]]
    assert torch.equal(b16.outputs.success, f32.outputs.success)
    assert b16.fleet.pos.dtype == torch.float32
    assert b16.fleet.p4_tab.dtype == torch.float32


@pytest.mark.parametrize("n", WORLDS)
def test_uneven_batch_is_rejected_up_front(runs, n):
    """The reference's message, on the mesh and without a world."""
    assert "shard evenly" in runs[n]["uneven"]
    mesh_exec.check_batch_divisible({"data": n}, 2 * n)
    with pytest.raises(ValueError) as e:
        mesh_exec.check_batch_divisible({"data": n}, n + 1)
    assert str(e.value) == (
        f"batch={n + 1} cells cannot shard evenly over the {n}-device data "
        f"axes ('data',) of the mesh (NamedSharding rejects uneven shards); "
        f"pick batch as a multiple of the device count")


def _assert_rows(blk, whole, lo, hi):
    """A block's RoundInputs against rows [lo, hi) of the whole batch's:
    masks bit for bit, floats to rtol 1e-5 (on the CPU ATen's vectorized
    body and scalar tail of exp/log10/pow part by ulps between batch
    sizes; the draws themselves are held bit for bit)."""
    for f in dataclasses.fields(whole):
        a, b = getattr(blk, f.name), getattr(whole, f.name)[lo:hi]
        if a.is_floating_point():
            torch.testing.assert_close(a, b, rtol=1e-5, atol=0)
        else:
            assert torch.equal(a, b), f.name


def _assert_draws_equal(a, b, path=()):
    assert a.keys() == b.keys(), path
    for k in a:
        if isinstance(a[k], dict):
            _assert_draws_equal(a[k], b[k], path + (k,))
        else:
            assert torch.equal(a[k], b[k]), path + (k,)


@pytest.mark.parametrize("draws", ["int", "ref"])
def test_block_draws_are_the_one_device_rows(problem, draws):
    """`block_keys` gives a block of cells bit for bit the draws one
    device gives them, and `fleet_round` on the block's fleet rows (and
    in fresh-fleet mode `make_round_batch`) builds the block's rows of
    the whole batch's round."""
    inp, _ = problem
    fleet = C._fleet(inp)
    N = fleet.n_vehicles
    key = 1234 if draws == "int" else inp["ref_rounds"][0]
    draw = mesh_exec.batch_draws(C.SC, C.MOB, C.CFG, N, "cpu")
    full = scn._fleet_round_draws_of(key, C.SC, C.B, N, "cpu")
    if draws == "int":
        _assert_draws_equal(draw(key), full)
    _, rnd, sel = scn.fleet_round(key, fleet, C.SC, C.MOB, C.CH, C.PRM,
                                  handoff=True)
    for lo, hi in ((0, 2), (2, 6), (6, 8)):
        blk = mesh_exec.block_keys([key], lo, hi, draw)[0]
        _assert_draws_equal(blk, mesh_exec.cell_rows(full, lo, hi))
        part = map_tree(lambda x: x[lo:hi], fleet)
        _, r_b, s_b = scn.fleet_round(blk, part, C.SC, C.MOB, C.CH, C.PRM,
                                      handoff=True)
        assert torch.equal(s_b.sov_idx, sel.sov_idx[lo:hi])
        assert torch.equal(s_b.opv_idx, sel.opv_idx[lo:hi])
        _assert_rows(r_b, rnd, lo, hi)
    assert mesh_exec.block_keys([list(range(C.B))], 2, 6, draw) == \
        [[2, 3, 4, 5]]
    if draws == "int":
        fresh = dataclasses.replace(C.CFG, fresh_fleet=True, handoff=False)
        whole = scn.make_round_batch(99, C.SC, C.MOB, C.CH, C.PRM, C.B,
                                     device="cpu")
        blk = mesh_exec.block_keys(
            [99], 4, 8, mesh_exec.batch_draws(C.SC, C.MOB, fresh, 0,
                                              "cpu"))[0]
        _assert_rows(scn.make_round_batch(blk, C.SC, C.MOB, C.CH, C.PRM, 4),
                     whole, 4, 8)


def test_one_rank_world_is_bit_for_bit_the_one_device_loop(problem,
                                                           tmp_path):
    """At world size 1 the collectives still run (the all-gathered
    exchange, `gather_result`) and change nothing: bit for bit the
    one-device `fused_rollout`, floats included."""
    import torch.distributed as dist
    inp, _ = problem
    init_world(0, 1, str(tmp_path / "store"), "cpu")
    try:
        mesh = mesh_exec.fleet_mesh(1)
        case = C.CASES[0]
        ours = C.run_one(inp, case, mesh)
        one = C.run_one(inp, case)
        _assert_fleet_equal(ours.fleet, one.fleet)
        for k in DECISIONS + ("zeta",):
            assert torch.equal(ours.outputs[k], one.outputs[k]), k
        assert torch.equal(ours.params["w"], one.params["w"])
        assert torch.equal(ours.loss, one.loss)
        with pytest.raises(ValueError, match="world has 1"):
            mesh_exec.fleet_mesh(2)
        # a ("data", "model") mesh of (1, 1): the data group of the
        # rank's model coordinate, the same run bit for bit
        grid = make_host_mesh(1)
        assert mesh_shape(grid) == {"data": 1, "model": 1}
        for case in (C.CASES[0], C.CASES[2]):
            two_d, one = C.run_one(inp, case, grid), C.run_one(inp, case)
            _assert_fleet_equal(two_d.fleet, one.fleet)
            for k in DECISIONS + ("zeta",):
                assert torch.equal(two_d.outputs[k], one.outputs[k]), k
    finally:
        dist.destroy_process_group()
