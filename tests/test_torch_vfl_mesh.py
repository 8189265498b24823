"""The VFL round over a vehicle mesh axis (`fl/vfl.py`) on a gloo world
of V = 2 ranks against the port's one-process round and against the
reference's shard_map round on a (2, 1) ("data", "model") mesh of two
forced CPU devices (a subprocess), and the training driver's `--devices`
(`launch/train.py`, spawned and under `torchrun`), at qwen3-32b's smoke
config in fp32, on the reference's parameters and batches.

Each rank holds one vehicle and aggregates with two all-reduces, as the
reference's shard_map body psums; the one-process round aggregates the
stacked vehicles with `fedavg_agg`. Every rank's result is checked.
Tolerances are `tests/test_torch_vfl.py`'s: the aggregated parameters
within 2e-4 absolute (sums in other orders); the all-failed round keeps
the old parameters exactly.
"""
import os
import re
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

import torch_mesh_cases as C
from repro.configs.registry import get_smoke_config as j_get_smoke_config
from repro.data.synthetic import lm_batch as j_lm_batch
from repro.models import engine as jengine
from repro.models.module import materialize as j_materialize
from repro_torch.channel.mobility import ManhattanParams
from repro_torch.channel.v2x import ChannelParams
from repro_torch.checkpoint import load_checkpoint
from repro_torch.configs.registry import get_smoke_config
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scenario import ScenarioParams
from repro_torch.core.streaming import StreamConfig
from repro_torch.data.synthetic import lm_batch
from repro_torch.fl import vfl
from repro_torch.launch import train as train_mod
from repro_torch.launch.mesh import run_world
from repro_torch.models import engine
from repro_torch.models.module import materialize, tree_leaves, tree_map

V, BPV, SEQ, LR, ATOL = 2, 2, 32, 0.1, 2e-4
# the whole-run step: 2 rounds of one cell's VEDS schedule (S = V)
STREAM_R = 2
STREAM_KW = dict(
    veds_prm=VedsParams(Q=2e7, slot=0.1), ch_prm=ChannelParams(),
    stream=StreamConfig(n_rounds=STREAM_R, carry_queues=True),
    sc=ScenarioParams(n_sov=V, n_opv=2, n_slots=10), mob=ManhattanParams())
MASKS = (([1., 1.], [1., 2.]), ([0., 1.], [1., 1.]), ([0., 0.], [1., 1.]))
CASES = tuple((torch.tensor(m), torch.tensor(w)) for m, w in MASKS)
F32 = dict(param_dtype="float32", compute_dtype="float32", num_vehicles=V,
           grad_accum=2)

# the reference's round on a (V, 1) ("data", "model") mesh of V forced CPU
# devices, on the parameters and batches of jax keys 0 and 1; its leaves
# in `jax.tree.leaves` order, one file entry per case and leaf
_REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=%(V)d"
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs.registry import get_smoke_config
    from repro.data.synthetic import lm_batch
    from repro.fl.vfl import make_vfl_round
    from repro.models import engine
    from repro.models.module import materialize
    V, BPV, SEQ, LR = %(V)d, %(BPV)d, %(SEQ)d, %(LR)r
    cfg = get_smoke_config("qwen3-32b").replace(**%(F32)r)
    jp = materialize(jax.random.key(0), engine.model_decl(cfg, "head"))
    params_v = jax.tree.map(
        lambda x: jnp.broadcast_to(x[None], (V,) + x.shape), jp)
    batch = lm_batch(jax.random.key(1), V * BPV, SEQ, cfg.vocab_size)
    batch_v = jax.tree.map(lambda x: x.reshape(V, BPV, *x.shape[1:]),
                           batch)
    mesh = jax.make_mesh((V, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    out = {}
    with jax.set_mesh(mesh):
        fn = jax.jit(make_vfl_round(cfg, mesh, "head", lr=LR))
        for i, (m, w) in enumerate(%(MASKS)r):
            res = fn(params_v, batch_v, jnp.array(m), jnp.array(w))
            for j, leaf in enumerate(jax.tree.leaves(res)):
                out[f"{i}/{j}"] = np.asarray(leaf)
    np.savez(sys.argv[1], **out)
""")


def _start_reference(path):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    src = _REFERENCE % dict(V=V, BPV=BPV, SEQ=SEQ, LR=LR, F32=F32,
                            MASKS=MASKS)
    return subprocess.Popen([sys.executable, "-c", src, path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


@pytest.fixture(scope="module")
def rounds(tmp_path_factory):
    """The three rounds on 2 ranks (every rank's result), on one process
    and on the reference's 2-device mesh (run beside the ranks)."""
    tmp = tmp_path_factory.mktemp("vfl")
    ref_path = str(tmp / "reference.npz")
    proc = _start_reference(ref_path)
    jcfg = j_get_smoke_config("qwen3-32b").replace(**F32)
    cfg = get_smoke_config("qwen3-32b").replace(**F32)
    jp = j_materialize(jax.random.key(0), jengine.model_decl(jcfg, "head"))
    params = engine.llm_params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    b = j_lm_batch(jax.random.key(1), V * BPV, SEQ, jcfg.vocab_size)
    batch_v = {k: torch.as_tensor(np.array(x), dtype=torch.int64).reshape(
        V, BPV, *x.shape[1:]) for k, x in b.items()}
    b = lm_batch(torch.Generator().manual_seed(2), STREAM_R * V * BPV, SEQ,
                 cfg.vocab_size)
    stream = dict(kw=STREAM_KW, seed=3, batches_v={
        k: x.reshape(STREAM_R, V, BPV, *x.shape[1:]) for k, x in b.items()})
    path = str(tmp / "inputs.pt")
    res = str(tmp / "out{rank}.pt")
    torch.save(dict(cfg=cfg, params=params, batch_v=batch_v, lr=LR,
                    cases=CASES, stream=stream), path)
    try:
        run_world(C.vfl_rank_main, V, path, res, device="cpu", threads=1,
                  timeout_s=240, store_dir=str(tmp))
        one = vfl.make_vfl_round(cfg, None, "head", lr=LR)
        stacked = tree_map(lambda x: x.unsqueeze(0).expand(V, *x.shape),
                           params)
        run = vfl.make_train_step(cfg, None, "head", lr=LR, **STREAM_KW)
        one_out = ([one(stacked, batch_v, m, w) for m, w in CASES]
                   + [run(stacked, stream["batches_v"], torch.ones(V), 3)])
        log, _ = proc.communicate(timeout=240)
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, log[-3000:]
    with np.load(ref_path) as f:
        ref = [[f[f"{i}/{j}"] for j in range(len(tree_leaves(params)))]
               for i in range(len(CASES))]
    mesh_out = [torch.load(res.format(rank=r), weights_only=False)
                for r in range(V)]
    return params, mesh_out, one_out, ref


@pytest.mark.parametrize("i", range(len(CASES)))
def test_vfl_round_on_two_ranks_matches_one_process(rounds, i):
    """Masks [1, 1], [0, 1] (weights [1, 2], [1, 1]) and all failed, on
    every rank: against the one-process round's vehicle and the
    reference's shard_map round's vehicle on its 2-device mesh."""
    params, mesh_out, one_out, ref = rounds
    assert len(tree_leaves(params)) == len(ref[i]) == 14
    for r in range(V):
        ours = tree_leaves(mesh_out[r][i])
        for a, b, c in zip(ours, tree_leaves(one_out[i]), ref[i]):
            assert a.shape[0] == 1
            np.testing.assert_allclose(a[0].numpy(), b[r].numpy(),
                                       atol=ATOL, rtol=0)
            np.testing.assert_allclose(a[0].numpy(), c[r], atol=ATOL,
                                       rtol=0)
        if not CASES[i][0].any():         # all failed: the old params
            for a, p in zip(ours, tree_leaves(params)):
                assert torch.equal(a[0], p)
        else:
            assert any(not torch.equal(a[0], p) for a, p in
                       zip(ours, tree_leaves(params)))


def test_whole_run_step_on_two_ranks_matches_one_process(rounds):
    """`make_train_step(mesh, stream=...)`: every rank schedules the same
    run and takes cell 0's masks; each rank's params as the one-process
    run's."""
    _, mesh_out, one_out, _ = rounds
    one, s_one = one_out[-1]
    assert s_one["mask"].shape == (STREAM_R, V) and s_one["mask"].any()
    for r in range(V):
        ours, s_ours = mesh_out[r][-1]
        assert torch.equal(s_ours["mask"], s_one["mask"])
        assert torch.equal(s_ours["n_success"], s_one["n_success"])
        for a, b in zip(tree_leaves(ours), tree_leaves(one)):
            np.testing.assert_allclose(a[0].numpy(), b[r].numpy(),
                                       atol=ATOL, rtol=0)


def test_vehicle_axes_follow_the_reference_rule():
    assert vfl.vehicle_axes(None, 4) == ()
    assert vfl.vehicle_axes({"data": 4, "model": 1}, 1) == ()
    assert vfl.vehicle_axes({"data": 4, "model": 1}, 4) == ("data",)
    assert vfl.vehicle_axes({"pod": 2, "data": 4}, 2) == ("pod",)
    assert vfl.vehicle_axes({"pod": 2, "data": 4}, 8) == ("pod", "data")
    with pytest.raises(ValueError, match="incompatible"):
        vfl.vehicle_axes({"data": 4, "model": 1}, 3)
    # a model axis beside them splits each vehicle's model
    assert vfl.vehicle_axes({"data": 4, "model": 2}, 4) == ("data",)
    assert vfl.vehicle_axes({"data": 2, "model": 2}, 1) == ()


TRAIN_ARGV = ["--device", "cpu", "--vehicles", "2", "--rounds", "2",
              "--batch-per-vehicle", "2", "--seq", "32"]


def _losses(out):
    return [float(x) for x in re.findall(r"loss=(\S+)", out)]


@pytest.fixture(scope="module")
def one_process_losses():
    """The driver's losses with `--devices 1` (one process, every
    vehicle)."""
    import io
    import contextlib
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert train_mod.main(TRAIN_ARGV) == 0
    return _losses(buf.getvalue())


def test_train_main_on_two_gloo_ranks(capfd, tmp_path, one_process_losses):
    """`--devices 2 --vehicles 2`: one rank a vehicle, rank 0 prints the
    rounds (finite losses) and saves vehicle 0's params, which load back
    and match the single-process run's losses' model."""
    ck = str(tmp_path / "q.npz")
    assert train_mod.main(TRAIN_ARGV + ["--devices", "2", "--ckpt", ck]) == 0
    out = capfd.readouterr().out
    losses = _losses(out)
    assert len(losses) == 2 and np.isfinite(losses).all(), out
    assert len(re.findall(r"succ=\d/2", out)) == 2
    np.testing.assert_allclose(losses, one_process_losses, rtol=1e-3)
    cfg = get_smoke_config("qwen3-32b").replace(num_vehicles=2)
    like = materialize(torch.Generator().manual_seed(5),
                       engine.model_decl(cfg, "head"))
    got = load_checkpoint(ck, like)
    assert all(torch.isfinite(x.float()).all() for x in tree_leaves(got))
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                     tree_leaves(like)))


def test_train_main_on_a_2x2_mesh(capfd, one_process_losses):
    """`--devices 4 --vehicles 2`: a (2, 2) ("data", "model") mesh, each
    vehicle's model split over two ranks (`tp` head: 8 heads over 2);
    rank 0 prints the rounds. The smoke config is bf16, where the split
    rounds each rank's partial sums to bf16 before they are summed (one
    process accumulates them in fp32): the losses are the one-process
    run's within one bf16 ulp, 2^-7, relative."""
    assert train_mod.main(TRAIN_ARGV + ["--devices", "4"]) == 0
    out = capfd.readouterr().out
    assert "tp=head" in out
    losses = _losses(out)
    assert len(losses) == 2 and np.isfinite(losses).all(), out
    assert len(re.findall(r"succ=\d/2", out)) == 2
    np.testing.assert_allclose(losses, one_process_losses, rtol=2 ** -7)


def test_train_main_joins_a_torchrun_world(one_process_losses):
    """Under `torchrun` (its environment: RANK, WORLD_SIZE,
    TORCHELASTIC_RUN_ID and the env:// rendezvous on a localhost port)
    each process joins the world instead of spawning one; rank 0 prints
    the rounds, the other rank nothing."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    src = ("import sys; from repro_torch.launch.train import main; "
           "sys.exit(main(sys.argv[1:]))")
    procs = []
    try:
        for rank in range(2):
            env = dict(os.environ, RANK=str(rank), LOCAL_RANK=str(rank),
                       WORLD_SIZE="2", TORCHELASTIC_RUN_ID="test",
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                       OMP_NUM_THREADS="1", PYTHONPATH=os.path.join(
                           os.path.dirname(__file__), "..", "src"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", src] + TRAIN_ARGV + ["--devices", "2"],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
        outs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    assert [p.returncode for p in procs] == [0, 0], outs
    np.testing.assert_allclose(_losses(outs[0]), one_process_losses,
                               rtol=1e-3)
    assert _losses(outs[1]) == []


@pytest.mark.parametrize("argv,err,match", [
    # a model axis of 3: the mLSTM's head dim of 128 does not split,
    # refused before any rank starts
    (["--arch", "xlstm-1.3b", "--devices", "12", "--vehicles", "4"],
     ValueError, "row_head_dim of 128"),
    (["--devices", "3", "--vehicles", "4"], ValueError, "one a vehicle"),
])
def test_train_main_refuses_other_layouts(argv, err, match):
    with pytest.raises(err, match=match):
        train_mod.main(["--device", "cpu", "--rounds", "1"] + argv)


def test_train_main_refuses_more_ranks_than_cards(monkeypatch):
    """On CUDA `--devices` above the card count raises with the count;
    it does not fall back to gloo or the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(RuntimeError, match="has 1"):
        train_mod.main(["--devices", "2", "--vehicles", "2", "--rounds",
                        "1"])


@pytest.mark.parametrize("arch,devices,vehicles,lr", [
    ("zamba2-2.7b", "4", "2", "1e-3"),
    ("xlstm-1.3b", "2", "1", "1e-5"),
])
def test_train_main_splits_the_recurrent_families(capfd, tmp_path, arch,
                                                  devices, vehicles, lr):
    """zamba2 on a (2, 2) mesh (Mamba2 by heads, the tied attention
    head-parallel) and xlstm on a (1, 2) mesh (the mLSTM by its head dim,
    the sLSTM replicated), at lrs where their bf16 smoke configs keep a
    finite loss: rank 0 prints finite losses, and `--ckpt` saves vehicle
    0's whole tree (gathered over the model axis), which loads into the
    one-device declaration's shapes with every leaf finite."""
    ck = str(tmp_path / "m.npz")
    assert train_mod.main(["--device", "cpu", "--arch", arch, "--rounds",
                           "1", "--batch-per-vehicle", "2", "--seq", "64",
                           "--devices", devices, "--vehicles", vehicles,
                           "--lr", lr, "--ckpt", ck]) == 0
    out = capfd.readouterr().out
    losses = _losses(out)
    assert len(losses) == 1 and np.isfinite(losses).all(), out
    cfg = get_smoke_config(arch).replace(num_vehicles=int(vehicles))
    like = materialize(torch.Generator().manual_seed(5),
                       engine.model_decl(cfg, "head"))
    got = load_checkpoint(ck, like)
    for a, b in zip(tree_leaves(got), tree_leaves(like)):
        assert a.shape == b.shape and torch.isfinite(a.float()).all()
    assert any(not torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                     tree_leaves(like)))
