"""The dry run of the port (`launch/specs.py`, `launch/dryrun.py`,
`launch/op_costs.py`, `launch/reanalyze.py`, `launch/mesh.py:
make_production_mesh`) and the kernels' operators' costs, on the CPU:

(a) every (arch x shape x mesh) case's per-rank inputs, at ranks 0, 37
    and the last of the fake world, have the shapes and dtypes of the
    reference's `build_case` arguments' shards (`NamedSharding.
    shard_shape`, in a subprocess of 512 forced host devices, no
    lowering), and so do the `--profile dp` decode cases of qwen3-32b
    and whisper-small; the dp decode step merges each attention
    sub-block's partial softmax statistics over the model axis (an
    all-reduce MAX and SUM each) and issues no other collective;
(b) each kernel's operation and bytes count reproduces the counts of
    PERF.md's bound column, and `FlopCounterMode` counts the operators;
(c) fake against real on the CPU at a mesh of one rank (a smoke train,
    prefill and decode case): operations, bytes, kernel calls, argument
    bytes and collectives equal, the peak of live bytes within 2%;
(d) `op_costs.analyze` on hand-built op logs, and a `reanalyze` round
    trip;
(e) a gloo world of 4 (2 data x 2 model) running llama4-scout's smoke
    train case for real: each rank's collectives, by kind, count and
    bytes, equal its fake world's.

The VEDS round of (c) and (e) runs `N_SLOTS_SMALL` slots instead of the
reference's 50 (`specs.N_SLOTS`): its op sequence is the same every
slot, and 50 slots of the real solver on the CPU take tens of seconds.
"""
import dataclasses
import gzip
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

import torch_dryrun_cases as DC
from repro_torch.configs.base import SHAPES_BY_NAME, ShapeConfig
from repro_torch.configs.registry import (ARCH_IDS, get_config,
                                          get_smoke_config)
from repro_torch.kernels.fedavg_agg.ops import fedavg_agg, fedavg_agg_cost
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_cost)
from repro_torch.kernels.ssd_scan.ops import ssd_scan, ssd_scan_cost
from repro_torch.kernels.veds_score.ops import (VEDS_BYTES_PER_ELEM,
                                                VEDS_OPS_PER_ELEM,
                                                veds_dt_score,
                                                veds_dt_score_cost)
from repro_torch.launch import dryrun, reanalyze, specs
from repro_torch.launch.mesh import (PRODUCTION_MESHES, fake_mesh,
                                     make_production_mesh, run_world)
from repro_torch.launch.op_costs import (FLOP_FORMULAS, OpCosts,
                                         TensorDesc, analyze, write_log)

RANKS = (0, 37, -1)
N_SLOTS_SMALL = 4
WORLD_TIMEOUT_S = 300

# the reference's per-device argument shapes of every case, by path
_REFERENCE = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    import jax
    from repro.configs.base import SHAPES_BY_NAME
    from repro.configs.registry import ARCH_IDS, get_config
    from repro.launch.mesh import make_production_mesh
    from repro.launch.specs import build_case

    def walk(x, s, path, out):
        if x is None:
            return
        if isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], s[k], f"{path}/{k}", out)
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, s[i], f"{path}/{i}", out)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), getattr(s, f.name),
                     f"{path}/{f.name}", out)
        else:
            out[path] = [list(s.shard_shape(x.shape)), str(x.dtype)]

    cases = [(a, "", s) for a in ARCH_IDS for s in SHAPES_BY_NAME] + [
        (a, "dp", s) for a in json.loads(sys.argv[2])
        for s in json.loads(sys.argv[3])]
    res = {}
    for mp in (False, True):
        mesh = make_production_mesh(multi_pod=mp)
        with jax.set_mesh(mesh):
            for arch, profile, shape in cases:
                cfg = get_config(arch)
                if profile:
                    cfg = cfg.replace(sharding_profile=profile)
                _, args, shard = build_case(cfg, SHAPES_BY_NAME[shape], mesh)
                out = {}
                for i, (a, s) in enumerate(zip(args, shard)):
                    walk(a, s, str(i), out)
                res[f"{arch}{'+' + profile if profile else ''}|{shape}|"
                    f"{int(mp)}"] = out
    with open(sys.argv[1], "w") as f:
        json.dump(res, f)
""")


def _case_tensors(args):
    """{path: tensor} of a case's inputs, by the reference walker's paths
    (dicts by sorted key, lists and tuples by index, `RoundInputs` by
    field; None left out)."""
    out = {}

    def walk(x, path):
        if x is None:
            return
        if isinstance(x, torch.Tensor):
            out[path] = x
        elif isinstance(x, dict):
            for k in sorted(x):
                walk(x[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{path}/{i}")
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), f"{path}/{f.name}")
    for i, a in enumerate(args):
        walk(a, str(i))
    return out


# the `--profile dp` decode cases held to the reference's shards too
DP_ARCHS, DP_SHAPES = ("qwen3-32b", "whisper-small"), ("decode_32k",
                                                       "long_500k")


def _port_shapes(arch, shape, multi_pod, rank, profile=""):
    cfg = get_config(arch)
    if profile:
        cfg = cfg.replace(sharding_profile=profile)
    with make_production_mesh(multi_pod, rank=rank, device="cpu") as mesh:
        with FakeTensorMode(allow_non_fake_inputs=True):
            _, args = specs.build_case(cfg, SHAPES_BY_NAME[shape],
                                       mesh, "cpu", with_step=False)
            return {p: [list(t.shape), str(t.dtype).split(".")[-1]]
                    for p, t in _case_tensors(args).items()}


def test_every_case_has_the_reference_per_device_inputs(tmp_path):
    """(a) All 80 cases and the dp decode cases: the port's inputs at
    ranks 0, 37 and the last equal the reference's shards, path by path,
    in shape and dtype."""
    ref_path = str(tmp_path / "reference.json")
    env = dict(os.environ, PYTHONPATH=os.path.join(
        os.path.dirname(__file__), "..", "src"))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.Popen([sys.executable, "-c", _REFERENCE, ref_path,
                             json.dumps(DP_ARCHS), json.dumps(DP_SHAPES)],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    cases = [(a, "", s) for a in ARCH_IDS for s in SHAPES_BY_NAME] + [
        (a, "dp", s) for a in DP_ARCHS for s in DP_SHAPES]
    try:
        ours = {}
        for mp in (False, True):
            n = int(np.prod(PRODUCTION_MESHES[mp][0]))
            for arch, profile, shape in cases:
                got = [_port_shapes(arch, shape, mp, r % n, profile)
                       for r in RANKS]
                assert got[0] == got[1] == got[2], (arch, shape, mp)
                ours[f"{arch}{'+' + profile if profile else ''}|{shape}|"
                     f"{int(mp)}"] = got[0]
        log, _ = proc.communicate(timeout=600)
    finally:
        proc.kill()
        proc.wait()
    assert proc.returncode == 0, log[-3000:]
    with open(ref_path) as f:
        ref = json.load(f)
    assert len(ref) == len(ours) == 80 + 2 * len(DP_ARCHS) * len(DP_SHAPES)
    for case, want in ref.items():
        assert ours[case] == want, case


@pytest.mark.parametrize("arch", DP_ARCHS)
def test_dp_decode_merges_each_attention_sub_block_over_the_model_axis(arch):
    """(a) The dp profile's decode step on rank 1 of a fake (2, 2) world:
    an all-reduce MAX and SUM for each attention sub-block (whisper's
    self and cross), nothing else; each layer's once in the
    per-iteration view."""
    cfg = get_smoke_config(arch).replace(sharding_profile="dp", n_rep=5)
    n_attn = sum(k in ("attn", "cross") for k in cfg.pattern)
    with fake_mesh((2, 2), ("data", "model"), rank=1, device="cpu") as mesh:
        rec = dryrun.trace_case(cfg, ShapeConfig("decode_s", 64, 4, "decode"),
                                mesh, "cpu")
    assert rec["collectives_count"] == {
        "all-reduce": 2 * n_attn * cfg.n_rep, "all-gather": 0,
        "reduce-scatter": 0, "all-to-all": 0, "collective-permute": 0}
    per = rec["collectives_bytes_periter"]["all-reduce"]
    assert rec["collectives_bytes"]["all-reduce"] == per * cfg.n_rep > 0
    assert rec["scaled_loops"]["layers"]["trip_count"] == cfg.n_rep


def test_production_mesh_is_the_references_topology():
    """The fake world's mesh has the reference's axes and shape; a
    world already initialized refuses a second one; the world is gone
    after the block."""
    for mp, (shape, names) in PRODUCTION_MESHES.items():
        with make_production_mesh(mp, rank=5, device="cpu") as mesh:
            assert tuple(mesh.mesh_dim_names) == names
            assert tuple(mesh.mesh.shape) == shape
            assert torch.distributed.get_world_size() == int(np.prod(shape))
            with pytest.raises(RuntimeError, match="already initialized"):
                with fake_mesh((1, 1), ("data", "model"), device="cpu"):
                    pass
        assert not torch.distributed.is_initialized()


def test_kernel_costs_reproduce_the_bound_column():
    """(b) The counts PERF.md's bound column uses: flash causal
    4 B H D T (T + 1) / 2 (68.8 GFLOP at q [4, 1024, 64, 128], 21.5 at
    zamba2's [4, 1024, 32, 80]), ssd_scan 16.1 GFLOP and 91.5 MB at v
    [4, 1024, 80, 64], fedavg_agg 7.78 GB at qwen3's embedding leaf over
    4 vehicles, veds_score 24 operations and 25 bytes a candidate."""
    bf = torch.bfloat16
    q = TensorDesc((4, 1024, 64, 128), bf, 0)
    k = TensorDesc((4, 1024, 8, 128), bf, 0)
    assert flash_attention_cost(q, k, k, True, None, 0) == (
        4 * 4 * 64 * 128 * 1024 * 1025 // 2, 152043520)
    assert flash_attention_cost(q, k, k, True, None, 0)[0] == 68786585600
    z = TensorDesc((4, 1024, 32, 80), bf, 0)
    assert flash_attention_cost(z, z, z, True, None, 0)[0] == 21495808000
    # the window and the offset count the pairs the masks keep
    assert flash_attention_cost(TensorDesc((1, 4, 1, 16), bf, 0),
                                TensorDesc((1, 8, 1, 16), bf, 0), None,
                                True, 2, 4)[0] == 4 * 16 * 8
    v = TensorDesc((4, 1024, 80, 64), bf, 0)
    b = TensorDesc((4, 1024, 64), bf, 0)
    assert ssd_scan_cost(v, b, b, None, 128) == (16106127360, 91488256)
    x = TensorDesc((4, 151936 * 5120), bf, 0)
    ops, nbytes = fedavg_agg_cost(x, None, None)
    assert nbytes == 7779123216 and ops == 9 * 151936 * 5120
    g = TensorDesc((1, 16), torch.float32, 0)
    assert veds_dt_score_cost(g, g, g, g) == (VEDS_OPS_PER_ELEM * 16,
                                              VEDS_BYTES_PER_ELEM * 16)


def test_flop_counter_counts_the_kernels_and_fakes_shape_them():
    """`FlopCounterMode` counts each kernel operator by its formula; the
    fake implementations give the plain versions' shapes and dtypes."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(1, 64, 4, 16, generator=gen)
    k = torch.randn(1, 64, 2, 16, generator=gen)
    v4 = torch.randn(1, 32, 2, 8, generator=gen)
    bc = torch.randn(1, 32, 4, generator=gen)
    la = -torch.rand(1, 32, 2, generator=gen)
    x, w = torch.randn(3, 10, generator=gen), torch.ones(3)
    g = torch.rand(2, 5, generator=gen)
    kw = dict(V=0.2, kappa=0.1, bw=1e6, noise=1e-13, p_max=0.2)

    def calls():
        return (flash_attention(q, k, k), ssd_scan(v4, bc, bc, la, 16),
                fedavg_agg(x, w, x[0]), veds_dt_score(g, g, g, g > 0.5, **kw))
    with FlopCounterMode(display=False) as fc:
        real = calls()
    want = (flash_attention_cost(q, k, k)[0] + ssd_scan_cost(
        v4, bc, bc, la, 16)[0] + fedavg_agg_cost(x, w, x[0])[0]
        + veds_dt_score_cost(g, g, g, g)[0])
    assert fc.get_total_flops() == want
    with FakeTensorMode(allow_non_fake_inputs=True):
        fake = calls()
    flat = [t for r in (real, fake) for t in (r[0], *r[1], r[2], *r[3])]
    n = len(flat) // 2
    for a, b in zip(flat[:n], flat[n:]):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_matmul_formulas_count_the_dtype_overload():
    """The decode core's fp32 scores on CUDA are `torch.bmm(a, b,
    out_dtype=float32)` (`aten::bmm.dtype`), whose third positional
    argument `torch.utils.flop_counter`'s own formula takes for its
    output shape and fails on; `FLOP_FORMULAS` counts it, in
    `FlopCounterMode` and in `analyze`, as 2 b m k n."""
    with FakeTensorMode():
        a = torch.empty(2, 3, 4, dtype=torch.bfloat16)
        b = torch.empty(2, 4, 5, dtype=torch.bfloat16)
        with pytest.raises(TypeError, match="out_shape"):
            with FlopCounterMode(display=False):
                torch.bmm(a, b, out_dtype=torch.float32)
        with FlopCounterMode(display=False,
                             custom_mapping=FLOP_FORMULAS) as fc, \
                OpCosts(keep=True) as costs:
            torch.bmm(a, b, out_dtype=torch.float32)
    assert fc.get_total_flops() == costs.analyze()["dot_flops"] == \
        2 * 2 * 3 * 4 * 5
    assert analyze(costs.records)["dot_flops"] == 240


# (c): (arch, shape) at a mesh of one rank
SMALL_CASES = {
    "train": ("qwen3-32b", ShapeConfig("train_s", 64, 4, "train"),
              dict(num_vehicles=2)),
    "prefill": ("zamba2-2.7b", ShapeConfig("prefill_s", 64, 2, "prefill"),
                dict(n_rep=2)),
    "decode": ("llama4-scout-17b-a16e",
               ShapeConfig("decode_s", 128, 2, "decode"), {}),
}


@pytest.mark.parametrize("kind", tuple(SMALL_CASES))
def test_fake_run_counts_what_the_real_run_does(kind, monkeypatch):
    """(c) The same smoke case traced on fake tensors and run for real on
    the CPU at a mesh of one rank: operations, bytes, kernel calls,
    collectives and argument bytes equal, the peak within 2%."""
    monkeypatch.setattr(specs, "N_SLOTS", N_SLOTS_SMALL)
    arch, shape, rep = SMALL_CASES[kind]
    cfg = get_smoke_config(arch).replace(grad_accum=1, **rep)
    one = {"data": 1, "model": 1}
    real = dryrun.trace_case(cfg, shape, one, "cpu", fake=False)
    fake = dryrun.trace_case(cfg, shape, one, "cpu", fake=True)
    for key in ("deep_cost", "kernels", "collectives_bytes",
                "collectives_count", "n_ops"):
        assert real[key] == fake[key], key
    assert real["memory"]["argument_bytes"] == \
        fake["memory"]["argument_bytes"] > 0
    assert abs(real["peak_bytes"] - fake["peak_bytes"]) <= \
        0.02 * real["peak_bytes"]
    assert real["deep_cost"]["dot_flops"] > 0
    want = {"train": {"repro::flash_attention_fwd", "repro::fedavg_agg",
                      "repro::veds_dt_score", "repro::p4_solve"},
            "prefill": {"repro::flash_attention_fwd", "repro::ssd_scan_fwd"},
            "decode": set()}[kind]
    assert set(real["kernels"]) == want


def _t(shape, dtype="float32", b=None):
    n = int(np.prod(shape)) * getattr(torch, dtype).itemsize
    return {"T": list(shape), "d": dtype, "b": n if b is None else b}


HAND_LOG = [
    # a matmul: 2 m k n operations, its inputs and output moved
    {"op": "aten::mm", "args": [_t((4, 8)), _t((8, 16))],
     "out": _t((4, 16))},
    # a view moves nothing
    {"op": "aten::view", "args": [_t((4, 16)), [64]], "out": _t((64,)),
     "view": True},
    # an elementwise op on one tensor twice reads it once
    {"op": "aten::mul", "args": [_t((64,)), _t((64,), b=0)],
     "out": _t((64,))},
    # collectives: the output tensors' bytes, by kind
    {"op": "c10d::allreduce_", "args": [[_t((10,))], "pg", "op", None,
                                        False, -1],
     "out": [[_t((10,))], "work"]},
    {"op": "c10d::_allgather_base_", "args": [_t((8, 3), "bfloat16"),
                                              _t((2, 3), "bfloat16"), "pg",
                                              False, -1],
     "out": [_t((8, 3), "bfloat16"), "work"]},
    {"op": "c10d::_reduce_scatter_base_",
     "args": [_t((2, 3)), _t((8, 3)), "pg", "op", False, -1],
     "out": [_t((2, 3)), "work"]},
    # a kernel counts its own operations and bytes
    {"op": "repro::flash_attention_fwd",
     "args": [_t((1, 4, 2, 16), "bfloat16"), _t((1, 4, 1, 16), "bfloat16"),
              _t((1, 4, 1, 16), "bfloat16"), True, None, 0],
     "out": [_t((1, 4, 2, 16), "bfloat16"), _t((1, 2, 4))]},
]


def test_op_costs_on_hand_built_logs():
    """(d) dot_flops, hbm_bytes, collectives and kernel calls of a
    hand-built log, counted by hand."""
    res = analyze(HAND_LOG)
    flash_ops = 4 * 1 * 2 * 16 * 10           # 10 causal pairs of T = 4
    flash_bytes = (2 * 128 + 2 * 64) * 2 + 1 * 2 * 4 * 4
    assert res["dot_flops"] == 2 * 4 * 8 * 16 + flash_ops
    assert res["hbm_bytes"] == (128 + 512 + 256) + (256 + 256) + \
        (40 + 40) + (48 + 12 + 48) + (24 + 96 + 24) + flash_bytes
    assert res["collectives_bytes"] == {
        "all-reduce": 40, "all-gather": 48, "reduce-scatter": 24,
        "all-to-all": 0, "collective-permute": 0}
    assert res["collectives_count"]["all-reduce"] == 1
    assert res["kernel_calls"] == {"repro::flash_attention_fwd": 1}
    assert res["n_ops"] == len(HAND_LOG)


def test_reanalyze_recomputes_a_record_from_its_log(tmp_path):
    """(d) A record whose cost fields are stale, beside its op log:
    `reanalyze` rewrites them from the log alone."""
    tag = tmp_path / "arch__shape__pod16x16"
    write_log(str(tag) + ".ops.jsonl.gz", HAND_LOG)
    stale = {"arch": "arch", "cost": {"flops": -1.0, "bytes_accessed": -1.0,
                                      "transcendentals": None},
             "deep_cost": {}, "collectives_bytes": {}}
    with open(str(tag) + ".json", "w") as f:
        json.dump(stale, f)
    assert reanalyze.main([str(tmp_path)]) == 0
    with open(str(tag) + ".json") as f:
        rec = json.load(f)
    res = analyze(HAND_LOG)
    assert rec["deep_cost"] == {"dot_flops": res["dot_flops"],
                                "hbm_bytes": res["hbm_bytes"],
                                "unknown_trip_whiles": 0}
    assert rec["cost"]["flops"] == res["dot_flops"]
    assert rec["collectives_bytes"] == res["collectives_bytes"]
    assert rec["kernels"] == res["kernel_calls"]
    with gzip.open(str(tag) + ".ops.jsonl.gz", "rt") as f:
        assert len(f.readlines()) == len(HAND_LOG)


def test_dryrun_main_writes_a_record_and_its_log(tmp_path):
    """`dryrun.main` on one production case at the CPU: exit 0, the
    record's fields, its op log, and `reanalyze` agreeing with it."""
    out = str(tmp_path)
    assert dryrun.main(["--device", "cpu", "--arch", "minitron-4b",
                        "--shape", "long_500k", "--out", out]) == 0
    path = os.path.join(out, "minitron-4b__long_500k__pod16x16.json")
    with open(path) as f:
        rec = json.load(f)
    assert rec["devices"] == 256 and rec["memory"]["code_bytes"] is None
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["alias_bytes"] > 0       # the cache, in place
    assert rec["collectives_count"]["all-reduce"] > 0
    again = reanalyze.reanalyze(path)
    assert again["deep_cost"] == rec["deep_cost"]


def test_gloo_world_moves_the_collectives_its_fake_world_counts(tmp_path):
    """(e) llama4-scout's smoke train case on a gloo world of 4 ranks
    (2 data x 2 model: FSDP over data, heads over model), for real: each
    rank's collectives by kind, count and bytes equal those of the same
    rank of a fake world of 4."""
    cfg = get_smoke_config("llama4-scout-17b-a16e").replace(grad_accum=1)
    shape = ShapeConfig("train_s", 32, 4, "train")
    path, out = str(tmp_path / "inputs.pt"), str(tmp_path / "out{rank}.pt")
    torch.save(dict(cfg=cfg, shape=shape, model=2,
                    n_slots=N_SLOTS_SMALL), path)
    run_world(DC.trace_rank_main, 4, path, out, device="cpu", threads=1,
              timeout_s=WORLD_TIMEOUT_S, store_dir=str(tmp_path))
    before = specs.N_SLOTS
    specs.N_SLOTS = N_SLOTS_SMALL
    try:
        for r in range(4):
            real = torch.load(out.format(rank=r), weights_only=False)
            with fake_mesh((2, 2), ("data", "model"), rank=r,
                           device="cpu") as mesh:
                fake = dryrun.trace_case(cfg, shape, mesh, "cpu")
            assert real["collectives_count"] == fake["collectives_count"]
            assert real["collectives_bytes"] == fake["collectives_bytes"]
            for kind in ("all-reduce", "all-gather", "reduce-scatter"):
                assert real["collectives_count"][kind] > 0, kind
            # (the bytes differ: gloo runs its tensor reduce-scatter as a
            # split and copies around its list form, ops the fake
            # backend does not run)
            assert real["deep_cost"]["dot_flops"] == \
                fake["deep_cost"]["dot_flops"]
    finally:
        specs.N_SLOTS = before
