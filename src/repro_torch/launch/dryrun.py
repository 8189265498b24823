"""Multi-pod dry run: one rank's step of every (arch x shape x mesh) case,
traced on fake tensors over a fake world.

Port of `repro/launch/dryrun.py`. The reference lowers and compiles each
case for 256 or 512 host devices and reads XLA's memory and cost
analyses. The port plays one rank (`--rank`, 0 by default) of the
production mesh (`launch/mesh.py:make_production_mesh`, a fake world of
256 or 512 ranks), builds that rank's inputs (`launch/specs.py:
build_case`) as fake tensors (`FakeTensorMode`: nothing is allocated)
and runs its step, the port's own code, under `launch/op_costs.OpCosts`,
which records every op the step dispatches. Each repeated loop (the
layer stack, the microbatches, the VEDS slots, the mLSTM's chunks, the
sLSTM's steps) runs a few checked iterations and the records are scaled
to its trip count, as the reference's HLO counter scales a `while` body
(`op_costs.scaled_trace`); `--full-trace` dispatches every iteration
instead, to compare the two.

Usage:
  python -m repro_torch.launch.dryrun --device cpu --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --device cpu --arch all --shape all --both-meshes
  python -m repro_torch.launch.dryrun --device cpu --arch qwen3-32b --shape decode_32k --profile dp --variant dp
  python -m repro_torch.launch.dryrun --list

The device is CUDA unless `--device` names another (fake CUDA tensors
need a PyTorch built for CUDA). Per case it writes
experiments/dryrun_torch/<arch>__<shape>__<mesh>.json and the gzipped op
log beside it (`.ops.jsonl.gz`, every trace's entries after a marker of
its weight, which `launch/reanalyze.py` reads). The record's fields, as
the reference's:

  memory.argument_bytes  this rank's inputs (each storage once)
  memory.output_bytes    the step's outputs
  memory.temp_bytes      the peak of live bytes less the arguments
  memory.alias_bytes     outputs that are inputs updated in place
  memory.code_bytes      null: eager PyTorch compiles no program
  cost.*, deep_cost.*    `op_costs.analyze`: dot_flops and hbm_bytes of
                         the whole step, each loop at its trip count (no
                         trip count is unknown: unknown_trip_whiles is 0)
  collectives_bytes/_count by kind, over the whole step
  collectives_bytes_periter by kind, each loop body counted once
  kernels                each custom kernel's calls
  scaled_loops           each scaled loop's trip count and the
                         iterations traced ({} with --full-trace)
  timings                build_s (the inputs), trace_s (the step)
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import time
import traceback
from typing import Optional

from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import resolve_device
from repro_torch.configs.base import SHAPES_BY_NAME, ModelConfig, \
    ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_costs import OpCosts, scaled_trace, \
    tree_tensors
from repro_torch.launch.specs import build_case
from repro_torch.sharding.rules import mesh_shape

OUT_DIR = "experiments/dryrun_torch"


def storage_bytes(tree, exclude=()) -> int:
    """The bytes of the distinct storages of `tree`'s tensors, leaving out
    those whose storage key is in `exclude`."""
    seen = {}
    for t in tree_tensors(tree):
        st = t.untyped_storage()
        if st._cdata not in exclude:
            seen[st._cdata] = st.nbytes()
    return sum(seen.values())


def _storages(tree) -> set:
    return {t.untyped_storage()._cdata for t in tree_tensors(tree)}


def trace_case(cfg: ModelConfig, shape: ShapeConfig, mesh, device, *,
               fake: bool = True, full_trace: bool = False,
               log: Optional[str] = None, seed: int = 0) -> dict:
    """Build this rank's case on `mesh` and run its step under `OpCosts`:
    on fake tensors with `fake`, each repeated loop scaled from a few
    checked iterations (`op_costs.scaled_trace`) unless `full_trace`
    asks for every iteration; for real otherwise, every iteration run.
    Returns the record's `memory`, `deep_cost`, collective, kernel,
    loop and timing fields, and the step's outputs under "outputs" (not
    serialisable). The timings are the host's: on fake tensors no device
    work exists, and a real run on a card is not synchronised."""
    t0 = time.perf_counter()
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake \
        else contextlib.nullcontext()
    with mode:
        step, args = build_case(cfg, shape, mesh, device, seed=seed)
        t_build = time.perf_counter() - t0  # reprolint: disable=timer-no-block
        if fake:
            tr = scaled_trace(step, args, full=full_trace, log=log)
            deep, out, peak = tr.totals, tr.outputs, tr.peak_bytes
            arg_b, loops, n_traces = tr.argument_bytes, tr.loops, \
                tr.n_traces
        else:
            costs = OpCosts(args, log=log)
            with costs:
                out = step(*args)
            deep, peak, arg_b = costs.analyze(), costs.peak_bytes, \
                costs.argument_bytes
            loops, n_traces = {}, 1
        # host time of the trace (fake: no device work)
        t_trace = time.perf_counter() - t0 - t_build  # reprolint: disable=timer-no-block
    arg_keys = _storages(args)
    return {
        "memory": {
            "argument_bytes": arg_b,
            "output_bytes": storage_bytes(out),
            "temp_bytes": peak - arg_b,
            "alias_bytes": storage_bytes(out) - storage_bytes(
                out, exclude=arg_keys),
            "code_bytes": None,
        },
        "peak_bytes": peak,
        "deep_cost": {"dot_flops": deep["dot_flops"],
                      "hbm_bytes": deep["hbm_bytes"],
                      "unknown_trip_whiles": 0},
        "collectives_bytes": deep["collectives_bytes"],
        "collectives_count": deep["collectives_count"],
        "collectives_bytes_periter": deep["collectives_bytes_periter"],
        "kernels": deep["kernel_calls"],
        "n_ops": deep["n_ops"],
        "scaled_loops": loops,
        "n_traces": n_traces,
        "timings": {"build_s": round(t_build, 3),
                    "trace_s": round(t_trace, 3)},
        "outputs": out,
    }


def run_case(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             force: bool = False, profile: str = "", variant: str = "",
             grad_accum: int = 0, device=None, rank: int = 0,
             full_trace: bool = False) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    tag = f"{arch}__{shape_name}__{mesh_name}"
    if variant:
        tag += f"__{variant}"
    path = os.path.join(out_dir, tag + ".json")
    if os.path.exists(path) and not force:
        with open(path) as f:
            return json.load(f)

    cfg = get_config(arch)
    if profile:
        cfg = cfg.replace(sharding_profile=profile)
    if grad_accum:
        cfg = cfg.replace(grad_accum=grad_accum)
    shape = SHAPES_BY_NAME[shape_name]
    device = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    with make_production_mesh(multi_pod, rank=rank, device=device) as mesh:
        res = trace_case(cfg, shape, mesh, device, full_trace=full_trace,
                         log=os.path.join(out_dir, tag + ".ops.jsonl.gz"))
        n_dev = math.prod(mesh_shape(mesh).values())
    res.pop("outputs")
    deep = res["deep_cost"]
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "devices": n_dev, "rank": rank, "device": device.type,
        "memory": res["memory"],
        "memory_notes": {
            "code_bytes": "eager PyTorch compiles no program: no code size",
            "temp_bytes": "peak of live storages during the step, less "
                          "the arguments"},
        # the whole step, each repeated loop at its trip count
        "cost": {"flops": deep["dot_flops"], "transcendentals": None,
                 "bytes_accessed": deep["hbm_bytes"]},
        "deep_cost": deep,
        "deep_cost_notes": {
            "unknown_trip_whiles": "0: every repeated loop's trip count is "
                                   "known in Python (scaled_loops)"},
        "collectives_bytes": res["collectives_bytes"],
        "collectives_count": res["collectives_count"],
        # each loop body counted once, the reference's per-iteration view
        "collectives_bytes_periter": res["collectives_bytes_periter"],
        "kernels": res["kernels"],
        "n_ops": res["n_ops"],
        "peak_bytes": res["peak_bytes"],
        "scaled_loops": res["scaled_loops"],
        "trace_notes": {
            "scaled_loops": "each loop's trip count and the iterations "
                            "the traces ran; empty: a full trace "
                            "(--full-trace), every iteration dispatched",
            "n_traces": "traces of the step combined into the record"},
        "n_traces": res["n_traces"],
        "timings": res["timings"],
    }
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    print({k: rec["memory"][k] for k in ("argument_bytes", "output_bytes",
                                         "temp_bytes", "alias_bytes")})
    print({k: rec["cost"][k] for k in ("flops", "bytes_accessed")})
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--profile", default="", help="sharding profile override")
    ap.add_argument("--variant", default="", help="record name suffix")
    ap.add_argument("--grad-accum", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (CUDA unless named)")
    ap.add_argument("--rank", type=int, default=0,
                    help="the rank of the production mesh this process plays")
    ap.add_argument("--full-trace", action="store_true",
                    help="dispatch every iteration of every repeated loop "
                         "instead of scaling a few checked ones")
    args = ap.parse_args(argv)

    if args.list:
        for a in ARCH_IDS:
            print(a)
        return 0

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES_BY_NAME) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    failures = []
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                tag = f"{arch}/{shape}/{'multi' if mp else 'single'}"
                try:
                    rec = run_case(arch, shape, mp, args.out,
                                   force=args.force, profile=args.profile,
                                   variant=args.variant,
                                   grad_accum=args.grad_accum,
                                   device=args.device, rank=args.rank,
                                   full_trace=args.full_trace)
                    coll = sum(rec["collectives_bytes"].values())
                    print(f"OK   {tag}  flops/dev={rec['cost']['flops']:.3e} "
                          f"args={rec['memory']['argument_bytes'] / 2**30:.2f}"
                          f"GiB temp={rec['memory']['temp_bytes'] / 2**30:.2f}"
                          f"GiB coll={coll / 2**20:.1f}MiB "
                          f"trace={rec['timings']['trace_s']}s", flush=True)
                except Exception as e:  # noqa: BLE001
                    failures.append(tag)
                    print(f"FAIL {tag}: {type(e).__name__}: {e}")
                    traceback.print_exc(limit=3)
    n_ok = len(archs) * len(shapes) * len(meshes) - len(failures)
    wall = time.perf_counter() - t0  # reprolint: disable=timer-no-block
    print(f"{n_ok} cases in {wall:.1f} s")
    if failures:
        print("FAILURES:", failures)
        return 1
    print("all dry-run cases traced")
    return 0


if __name__ == "__main__":
    sys.exit(main())
