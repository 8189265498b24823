"""Multi-pod dry run: one rank's step of every (arch x shape x mesh) case,
traced on fake tensors over a fake world.

Port of `repro/launch/dryrun.py`. The reference lowers and compiles each
case for 256 or 512 host devices and reads XLA's memory and cost
analyses. The port plays one rank (`--rank`, 0 by default) of the
production mesh (`launch/mesh.py:make_production_mesh`, a fake world of
256 or 512 ranks), builds that rank's inputs (`launch/specs.py:
build_case`) as fake tensors (`FakeTensorMode`: nothing is allocated)
and runs its step, the port's own code, under `launch/op_costs.OpCosts`,
which records every op the step dispatches.

Usage:
  python -m repro_torch.launch.dryrun --device cpu --arch qwen3-32b --shape train_4k
  python -m repro_torch.launch.dryrun --device cpu --arch all --shape all --both-meshes
  python -m repro_torch.launch.dryrun --list

The device is CUDA unless `--device` names another (fake CUDA tensors
need a PyTorch built for CUDA). Per case it writes
experiments/dryrun_torch/<arch>__<shape>__<mesh>.json and the gzipped op
log beside it (`.ops.jsonl.gz`, which `launch/reanalyze.py` reads). The
record's fields, as the reference's:

  memory.argument_bytes  this rank's inputs (each storage once)
  memory.output_bytes    the step's outputs
  memory.temp_bytes      the peak of live bytes less the arguments
  memory.alias_bytes     outputs that are inputs updated in place
  memory.code_bytes      null: eager PyTorch compiles no program
  cost.*, deep_cost.*    `op_costs.analyze`: dot_flops and hbm_bytes of
                         the whole step (no loop is counted once, so
                         there is no per-iteration view and no unknown
                         trip count: unknown_trip_whiles is 0)
  collectives_bytes/_count by kind, over the whole step
  kernels                each custom kernel's calls
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
from repro_torch.launch.op_costs import OpCosts, tree_tensors
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
               fake: bool = True, log: Optional[str] = None,
               seed: int = 0) -> dict:
    """Build this rank's case on `mesh` and run its step once under
    `OpCosts` (on fake tensors with `fake`, for real otherwise). Returns
    the record's `memory`, `deep_cost`, collective, kernel and timing
    fields, and the step's outputs under "outputs" (not serialisable).
    The timings are the host's: on fake tensors no device work exists,
    and a real run on a card is not synchronised."""
    t0 = time.perf_counter()
    mode = FakeTensorMode(allow_non_fake_inputs=True) if fake \
        else contextlib.nullcontext()
    with mode:
        step, args = build_case(cfg, shape, mesh, device, seed=seed)
        t_build = time.perf_counter() - t0  # reprolint: disable=timer-no-block
        costs = OpCosts(args, log=log)
        with costs:
            out = step(*args)
        # host time of the trace (fake: no device work)
        t_trace = time.perf_counter() - t0 - t_build  # reprolint: disable=timer-no-block
    deep = costs.analyze()
    arg_keys = _storages(args)
    return {
        "memory": {
            "argument_bytes": costs.argument_bytes,
            "output_bytes": storage_bytes(out),
            "temp_bytes": costs.peak_bytes - costs.argument_bytes,
            "alias_bytes": storage_bytes(out) - storage_bytes(
                out, exclude=arg_keys),
            "code_bytes": None,
        },
        "peak_bytes": costs.peak_bytes,
        "deep_cost": {"dot_flops": deep["dot_flops"],
                      "hbm_bytes": deep["hbm_bytes"],
                      "unknown_trip_whiles": 0},
        "collectives_bytes": deep["collectives_bytes"],
        "collectives_count": deep["collectives_count"],
        "kernels": deep["kernel_calls"],
        "n_ops": deep["n_ops"],
        "timings": {"build_s": round(t_build, 3),
                    "trace_s": round(t_trace, 3)},
        "outputs": out,
    }


def run_case(arch: str, shape_name: str, multi_pod: bool, out_dir: str,
             force: bool = False, profile: str = "", variant: str = "",
             grad_accum: int = 0, device=None, rank: int = 0) -> dict:
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
        res = trace_case(cfg, shape, mesh, device,
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
        # the port's op counter sees every op: the whole step
        "cost": {"flops": deep["dot_flops"], "transcendentals": None,
                 "bytes_accessed": deep["hbm_bytes"]},
        "deep_cost": deep,
        "deep_cost_notes": {
            "unknown_trip_whiles": "0: every loop iteration dispatches its "
                                   "ops, so no trip count is needed"},
        "collectives_bytes": res["collectives_bytes"],
        "collectives_count": res["collectives_count"],
        # no loop body is counted once: the per-iteration view is the total
        "collectives_bytes_periter": res["collectives_bytes"],
        "kernels": res["kernels"],
        "n_ops": res["n_ops"],
        "peak_bytes": res["peak_bytes"],
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
                                   device=args.device, rank=args.rank)
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
