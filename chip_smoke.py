"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version on the card, drives the
port's main path (a blocked `run_fl` of VEDS + CNN FedAvg at the paper's
full width: 40 clients, S=U=10 vehicles, T=60 slots, batch 32, the 6-conv
CIFAR CNN) and checks its output, then compares the card against the CPU
on a small input. TF32 is off for matmuls and cuDNN throughout.

The last line of its output is `{"ok": true, "device": {...}}`; the line
before it lists each kernel with its launches on the main path, its error
against the plain version and its times beside its bound. Details go to
`chiprun_out/chip_smoke.json`. Any failed phase raises and the script
exits non-zero, as it does without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# the card's peaks used for the bounds (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
# veds_score moves 13 bytes in (g, q, w fp32, e bool) and 12 out (y, p, z
# fp32) per candidate, for 24 fp32 operations (log1p counted as one)
VEDS_BYTES_PER_ELEM = 25
VEDS_OPS_PER_ELEM = 24
# the main path's cut: 3 rounds scheduled as one block
ROUNDS, ROUND_BATCH = 3, 3


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, inner: int, samples: int = 21, warmup: int = 5) -> float:
    """Median over `samples` of the mean per-call time of `inner` back to
    back calls, between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b) / inner)
    return statistics.median(out)


def veds_inputs(shape, seed: int, device):
    """Realistic DT candidate grids: gains 1e-13..1e-11 with dead links,
    queues, sigmoid weights and eligibility."""
    g = torch.Generator(device=device).manual_seed(seed)

    def u():
        return torch.rand(shape, generator=g, device=device)

    gain = 10.0 ** (-13.0 + 2.0 * u())
    gain = torch.where(u() < 0.2, 0.0, gain)
    q = 0.1 * u()
    w = 1e-7 * u()
    e = u() < 0.75
    return gain, q, w, e


def bound_ms(n: int):
    t_bytes = n * VEDS_BYTES_PER_ELEM / PEAK_BYTES_PER_S * 1e3
    t_ops = n * VEDS_OPS_PER_ELEM / PEAK_FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_kernels(shapes, device):
    """Each kernel against its plain version on the card, and timed."""
    from repro_torch.core.lyapunov import VedsParams
    from repro_torch.channel.v2x import ChannelParams
    from repro_torch.kernels.veds_score.ops import (veds_dt_score,
                                                    veds_dt_score_plain)
    prm, ch = VedsParams(), ChannelParams()
    kw = dict(V=prm.V, kappa=prm.slot, bw=ch.bandwidth,
              noise=ch.noise_power, p_max=ch.p_max)
    rtol = 1e-6
    res = {}
    for label, shape in shapes.items():
        g, q, w, e = veds_inputs(shape, 7, device)
        outs = veds_dt_score(g, q, w, e, **kw)
        plain = veds_dt_score_plain(g, q, w, e, **kw)
        torch.cuda.synchronize()
        err = max(float((a - b).abs().max()) for a, b in zip(outs, plain))
        rel = max(float(((a - b).abs() / b.abs().clamp_min(1e-30)).max())
                  for a, b in zip(outs, plain))
        for a, b in zip(outs, plain):
            check(bool(((a - b).abs() <= rtol * b.abs()).all()),
                  f"veds_score {label}: kernel disagrees with plain "
                  f"version beyond rtol {rtol}")
        n = g.numel()
        inner = 200 if n < 1 << 16 else 20
        ms = time_ms(lambda: veds_dt_score(g, q, w, e, **kw), inner)
        plain_ms = time_ms(lambda: veds_dt_score_plain(g, q, w, e, **kw),
                           inner)
        b_ms, b_by = bound_ms(n)
        res[label] = dict(shape=list(shape), max_abs_err=err,
                          max_rel_err=rel, tolerance=f"rtol {rtol}",
                          ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                          bound_by=b_by)
        log("kernels", f"veds_score {label} {list(shape)}: max_abs_err "
            f"{err:.3e} max_rel_err {rel:.3e} (tolerance |kernel-plain| <= "
            f"{rtol}*|plain|) kernel {ms:.5f} ms plain {plain_ms:.5f} ms "
            f"bound {b_ms:.7f} ms ({b_by})")
    return res


def make_fl_setup(device, rounds: int, round_batch: int):
    """fig10's setting: synthetic CIFAR-like data (n_train 4000, noise
    0.8), 40 non-iid clients, S=U=10, T=60, batch 32, lr 0.07, VEDS. The
    data is drawn on the card; the clients' shards are host arrays, as
    `run_fl` gathers minibatches on the host."""
    from repro_torch.data.synthetic import cifar_like_dataset, \
        partition_labels
    from repro_torch.fl.simulator import FLSimConfig
    from repro_torch.models.cnn import init_cnn
    x, y = cifar_like_dataset(
        torch.Generator(device=device).manual_seed(1), 4000, 0.8)
    xt, yt = cifar_like_dataset(
        torch.Generator(device=device).manual_seed(2), 512, 0.8)
    x, y = x.cpu().numpy(), y.cpu().numpy()
    client_data = [{"x": x[i], "y": y[i]}
                   for i in partition_labels(y, 40, iid=False)]
    model = init_cnn(torch.Generator(device=device).manual_seed(3))
    params = {k: v.detach() for k, v in model.named_parameters()}
    sim = FLSimConfig(n_clients=40, n_sov=10, n_opv=10, n_slots=60,
                      rounds=rounds, round_batch=round_batch,
                      batch_size=32, lr=0.07, scheduler="veds", seed=7)
    return params, client_data, (xt, yt), sim


def phase_main(device, rounds: int, round_batch: int):
    from repro_torch.fl.simulator import run_fl
    from repro_torch.kernels.veds_score.ops import veds_dt_score
    from repro_torch.models.cnn import cnn_accuracy, cnn_loss
    import dataclasses
    params, client_data, (xt, yt), sim = make_fl_setup(device, rounds,
                                                       round_batch)

    def eval_fn(p):
        return cnn_accuracy(p, {"x": xt, "y": yt})

    t0 = time.perf_counter()
    run_fl(0, params, cnn_loss, client_data,
           dataclasses.replace(sim, rounds=1, round_batch=1),
           eval_fn=eval_fn, eval_every=1, device=device)
    log("main", f"warm-up run_fl (1 round): "
        f"{time.perf_counter() - t0:.2f} s")

    veds_dt_score.launches = 0
    t0 = time.perf_counter()
    hist = run_fl(0, params, cnn_loss, client_data, sim, eval_fn=eval_fn,
                  eval_every=1, device=device)
    wall = time.perf_counter() - t0          # run_fl synchronises at exit
    launches = {"veds_score": veds_dt_score.launches}

    n_blocks = math.ceil(rounds / round_batch)
    want = n_blocks * sim.n_slots
    log("main", f"run_fl {device}: clients {sim.n_clients} "
        f"S=U={sim.n_sov} T={sim.n_slots} batch {sim.batch_size} "
        f"scheduler {sim.scheduler} rounds {rounds} round_batch "
        f"{round_batch}: wall {wall:.3f} s")
    log("main", f"n_success {hist['n_success']} test_acc "
        f"{[round(m, 4) for m in hist['metric']]}")
    log("main", f"launches on the main path: {launches} (expected "
        f"veds_score {want} = {n_blocks} blocks x T {sim.n_slots})")
    check(launches["veds_score"] == want,
          f"veds_score launched {launches['veds_score']} times on the main "
          f"path, expected {want}")
    check(hist["scheduled_rounds"] == rounds and
          hist["round"] == list(range(rounds)), "history rounds")
    check(all(0 <= s <= sim.n_sov for s in hist["n_success"]),
          "n_success out of range")
    check(all(math.isfinite(m) and 0.0 <= m <= 1.0
              for m in hist["metric"]), "accuracy not finite in [0, 1]")
    return dict(history=hist, wall_s=wall, launches=launches), \
        (params, client_data, eval_fn, sim)


def phase_stages(device, setup):
    """One block of the main path, stage by stage: scenario, scheduling,
    training, eval. A first pass closes each stage with a device
    synchronisation and times it on the host clock; a second pass runs
    the same block under `torch.profiler` and reads the device's busy
    time (the sum of its kernels' and copies' times) and their number."""
    from repro_torch.channel.mobility import ManhattanParams
    from repro_torch.channel.v2x import ChannelParams
    from repro_torch.core.baselines import get_scheduler
    from repro_torch.core.lyapunov import VedsParams
    from repro_torch.core.scenario import (ScenarioParams, make_round,
                                           round_generator)
    from repro_torch.core.veds import RoundInputs
    from repro_torch.fl.engine import client_grads, fedavg_apply
    from repro_torch.models.cnn import cnn_loss
    params, client_data, eval_fn, sim = setup
    mob, ch = ManhattanParams(v_max=sim.v_max), ChannelParams()
    prm = VedsParams(alpha=sim.alpha, V=sim.V, Q=sim.q_bits, slot=0.1)
    sc = ScenarioParams(n_sov=sim.n_sov, n_opv=sim.n_opv,
                        n_slots=sim.n_slots, batch_size=sim.batch_size)
    B = sim.round_batch
    rng = np.random.default_rng(0)

    def train(out):
        # as run_fl's round step: host gather, upload, per-client grads,
        # FedAvg
        p = params
        for j in range(B):
            sel = rng.choice(sim.n_clients, size=sim.n_sov, replace=False)
            mbs, weights = [], []
            for c in sel:
                n = client_data[c]["x"].shape[0]
                idx = rng.choice(n, size=sim.batch_size,
                                 replace=n < sim.batch_size)
                mbs.append({k: v[idx] for k, v in client_data[c].items()})
                weights.append(float(n))
            mb = {k: torch.as_tensor(np.stack([m[k] for m in mbs]))
                  .to(device) for k in ("x", "y")}
            grads = client_grads(cnn_loss, p, mb)
            p = fedavg_apply(p, grads, out.cell(j).success.float(),
                             torch.tensor(weights, device=device),
                             lr=sim.lr)
        return p

    def block(times):
        def stage(name, fn):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn()
            torch.cuda.synchronize()
            times[name] = (time.perf_counter() - t0) * 1e3
            return res

        rounds = stage("scenario_ms", lambda: [
            make_round(round_generator(0, r, device), sc, mob, ch, prm)
            for r in range(B)])
        out = stage("schedule_ms", lambda: get_scheduler(
            "veds").solve_round(RoundInputs.stack(rounds), prm, ch))
        p = stage("train_ms", lambda: train(out))
        stage("eval_ms", lambda: float(eval_fn(p)))

    times = {}
    block(times)
    log("stages", f"one block of {B} rounds: " + ", ".join(
        f"{k[:-3]} {v:.1f} ms" for k, v in times.items()))

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    traced = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        block(traced)
    # device-side events: kernels, copies and memsets
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    wall_ms = sum(traced.values())
    prof_res = dict(traced_wall_ms=wall_ms, device_busy_ms=busy_ms,
                    device_events=len(kernels),
                    idle_share=(1.0 - busy_ms / wall_ms) if busy_ms > 0
                    else None)
    log("stages", f"traced block: wall {wall_ms:.1f} ms, device busy "
        f"{busy_ms:.1f} ms in {len(kernels)} device events, idle share "
        + (f"{prof_res['idle_share']:.3f}" if busy_ms > 0 else
           "not measured (the profiler saw no device time)"))
    return dict(rounds=B, **times, profile=prof_res)


def phase_reference(device):
    """The same small inputs through the port on the card and on the
    CPU: VEDS decisions identical, floats within rtol 1e-4; one CNN
    gradient + FedAvg step within 1e-4 relative, norm-wise per tensor
    (TF32 off; cuDNN and oneDNN sum the convolutions in other orders,
    so entries that cancel to ~0 differ more than the tensor does)."""
    from repro_torch.channel.mobility import ManhattanParams
    from repro_torch.channel.v2x import ChannelParams
    from repro_torch.core.lyapunov import VedsParams
    from repro_torch.core.scenario import (ScenarioParams, make_round,
                                           round_generator)
    from repro_torch.core.veds import RoundInputs, veds_round
    from repro_torch.fl.engine import client_grads, fedavg_apply
    from repro_torch.models.cnn import cnn_loss, init_cnn
    sc = ScenarioParams(n_sov=4, n_opv=4, n_slots=12)
    prm, ch = VedsParams(), ChannelParams()
    rnd = RoundInputs.stack([
        make_round(round_generator(11, r, "cpu"), sc, ManhattanParams(),
                   ch, prm) for r in range(3)])
    cpu = veds_round(rnd, prm, ch)
    gpu = veds_round(rnd.to(device), prm, ch)
    for k in ("success", "n_success", "n_cot_slots", "n_dt_slots"):
        check(torch.equal(cpu[k], gpu[k].cpu()),
              f"veds_round {k} differs between card and CPU")
    for k in ("zeta", "energy_sov", "energy_opv"):
        check(torch.allclose(gpu[k].cpu(), cpu[k], rtol=1e-4, atol=1e-9),
              f"veds_round {k} beyond rtol 1e-4 between card and CPU")

    model = init_cnn(torch.Generator().manual_seed(5))
    params = {k: v.detach() for k, v in model.named_parameters()}
    g = torch.Generator().manual_seed(6)
    batch = {"x": torch.randn((2, 4, 32, 32, 3), generator=g),
             "y": torch.randint(0, 10, (2, 4), generator=g)}
    mask, w = torch.tensor([1.0, 1.0]), torch.tensor([3.0, 5.0])

    def step(dev):
        p = {k: v.to(dev) for k, v in params.items()}
        b = {k: v.to(dev) for k, v in batch.items()}
        gr = client_grads(cnn_loss, p, b)
        return gr, fedavg_apply(p, gr, mask.to(dev), w.to(dev), lr=0.07)

    (gc, pc), (gg, pg) = step("cpu"), step(device)

    def rel(a, b):
        return float((a.cpu() - b).norm() / b.norm().clamp_min(1e-30))

    grad_err = max(rel(gg[k], gc[k]) for k in gc)
    upd_err = max(rel(pg[k].cpu() - params[k], pc[k] - params[k])
                  for k in pc)
    check(grad_err <= 1e-4 and upd_err <= 1e-4,
          f"CNN grads ({grad_err:.2e}) or FedAvg update ({upd_err:.2e}) "
          f"differ between card and CPU beyond 1e-4 relative (norm-wise)")
    log("reference", f"card vs CPU on a small input: veds_round decisions "
        f"identical (n_success {cpu.n_success.tolist()}, COT slots "
        f"{cpu.n_cot_slots.tolist()}); CNN grads {grad_err:.2e} and FedAvg "
        f"update {upd_err:.2e} relative (norm-wise, tolerance 1e-4)")
    return dict(n_success=cpu.n_success.tolist(),
                n_cot_slots=cpu.n_cot_slots.tolist(),
                grad_rel_err=grad_err, update_rel_err=upd_err)


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]) \
        .parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on an NVIDIA "
              "GPU only", file=sys.stderr)
        return 2
    src = ROOT / "src" / "repro_torch"
    if not src.is_dir():
        print(f"chip_smoke: {src} not found; run from the root of a "
              f"checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import load_library

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    smi = smi_line()
    log("device", smi)
    log("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}; bounds at "
        f"{PEAK_BYTES_PER_S:.3g} B/s and {PEAK_FP32_OPS_PER_S:.3g} fp32 "
        f"op/s")

    t0 = time.perf_counter()
    lib = load_library()
    build_s = time.perf_counter() - t0
    log("build", f"{lib.path.relative_to(ROOT)} in {build_s:.1f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())

    kernels = phase_kernels({"main": (ROUND_BATCH, 10),
                             "large": (1 << 22,)}, device)
    main_res, setup = phase_main(device, ROUNDS, ROUND_BATCH)
    stages = phase_stages(device, setup)
    ref = phase_reference(device)

    k = kernels["main"]
    line = {"kernels": [{
        "name": "veds_score", "route": "cuda",
        "source": "src/repro_torch/kernels/veds_score/csrc/veds_score.cu",
        "replaces": "src/repro/kernels/veds_score/veds_score.py:25",
        "launches": main_res["launches"]["veds_score"],
        "max_abs_err": max(r["max_abs_err"] for r in kernels.values()),
        "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        "shape": k["shape"]}]}
    out = ROOT / "chiprun_out" / "chip_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(
        smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s, kernels=kernels, main=main_res, stages=stages,
        reference=ref), indent=1))
    log("device", smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
