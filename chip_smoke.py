"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version on the card, and drives the
port's two main paths, each checked and each with its kernel launches
counted from 0:

- `run_fl`, blocked, VEDS + CNN FedAvg at the paper's full width (40
  clients, S=U=10 vehicles, T=60 slots, batch 32, the 6-conv CIFAR CNN),
  then the card against the CPU on a small input;
- the VFL training loop of `launch/train.py` at qwen3-32b's full width
  (d_model 5120, 64 query and 8 KV heads of 128, d_ff 25600, vocab
  151936, bf16) cut to 2 repetitions, 4 vehicles with 4 sequences of
  1024 tokens each, then one round of the smoke config in fp32 on the
  card against the CPU.

TF32 is off for matmuls and cuDNN throughout.

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
PEAK_BF16_OPS_PER_S = 989e12       # dense tensor-core rate
# veds_score moves 13 bytes in (g, q, w fp32, e bool) and 12 out (y, p, z
# fp32) per candidate, for 24 fp32 operations (log1p counted as one)
VEDS_BYTES_PER_ELEM = 25
VEDS_OPS_PER_ELEM = 24
# the main path's cut: 3 rounds scheduled as one block
ROUNDS, ROUND_BATCH = 3, 3
# the VFL path: qwen3-32b at full width, 2 repetitions, 4 vehicles x 4
# sequences of 1024 tokens; 1 warm-up round and 3 timed rounds
VFL_REPS, VFL_VEHICLES, VFL_BATCH, VFL_SEQ = 2, 4, 4, 1024
VFL_WARMUP, VFL_ROUNDS, VFL_LR, VFL_SLOTS = 1, 3, 0.5, 50


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


def flash_bound_ms(q, k, causal: bool, window, q_offset: int):
    """Least time for the attention forward on this card: the larger of
    its bytes (q, k, v read once, out and lse written once) over the
    memory rate and its operations (2 * 2 * D per (query, key) pair the
    masks keep, counted on these shapes) over the dense tensor-core rate
    of bf16 (the fp32 CUDA-core rate for fp32 inputs)."""
    B, T, H, D = q.shape
    S = k.shape[1]
    qpos = q_offset + torch.arange(T, dtype=torch.float64)[:, None]
    kpos = torch.arange(S, dtype=torch.float64)[None, :]
    keep = torch.ones((T, S), dtype=torch.bool)
    if causal:
        keep &= qpos >= kpos
    if window is not None:
        keep &= qpos - kpos < window
    pairs = int(keep.sum())
    ops = B * H * pairs * 4 * D
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        + B * H * T * 4
    peak = PEAK_BF16_OPS_PER_S if q.dtype == torch.bfloat16 \
        else PEAK_FP32_OPS_PER_S
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), ops, nbytes


def phase_kernels_llm(device, main_shape=(4, 1024, 64, 8, 128),
                      fedavg_l=151936 * 5120):
    """flash_attention and fedavg_agg against their plain versions on the
    card, at the VFL path's shapes and at the edge cases; timed at the
    main-path shapes beside their bounds and, for attention, PyTorch's
    scaled_dot_product_attention. The attention Function's gradients are
    held against autograd through the plain version at a small shape."""
    import torch.nn.functional as F
    from repro_torch.kernels.fedavg_agg.ops import (fedavg_agg,
                                                    fedavg_agg_plain)
    from repro_torch.kernels.flash_attention.ops import (
        flash_attention, flash_attention_fwd, flash_attention_plain)
    g = torch.Generator(device=device).manual_seed(11)
    res = {"flash_attention": {}, "fedavg_agg": {}}

    def qkv(B, T, S, H, KV, D, dtype):
        return tuple(torch.randn(sh, generator=g, device=device).to(dtype)
                     for sh in ((B, T, H, D), (B, S, KV, D), (B, S, KV, D)))

    B, T, H, KV, D = main_shape
    cases = {
        "main": (B, T, T, H, KV, D, torch.bfloat16, True, None, 0),
        "window": (2, 512, 512, 16, 2, 128, torch.bfloat16, True, 128, 0),
        "full_s_ne_t": (2, 256, 384, 8, 2, 64, torch.bfloat16, False, None,
                        0),
        "ragged": (2, 333, 333, 8, 4, 128, torch.bfloat16, True, None, 0),
        "q_offset": (2, 200, 456, 8, 2, 32, torch.bfloat16, True, None, 256),
        "fp32": (2, 300, 300, 8, 2, 128, torch.float32, True, 100, 0),
        "fp32_d16": (2, 100, 200, 4, 1, 16, torch.float32, True, None, 100),
    }
    for label, (b, t, s_, h, kv, d, dtype, causal, window, off) in \
            cases.items():
        q, k, v = qkv(b, t, s_, h, kv, d, dtype)
        kw = dict(causal=causal, window=window, q_offset=off)
        out, lse = flash_attention_fwd(q, k, v, **kw)
        ref, ref_lse = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        err = float((out.float() - ref.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        check(bool(torch.isfinite(out).all()) and
              bool(((out.float() - ref.float()).abs()
                    <= tol + tol * ref.float().abs()).all()),
              f"flash_attention {label}: kernel disagrees with the plain "
              f"version beyond atol=rtol={tol} (max abs {err:.3e})")
        check(lse_err <= 1e-3, f"flash_attention {label}: lse off by "
              f"{lse_err:.3e}")
        r = dict(shape_q=list(q.shape), shape_kv=list(k.shape),
                 dtype=str(dtype).split(".")[-1], causal=causal,
                 window=window, q_offset=off, max_abs_err=err,
                 lse_max_abs_err=lse_err, tolerance=f"atol=rtol={tol}")
        if label == "main":
            r["ms"] = time_ms(lambda: flash_attention_fwd(q, k, v, **kw), 3,
                              samples=7, warmup=2)
            r["plain_ms"] = time_ms(
                lambda: flash_attention_plain(q, k, v, **kw), 3, samples=7,
                warmup=2)
            (r["bound_ms"], r["bound_by"], r["flops"],
             r["bytes"]) = flash_bound_ms(q, k, causal, window, off)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            try:
                lib = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True, enable_gqa=True)
                r["library_err"] = float(
                    (lib.transpose(1, 2).float() - ref.float()).abs().max())
                r["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True, enable_gqa=True), 5,
                    samples=7, warmup=2)
            except RuntimeError as e:      # the yardstick only
                r["library_ms"], r["library_error"] = None, str(e)[:200]
        res["flash_attention"][label] = r
        log("kernels", f"flash_attention {label} q {list(q.shape)} kv "
            f"{list(k.shape)} {r['dtype']} causal={causal} window={window} "
            f"q_offset={off}: max_abs_err {err:.3e} lse {lse_err:.3e} "
            f"(tolerance atol=rtol={tol})" + (
                f" kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
                f"sdpa {r['library_ms']} ms bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']})" if label == "main" else ""))
        del q, k, v, out, ref

    # gradients of the Function (kernel forward) vs autograd through the
    # plain version, fp32
    q, k, v = (x.requires_grad_() for x in qkv(2, 160, 160, 8, 2, 64,
                                                  torch.float32))
    o = flash_attention(q, k, v, causal=True, window=96, bwd_chunk=64)
    ct = torch.randn(o.shape, generator=g, device=device)
    got = torch.autograd.grad(o, (q, k, v), ct)
    want = torch.autograd.grad(
        flash_attention_plain(q, k, v, causal=True, window=96)[0], (q, k, v),
        ct)
    gerr = max(float((a - b).abs().max()) for a, b in zip(got, want))
    check(all(torch.allclose(a, b, atol=2e-5, rtol=2e-5)
              for a, b in zip(got, want)),
          f"flash_attention gradients off autograd by {gerr:.3e}")
    res["flash_attention"]["grad_max_abs_err"] = gerr
    log("kernels", f"flash_attention Function gradients vs autograd "
        f"through the plain version (fp32, [2,160,8,64]): max abs "
        f"{gerr:.3e} (tolerance 2e-5)")

    V = VFL_VEHICLES
    fcases = {
        "main": (V, fedavg_l, torch.bfloat16, False),
        "ragged": (V, 1_000_003, torch.bfloat16, False),
        "all_failed": (V, 1 << 20, torch.bfloat16, True),
        "fp32": (V, 1 << 22, torch.float32, False),
    }
    for label, (nv, L, dtype, dead) in fcases.items():
        x = torch.randn((nv, L), generator=g, device=device).to(dtype)
        old = torch.randn((L,), generator=g, device=device).to(dtype)
        w = torch.tensor([1.0, 0.0, 2.0, 1.0], device=device)[:nv]
        if dead:
            w = torch.zeros_like(w)
        out = fedavg_agg(x, w, old)
        ref = fedavg_agg_plain(x, w, old)
        torch.cuda.synchronize()
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        err = float((out.float() - ref.float()).abs().max())
        check(bool(((out.float() - ref.float()).abs()
                    <= tol + tol * ref.float().abs()).all()),
              f"fedavg_agg {label}: kernel disagrees with the plain version "
              f"beyond atol=rtol={tol} (max abs {err:.3e})")
        if dead:
            check(torch.equal(out, old), "fedavg_agg all_failed: not old")
        r = dict(shape=[nv, L], dtype=str(dtype).split(".")[-1],
                 sum_w=float(w.sum()), max_abs_err=err,
                 tolerance=f"atol=rtol={tol}")
        del ref
        if label == "main":
            r["ms"] = time_ms(lambda: fedavg_agg(x, w, old), 5, samples=7,
                              warmup=2)
            r["plain_ms"] = time_ms(lambda: fedavg_agg_plain(x, w, old), 1,
                                    samples=5, warmup=1)
            # bytes: x read once, out written once (old is read only when
            # every upload failed); 2V + 1 fp32 operations per element
            nbytes = (nv + 1) * L * x.element_size() + 4 * nv
            ops = (2 * nv + 1) * L
            t_b = nbytes / PEAK_BYTES_PER_S * 1e3
            t_o = ops / PEAK_FP32_OPS_PER_S * 1e3
            r.update(bytes=nbytes, bound_ms=max(t_b, t_o),
                     bound_by="bytes" if t_b >= t_o else "operations",
                     library_ms=None)
        res["fedavg_agg"][label] = r
        log("kernels", f"fedavg_agg {label} x {[nv, L]} {r['dtype']} "
            f"sum_w {r['sum_w']}: max_abs_err {err:.3e} (tolerance "
            f"atol=rtol={tol})" + (
                f" kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
                f"{nbytes / 1e9:.3f} GB)" if label == "main" else ""))
        del x, old, out
    torch.cuda.empty_cache()
    return res


def vfl_config(reps: int = VFL_REPS, vehicles: int = VFL_VEHICLES):
    from repro_torch.configs.registry import get_config
    return get_config("qwen3-32b").replace(n_rep=reps, num_vehicles=vehicles,
                                           grad_accum=1)


def phase_vfl(device, cfg, warmup: int, rounds: int, batch: int, seq: int):
    """The VFL loop of `launch/train.py` (`make_train_step` with the
    scheduler inline) on the card, every kernel count set to 0 first:
    per round the wall time, its stages (each closed by a device
    synchronisation), the schedule's outcome, the eval loss and the peak
    memory; then the launch counts against those the code implies."""
    from repro_torch.kernels.fedavg_agg.ops import fedavg_agg
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.kernels.veds_score.ops import veds_dt_score
    from repro_torch.launch.train import train
    from repro_torch.models import engine
    from repro_torch.models.module import (param_bytes, param_count,
                                           tree_leaves)
    decl = engine.model_decl(cfg, "head")
    log("vfl", f"{cfg.name} n_rep {cfg.n_rep} d_model {cfg.d_model} heads "
        f"{cfg.num_heads}/{cfg.num_kv_heads}x{cfg.head_dim} d_ff {cfg.d_ff} "
        f"vocab {cfg.vocab_size} {cfg.param_dtype}: {param_count(decl)} "
        f"params, {param_bytes(decl) / 1e9:.3f} GB; {cfg.num_vehicles} "
        f"vehicles x {batch} x {seq} tokens")
    stages, records = [], []
    mark = [0.0]

    def hook(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages.append((name, (now - mark[0]) * 1e3))
        mark[0] = now

    def on_round(rec):
        rec["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        records.append(rec)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    fedavg_agg.launches = 0
    veds_dt_score.launches = 0
    mark[0] = time.perf_counter()
    hist = train(cfg, rounds=warmup + rounds, batch_per_vehicle=batch,
                 seq=seq, lr=VFL_LR, seed=0, device=device,
                 log=lambda m: log("vfl", m), stage_hook=hook,
                 on_round=on_round)
    launches = {"flash_attention": flash_attention_fwd.launches,
                "fedavg_agg": fedavg_agg.launches,
                "veds_score": veds_dt_score.launches}

    per_round = [dict(r) for r in records]
    names = [n for n, _ in stages]
    check(names[0] == "setup", "stage marks")
    setup_ms = stages[0][1]
    body = stages[1:]
    for i, rec in enumerate(per_round):
        rec.update({f"{n}_ms": ms for n, ms in body[5 * i: 5 * i + 5]})
        log("vfl", f"round {rec['round']}{' (warm-up)' if i < warmup else ''}"
            f": wall {rec['wall_s'] * 1e3:.1f} ms = scenario "
            f"{rec['scenario_ms']:.1f} + schedule {rec['schedule_ms']:.1f} + "
            f"local_sgd {rec['local_sgd_ms']:.1f} + aggregate "
            f"{rec['aggregate_ms']:.1f} + eval {rec['eval_ms']:.1f} ms; "
            f"n_success {rec['n_success']} mask {rec['mask']} eval loss "
            f"{rec['loss']:.4f}; peak memory {rec['max_memory_gb']:.2f} GB")
        check(math.isfinite(rec["loss"]), f"round {i}: eval loss not finite")
        check(0 <= rec["n_success"] <= VFL_VEHICLES, "n_success range")

    n = warmup + rounds
    V, reps = cfg.num_vehicles, cfg.n_rep
    n_attn = reps * sum(k in ("attn", "attn_swa", "cross")
                        for k in cfg.pattern)
    want = {
        # each attention sub-block per vehicle: forward, and again when
        # remat recomputes it in the backward; plus the eval forward
        "flash_attention": n * (V * n_attn * 2 + n_attn),
        # one launch per parameter leaf per round (the device decides
        # between the mean and `old`, so the count does not depend on the
        # mask)
        "fedavg_agg": n * len(tree_leaves(decl)),
        # one per slot of the round's schedule
        "veds_score": n * VFL_SLOTS,
    }
    log("vfl", f"launches on the VFL path: {launches} (expected {want})")
    for k, w in want.items():
        check(launches[k] == w, f"{k} launched {launches[k]} times on the "
              f"VFL path, expected {w}")
    timed = per_round[warmup:]
    return dict(setup_ms=setup_ms, rounds=per_round, launches=launches,
                expected_launches=want,
                timed_wall_s=[r["wall_s"] for r in timed],
                history_len=len(hist))


def phase_vfl_reference(device, seq: int = 128, batch: int = 4):
    """One VFL round of the smoke config in fp32 on the card and on the
    CPU, from the same weights, batch, mask and weights: the aggregated
    parameters agree within 2e-4 absolute (the CPU tests' tolerance
    against the reference)."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.fl.vfl import make_vfl_round
    from repro_torch.models import engine
    from repro_torch.models.module import materialize, tree_leaves, tree_map
    V = VFL_VEHICLES
    cfg = get_smoke_config("qwen3-32b").replace(
        num_vehicles=V, grad_accum=1, param_dtype="float32",
        compute_dtype="float32")
    params = materialize(torch.Generator().manual_seed(21),
                         engine.model_decl(cfg, "head"))
    b = lm_batch(torch.Generator().manual_seed(22), V * batch, seq,
                 cfg.vocab_size)
    mask, w = torch.tensor([1.0, 0.0, 1.0, 1.0]), torch.tensor(
        [1.0, 1.0, 2.0, 1.0])

    def run(dev):
        p = tree_map(lambda x: x.to(dev).unsqueeze(0).expand(V, *x.shape),
                     params)
        bv = {k: x.to(dev).reshape(V, batch, seq) for k, x in b.items()}
        out = make_vfl_round(cfg, None, "head", lr=0.1)(
            p, bv, mask.to(dev), w.to(dev))
        return [x[0].cpu() for x in tree_leaves(out)]

    cpu, gpu = run("cpu"), run(device)
    err = max(float((a - c).abs().max()) for a, c in zip(gpu, cpu))
    moved = max(float((c - p0).abs().max())
                for c, p0 in zip(cpu, tree_leaves(params)))
    check(err <= 2e-4, f"VFL round: card vs CPU aggregate differs by "
          f"{err:.3e} > 2e-4")
    log("vfl_reference", f"one VFL round of the smoke config (fp32, V={V}, "
        f"mask {mask.tolist()}, weights {w.tolist()}): card vs CPU "
        f"aggregate max abs {err:.3e} (tolerance 2e-4; the round moved the "
        f"params by up to {moved:.3e})")
    return dict(max_abs_err=err, max_update=moved)


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
        f"{PEAK_BYTES_PER_S:.3g} B/s, {PEAK_FP32_OPS_PER_S:.3g} fp32 op/s "
        f"and {PEAK_BF16_OPS_PER_S:.3g} bf16 op/s")

    t0 = time.perf_counter()
    lib = load_library()
    build_s = time.perf_counter() - t0
    log("build", f"{lib.path.relative_to(ROOT)} in {build_s:.1f} s")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            log("build", line.strip())

    kernels = phase_kernels({"main": (ROUND_BATCH, 10),
                             "large": (1 << 22,)}, device)
    llm_kernels = phase_kernels_llm(device)
    main_res, setup = phase_main(device, ROUNDS, ROUND_BATCH)
    stages = phase_stages(device, setup)
    ref = phase_reference(device)
    del setup
    torch.cuda.empty_cache()
    vfl = phase_vfl(device, vfl_config(), VFL_WARMUP, VFL_ROUNDS, VFL_BATCH,
                    VFL_SEQ)
    vfl_ref = phase_vfl_reference(device)

    k = kernels["main"]
    fa = llm_kernels["flash_attention"]
    fd = llm_kernels["fedavg_agg"]
    line = {"kernels": [{
        "name": "veds_score", "route": "cuda",
        "source": "src/repro_torch/kernels/veds_score/csrc/veds_score.cu",
        "replaces": "src/repro/kernels/veds_score/veds_score.py:25",
        "launches": vfl["launches"]["veds_score"],
        "launches_by_path": {"run_fl": main_res["launches"]["veds_score"],
                             "vfl": vfl["launches"]["veds_score"]},
        "max_abs_err": max(r["max_abs_err"] for r in kernels.values()),
        "ms": k["ms"],
        "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
        "bound_by": k["bound_by"], "library_ms": None,
        "shape": k["shape"]}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:29",
        "launches": vfl["launches"]["flash_attention"],
        "max_abs_err": max(r["max_abs_err"] for r in fa.values()
                           if isinstance(r, dict)),
        "ms": fa["main"]["ms"], "plain_ms": fa["main"]["plain_ms"],
        "bound_ms": fa["main"]["bound_ms"],
        "bound_by": fa["main"]["bound_by"],
        "library_ms": fa["main"]["library_ms"],
        "shape": {"q": fa["main"]["shape_q"],
                  "kv": fa["main"]["shape_kv"]}}, {
        "name": "fedavg_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/fedavg_agg/csrc/fedavg_agg.cu",
        "replaces": "src/repro/kernels/fedavg_agg/fedavg_agg.py:20",
        "launches": vfl["launches"]["fedavg_agg"],
        "max_abs_err": max(r["max_abs_err"] for r in fd.values()),
        "ms": fd["main"]["ms"], "plain_ms": fd["main"]["plain_ms"],
        "bound_ms": fd["main"]["bound_ms"],
        "bound_by": fd["main"]["bound_by"], "library_ms": None,
        "shape": fd["main"]["shape"]}]}
    out = ROOT / "chiprun_out" / "chip_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(
        smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s, kernels=kernels, llm_kernels=llm_kernels,
        main=main_res, stages=stages, reference=ref, vfl=vfl,
        vfl_reference=vfl_ref), indent=1,
        default=str))
    log("device", smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
