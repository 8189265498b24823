"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version on the card (`flash_attention`
and `ssd_scan` in both variants: bf16 inputs on the tensor-core kernels,
fp32 on the CUDA-core ones, each case checked to reach its dtype's entry
point), and drives the port's three main paths, each checked and each
with its kernel launches counted from 0:

- `run_fl`, blocked, VEDS + CNN FedAvg at the paper's full width (40
  clients, S=U=10 vehicles, T=60 slots, batch 32, the 6-conv CIFAR CNN),
  with its stages timed and traced and the block's schedule run again
  with the slot step eager, then the card against the CPU on a small
  input. On the card `veds_round` replays one captured CUDA graph of the
  VEDS slot step per slot; every phase that schedules logs the graphs it
  captured, and the graph is held to the eager step bit for bit;
- `run_fl(streaming=True)`, the paper's own loop, at the same setting: a
  persistent fleet, carried queues and the warm P4 table riding the
  slot graph, 20 rounds with eval every 5 inside the loop, then 5 rounds
  cold, each round's stages timed; the warm slot graph held to the
  eager step on one streaming round, and 3 small streaming rounds on
  the card against the CPU;
- the paper's Section VI comparison: all five schedulers (`veds` and
  the benchmarks `optimal`, `v2i_only`, `madca`, `sa`) through blocked
  `run_fl` on fig10's CIFAR task and on fig12's trajectory task
  (LaneGCN at its full width on 40 clients of 128 Argoverse-like
  tracks), 20 rounds each, stage by stage, `veds_score` counted under
  each; the five on one fig10 batch and LaneGCN on the card against the
  CPU (`v2i_only`'s slot graph, without COT, against its eager step);
  then the four baselines through `run_fl(streaming=True)`;
- the VFL training loop of `launch/train.py` at qwen3-32b's full width
  (d_model 5120, 64 query and 8 KV heads of 128, d_ff 25600, vocab
  151936, bf16) cut to 2 repetitions, 4 vehicles with 4 sequences of
  1024 tokens each, at `launch/train.py`'s lr 0.5, and its whole-run
  streaming step (`make_train_step(stream=...)`, 2 rounds);
- the same loop at granite-moe-1b-a400m's full width and depth (24 x
  (attention of 16 query and 8 KV heads of 64, MoE of 32 experts top-8
  with expert d_ff 512), d_model 1024, vocab 49155, bf16; 1.385 B
  parameters) at `GRANITE_LR`, with the share of bf16 entries its round
  0 changes; one MoE block at that width run twice, forward and
  backward, bit for bit, and its combine timed beside `index_add_`;
- the same loop at zamba2-2.7b's full width and depth (9 x (5 Mamba2,
  the weight-tied attention of 32 heads of 80 and MLP), d_model 2560,
  80 SSM heads of 64, N 64, chunk 128, vocab 32000, bf16), the path of
  all four kernels, at one fixed lr (`ZAMBA2_LR`: at the reference's
  init lr 1e-5 and above give NaN there, far below `launch/train.py`'s
  default of 0.5), with the share of bf16 parameter
  entries that its round 0 changes; then one round of each smoke config
  in fp32 on the card against the CPU (zamba2's with 2 repetitions, so
  that the tied block is used twice; granite's, llama4-scout's and the
  dense starcoder2's, codeqwen's and minitron's too);
- the same loop at xlstm-1.3b's full width, its depth cut from 6 to
  `XLSTM_REPS` 1 repetition (7 mLSTM + 1 sLSTM; d_model 2048, 4 heads,
  mLSTM head dim 1024 and chunk 128, vocab 50304, bf16) at `XLSTM_LR`,
  with one mLSTM and
  one sLSTM sub-block timed beside the rounds' local SGD; and at
  whisper-small's (12 bidirectional encoder layers over 1536 frames, 12 x
  (attention, cross-attention onto the encoded frames, MLP), d_model 768,
  12 heads of 64, vocab 51865, bf16; 279 M parameters), whose batches
  carry `src` [b, 1536, 768] (`data/synthetic.py` `src_lm_batch`), at
  `WHISPER_LR`; then the card against the CPU for the xlstm, whisper
  (one encoder layer and one repetition, where the round is well
  conditioned at the init) and llama-3.2-vision smoke configs, the last
  two with `src`. `flash_attention` is also held
  and timed at whisper's encoder, cross and self shapes and at
  llama-3.2-vision's cross shape, beside SDPA under the same mask.

- the scheduling service (`launch/serve.py`): the reference's own
  `ServeConfig()` (madca, B 4, L 4) over 3 waves of 6 sessions on the card
  against the CPU on the same draws, then VEDS with the warm P4 table at
  fig10's width (S=U=10, T=60, fleets of 40, B 8 on the tier ladder (2,
  4, 8) x (1, 2, 4, 8), 4 sessions on the card) under 12 sessions'
  mixed load, each dispatch timed, no slot graph captured after
  `warmup()`, and requests replayed alone at B = 1 (masks identical, the
  floats' distance in ulps, and where they part, the first operation
  that parts them).

The VFL rounds' masks must be those recorded before the bf16 kernels
moved to the tensor cores (the schedule does not depend on the kernels);
their eval losses are logged beside the recorded ones, and each
model's eval loss at init is taken through the kernels, through their
plain versions and with every bf16 weight moved one ulp, to set the
kernels' effect beside the model's own sensitivity. `veds_score` is
also timed launched from a CUDA graph, beside a one-element PyTorch op
captured the same way (the floor of that setting). TF32 is off for
matmuls and cuDNN throughout.

The last line of its output is `{"ok": true, "device": {...}}`; the line
before it lists each kernel with its launches on the main path, its error
against the plain version and its times beside its bound. Details go to
`chiprun_out/chip_smoke.json`. Any failed phase raises and the script
exits non-zero, as it does without a CUDA device.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
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
# zamba2-2.7b on the same VFL path at full width and full depth, at one
# fixed lr: the largest power of ten at which all 4 rounds keep a finite
# eval loss and round 0 changes at least ZAMBA2_MIN_CHANGED of the bf16
# parameter entries (PERF.md section 4: the reference's init makes
# zamba2's gradients explode, and lr 1e-5 and above give NaN)
ZAMBA2_REPS, ZAMBA2_LR, ZAMBA2_MIN_CHANGED = 9, 1e-6, 0.1
# granite-moe-1b-a400m on the same VFL path at full width and full depth
# (24 x (attn, moe)), at the largest power of ten at which all 4 rounds
# keep a finite eval loss: at the reference's init its gradients reach
# ~1e16 (no qk-norm; they grow about tenfold a repetition, on the
# reference's side as on the port's), and 1e-14 and above give NaN
# (PERF.md section 4). No power of ten also changes ZAMBA2_MIN_CHANGED of
# the bf16 entries in round 0; the share is logged and must be positive.
GRANITE_REPS, GRANITE_LR = 24, 1e-15
# xlstm-1.3b (at 1 of its 6 repetitions of (7 mLSTM + 1 sLSTM): its
# sLSTM time loop is host-bound, 100-144 s a round at full depth) and
# whisper-small (12 encoder layers, 12 x (attn, cross, mlp), full depth)
# on the same VFL path at full width, each at the largest power of ten up
# to launch/train.py's 0.5 at which all 4 rounds keep a finite eval loss
# (`tests/torch_chip_probes.py lr-sweep` on an NVIDIA H100 80GB HBM3 at
# 700 W; PERF.md sections 4 and 6, PRs 23 and 24): at the reference's
# init the largest gradients reach ~1.6e4 at xlstm's one repetition
# (~1e15 at its six) and ~1e24 in whisper's encoder, so 1e-4 and 1e-21
# give NaN; the share of bf16 entries round 0 changes is logged and must
# be positive
XLSTM_REPS, XLSTM_LR = 1, 1e-5
WHISPER_REPS, WHISPER_LR = 12, 1e-22
# the flash_attention cases of phase_kernels_llm timed beside their bounds
TIMED_FLASH = ("main", "zamba2", "granite", "whisper_encoder",
               "whisper_cross", "whisper_self", "vlm_cross")
# the C entry point each dtype must reach: bf16 the tensor-core kernels,
# fp32 the CUDA-core ones
FLASH_ENTRY = {torch.bfloat16: "flash_attention_fwd_bf16_sm90",
               torch.float32: "flash_attention_fwd_f32"}
SSD_ENTRY = {torch.bfloat16: "ssd_scan_fwd_bf16_sm90",
             torch.float32: "ssd_scan_fwd_f32"}
# the VFL rounds' schedule masks as measured with the CUDA-core kernels
# (NVIDIA H100 80GB HBM3, 700 W, PERF.md section 5); no kernel touches
# the schedule, so they must be the same
RECORDED_MASKS = {
    "qwen3-32b": [[1, 1, 1, 0], [1, 1, 1, 1], [1, 1, 1, 1], [0, 1, 1, 1]],
    "zamba2-2.7b": [[1, 1, 1, 0], [1, 1, 1, 1], [1, 1, 1, 1], [0, 1, 1, 1]],
    # Q = min(8 x param bytes, 2e7) is capped for every model here, so the
    # schedule is the same
    "granite-moe-1b-a400m": [[1, 1, 1, 0], [1, 1, 1, 1], [1, 1, 1, 1],
                             [0, 1, 1, 1]],
    "xlstm-1.3b": [[1, 1, 1, 0], [1, 1, 1, 1], [1, 1, 1, 1], [0, 1, 1, 1]],
    "whisper-small": [[1, 1, 1, 0], [1, 1, 1, 1], [1, 1, 1, 1],
                      [0, 1, 1, 1]],
}
# the streaming path (`run_fl(streaming=True)`): rounds with the warm P4
# table (benchmarks/fig4_speed.py warm_ipm_sweep's budget, at most half
# of ipm_iters 25) and eval every 5 rounds inside the loop, then rounds
# cold; the whole-run VFL step takes 2 rounds
STREAM_ROUNDS, STREAM_EVAL_EVERY, STREAM_WARM_ITERS = 20, 5, 10
STREAM_COLD_ROUNDS, STREAM_SEED, STREAM_VFL_ROUNDS = 5, 11, 2
# the Section VI comparison (figs. 10-12): the five schedulers through
# blocked run_fl on fig10's CIFAR task and fig12's trajectory task, cut
# from the figure scripts' 30 rounds; then the four baselines through
# run_fl(streaming=True)
COMPARE_SCHEDULERS = ("veds", "optimal", "v2i_only", "madca", "sa")
COMPARE_ROUNDS, COMPARE_EVAL_EVERY, COMPARE_SEED = 20, 5, 4
TRAJ_CLIENTS, TRAJ_PER_CLIENT, TRAJ_TEST = 40, 128, 512
STREAM_COMPARE_ROUNDS = 10
# the scheduling service (`launch/serve.py`): the reference's own
# `ServeConfig()` on the card against the CPU over 3 waves of 6 sessions
# (repeat sessions in the later waves), then VEDS with warm P4 at fig10's
# width: SERVE_SESSIONS sessions sending the reference's serve_tier_sweep
# mix of round counts (`benchmarks/fig4_speed.py`: the tiers, then all
# but the last again), packed into windows of up to SERVE_WINDOW
# requests; SERVE_TRACK's requests are replayed alone at B = 1
SERVE_REF_WAVES = (
    (("s0", 1, 0), ("s1", 2, 1), ("s2", 3, 2), ("s3", 4, 3)),
    (("s4", 4, 10), ("s5", 3, 11), ("s0", 2, 12), ("s1", 1, 13)),
    (("s2", 2, 20), ("s3", 2, 21), ("s4", 3, 22), ("s5", 1, 23)))
SERVE_FIG10 = dict(batch=8, tiers=(2, 4, 8), scheduler="veds", n_sov=10,
                   n_opv=10, n_slots=60, n_fleet=40,
                   ipm_warm_iters=STREAM_WARM_ITERS, batch_size=32,
                   n_clients=40, max_sessions=4)
SERVE_SESSIONS, SERVE_MIX, SERVE_WINDOW = 12, (2, 4, 8, 2, 4), 8
SERVE_TRACK = ((0, 0), (0, 1), (5, 0), (5, 1))
SERVE_LOSS_RTOL = SERVE_CARRY_RTOL = 1e-5
# the eval loss at init through the kernels may move from the plain
# versions' by at most SENS_ULP_FACTOR times the largest move that
# SENS_DRAWS random one-ulp changes of every nonzero bf16 weight make
SENS_DRAWS, SENS_ULP_FACTOR = 4, 2.0

def free() -> None:
    """Return the memory of the phase before to the card."""
    gc.collect()
    torch.cuda.empty_cache()


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


def flash_used(out, lse, ref, ref_lse, allow: float = 1.0) -> float:
    """The share of its bound that flash_attention's worst entry uses
    against the plain version's (1 = at the bound; inf where the output
    is not finite): each output entry within allow x (tol + tol |ref|)
    (tol 2e-2 in bf16, 2e-5 in fp32), the float32 lse, where given,
    within 1e-3."""
    if not bool(torch.isfinite(out).all()):
        return math.inf
    tol = 2e-2 if out.dtype == torch.bfloat16 else 2e-5
    o = (out.float() - ref.float()).abs() / (tol + tol * ref.float().abs())
    used = float(o.max()) / allow
    if lse is None:
        return used
    return max(used, float((lse - ref_lse).abs().max()) / 1e-3)


def flash_used_beside_library(args, kw, out, ref):
    """flash_attention's share of its bound on a model's own inputs
    (`args`, `kw` of one call), where the output's allowance is the larger
    of the bound and 1.25 times the share that PyTorch's bf16
    scaled_dot_product_attention uses on the same inputs: at the models'
    init |v| reaches ~250, and rounding the attention probabilities to
    bf16, as both do, leaves absolute errors past the bound's 2e-2 at
    entries whose terms cancel (PERF.md section 6). Returns the share and
    the library's."""
    check(kw.get("window") is None and not kw.get("q_offset"),
          f"flash_attention call {kw}: the library yardstick covers causal "
          f"and full attention without a window")
    lib = torch.nn.functional.scaled_dot_product_attention(
        *(x.transpose(1, 2) for x in args), is_causal=kw.get("causal", True),
        enable_gqa=True).transpose(1, 2)
    lib_used = flash_used(lib, None, ref[0], None)
    return flash_used(*out, *ref, allow=max(1.0, 1.25 * lib_used)), lib_used


def ssd_used(y, st, ry, rst) -> float:
    """The share of its bound that ssd_scan's worst entry uses against the
    plain version's (1 = at the bound; inf where an output is not finite):
    bf16 y entry by entry within 2^-7 |ry| + 1e-3 max|ry|, fp32 y within
    5e-5 max|ry|, the float32 final state within 5e-5 max|rst|."""
    if not (bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all())):
        return math.inf
    ys = float(ry.float().abs().max())
    diff = (y.float() - ry.float()).abs()
    if y.dtype == torch.bfloat16:
        y_used = float((diff / (2.0 ** -7 * ry.float().abs()
                                + 1e-3 * ys)).max())
    else:
        y_used = float(diff.max()) / (5e-5 * ys)
    return max(y_used, float((st - rst).abs().max())
               / (5e-5 * float(rst.abs().max())))


def bound_ms(n: int):
    t_bytes = n * VEDS_BYTES_PER_ELEM / PEAK_BYTES_PER_S * 1e3
    t_ops = n * VEDS_OPS_PER_ELEM / PEAK_FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def graph_ms(fn, reps: int = 100, inner: int = 20):
    """Per-launch time of `fn` captured `reps` times into one CUDA graph
    and replayed (after one warm-up call outside the capture, as PyTorch's
    recipe asks), and what the last captured call returned, as the
    replays left it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            out = fn()
    ms = time_ms(graph.replay, inner) / reps
    torch.cuda.synchronize()
    return ms, out


def phase_kernels(shapes, device, graphed=()):
    """Each kernel against its plain version on the card, and timed; at
    the shapes in `graphed` also launched from a CUDA graph of 100
    launches (bit for bit against the plain version), beside the floor of
    that setting: a one-element PyTorch op captured the same way."""
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
        if label not in graphed:
            continue
        g_ms, outs = graph_ms(lambda: veds_dt_score(g, q, w, e, **kw))
        check(all(torch.equal(a, b) for a, b in zip(outs, plain)),
              f"veds_score {label}: launched from a CUDA graph, the kernel "
              f"differs from the plain version")
        one = torch.zeros(1, device=device)
        floor_ms, _ = graph_ms(lambda: one.add_(1.0))
        res[label].update(graph_ms=g_ms, graph_floor_ms=floor_ms)
        log("kernels", f"veds_score {label} {list(shape)} from a CUDA graph "
            f"of 100 launches: {g_ms:.5f} ms a launch, bit for bit as the "
            f"plain version; floor (a one-element add_ in the same "
            f"setting) {floor_ms:.5f} ms; eager {ms:.5f} ms")
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
    from repro_torch.core.veds import _SlotGraph
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
    captures = _SlotGraph.captures
    t0 = time.perf_counter()
    hist = run_fl(0, params, cnn_loss, client_data, sim, eval_fn=eval_fn,
                  eval_every=1, device=device)
    wall = time.perf_counter() - t0          # run_fl synchronises at exit
    launches = {"veds_score": veds_dt_score.launches}
    captures = _SlotGraph.captures - captures

    n_blocks = math.ceil(rounds / round_batch)
    want = n_blocks * sim.n_slots
    log("main", f"run_fl {device}: clients {sim.n_clients} "
        f"S=U={sim.n_sov} T={sim.n_slots} batch {sim.batch_size} "
        f"scheduler {sim.scheduler} rounds {rounds} round_batch "
        f"{round_batch}: wall {wall:.3f} s")
    log("main", f"n_success {hist['n_success']} test_acc "
        f"{[round(m, 4) for m in hist['metric']]}")
    log("main", f"launches on the main path: {launches} (expected "
        f"veds_score {want} = {n_blocks} blocks x T {sim.n_slots}); slot "
        f"graphs captured: {captures}")
    check(launches["veds_score"] == want,
          f"veds_score launched {launches['veds_score']} times on the main "
          f"path, expected {want}")
    check(hist["scheduled_rounds"] == rounds and
          hist["round"] == list(range(rounds)), "history rounds")
    check(all(0 <= s <= sim.n_sov for s in hist["n_success"]),
          "n_success out of range")
    check(all(math.isfinite(m) and 0.0 <= m <= 1.0
              for m in hist["metric"]), "accuracy not finite in [0, 1]")
    return dict(history=hist, wall_s=wall, launches=launches,
                graph_captures=captures), \
        (params, client_data, eval_fn, sim)


def phase_stages(device, setup):
    """One block of the main path, stage by stage: scenario, scheduling,
    training, eval. A first pass closes each stage with a device
    synchronisation and times it on the host clock, and schedules the
    same rounds again with the slot step run eagerly (the path before the
    slot graph), timed the same way and held to the graph's outputs bit
    for bit; a second pass runs the block under `torch.profiler` and
    reads the device's busy time (the sum of its kernels' and copies'
    times) and their number. The idle share is reported only where the
    trace holds the `veds_score` launches of the graph's replays, and that
    trace must see one `veds_score` run a slot. The same trace then holds
    the schedule alone, which must see one `veds_score` run a slot too.
    Each part opens on two eager kernels run to their end, which the
    summary leaves out and which mark where the schedule's part
    begins."""
    from repro_torch.channel.mobility import ManhattanParams
    from repro_torch.channel.v2x import ChannelParams
    from repro_torch.core.baselines import get_scheduler
    from repro_torch.core.lyapunov import VedsParams
    from repro_torch.core.scenario import (ScenarioParams, make_round,
                                           round_generator)
    from repro_torch.core.veds import RoundInputs, _SlotGraph, _veds_round
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
            p, _ = fedavg_apply(p, grads, out.cell(j).success.float(),
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
        return rounds, out

    times = {}
    captures = _SlotGraph.captures
    rounds, out = block(times)
    captures = _SlotGraph.captures - captures
    log("stages", f"one block of {B} rounds: " + ", ".join(
        f"{k[:-3]} {v:.1f} ms" for k, v in times.items())
        + f"; slot graphs captured in it: {captures}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = _veds_round(RoundInputs.stack(rounds), prm, ch, enable_cot=True,
                        carry=None, graphed=False)
    torch.cuda.synchronize()
    times["schedule_eager_ms"] = (time.perf_counter() - t0) * 1e3
    for k in out.keys():
        check(torch.equal(out[k], eager[k]), f"stages: the slot graph's "
              f"{k} differs from the eager step's")
    check(torch.equal(out.carry.qs, eager.carry.qs)
          and torch.equal(out.carry.qu, eager.carry.qu),
          "stages: the slot graph's queues differ from the eager step's")
    log("stages", f"the same rounds with the slot step run eagerly: "
        f"schedule {times['schedule_eager_ms']:.1f} ms (graph "
        f"{times['schedule_ms']:.1f} ms); outputs bit for bit equal")

    # Each part of the trace opens on two eager kernels (PyTorch's
    # `spin_kernel`), each run to its end and followed by 10 ms on the
    # host; the summary leaves them out and counts those it holds. The
    # block and the schedule alone share one profiler session: a session
    # after the first in a process loses stretches of its records (on an
    # H100 from one kernel to ~34k events, at its opening or its end,
    # in runs of PRs 18 and 19), and the first session lost none.
    from torch.profiler import ProfilerActivity, profile

    def open_trace():
        for _ in range(2):
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.01)

    traced = {}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        open_trace()
        block(traced)
        open_trace()
        t0 = time.perf_counter()
        get_scheduler("veds").solve_round(RoundInputs.stack(rounds), prm, ch)
        torch.cuda.synchronize()
        sched_wall_ms = (time.perf_counter() - t0) * 1e3
    from torch.autograd import DeviceType
    events = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    # the schedule's part begins at the first opener after the block's work
    work = next((i for i, e in enumerate(events)
                 if "spin_kernel" not in e.name), len(events))
    cut = next((i for i in range(work, len(events))
                if "spin_kernel" in events[i].name), None)
    check(cut is not None, "stages: the trace holds no opener between the "
          "block and the schedule")
    prof_res = trace_summary(events[:cut], sum(traced.values()),
                             sim.n_slots, opener="spin_kernel")
    log("stages", f"traced block (schedule {traced['schedule_ms']:.1f} "
        f"ms): " + trace_line(prof_res))
    sched_res = trace_summary(events[cut:], sched_wall_ms, sim.n_slots,
                              opener="spin_kernel")
    sched_res["events_per_slot"] = sched_res["device_events"] / sim.n_slots
    log("stages", f"traced schedule alone ({sched_res['events_per_slot']:.1f}"
        f" device events a slot): " + trace_line(sched_res))
    # one veds_score run a slot seen by the profiler, apart from the
    # kernel's own count, in each part
    for part, res in (("block", prof_res), ("schedule", sched_res)):
        check(res["veds_score_events"] == sim.n_slots,
              f"stages: the traced {part} ran veds_score "
              f"{res['veds_score_events']} times on the card, expected "
              f"one a slot ({sim.n_slots})")
    return dict(rounds=B, graph_captures=captures, **times,
                profile=prof_res, profile_schedule=sched_res)


def trace_summary(events, wall_ms: float, n_slots: int, opener=None):
    """Device busy time (the sum of the kernels', copies' and memsets'
    times) and number of `events`, a stretch of a `torch.profiler` trace's
    device events in start order, over `wall_ms` of host time, and the
    idle share, reported only where the trace holds the
    `n_slots` `veds_score` launches of the slot graph's replays and, where
    the trace was opened by kernels named `opener`, one of them at least
    (a trace loses a stretch of records from its opening: where it holds
    an opener, the stretch ended before the timed work). The openers are
    left out and counted. `slot_events` gives the device events
    before the first `veds_score` run, [min, max] between two, and after
    the last, in start order: where a trace loses records."""
    seen = None
    if opener is not None:
        seen = sum(opener in e.name for e in events)
        events = [e for e in events if opener not in e.name]
    marks = [i for i, e in enumerate(events) if "veds_score" in e.name]
    gaps = [b - a - 1 for a, b in zip(marks, marks[1:])]
    slot_events = (None if not marks else
                   [marks[0], [min(gaps, default=0), max(gaps, default=0)],
                    len(events) - 1 - marks[-1]])
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    n_veds = sum("veds_score" in e.name for e in events)
    whole = busy_ms > 0 and n_veds == n_slots and seen != 0
    return dict(traced_wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_events=len(events), veds_score_events=n_veds,
                idle_share=(1.0 - busy_ms / wall_ms) if whole else None,
                opener_seen=seen, slot_events=slot_events)


def trace_line(res) -> str:
    idle = (f"{res['idle_share']:.3f}" if res["idle_share"] is not None
            else "not measured (the trace lost veds_score runs or its "
                 "openers)")
    return (f"wall {res['traced_wall_ms']:.1f} ms, device busy "
            f"{res['device_busy_ms']:.1f} ms in {res['device_events']} "
            f"device events ({res['veds_score_events']} of veds_score; "
            f"events before the first, between two and after the last: "
            f"{res['slot_events']}; openers held {res['opener_seen']}), "
            f"idle share {idle}")


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
    from repro_torch.core.veds import RoundInputs, _veds_round, veds_round
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
    eager = _veds_round(rnd.to(device), prm, ch, enable_cot=True, carry=None,
                        graphed=False)
    for k in gpu.keys():
        check(torch.equal(gpu[k], eager[k]), f"veds_round {k}: the slot "
              f"graph differs from the eager step on the card")
    check(torch.equal(gpu.carry.qs, eager.carry.qs)
          and torch.equal(gpu.carry.qu, eager.carry.qu),
          "veds_round queues: the slot graph differs from the eager step")

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
        return gr, fedavg_apply(p, gr, mask.to(dev), w.to(dev), lr=0.07)[0]

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
        f"{cpu.n_cot_slots.tolist()}); on the card the slot graph equals the "
        f"eager step bit for bit; CNN grads {grad_err:.2e} and FedAvg "
        f"update {upd_err:.2e} relative (norm-wise, tolerance 1e-4)")
    return dict(n_success=cpu.n_success.tolist(),
                n_cot_slots=cpu.n_cot_slots.tolist(),
                grad_rel_err=grad_err, update_rel_err=upd_err)


def _stage_timer(records):
    """A `stage_hook` closing each stage with a device synchronisation:
    appends one dict of `<stage>_ms` a round to `records` (a round ends
    with its "eval" stage). Call `.start()` right before the run."""
    cur, mark = {}, [0.0]

    def hook(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        cur[f"{name}_ms"] = (now - mark[0]) * 1e3
        mark[0] = now
        if name == "eval":
            records.append(dict(cur))
            cur.clear()

    hook.start = lambda: mark.__setitem__(0, time.perf_counter())
    return hook


def _median(xs):
    return statistics.median(xs) if xs else float("nan")


def phase_stream(device, setup):
    """The paper's own loop, `run_fl(streaming=True)`, at fig10's setting
    (the CNN and data of `make_fl_setup`, 40 clients, S=U=10, T=60,
    batch 32, lr 0.07, a persistent fleet of 2(S+U) vehicles, carried
    queues, VEDS with COT): STREAM_ROUNDS rounds with the warm P4 table
    (`ipm_warm_iters` STREAM_WARM_ITERS) and eval every
    STREAM_EVAL_EVERY rounds inside the loop, then STREAM_COLD_ROUNDS
    rounds cold, each stage of every round closed by a device
    synchronisation (the stage hook). `veds_score` must run T times a
    round by its own count. Then the warm slot graph against the eager
    step on one streaming round, bit for bit."""
    import dataclasses
    from repro_torch.channel.mobility import ManhattanParams
    from repro_torch.channel.v2x import ChannelParams
    from repro_torch.core.baselines import get_scheduler
    from repro_torch.core.lyapunov import VedsParams
    from repro_torch.core.scenario import ScenarioParams, fleet_round
    from repro_torch.core.scheduler import SchedulerCarry
    from repro_torch.core.streaming import (ROUND_STREAM, StreamConfig,
                                            round_key, stream_rounds)
    from repro_torch.core.veds import _SlotGraph, _veds_round, veds_round
    from repro_torch.fl.simulator import run_fl
    from repro_torch.kernels.veds_score.ops import veds_dt_score
    from repro_torch.models.cnn import cnn_loss
    params, client_data, eval_fn, sim = setup
    out = {}
    for label, rounds, warm, every in (
            ("warm", STREAM_ROUNDS, STREAM_WARM_ITERS, STREAM_EVAL_EVERY),
            ("cold", STREAM_COLD_ROUNDS, 0, None)):
        s = dataclasses.replace(sim, rounds=rounds, round_batch=1,
                                streaming=True, carry_queues=True,
                                ipm_warm_iters=warm)
        records = []
        hook = _stage_timer(records)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        veds_dt_score.launches = 0
        captures = _SlotGraph.captures
        t0 = time.perf_counter()
        hook.start()
        hist = run_fl(STREAM_SEED, params, cnn_loss, client_data, s,
                      eval_fn=eval_fn if every else None,
                      eval_every=every or 1, device=device,
                      stage_hook=hook)
        wall = time.perf_counter() - t0      # run_fl synchronises at exit
        launches = veds_dt_score.launches
        captures = _SlotGraph.captures - captures
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(len(records) == rounds, f"stream {label}: {len(records)} "
              f"rounds timed, expected {rounds}")
        for r, rec in enumerate(records):
            log("stream", f"{label} round {r}: scenario "
                f"{rec['scenario_ms']:.1f} + schedule "
                f"{rec['schedule_ms']:.1f} + train {rec['train_ms']:.1f} + "
                f"eval {rec['eval_ms']:.1f} ms"
                + (" (round 0's scenario includes run_fl's set-up)"
                   if r == 0 else ""))
        steady = records[1:]
        med = {k: _median([rec[k] for rec in steady])
               for k in ("scenario_ms", "schedule_ms", "train_ms",
                         "eval_ms")}
        want = rounds * s.n_slots
        log("stream", f"{label}: run_fl(streaming=True) {rounds} rounds, "
            f"ipm_warm_iters {warm}, eval every {every}: wall {wall:.3f} "
            f"s; median of rounds 1.. " + ", ".join(
                f"{k[:-3]} {v:.2f} ms" for k, v in med.items())
            + f"; veds_score launches {launches} (expected {want} = "
            f"{rounds} x T {s.n_slots}); slot graphs captured {captures}; "
            f"peak memory {peak_gb:.3f} GB; history {hist}")
        check(launches == want, f"stream {label}: veds_score launched "
              f"{launches} times, expected {want}")
        check(hist["scheduled_rounds"] == rounds, "stream history rounds")
        if every:
            check(hist["dispatches"] == 1
                  and hist["round"] == [r for r in range(rounds)
                                        if r % every == 0 or
                                        r == rounds - 1],
                  f"stream {label}: history {hist}")
            check(all(0 <= n <= sim.n_sov for n in hist["n_success"])
                  and all(math.isfinite(m) and 0.0 <= m <= 1.0
                          for m in hist["metric"]),
                  f"stream {label}: n_success or accuracy out of range")
        out[label] = dict(rounds=records, median=med, wall_s=wall,
                          launches={"veds_score": launches},
                          graph_captures=captures, peak_memory_gb=peak_gb,
                          history=hist)
    out["schedule_warm_over_cold"] = (out["warm"]["median"]["schedule_ms"]
                                      / out["cold"]["median"]["schedule_ms"])
    log("stream", f"warm schedule / cold schedule (medians): "
        f"{out['schedule_warm_over_cold']:.3f}")

    # the warm slot graph against the eager step on one streaming round:
    # two rounds refresh the table and queues, the third is held
    mob, ch = ManhattanParams(v_max=sim.v_max), ChannelParams()
    prm = VedsParams(alpha=sim.alpha, V=sim.V, Q=sim.q_bits, slot=0.1,
                     ipm_warm_iters=STREAM_WARM_ITERS)
    sc = ScenarioParams(n_sov=sim.n_sov, n_opv=sim.n_opv,
                        n_slots=sim.n_slots, batch_size=sim.batch_size)
    pre = stream_rounds(STREAM_SEED, get_scheduler("veds"), sc, mob, ch, prm,
                        StreamConfig(n_rounds=2, carry_queues=True),
                        device=device)
    fl, rnd, sel = fleet_round(round_key(STREAM_SEED, ROUND_STREAM, 2),
                               pre.fleet, sc, mob, ch, prm)
    rows = torch.arange(1, device=device)[:, None]
    c = SchedulerCarry(qs=torch.gather(fl.queue, 1, sel.sov_idx),
                       qu=torch.gather(fl.queue, 1, sel.opv_idx),
                       p4=fl.p4_tab[rows, sel.sov_idx])
    g = veds_round(rnd, prm, ch, carry=c)
    e = _veds_round(rnd, prm, ch, enable_cot=True, carry=c, graphed=False)
    for k in g.keys():
        check(torch.equal(g[k], e[k]), f"stream: the warm slot graph's {k} "
              f"differs from the eager step's")
    for k in ("qs", "qu", "p4"):
        check(torch.equal(getattr(g.carry, k), getattr(e.carry, k)),
              f"stream: the warm slot graph's {k} differs from the eager "
              f"step's")
    check(not torch.equal(g.carry.p4, c.p4), "stream: table not refreshed")
    log("stream", f"warm slot graph vs eager step on streaming round 2 "
        f"(n_success {int(g.n_success)}, COT slots {int(g.n_cot_slots)}, "
        f"queues max {float(g.carry.qs.max()):.3e}): masks, zeta, queues "
        f"and the P4 table bit for bit equal")
    out["graph_vs_eager"] = dict(n_success=int(g.n_success),
                                 n_cot_slots=int(g.n_cot_slots))
    return out


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_stream_reference(device):
    """3 streaming rounds at a small size (S=U=4, T=10, a fleet of 16,
    warm P4 and carried queues, the CNN on 8 clients of 12 samples,
    batch 4) through `fused_rollout` on the card and on the CPU, every
    draw made on the CPU and moved across: decisions identical, every
    parameter within 1e-4 relative, norm-wise (TF32 off; cuDNN and oneDNN
    sum the convolutions in other orders)."""
    from repro_torch.channel.mobility import ManhattanParams
    from repro_torch.channel.v2x import ChannelParams
    from repro_torch.core.baselines import get_scheduler
    from repro_torch.core.lyapunov import VedsParams
    from repro_torch.core.scenario import (ScenarioParams, fleet_round_draws,
                                           init_fleet, init_fleet_draws)
    from repro_torch.core.streaming import StreamConfig
    from repro_torch.data.synthetic import cifar_like_dataset
    from repro_torch.fl.engine import ClientShards, fused_rollout, init_carry
    from repro_torch.models.cnn import cnn_loss, init_cnn
    R, S, N, C, BS = 3, 4, 16, 8, 4
    sc = ScenarioParams(n_sov=S, n_opv=S, n_slots=10, batch_size=BS)
    mob, ch = ManhattanParams(), ChannelParams()
    prm = VedsParams(ipm_warm_iters=STREAM_WARM_ITERS)
    cfg = StreamConfig(n_rounds=R, batch=1, carry_queues=True, n_fleet=N)
    gen = torch.Generator().manual_seed(13)
    fleet_draws = init_fleet_draws(gen, mob, sc, 1, N, "cpu")
    rounds = [fleet_round_draws(gen, sc, 1, N, "cpu") for _ in range(R)]
    sel = torch.stack([torch.randperm(C, generator=gen)[:S]
                       for _ in range(R)])[:, None]
    mb_u = torch.rand((R, 1, S, BS), generator=gen)
    x, y = cifar_like_dataset(torch.Generator().manual_seed(14), C * 12,
                              0.8)
    data = [{"x": x[i::C], "y": y[i::C]} for i in range(C)]
    model = init_cnn(torch.Generator().manual_seed(15))
    params = {k: v.detach() for k, v in model.named_parameters()}
    res = {}
    for dev in ("cpu", device):
        fleet = init_fleet(_to_device(fleet_draws, dev), sc, mob, 1,
                           n_fleet=N)
        carry = init_carry(0, sc, mob, cfg, params, fleet=fleet, device=dev)
        res[str(dev)] = fused_rollout(
            [_to_device(d, dev) for d in rounds], sel.to(dev),
            mb_u.to(dev), get_scheduler("veds"), sc, mob, ch, prm, cfg,
            cnn_loss, ClientShards.from_ragged(data, dev), carry, lr=0.07)
    cpu, gpu = res["cpu"], res[str(device)]
    for k in ("success", "n_success", "n_cot_slots", "n_dt_slots"):
        check(torch.equal(cpu.outputs[k], gpu.outputs[k].cpu()),
              f"stream reference: {k} differs between card and CPU")
    rel = max(float((gpu.params[k].cpu() - cpu.params[k]).norm()
                    / cpu.params[k].norm().clamp_min(1e-30))
              for k in cpu.params)
    moved = math.sqrt(
        sum(float((cpu.params[k][0] - params[k]).norm()) ** 2
            for k in params)
        / sum(float(cpu.params[k].norm()) ** 2 for k in params))
    check(rel <= 1e-4, f"stream reference: parameters differ between card "
          f"and CPU by {rel:.2e} relative (norm-wise), beyond 1e-4")
    log("stream_reference", f"3 warm streaming rounds, S=U=4, T=10, card vs "
        f"CPU on the same draws: decisions identical (n_success "
        f"{cpu.outputs.n_success[:, 0].tolist()}, COT slots "
        f"{cpu.outputs.n_cot_slots[:, 0].tolist()}); parameters "
        f"{rel:.2e} relative, norm-wise (tolerance 1e-4; the rounds moved "
        f"the whole model by {moved:.2e} of its norm)")
    return dict(n_success=cpu.outputs.n_success[:, 0].tolist(),
                n_cot_slots=cpu.outputs.n_cot_slots[:, 0].tolist(),
                param_rel_err=rel, moved=moved)


def make_traj_setup(device, rounds: int):
    """fig12's setting (`benchmarks/fig12_traj.py`): 40 clients of
    `make_trajectory_batch(., 128)` with 64 lane nodes, a test batch of
    512, LaneGCN at its full width (D 64), S=U=10, T=60, batch 32, lr
    0.02. The data is drawn on the card; the clients' shards are host
    arrays, as `run_fl` gathers minibatches on the host."""
    from repro_torch.data.synthetic import make_trajectory_batch
    from repro_torch.fl.simulator import FLSimConfig
    from repro_torch.models.lanegcn import init_lanegcn
    client_data = []
    for c in range(TRAJ_CLIENTS):
        b = make_trajectory_batch(
            torch.Generator(device=device).manual_seed(100 + c),
            TRAJ_PER_CLIENT)
        client_data.append({k: v.cpu().numpy() for k, v in b.items()})
    test = make_trajectory_batch(
        torch.Generator(device=device).manual_seed(999), TRAJ_TEST)
    params = init_lanegcn(torch.Generator(device=device).manual_seed(3))
    sim = FLSimConfig(n_clients=TRAJ_CLIENTS, rounds=rounds, seed=7,
                      lr=0.02)
    return params, client_data, test, sim


class _Recorder:
    """A scheduler that hands each round to `sched` and keeps what it
    returned and the round's validity mask (device tensors, read after
    the run): `run_fl` reports `n_success` on its eval rounds only."""

    def __init__(self, sched):
        self.sched, self.rounds = sched, []
        self.name = sched.name

    def solve_round(self, rnd, prm, ch, carry=None):
        out = self.sched.solve_round(rnd, prm, ch, carry)
        self.rounds.append((out, rnd.valid_sov))
        return out

    __call__ = solve_round


def _run_recorded(device, seed, params, loss_fn, client_data, eval_fn,
                  sim, every):
    """One blocked `run_fl` under `sim.scheduler`, each stage closed by a
    device synchronisation, with the `veds_score` count set to 0 just
    before and read just after. Returns the history, the per-round
    stage times, the recorded rounds and the launches."""
    from repro_torch.core.baselines import get_scheduler
    from repro_torch.fl import simulator
    from repro_torch.kernels.veds_score.ops import veds_dt_score
    rec = _Recorder(get_scheduler(sim.scheduler))
    records = []
    hook = _stage_timer(records)
    real = simulator.get_scheduler
    simulator.get_scheduler = lambda name: rec
    try:
        torch.cuda.synchronize()
        veds_dt_score.launches = 0
        t0 = time.perf_counter()
        hook.start()
        hist = simulator.run_fl(seed, params, loss_fn, client_data, sim,
                                eval_fn=eval_fn, eval_every=every,
                                device=device, stage_hook=hook)
        wall = time.perf_counter() - t0
        launches = veds_dt_score.launches
    finally:
        simulator.get_scheduler = real
    return hist, records, rec.rounds, launches, wall


def phase_compare(device, cifar_setup):
    """The paper's Section VI comparison (Figs. 10-12) on the card: all
    five schedulers through blocked `run_fl` on fig10's CIFAR task (the
    CNN and data of `make_fl_setup`) and fig12's trajectory task
    (`make_traj_setup`), COMPARE_ROUNDS rounds each (cut from the figure
    scripts' 30), `round_batch` 1, eval every COMPARE_EVAL_EVERY. Every
    round of one task draws the same scenario under every scheduler.
    Checked: `optimal` succeeds on every valid SOV and at least as often
    as every other scheduler in every round; only `veds` uses COT slots;
    `veds_score` runs rounds x T times under `veds` and `v2i_only` by
    its own count and never under the others; every metric is finite.
    Logged only: the total uploads of `veds` against `v2i_only` and the
    order of the final metrics."""
    import dataclasses
    from repro_torch.core.veds import _SlotGraph
    from repro_torch.models.cnn import cnn_loss
    from repro_torch.models.lanegcn import lanegcn_ade, lanegcn_loss
    params, client_data, eval_fn, sim = cifar_setup
    tparams, tclients, ttest, tsim = make_traj_setup(device,
                                                     COMPARE_ROUNDS)
    tasks = {
        "cifar": (params, cnn_loss, client_data, eval_fn,
                  dataclasses.replace(sim, rounds=COMPARE_ROUNDS,
                                      round_batch=1), "accuracy"),
        "traj": (tparams, lanegcn_loss, tclients,
                 lambda p: lanegcn_ade(p, ttest), tsim, "ADE"),
    }
    out = {}
    for task, (p0, loss_fn, data, ev, s, metric) in tasks.items():
        res = {}
        for name in COMPARE_SCHEDULERS:
            captures = _SlotGraph.captures
            hist, records, rounds, launches, wall = _run_recorded(
                device, COMPARE_SEED, p0, loss_fn, data, ev,
                dataclasses.replace(s, scheduler=name), COMPARE_EVAL_EVERY)
            captures = _SlotGraph.captures - captures
            n_succ = [int(o.n_success) for o, _ in rounds]
            n_valid = [s.n_sov if v is None else int(v.sum())
                       for _, v in rounds]
            n_cot = [int(o.n_cot_slots) for o, _ in rounds]
            n_dt = [int(o.n_dt_slots) for o, _ in rounds]
            med = {k: _median([r[k] for r in records[1:]])
                   for k in ("scenario_ms", "schedule_ms", "train_ms",
                             "eval_ms")}
            want = s.rounds * s.n_slots if name in ("veds", "v2i_only") \
                else 0
            log("compare", f"{task} {name}: wall {wall:.3f} s; median of "
                f"rounds 1.. " + ", ".join(f"{k[:-3]} {v:.2f} ms"
                                           for k, v in med.items())
                + f"; n_success {n_succ}; COT slots {sum(n_cot)}, DT slots "
                f"{sum(n_dt)}; {metric} {[round(m, 4) for m in hist['metric']]}"
                f" at rounds {hist['round']}; veds_score launches {launches}"
                f" (expected {want}); slot graphs captured {captures}")
            check(len(rounds) == s.rounds and len(records) == s.rounds,
                  f"compare {task} {name}: {len(rounds)} rounds scheduled, "
                  f"{len(records)} timed, expected {s.rounds}")
            check(launches == want, f"compare {task} {name}: veds_score "
                  f"launched {launches} times, expected {want}")
            check(name == "veds" or sum(n_cot) == 0,
                  f"compare {task} {name}: {sum(n_cot)} COT slots")
            check(hist["round"] == [r for r in range(s.rounds)
                                    if r % COMPARE_EVAL_EVERY == 0
                                    or r == s.rounds - 1]
                  and all(math.isfinite(m) for m in hist["metric"]),
                  f"compare {task} {name}: history {hist}")
            if name == "optimal":
                check(n_succ == n_valid, f"compare {task} optimal: "
                      f"n_success {n_succ}, valid SOVs {n_valid}")
            res[name] = dict(n_success=n_succ, n_valid=n_valid,
                             n_cot_slots=n_cot, n_dt_slots=n_dt,
                             metric=hist["metric"], rounds=hist["round"],
                             stages=records, median=med, wall_s=wall,
                             launches={"veds_score": launches},
                             graph_captures=captures)
        best = res["optimal"]["n_success"]
        for name, r in res.items():
            check(all(a <= b for a, b in zip(r["n_success"], best)),
                  f"compare {task} {name}: n_success {r['n_success']} "
                  f"above optimal's {best}")
        total = {n: sum(r["n_success"]) for n, r in res.items()}
        finals = {n: r["metric"][-1] for n, r in res.items()}
        order = sorted(finals, key=finals.get,
                       reverse=(metric == "accuracy"))
        log("compare", f"{task}: total uploads {total} (veds >= v2i_only: "
            f"{total['veds'] >= total['v2i_only']}, logged, not checked); "
            f"final {metric} {finals}, best first {order}")
        out[task] = dict(schedulers=res, total_uploads=total, final=finals,
                         order=order)
    return out


def phase_compare_reference(device):
    """Card against CPU for the comparison's pieces. The five schedulers
    on one stacked fig10 round (B=3 heterogeneous cells, S=U=10, T=60,
    a non-zero carry): masks, `n_success` and slot counts identical,
    delivered bits, energies and queues within rtol 1e-4; `v2i_only`'s
    slot graph against its eager loop on the card, bit for bit. LaneGCN
    at full width on the same parameters and batch: forward and ADE
    within rtol 1e-5 (TF32 off; the forward's entries within 1e-5 of its
    scale, where sums cancel). Two blocked `run_fl` rounds of fig12's
    task under `sa` on rounds made on the CPU: `n_success` identical and
    the parameters within 1e-5 of their norm after each round."""
    import dataclasses
    from repro_torch.channel.mobility import ManhattanParams
    from repro_torch.channel.v2x import ChannelParams
    from repro_torch.core.baselines import get_scheduler
    from repro_torch.core.lyapunov import VedsParams
    from repro_torch.core.scenario import (ScenarioParams, make_round,
                                           make_round_batch,
                                           round_generator)
    from repro_torch.core.scheduler import SchedulerCarry
    from repro_torch.core.veds import _veds_round
    from repro_torch.data.synthetic import make_trajectory_batch
    from repro_torch.fl import simulator
    from repro_torch.models.lanegcn import (init_lanegcn, lanegcn_ade,
                                            lanegcn_apply, lanegcn_loss)
    sc = ScenarioParams(n_sov=10, n_opv=10, n_slots=60)
    mob, ch, prm = ManhattanParams(), ChannelParams(), VedsParams()
    rnd = make_round_batch(17, sc, mob, ch, prm, 3, hetero_fleet=True,
                           device="cpu")
    gen = torch.Generator().manual_seed(18)
    carry = SchedulerCarry(qs=0.02 * torch.rand((3, 10), generator=gen),
                           qu=0.02 * torch.rand((3, 10), generator=gen))
    gcarry = SchedulerCarry(qs=carry.qs.to(device), qu=carry.qu.to(device))
    grnd = rnd.to(device)
    sched_res = {}
    for name in COMPARE_SCHEDULERS:
        cpu = get_scheduler(name).solve_round(rnd, prm, ch, carry)
        gpu = get_scheduler(name).solve_round(grnd, prm, ch, gcarry)
        for k in ("success", "n_success", "n_cot_slots", "n_dt_slots"):
            check(torch.equal(cpu[k], gpu[k].cpu()), f"compare reference "
                  f"{name}: {k} differs between card and CPU")
        rel = 0.0
        for a, b in [(gpu[k], cpu[k]) for k in
                     ("zeta", "energy_sov", "energy_opv")] + \
                [(getattr(gpu.carry, k), getattr(cpu.carry, k))
                 for k in ("qs", "qu")]:
            check(torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-9),
                  f"compare reference {name}: floats beyond rtol 1e-4 "
                  f"between card and CPU")
            rel = max(rel, float(((a.cpu() - b).abs()
                                  / b.abs().clamp_min(1e-30)).max()))
        sched_res[name] = dict(n_success=cpu.n_success.tolist(),
                               n_dt_slots=cpu.n_dt_slots.tolist(),
                               n_cot_slots=cpu.n_cot_slots.tolist(),
                               max_rel_err=rel)
    g = get_scheduler("v2i_only").solve_round(grnd, prm, ch, gcarry)
    e = _veds_round(grnd, prm, ch, enable_cot=False, carry=gcarry,
                    graphed=False)
    for k in g.keys():
        check(torch.equal(g[k], e[k]), f"compare reference: v2i_only's slot "
              f"graph {k} differs from its eager step")
    check(torch.equal(g.carry.qs, e.carry.qs)
          and torch.equal(g.carry.qu, e.carry.qu),
          "compare reference: v2i_only's slot graph queues differ from its "
          "eager step's")
    log("compare_reference", "fig10 batch (B=3 heterogeneous, S=U=10, T=60, "
        "a carry), card vs CPU: decisions identical, floats within rtol "
        "1e-4 for all five; " + "; ".join(
            f"{n} n_success {r['n_success']} DT {r['n_dt_slots']} COT "
            f"{r['n_cot_slots']} max rel {r['max_rel_err']:.2e}"
            for n, r in sched_res.items())
        + "; v2i_only's slot graph equals its eager step bit for bit")

    params = init_lanegcn(torch.Generator().manual_seed(19))
    batch = make_trajectory_batch(torch.Generator().manual_seed(20),
                                  TRAJ_PER_CLIENT)
    gp = {k: v.to(device) for k, v in params.items()}
    gb = {k: v.to(device) for k, v in batch.items()}
    out_c, out_g = lanegcn_apply(params, batch), lanegcn_apply(gp, gb)
    scale = float(out_c.abs().max())
    fwd_err = float((out_g.cpu() - out_c).abs().max())
    check(bool(((out_g.cpu() - out_c).abs()
                <= 1e-5 * out_c.abs() + 1e-5 * scale).all()),
          f"compare reference: LaneGCN forward differs between card and "
          f"CPU by {fwd_err:.2e} (scale {scale:.3f})")
    ade_c, ade_g = float(lanegcn_ade(params, batch)), float(lanegcn_ade(gp,
                                                                        gb))
    check(abs(ade_g - ade_c) <= 1e-5 * abs(ade_c), f"compare reference: "
          f"LaneGCN ADE {ade_g} on the card, {ade_c} on the CPU")

    # two blocked run_fl rounds of fig12's task under sa, card and CPU,
    # on the same rounds, clients and minibatch draws
    _, tclients, ttest, tsim = make_traj_setup("cpu", 2)
    tsim = dataclasses.replace(tsim, scheduler="sa")
    tsc = ScenarioParams(n_sov=tsim.n_sov, n_opv=tsim.n_opv,
                         n_slots=tsim.n_slots, batch_size=tsim.batch_size)
    rounds = [make_round(round_generator(COMPARE_SEED, r, "cpu"), tsc,
                         ManhattanParams(v_max=tsim.v_max), ch, prm)
              for r in range(2)]
    runs = {}
    real = simulator.make_round
    for dev in ("cpu", device):
        it = iter(rounds)
        seen = []
        test = {k: v.to(dev) for k, v in ttest.items()}

        def ev(p, seen=seen, test=test):
            seen.append({k: v.detach().cpu().clone() for k, v in p.items()})
            return lanegcn_ade(p, test)

        simulator.make_round = lambda *a, it=it, dev=dev, **k: \
            next(it).to(dev)
        try:
            hist = simulator.run_fl(COMPARE_SEED, params, lanegcn_loss,
                                    tclients, tsim, eval_fn=ev,
                                    eval_every=1, device=dev)
        finally:
            simulator.make_round = real
        runs[str(dev)] = (hist, seen)
    (hc, pc), (hg, pg) = runs["cpu"], runs[str(device)]
    check(hc["n_success"] == hg["n_success"] and len(pc) == len(pg) == 2,
          f"compare reference: run_fl sa n_success {hg['n_success']} on the "
          f"card, {hc['n_success']} on the CPU")
    rel = []
    for a, b in zip(pg, pc):
        err = torch.cat([(a[k] - b[k]).flatten() for k in b]).norm()
        rel.append(float(err / torch.cat([b[k].flatten()
                                          for k in b]).norm()))
    check(max(rel) <= 1e-5, f"compare reference: run_fl parameters differ "
          f"between card and CPU by {rel} of their norm, beyond 1e-5")
    log("compare_reference", f"LaneGCN (D 64) on {TRAJ_PER_CLIENT} tracks, "
        f"card vs CPU: forward max abs {fwd_err:.2e} (scale {scale:.3f}), "
        f"ADE {ade_g:.6f} / {ade_c:.6f}; two blocked run_fl rounds under "
        f"sa: n_success {hg['n_success']} on both, parameters {rel} of "
        f"their norm (tolerance 1e-5), ADE {hg['metric']} / {hc['metric']}")
    return dict(schedulers=sched_res, lanegcn_fwd_max_abs=fwd_err,
                lanegcn_scale=scale, ade=[ade_g, ade_c],
                run_fl_n_success=hg["n_success"], run_fl_param_rel=rel)


def phase_stream_compare(device, setup):
    """`run_fl(streaming=True)`, fused, for each of the four baselines at
    fig10's setting (the CNN and data of `make_fl_setup`): a persistent
    fleet of 40, carried queues, `ipm_warm_iters` STREAM_WARM_ITERS (no
    baseline solves P4, so the warm budget must change nothing),
    STREAM_COMPARE_ROUNDS rounds with eval every STREAM_EVAL_EVERY inside
    the loop, each stage closed by a device synchronisation; `veds_score`
    must run rounds x T times under `v2i_only` and never under the
    others. Then `stream_rounds` over the same number of rounds under
    `sa` and `v2i_only`: the largest SOV queue at the end, logged (the
    reference's tests hold growth under SA's full-power transmissions and
    stability under V2I-only at their own sizes)."""
    import dataclasses
    from repro_torch.channel.mobility import ManhattanParams
    from repro_torch.channel.v2x import ChannelParams
    from repro_torch.core.baselines import get_scheduler
    from repro_torch.core.lyapunov import VedsParams
    from repro_torch.core.scenario import ScenarioParams
    from repro_torch.core.streaming import (StreamConfig, stream_rounds,
                                            warm_p4)
    from repro_torch.fl.simulator import run_fl
    from repro_torch.kernels.veds_score.ops import veds_dt_score
    from repro_torch.models.cnn import cnn_loss
    params, client_data, eval_fn, sim = setup
    R = STREAM_COMPARE_ROUNDS
    prm = VedsParams(alpha=sim.alpha, V=sim.V, Q=sim.q_bits, slot=0.1,
                     ipm_warm_iters=STREAM_WARM_ITERS)
    out = {}
    for name in ("optimal", "v2i_only", "madca", "sa"):
        check(not warm_p4(get_scheduler(name), prm), f"stream compare "
              f"{name}: a baseline would thread the P4 table")
        s = dataclasses.replace(sim, rounds=R, round_batch=1,
                                streaming=True, carry_queues=True,
                                n_fleet=2 * (sim.n_sov + sim.n_opv),
                                ipm_warm_iters=STREAM_WARM_ITERS,
                                scheduler=name)
        records = []
        hook = _stage_timer(records)
        torch.cuda.synchronize()
        veds_dt_score.launches = 0
        t0 = time.perf_counter()
        hook.start()
        hist = run_fl(STREAM_SEED, params, cnn_loss, client_data, s,
                      eval_fn=eval_fn, eval_every=STREAM_EVAL_EVERY,
                      device=device, stage_hook=hook)
        wall = time.perf_counter() - t0
        launches = veds_dt_score.launches
        want = R * s.n_slots if name == "v2i_only" else 0
        sched_ms = [r["schedule_ms"] for r in records]
        med = {k: _median([r[k] for r in records[1:]])
               for k in ("scenario_ms", "schedule_ms", "train_ms")}
        log("stream_compare", f"{name}: run_fl(streaming=True) {R} rounds, "
            f"wall {wall:.3f} s; schedule ms a round "
            f"{[round(x, 2) for x in sched_ms]}; median of rounds 1.. "
            + ", ".join(f"{k[:-3]} {v:.2f} ms" for k, v in med.items())
            + f"; history {hist}; veds_score launches {launches} (expected "
            f"{want})")
        check(len(records) == R, f"stream compare {name}: {len(records)} "
              f"rounds timed, expected {R}")
        check(launches == want, f"stream compare {name}: veds_score "
              f"launched {launches} times, expected {want}")
        check(hist["dispatches"] == 1 and hist["scheduled_rounds"] == R
              and all(math.isfinite(m) and 0.0 <= m <= 1.0
                      for m in hist["metric"])
              and all(0 <= n <= sim.n_sov for n in hist["n_success"]),
              f"stream compare {name}: history {hist}")
        out[name] = dict(schedule_ms=sched_ms, median=med, wall_s=wall,
                         history=hist, launches={"veds_score": launches})

    sc = ScenarioParams(n_sov=sim.n_sov, n_opv=sim.n_opv,
                        n_slots=sim.n_slots, batch_size=sim.batch_size)
    cfg = StreamConfig(n_rounds=R, batch=1, carry_queues=True,
                       n_fleet=2 * (sim.n_sov + sim.n_opv))
    queues = {}
    for name in ("sa", "v2i_only"):
        res = stream_rounds(STREAM_SEED, get_scheduler(name), sc,
                            ManhattanParams(v_max=sim.v_max),
                            ChannelParams(), prm, cfg, device=device)
        per_round = res.outputs.carry.qs.amax(dim=(1, 2)).tolist()
        queues[name] = dict(max_sov_queue_end=float(res.fleet.queue.max()),
                            max_sov_queue_per_round=per_round)
    log("stream_compare", f"stream_rounds {R} rounds, persistent fleet of "
        f"{cfg.n_fleet}: largest SOV queue at the end sa "
        f"{queues['sa']['max_sov_queue_end']:.4e} J, v2i_only "
        f"{queues['v2i_only']['max_sov_queue_end']:.4e} J (logged, not "
        f"checked); per round sa "
        f"{[f'{q:.3e}' for q in queues['sa']['max_sov_queue_per_round']]}, "
        f"v2i_only "
        f"{[f'{q:.3e}' for q in queues['v2i_only']['max_sov_queue_per_round']]}")
    out["queues"] = queues
    return out


def phase_stream_vfl(device, cfg, rounds: int, batch: int, seq: int,
                     lr: float):
    """`make_train_step(stream=...)`, the whole-run VFL step, at the
    setting of `phase_vfl` (the same model, vehicles, batch and lr; a
    persistent fleet with carried queues and the warm P4 table): the
    run's schedule, then its rounds, stage by stage; every kernel count
    set to 0 first and held to what the code implies."""
    from repro_torch.channel.mobility import ManhattanParams
    from repro_torch.channel.v2x import ChannelParams
    from repro_torch.core.lyapunov import VedsParams
    from repro_torch.core.scenario import ScenarioParams
    from repro_torch.core.streaming import StreamConfig
    from repro_torch.core.veds import _SlotGraph
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.fl.vfl import make_train_step
    from repro_torch.kernels.fedavg_agg.ops import fedavg_agg
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.kernels.veds_score.ops import veds_dt_score
    from repro_torch.models import engine
    from repro_torch.models.module import (materialize, param_bytes,
                                           tree_leaves, tree_map)
    phase = f"stream_vfl {cfg.name}"
    V = cfg.num_vehicles
    decl = engine.model_decl(cfg, "head")
    params = materialize(torch.Generator(device=device).manual_seed(0),
                         decl)
    params_v = tree_map(lambda x: x.unsqueeze(0).expand(V, *x.shape),
                        params)
    del params
    prm = VedsParams(Q=min(8.0 * param_bytes(decl), 2e7), slot=0.1,
                     ipm_warm_iters=STREAM_WARM_ITERS)
    sc = ScenarioParams(n_sov=V, n_opv=8, n_slots=VFL_SLOTS)
    stages = []
    mark = [0.0]

    def hook(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        stages.append((name, (now - mark[0]) * 1e3))
        mark[0] = now

    run = make_train_step(cfg, None, "head", lr=lr,
                          stream=StreamConfig(n_rounds=rounds, batch=1,
                                              carry_queues=True),
                          sc=sc, mob=ManhattanParams(), veds_prm=prm,
                          ch_prm=ChannelParams(), stage_hook=hook)
    data = lm_batch(torch.Generator(device=device).manual_seed(1),
                    rounds * V * batch, seq, cfg.vocab_size)
    batches_v = {k: x.reshape(rounds, V, batch, *x.shape[1:])
                 for k, x in data.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention_fwd.launches = 0
    fedavg_agg.launches = 0
    veds_dt_score.launches = 0
    captures = _SlotGraph.captures
    t0 = time.perf_counter()
    mark[0] = t0
    out, stats = run(params_v, batches_v, torch.ones(V, device=device), 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention_fwd.launches,
                "fedavg_agg": fedavg_agg.launches,
                "veds_score": veds_dt_score.launches}
    captures = _SlotGraph.captures - captures
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_attn = cfg.n_rep * sum(k in ("attn", "attn_swa", "cross")
                             for k in cfg.pattern)
    want = {"flash_attention": rounds * V * n_attn * 2,
            "fedavg_agg": rounds * len(tree_leaves(decl)),
            "veds_score": rounds * VFL_SLOTS}
    finite = all(bool(torch.isfinite(x).all()) for x in tree_leaves(out))
    log(phase, f"{rounds} rounds, {V} vehicles x {batch} x {seq} tokens, "
        f"ipm_warm_iters {STREAM_WARM_ITERS}: wall {wall:.3f} s = "
        + " + ".join(f"{n} {ms:.1f}" for n, ms in stages)
        + f" ms; masks {stats['mask'].tolist()} n_success "
        f"{stats['n_success'].tolist()}; slot graphs captured {captures}; "
        f"peak memory {peak_gb:.2f} GB; launches {launches} (expected "
        f"{want})")
    check(finite, f"{phase}: parameters not finite")
    for k, w in want.items():
        check(launches[k] == w, f"{phase}: {k} launched {launches[k]} "
              f"times, expected {w}")
    return dict(wall_s=wall, stages=stages, launches=launches,
                expected_launches=want, masks=stats["mask"].tolist(),
                n_success=stats["n_success"].tolist(),
                graph_captures=captures, peak_memory_gb=peak_gb)


def sm90_resources(kernel: str, variant: int):
    """(dynamic shared memory in bytes, CTAs an SM holds) of the bf16
    tensor-core kernel `kernel` built for `variant` (head dim or chunk)."""
    import ctypes
    from repro_torch.kernels.build import load_library
    lib = load_library()
    fn = lib.function(f"{kernel}_bf16_sm90_resources",
                      [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                       ctypes.POINTER(ctypes.c_int)])
    smem, ctas = ctypes.c_int(), ctypes.c_int()
    lib.check(fn(variant, ctypes.byref(smem), ctypes.byref(ctas)),
              f"{kernel} resources")
    return smem.value, ctas.value


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
                      zamba2_shape=(4, 1024, 32, 80),
                      granite_shape=(4, 1024, 16, 8, 64),
                      whisper_shape=(4, 1024, 1536, 12, 64),
                      vlm_cross_shape=(4, 1024, 2048, 64, 8, 128),
                      fedavg_l=151936 * 5120,
                      fedavg_granite_l=GRANITE_REPS * 32 * 1024 * 512,
                      fedavg_xlstm_l=50304 * 2048):
    """flash_attention and fedavg_agg against their plain versions on the
    card, at the VFL paths' shapes and at the edge cases; timed at the
    paths' shapes beside their bounds and, for attention, PyTorch's
    scaled_dot_product_attention under the case's own mask (whisper's
    encoder and its cross-attention, and llama-3.2-vision's cross
    attention, attend to every key). The attention Function's gradients
    are held against autograd through the plain version at a small
    shape."""
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
    zb, zt, zh, zd = zamba2_shape
    gb, gt, gh, gkv, gd = granite_shape
    wb, wt, ws, wh, wd = whisper_shape
    vb, vt, vs, vh, vkv, vd = vlm_cross_shape
    cases = {
        "main": (B, T, T, H, KV, D, torch.bfloat16, True, None, 0),
        # zamba2's shared attention: 32 heads of 80 (3 output columns a
        # lane, the third only for lanes < 16)
        "zamba2": (zb, zt, zt, zh, zh, zd, torch.bfloat16, True, None, 0),
        # granite's attention: 16 query heads of 64 on 8 KV heads, causal
        "granite": (gb, gt, gt, gh, gkv, gd, torch.bfloat16, True, None, 0),
        # whisper-small: the encoder over its 1536 frames, bidirectional;
        # the decoder's cross-attention of 1024 tokens onto them; its
        # causal self-attention
        "whisper_encoder": (wb, ws, ws, wh, wh, wd, torch.bfloat16, False,
                            None, 0),
        "whisper_cross": (wb, wt, ws, wh, wh, wd, torch.bfloat16, False,
                          None, 0),
        "whisper_self": (wb, wt, wt, wh, wh, wd, torch.bfloat16, True, None,
                         0),
        # llama-3.2-vision's cross-attention (64 query and 8 KV heads of
        # 128) onto its 2048 projected patches
        "vlm_cross": (vb, vt, vs, vh, vkv, vd, torch.bfloat16, False, None,
                      0),
        "fp32_d80": (2, 200, 260, 4, 2, 80, torch.float32, False, 90, 0),
        "window": (2, 512, 512, 16, 2, 128, torch.bfloat16, True, 128, 0),
        "full_s_ne_t": (2, 256, 384, 8, 2, 64, torch.bfloat16, False, None,
                        0),
        "ragged": (2, 333, 333, 8, 4, 128, torch.bfloat16, True, None, 0),
        "q_offset": (2, 200, 456, 8, 2, 32, torch.bfloat16, True, None, 256),
        "fp32": (2, 300, 300, 8, 2, 128, torch.float32, True, 100, 0),
        "fp32_d16": (2, 100, 200, 4, 1, 16, torch.float32, True, None, 100),
        # rows t >= 50 (qpos >= S - 1 + window) see no key
        "blind_rows_d80": (2, 77, 131, 8, 8, 80, torch.bfloat16, True, 40,
                           120),
    }
    for label, (b, t, s_, h, kv, d, dtype, causal, window, off) in \
            cases.items():
        q, k, v = qkv(b, t, s_, h, kv, d, dtype)
        kw = dict(causal=causal, window=window, q_offset=off)
        out, lse = flash_attention_fwd(q, k, v, **kw)
        entry = flash_attention_fwd.entry
        ref, ref_lse = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        check(entry == FLASH_ENTRY[dtype], f"flash_attention {label}: "
              f"{dtype} ran {entry}, not {FLASH_ENTRY[dtype]}")
        tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        err = float((out.float() - ref.float()).abs().max())
        lse_err = float((lse - ref_lse).abs().max())
        check(flash_used(out, lse, ref, ref_lse) <= 1.0,
              f"flash_attention {label}: kernel disagrees with the plain "
              f"version beyond atol=rtol={tol} or lse 1e-3 (max abs "
              f"{err:.3e}, lse {lse_err:.3e})")
        scale = float(ref.float().abs().max())
        r = dict(shape_q=list(q.shape), shape_kv=list(k.shape),
                 dtype=str(dtype).split(".")[-1], causal=causal,
                 window=window, q_offset=off, max_abs_err=err,
                 rel_err=err / scale, out_max_abs=scale,
                 lse_max_abs_err=lse_err, tolerance=f"atol=rtol={tol}",
                 entry=entry)
        if label in TIMED_FLASH:
            r.update(zip(("smem_bytes", "ctas_per_sm"),
                         sm90_resources("flash_attention", d)))
            # 20 calls a sample: the wrapper's host time before the first
            # launch (tensor maps, outputs) is not counted 3 times over
            r["ms"] = time_ms(lambda: flash_attention_fwd(q, k, v, **kw),
                              20, samples=7, warmup=2)
            r["plain_ms"] = time_ms(
                lambda: flash_attention_plain(q, k, v, **kw), 3, samples=7,
                warmup=2)
            (r["bound_ms"], r["bound_by"], r["flops"],
             r["bytes"]) = flash_bound_ms(q, k, causal, window, off)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            try:
                lib = F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True)
                r["library_err"] = float(
                    (lib.transpose(1, 2).float() - ref.float()).abs().max())
                r["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=causal, enable_gqa=True), 20,
                    samples=7, warmup=2)
            except RuntimeError as e:      # the yardstick only
                r["library_ms"], r["library_error"] = None, str(e)[:200]
        res["flash_attention"][label] = r
        log("kernels", f"flash_attention {label} q {list(q.shape)} kv "
            f"{list(k.shape)} {r['dtype']} causal={causal} window={window} "
            f"q_offset={off} [{entry}]: max_abs_err {err:.3e} = "
            f"{err / scale:.2e} of max|out| {scale:.3e}, lse {lse_err:.3e} "
            f"(tolerance atol=rtol={tol})" + (
                f" kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
                f"sdpa {r['library_ms']} ms bound {r['bound_ms']:.4f} ms "
                f"({r['bound_by']}); {r['smem_bytes']} B shared memory, "
                f"{r['ctas_per_sm']} CTA(s) an SM" if "ms" in r else ""))
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
        # granite's largest leaf: an expert weight of all 24 layers
        "granite": (V, fedavg_granite_l, torch.bfloat16, False),
        # xlstm's largest leaf: the embedding (and lm_head), [50304, 2048]
        "xlstm": (V, fedavg_xlstm_l, torch.bfloat16, False),
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
        if label in ("main", "granite", "xlstm"):
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
                f"{nbytes / 1e9:.3f} GB)" if "ms" in r else ""))
        del x, old, out
    torch.cuda.empty_cache()
    return res


def ssd_bound_ms(v, b, chunk: int):
    """Least time for the scan on this card: the larger of its bytes (v,
    b, c, log_a read once; y and the fp32 final state written once) over
    the memory rate and its operations, counted as the Pallas kernel
    does them (per row, head and chunk: the C x C scores over N, W v over
    P, c S and the state update over N x P, 2 operations a
    multiply-add), over the dense tensor-core rate of bf16 (the fp32
    CUDA-core rate for fp32 inputs)."""
    B, T, H, P = v.shape
    N = b.shape[-1]
    C = min(chunk, T)
    n_chunks = -(-T // C)
    ops = B * H * n_chunks * (2 * C * C * (N + P) + 4 * C * N * P)
    nbytes = (2 * v.numel() + 2 * b.numel()) * v.element_size() \
        + B * T * H * 4 + B * H * N * P * 4
    peak = PEAK_BF16_OPS_PER_S if v.dtype == torch.bfloat16 \
        else PEAK_FP32_OPS_PER_S
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), ops, nbytes


def phase_kernels_ssd(device, main_shape=(4, 1024, 80, 128)):
    """ssd_scan against its plain version on the card: at the zamba2
    path's shape (v [4, 1024, 80, 64], b/c [4, 1024, 64], chunk 128) in
    bf16 and fp32, at a ragged T (pad path), at H = 1 (the Pallas
    layout), with an initial state at the smoke config's chunk, and at
    chunk 128 with dt ~ 0.7 (zamba2's init), where the reference model's
    jnp scan overflows; timed at the main shape beside its bound. log_a =
    -softplus(normal) elsewhere, so a chunk of 128 decays by ~100 too.
    Each error is reported as max abs and as a share of the output's
    largest entry. fp32 y is held within 5e-5 of max|y| (the kernel's
    products and its cumsum sum in other orders; entries near 0 cancel);
    bf16 y entry by entry within 2^-7 of the plain version's entry plus
    1e-3 of max|y| (both compute in fp32 from the same bf16 inputs and
    round once, so they may land one bf16 ulp, at most 2^-7 of the value,
    apart, plus the fp32 difference); the fp32 final state within 5e-5 of
    max|state|. The Function's gradients are held against autograd
    through the plain version."""
    from repro_torch.kernels.ssd_scan.ops import (ssd_scan, ssd_scan_fwd,
                                                  ssd_scan_plain)
    g = torch.Generator(device=device).manual_seed(13)

    def rn(*shape):
        return torch.randn(shape, generator=g, device=device)

    def inputs(B, T, H, dtype, decay=1.0):
        la = -decay * torch.nn.functional.softplus(rn(B, T, H))
        return (rn(B, T, H, 64).to(dtype), rn(B, T, 64).to(dtype),
                rn(B, T, 64).to(dtype), la)

    B, T, H, C = main_shape
    cases = {
        "main": (B, T, H, C, torch.bfloat16, False),
        "fp32": (B, T, H, C, torch.float32, False),
        "ragged": (2, 1000, 8, C, torch.float32, True),
        "h1_pallas_layout": (6, 512, 1, C, torch.float32, False),
        "chunk32_state0": (2, 256, 8, 32, torch.bfloat16, True),
        "overflow_dt07": (2, 512, 8, C, torch.float32, False),
        "ragged_bf16": (2, 1000, 8, C, torch.bfloat16, True),
        "overflow_dt07_bf16": (2, 512, 8, C, torch.bfloat16, False),
    }
    res = {}
    for label, (b_, t, h, c, dtype, with_s0) in cases.items():
        v, b, cm, la = inputs(b_, t, h, dtype)
        if label.startswith("overflow_dt07"):
            # dt = 0.7 (1 + 0.01 N(0, 1)), A = -1: the decays of a chunk
            # sum to ~89, so the jnp form's exp(cum_i - cum_j) above the
            # diagonal reaches exp(88.9), past float32's largest
            la = -0.7 * (1.0 + 0.01 * rn(b_, t, h))
            span = -la.reshape(b_, t // c, c, h)[:, :, 1:].sum(2)
            check(bool(torch.isinf(torch.exp(span)).any()),
                  "ssd_scan overflow case: the jnp form would not overflow")
        s0 = rn(b_, h, 64, 64) if with_s0 else None
        y, st = ssd_scan_fwd(v, b, cm, la, c, s0)
        entry = ssd_scan_fwd.entry
        ry, rst = ssd_scan_plain(v, b, cm, la, c, s0)
        torch.cuda.synchronize()
        check(entry == SSD_ENTRY[dtype], f"ssd_scan {label}: {dtype} ran "
              f"{entry}, not {SSD_ENTRY[dtype]}")
        ys, ss = float(ry.float().abs().max()), float(rst.abs().max())
        err = float((y.float() - ry.float()).abs().max())
        st_err = float((st - rst).abs().max())
        if dtype == torch.bfloat16:
            tol = f"y per entry 2^-7 |y| + 1e-3 x max|y| = {1e-3 * ys:.3e}"
        else:
            tol = f"y 5e-05 x max|y| = {5e-5 * ys:.3e}"
        tol += f", state 5e-05 x max|state| = {5e-5 * ss:.3e}"
        check(ssd_used(y, st, ry, rst) <= 1.0,
              f"ssd_scan {label}: kernel disagrees with the plain version "
              f"beyond {tol} (y max abs {err:.3e}, state {st_err:.3e})")
        r = dict(shape_v=list(v.shape), shape_bc=list(b.shape), chunk=c,
                 dtype=str(dtype).split(".")[-1], state0=with_s0,
                 max_abs_err=err, rel_err=err / ys, y_max_abs=ys,
                 state_max_abs_err=st_err, state_rel_err=st_err / ss,
                 tolerance=tol, entry=entry)
        if label == "main":
            r.update(zip(("smem_bytes", "ctas_per_sm"),
                         sm90_resources("ssd_scan", c)))
            r["ms"] = time_ms(lambda: ssd_scan_fwd(v, b, cm, la, c), 20,
                              samples=7, warmup=2)
            r["plain_ms"] = time_ms(lambda: ssd_scan_plain(v, b, cm, la, c),
                                    2, samples=5, warmup=1)
            (r["bound_ms"], r["bound_by"], r["flops"],
             r["bytes"]) = ssd_bound_ms(v, b, c)
            r["library_ms"] = None   # no PyTorch call computes the scan
            # the scan's part of a layer's backward on the VFL path:
            # forward (the remat recompute) and backward of the Function
            ins = [x.detach().requires_grad_() for x in (v, b, cm, la)]
            dy = rn(*v.shape).to(dtype)

            def fwd_bwd():
                yy, _ = ssd_scan(*ins, c)
                torch.autograd.grad(yy, ins, dy)
            r["fn_fwd_bwd_ms"] = time_ms(fwd_bwd, 1, samples=5, warmup=1)
            del ins, dy
        res[label] = r
        log("kernels", f"ssd_scan {label} v {list(v.shape)} b/c "
            f"{list(b.shape)} chunk {c} {r['dtype']} state0={with_s0} "
            f"[{entry}]: y "
            f"max abs err {err:.3e} = {err / ys:.2e} of max|y| {ys:.3e}; "
            f"state {st_err:.3e} = {st_err / ss:.2e} of max|state| "
            f"(tolerance {tol})" + (
                f" kernel {r['ms']:.4f} ms plain {r['plain_ms']:.4f} ms "
                f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}, "
                f"{r['bytes'] / 1e6:.1f} MB, {r['flops'] / 1e9:.2f} GFLOP); "
                f"Function forward + backward {r['fn_fwd_bwd_ms']:.3f} ms; "
                f"{r['smem_bytes']} B shared memory, {r['ctas_per_sm']} "
                f"CTA(s) an SM" if label == "main" else ""))
        del v, b, cm, la, y, ry

    # the Function's gradients (kernel forward) vs autograd through the
    # plain version, fp32
    ins = [x.requires_grad_() for x in inputs(2, 384, 4, torch.float32,
                                              decay=0.5)]
    y, st = ssd_scan(*ins, 128)
    cy = torch.randn(y.shape, generator=g, device=device)
    cs = torch.randn(st.shape, generator=g, device=device)
    got = torch.autograd.grad((y * cy).sum() + (st * cs).sum(), ins)
    ry, rst = ssd_scan_plain(*ins, 128)
    want = torch.autograd.grad((ry * cy).sum() + (rst * cs).sum(), ins)
    # each gradient within 1e-4 of its largest entry
    gerr = max(float((a - b).abs().max() / b.abs().max())
               for a, b in zip(got, want))
    check(gerr <= 1e-4, f"ssd_scan gradients off autograd by {gerr:.3e} "
          f"of their scale")
    res["grad_max_rel_err"] = gerr
    log("kernels", f"ssd_scan Function gradients (v, b, c, log_a) vs "
        f"autograd through the plain version (fp32, v [2,384,4,64], chunk "
        f"128): max abs error {gerr:.3e} of the largest entry (tolerance "
        f"1e-4)")
    torch.cuda.empty_cache()
    return res


def vfl_config(arch: str, reps: int, vehicles: int = VFL_VEHICLES):
    from repro_torch.configs.registry import get_config
    return get_config(arch).replace(n_rep=reps, num_vehicles=vehicles,
                                    grad_accum=1)


def phase_vfl(device, cfg, warmup: int, rounds: int, batch: int, seq: int,
              lr: float, masks=None):
    """The VFL loop of `launch/train.py` (`make_train_step` with the
    scheduler inline) on the card, every kernel count set to 0 first:
    per round the wall time, its stages (each closed by a device
    synchronisation), the schedule's outcome, the eval loss and the peak
    memory; then the launch counts against those the code implies, and
    the masks against `masks` (an entry of RECORDED_MASKS) where given.
    A model that reads `src` gets its batches from `src_lm_batch`."""
    from repro_torch.data.synthetic import src_lm_batch
    from repro_torch.kernels.fedavg_agg.ops import fedavg_agg
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_fwd
    from repro_torch.core.veds import _SlotGraph
    from repro_torch.kernels.veds_score.ops import veds_dt_score
    from repro_torch.launch.train import train
    from repro_torch.models import engine
    from repro_torch.models.module import (param_bytes, param_count,
                                           tree_leaves)
    phase = f"vfl {cfg.name}"
    decl = engine.model_decl(cfg, "head")
    log(phase, f"{cfg.name} pattern {cfg.pattern} x n_rep {cfg.n_rep} "
        f"d_model {cfg.d_model} heads {cfg.num_heads}/{cfg.num_kv_heads}x"
        f"{cfg.head_dim} d_ff {cfg.d_ff} experts {cfg.num_experts} top-"
        f"{cfg.experts_per_tok} expert d_ff {cfg.moe_d_ff} ssm N "
        f"{cfg.ssm_state} heads "
        f"{cfg.ssm_heads}x{cfg.ssm_head_dim} chunk {cfg.ssm_chunk} encoder "
        f"layers {cfg.encoder_layers} src {cfg.num_src_tokens}x"
        f"{cfg.src_dim} vocab "
        f"{cfg.vocab_size} {cfg.param_dtype}: {param_count(decl)} params, "
        f"{param_bytes(decl) / 1e9:.3f} GB; {cfg.num_vehicles} vehicles x "
        f"{batch} x {seq} tokens")
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
    ssd_scan_fwd.launches = 0
    veds_dt_score.launches = 0
    captures = _SlotGraph.captures
    mark[0] = time.perf_counter()
    with round0_share() as changed:
        hist = train(cfg, rounds=warmup + rounds, batch_per_vehicle=batch,
                     seq=seq, lr=lr, seed=0, device=device,
                     log=lambda m: log(phase, m), stage_hook=hook,
                     on_round=on_round, batch_fn=src_lm_batch(cfg))
    captures = _SlotGraph.captures - captures
    launches = {"flash_attention": flash_attention_fwd.launches,
                "fedavg_agg": fedavg_agg.launches,
                "ssd_scan": ssd_scan_fwd.launches,
                "veds_score": veds_dt_score.launches}

    per_round = [dict(r) for r in records]
    names = [n for n, _ in stages]
    check(names[0] == "setup", "stage marks")
    setup_ms = stages[0][1]
    body = stages[1:]
    for i, rec in enumerate(per_round):
        rec.update({f"{n}_ms": ms for n, ms in body[5 * i: 5 * i + 5]})
        log(phase, f"round {rec['round']}{' (warm-up)' if i < warmup else ''}"
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
    n_mamba = reps * cfg.pattern.count("mamba")
    n_enc = cfg.encoder_layers
    want = {
        # each attention (Mamba2) sub-block per vehicle: forward, and
        # again when remat recomputes it in the backward; each encoder
        # layer's attention once (the encoder is not checkpointed); plus
        # the eval forward
        "flash_attention": n * (V * (n_attn * 2 + n_enc) + n_attn + n_enc),
        "ssd_scan": n * (V * n_mamba * 2 + n_mamba),
        # one launch per parameter leaf per round (the device decides
        # between the mean and `old`, so the count does not depend on the
        # mask)
        "fedavg_agg": n * len(tree_leaves(decl)),
        # one per slot of the round's schedule
        "veds_score": n * VFL_SLOTS,
    }
    log(phase, f"launches on the VFL path: {launches} (expected {want}); "
        f"slot graphs captured: {captures}; schedule "
        f"{[round(r['schedule_ms'], 1) for r in per_round]} ms by round")
    for k, w in want.items():
        check(launches[k] == w, f"{k} launched {launches[k]} times on the "
              f"VFL path, expected {w}")
    if masks is not None:
        got = [rec["mask"] for rec in per_round]
        check(got == masks, f"masks {got} are not the recorded {masks}")
        log(phase, "masks as recorded")
    share = changed["share"]
    log(phase, f"lr {lr:g}: round 0 changed {share:.4f} of the bf16 "
        f"parameter entries")
    check(share > 0, f"{cfg.name} round 0 changed no bf16 entry")
    timed = per_round[warmup:]
    return dict(setup_ms=setup_ms, rounds=per_round, launches=launches,
                expected_launches=want, lr=lr, graph_captures=captures,
                timed_wall_s=[r["wall_s"] for r in timed],
                history_len=len(hist), changed_bf16_round0=share)


def phase_moe(device, cfg, batch: int, seq: int, seed: int = 31):
    """One MoE sub-block of `cfg` at full width (bf16, its init as
    `engine.model_decl` casts it) on one vehicle's batch of `batch` x
    `seq` tokens: forward and backward of sum(y * ct) + aux, twice from
    the same inputs; the output, aux and every gradient must be equal bit
    for bit (the combine and the dispatch's backward sum each token's
    slots in expert order, with no atomics). Times the block's forward
    and backward, and the combine (`_sum_rows` of the gated expert
    outputs over each token's kept slots) beside the `index_add_`
    scatter-add that the reference's `.at[].add` would be in PyTorch, on
    the block's own slots."""
    from repro_torch.models import blocks as B
    from repro_torch.models import engine
    from repro_torch.models.module import (materialize, tree_leaves,
                                           tree_map, tree_unflatten)
    one = cfg.replace(n_rep=1)
    params = materialize(torch.Generator(device=device).manual_seed(seed),
                         engine.model_decl(one, "head"))
    p = tree_map(lambda a: a[0], params["blocks"][cfg.pattern.index("moe")])
    del params
    g = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn((batch, seq, cfg.d_model), generator=g,
                    device=device).to(cfg.dtype)
    ct = torch.randn(x.shape, generator=g, device=device).to(cfg.dtype)

    def run():
        leaves = [a.detach().clone().requires_grad_() for a in tree_leaves(p)]
        xx = x.clone().requires_grad_()
        y, aux = B.moe_apply(tree_unflatten(p, leaves), xx, cfg)
        grads = torch.autograd.grad((y.float() * ct.float()).sum() + aux,
                                    leaves + [xx])
        return [y, aux, *grads]

    first, second = run(), run()
    torch.cuda.synchronize()
    def paths(tree, pre=""):
        if isinstance(tree, dict):
            for key in sorted(tree):
                yield from paths(tree[key], f"{pre}{key}.")
        else:
            yield pre[:-1]
    names = ["y", "aux"] + [f"d_{q}" for q in paths(p)] + ["d_x"]
    equal = {n: bool(torch.equal(a, b)) for n, a, b in
             zip(names, first, second)}
    finite = all(bool(torch.isfinite(a).all()) for a in first)
    h, gate, eidx, _ = B.moe_route(p, x, cfg)
    tok_idx, slot_valid, gates_ec, pos, valid = B.moe_plan(gate, eidx, cfg)
    G, n, k = eidx.shape
    E = cfg.num_experts
    C = tok_idx.shape[1] // E
    dropped = int(G * n * k - valid.sum())
    del first, second
    block_ms = time_ms(run, 1, samples=5, warmup=1)
    yb = torch.randn((G, E * C, cfg.d_model), generator=g,
                     device=device).to(cfg.dtype) * gates_ec[..., None].to(
                         cfg.dtype)
    combine_ms = time_ms(lambda: B._sum_rows(yb, pos, valid), 20,
                         samples=7, warmup=2)
    rows = (torch.arange(G, device=device)[:, None] * n + tok_idx).reshape(-1)
    flat = yb.reshape(G * E * C, cfg.d_model)

    def scatter():
        return torch.zeros((G * n, cfg.d_model), dtype=yb.dtype,
                           device=device).index_add_(0, rows, flat)
    index_add_ms = time_ms(scatter, 20, samples=7, warmup=2)
    err = float((scatter().reshape(G, n, -1).float()
                 - B._sum_rows(yb, pos, valid).float()).abs().max())
    log("moe", f"{cfg.name} MoE block ({E} experts top-{k}, expert d_ff "
        f"{cfg.moe_d_ff}, d_model {cfg.d_model}, {cfg.param_dtype}) on "
        f"{batch} x {seq} tokens: G {G} groups of {n}, capacity {C}, "
        f"{dropped} of {G * n * k} (token, choice) pairs dropped; two "
        f"forward+backward runs equal bit for bit: {equal}; block fwd+bwd "
        f"{block_ms:.3f} ms; combine {combine_ms:.4f} ms beside "
        f"index_add_ {index_add_ms:.4f} ms (max abs difference "
        f"{err:.3e}: bf16 sums in another order)")
    check(finite, f"{cfg.name} MoE block: output or gradient not finite")
    check(all(equal.values()), f"{cfg.name} MoE block: two identical runs "
          f"differ: {equal}")
    return dict(bitwise_equal=equal, groups=G, capacity=C, dropped=dropped,
                pairs=G * n * k, block_fwd_bwd_ms=block_ms,
                combine_ms=combine_ms, index_add_ms=index_add_ms,
                combine_vs_index_add_max_abs=err)


def phase_xlstm_blocks(device, cfg, batch: int, seq: int, vfl_res):
    """One mLSTM and the sLSTM sub-block of `cfg` at full width (bf16, the
    init as `engine.model_decl` casts it) on one vehicle's batch of
    `batch` x `seq` tokens: the forward alone and forward + backward of
    sum(y * ct), timed with CUDA events. Under remat local SGD runs each
    sub-block's forward, then its forward again and its backward, so a
    round's local SGD spends about V x n_rep x (fwd + fwd_bwd) in each
    kind (7 mLSTM positions, 1 sLSTM); that estimate is set beside the
    timed rounds' median `local_sgd` of `vfl_res` (`phase_vfl`)."""
    from repro_torch.models import blocks as B
    from repro_torch.models import engine
    from repro_torch.models.module import (materialize, tree_leaves,
                                           tree_map, tree_unflatten)
    one = cfg.replace(n_rep=1)
    params = materialize(torch.Generator(device=device).manual_seed(41),
                         engine.model_decl(one, "head"))
    g = torch.Generator(device=device).manual_seed(42)
    x = torch.randn((batch, seq, cfg.d_model), generator=g,
                    device=device).to(cfg.dtype)
    ct = torch.randn(x.shape, generator=g, device=device).to(cfg.dtype)
    res = {}
    for kind, apply in (("mlstm", B.mlstm_apply), ("slstm", B.slstm_apply)):
        p = tree_map(lambda a: a[0], params["blocks"][cfg.pattern.index(kind)])

        def fwd():
            return apply(p, x, cfg)

        def fwd_bwd():
            leaves = [a.detach().requires_grad_() for a in tree_leaves(p)]
            xx = x.detach().requires_grad_()
            y = apply(tree_unflatten(p, leaves), xx, cfg)
            return torch.autograd.grad((y.float() * ct.float()).sum(),
                                       leaves + [xx])

        finite = all(bool(torch.isfinite(a).all()) for a in fwd_bwd())
        check(finite, f"{cfg.name} {kind} block: output or gradient not "
              f"finite")
        with torch.no_grad():
            f_ms = time_ms(fwd, 1, samples=3, warmup=1)
        fb_ms = time_ms(fwd_bwd, 1, samples=3, warmup=1)
        n = cfg.n_rep * cfg.pattern.count(kind)
        res[kind] = dict(fwd_ms=f_ms, fwd_bwd_ms=fb_ms, per_round=n,
                         local_sgd_est_ms=cfg.num_vehicles * n
                         * (f_ms + fb_ms))
    del params
    sgd = statistics.median(r["local_sgd_ms"]
                            for r in vfl_res["rounds"][VFL_WARMUP:])
    for kind, r in res.items():
        r["share_of_local_sgd"] = r["local_sgd_est_ms"] / sgd
        log("xlstm", f"{cfg.name} {kind} sub-block (d_model {cfg.d_model}, "
            f"{cfg.num_heads} heads, {cfg.param_dtype}) on {batch} x {seq} "
            f"tokens: forward {r['fwd_ms']:.2f} ms, forward + backward "
            f"{r['fwd_bwd_ms']:.2f} ms; {r['per_round']} a vehicle's model "
            f"x {cfg.num_vehicles} vehicles x (fwd + fwd_bwd) = "
            f"{r['local_sgd_est_ms']:.1f} ms, {r['share_of_local_sgd']:.3f} "
            f"of the timed rounds' median local_sgd {sgd:.1f} ms")
    res["local_sgd_median_ms"] = sgd
    return res


@contextlib.contextmanager
def round0_share():
    """Inside the block, the first step of `launch/train.py`'s `train`
    records in the yielded dict, under "share", the share of the bf16
    parameter entries of vehicle 0's model that its round changes: the
    step's `make_train_step` is wrapped to compare its parameters before
    and after (the old ones are not written in place). The comparison
    runs after round 0's aggregate, in its eval stage."""
    import repro_torch.launch.train as tr
    from repro_torch.models.module import tree_leaves
    make, out = tr.make_train_step, {}

    def wrapped(*args, **kw):
        step = make(*args, **kw)

        def first_recorded(params_v, *rest):
            new_v, stats = step(params_v, *rest)
            if "share" not in out:
                n = changed = 0
                for a, x in zip(tree_leaves(params_v), tree_leaves(new_v)):
                    if a.dtype == torch.bfloat16:
                        n += a[0].numel()
                        changed += int((a[0] != x[0]).sum())
                out["share"] = changed / n
            return new_v, stats
        return first_recorded
    tr.make_train_step = wrapped
    try:
        yield out
    finally:
        tr.make_train_step = make


def forward_sensitivity(device, cfg, seq: int, seed: int = 0):
    """The eval loss of `cfg` at its init (`train`'s weights and eval batch
    for `seed`) through the plain versions (`flash_attention_plain` and
    `ssd_scan_plain`, on the card); through all the kernels the model
    runs, each call of which is held against the plain version on the
    same inputs (the model's own) with the kernels phases' bounds
    (flash_attention's beside the library's: `flash_used_beside_library`);
    where the model runs two kernels, through each alone, the other
    through its plain version; and through the plain versions with every
    nonzero bf16 weight moved by one ulp, up or down at random,
    SENS_DRAWS times. Each route through the kernels must stay within
    SENS_ULP_FACTOR times the largest move of those draws from the plain
    versions' loss. The loss alone cannot tell a right kernel from a
    wrong one (PERF.md section 6); the calls' bounds can. Run outside the
    counted window."""
    import repro_torch.kernels.flash_attention.ops as fa
    import repro_torch.kernels.ssd_scan.ops as ss
    from repro_torch.data.synthetic import lm_batch, src_lm_batch
    from repro_torch.fl.vfl import lm_loss
    from repro_torch.launch.train import EVAL_STREAM, _generator
    from repro_torch.models import engine
    from repro_torch.models.module import materialize, tree_map
    params = materialize(torch.Generator(device=device).manual_seed(seed),
                         engine.model_decl(cfg, "head"))
    batch = (src_lm_batch(cfg) or lm_batch)(
        _generator(seed, EVAL_STREAM, 0, device), 8, seq, cfg.vocab_size)
    g = torch.Generator(device=device).manual_seed(seed + 1)

    def one_ulp(x):
        if x.dtype != torch.bfloat16:
            return x
        step = 2 * torch.randint(0, 2, x.shape, generator=g, device=device,
                                 dtype=torch.int16) - 1
        return (x.view(torch.int16) + step * (x != 0)).view(torch.bfloat16)

    # name: (module, attribute, kernel wrapper, plain version, bound share)
    swap = {"flash_attention": (fa, "flash_attention_fwd",
                                fa.flash_attention_fwd,
                                fa.flash_attention_plain,
                                flash_used_beside_library),
            "ssd_scan": (ss, "ssd_scan_fwd", ss.ssd_scan_fwd,
                         ss.ssd_scan_plain,
                         lambda args, kw, out, ref: (ssd_used(*out, *ref),
                                                     None))}
    # per kernel: calls, the largest share of its bound, and the largest
    # share the library's version used where there is one
    calls, used, lib = (dict.fromkeys(swap, 0), dict.fromkeys(swap, 0.0),
                        dict.fromkeys(swap, 0.0))

    def held(name):
        _, _, kernel, plain, share = swap[name]

        # the kernel wrapper counts on the object its module's name holds,
        # so the stand-in carries copies of its attributes
        @functools.wraps(kernel)
        def call(*args, **kw):
            out = kernel(*args, **kw)
            calls[name] += 1
            u, lu = share(args, kw, out, plain(*args, **kw))
            used[name] = max(used[name], u)
            lib[name] = max(lib[name], lu or 0.0)
            return out
        return call

    def loss(through, weights=params):
        try:
            for name, (mod, attr, _, plain, _) in swap.items():
                setattr(mod, attr, through.get(name, plain))
            return float(lm_loss(weights, batch, cfg, "head"))
        finally:
            for mod, attr, kernel, _, _ in swap.values():
                setattr(mod, attr, kernel)

    attends = cfg.encoder_layers or any(
        k in ("attn", "attn_swa", "cross") for k in cfg.pattern)
    runs = (["flash_attention"] if attends else []) + (
        ["ssd_scan"] if "mamba" in cfg.pattern else [])
    with torch.no_grad():
        plain = loss({})
        routes = {"all kernels": loss({n: held(n) for n in runs})}
        if len(runs) > 1:
            routes.update({f"{n} alone": loss({n: swap[n][2]})
                           for n in runs})
        ulp = [loss({}, tree_map(one_ulp, params))
               for _ in range(SENS_DRAWS)]
    limit = SENS_ULP_FACTOR * max(abs(x - plain) for x in ulp)
    log("sensitivity", f"{cfg.name} eval loss at init "
        f"({batch['tokens'].shape[0]} x {seq} tokens): plain versions "
        f"{plain:.5f}; " + ", ".join(f"{k} {v - plain:+.5f}"
                                     for k, v in routes.items())
        + "; one ulp of every bf16 weight "
        + ", ".join(f"{x - plain:+.5f}" for x in ulp)
        + f" (limit {SENS_ULP_FACTOR:g} x the largest = {limit:.5f}); "
        + ("each kernel call on the model's inputs used at most "
           + ", ".join(f"{used[n]:.3f} ({calls[n]} calls of {n}"
                       + (f"; the library's used up to {lib[n]:.3f} of the "
                          f"bound" if lib[n] else "") + ")" for n in runs)
           + " of its allowance" if runs else
           "the model's forward runs no kernel"))
    check(all(math.isfinite(x) for x in [plain, *routes.values(), *ulp]),
          f"{cfg.name}: eval loss at init not finite")
    for n in runs:
        check(calls[n] > 0, f"{cfg.name}: the model made no {n} call")
        check(used[n] <= 1.0, f"{cfg.name}: a {n} call on the model's "
              f"inputs used {used[n]:.3f} of its allowance")
    for k, v in routes.items():
        check(abs(v - plain) <= limit, f"{cfg.name}: {k} moves the eval "
              f"loss at init by {v - plain:+.5f}, beyond {limit:.5f}")
    return dict(plain=plain, routes=routes, one_ulp=ulp, limit=limit,
                bound_used={n: used[n] for n in runs},
                library_bound_used={n: lib[n] for n in runs},
                calls={n: calls[n] for n in runs})


def phase_vfl_reference(device, arch: str, reps: int, *, atol=None,
                        update_rtol=None, seq: int = 128, batch: int = 4,
                        **replace):
    """One VFL round of `arch`'s smoke config with `reps` repetitions
    (and `replace`, e.g. a cut encoder) in fp32 on the card and on the
    CPU, from the same weights (the init as it is), batch (with `src` =
    0.1 * N(0, 1) for the audio and vlm families), mask and weights, held
    to the CPU tests' tolerance against the reference: the aggregate
    within `atol` absolute, or each leaf's update (aggregate less the old
    parameters) within `update_rtol` of its norm. The latter is zamba2's:
    at its init the tied attention's scores reach ~900 and the whole
    model amplifies one-ulp differences to a few 1e-2 of a gradient
    (`tests/test_torch_zamba2.py`'s docstring). To show that scale where
    it sets the tolerance, the CPU round then runs a second time with
    every weight moved by half an ulp (x (1 +- 6e-8)), and that change of
    the update is logged beside the card's."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.synthetic import lm_batch, src_lm_batch
    from repro_torch.fl.vfl import make_vfl_round
    from repro_torch.models import engine
    from repro_torch.models.module import materialize, tree_leaves, tree_map
    V = VFL_VEHICLES
    cfg = get_smoke_config(arch).replace(
        n_rep=reps, num_vehicles=V, grad_accum=1, param_dtype="float32",
        compute_dtype="float32", **replace)
    params = materialize(torch.Generator().manual_seed(21),
                         engine.model_decl(cfg, "head"))
    b = (src_lm_batch(cfg) or lm_batch)(torch.Generator().manual_seed(22),
                                        V * batch, seq, cfg.vocab_size)
    mask, w = torch.tensor([1.0, 0.0, 1.0, 1.0]), torch.tensor(
        [1.0, 1.0, 2.0, 1.0])

    def run(dev, weights=params):
        p = tree_map(lambda x: x.to(dev).unsqueeze(0).expand(V, *x.shape),
                     weights)
        bv = {k: x.to(dev).reshape(V, batch, *x.shape[1:])
              for k, x in b.items()}
        out = make_vfl_round(cfg, None, "head", lr=0.1)(
            p, bv, mask.to(dev), w.to(dev))
        return [x[0].cpu() for x in tree_leaves(out)]

    cpu, gpu = run("cpu"), run(device)
    old = tree_leaves(params)

    def update_err(out):
        return max(float((a - c).norm() / (c - p0).norm().clamp_min(1e-30))
                   for a, c, p0 in zip(out, cpu, old))
    err = max(float((a - c).abs().max()) for a, c in zip(gpu, cpu))
    upd = update_err(gpu)
    moved = max(float((c - p0).abs().max()) for c, p0 in zip(cpu, old))
    check(all(math.isfinite(float(a.abs().max())) for a in gpu),
          "VFL round on the card: aggregate not finite")
    if atol is not None:
        check(err <= atol, f"VFL round {arch}: card vs CPU aggregate "
              f"differs by {err:.3e} > {atol}")
    if update_rtol is not None:
        check(upd <= update_rtol, f"VFL round {arch}: card vs CPU update "
              f"differs by {upd:.3e} of its norm > {update_rtol}")
    tol = (f"aggregate atol {atol}" if atol is not None else
           f"update {update_rtol} of its norm")
    res = dict(max_abs_err=err, update_rel_err=upd, max_update=moved,
               tolerance=tol)
    note = ""
    if update_rtol is not None:
        g = torch.Generator().manual_seed(23)
        nudged = tree_map(lambda x: x * (1.0 + 6e-8 * (2.0 * torch.randint(
            0, 2, x.shape, generator=g) - 1.0)), params)
        res["cpu_half_ulp_update_rel"] = update_err(run("cpu", nudged))
        # a tolerance of the update's norm tells a right update from a
        # wrong one (a zero update reads 1) only where the CPU's own
        # half-ulp move is well below 1
        check(res["cpu_half_ulp_update_rel"] < 0.1, f"VFL round {arch}: "
              f"the CPU's own update moves by "
              f"{res['cpu_half_ulp_update_rel']:.3e} of its norm under a "
              f"half-ulp change of the weights; the config is too "
              f"ill-conditioned at its init to hold the card to it")
        note = (f"; the CPU's own update moves by "
                f"{res['cpu_half_ulp_update_rel']:.3e} of its norm when "
                f"every weight moves by half an ulp")
    log("vfl_reference", f"one VFL round of the {arch} smoke config "
        f"(n_rep {reps}{''.join(f', {k} {v}' for k, v in replace.items())}"
        f", fp32, V={V}, mask {mask.tolist()}, weights {w.tolist()}"
        f"{', src ' + str(list(b['src'].shape)) if 'src' in b else ''}"
        f"): card vs CPU aggregate max abs {err:.3e}, update "
        f"{upd:.3e} of its norm (tolerance {tol}; the round moved the "
        f"params by up to {moved:.3e}){note}")
    return res


# ---------------------------------------------------------------------------
# the scheduling service (`launch/serve.py`): the reference's own
# configuration card against CPU, and VEDS with warm P4 at fig10's width
# ---------------------------------------------------------------------------

def ulps(a, b) -> int:
    """The largest distance in float32 ulps between the entries of two
    tensors of one shape (the count of floats between them)."""
    def key(t):
        i = t.detach().cpu().float().contiguous().view(torch.int32)
        i = i.to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((key(a) - key(b)).abs().max()) if a.numel() else 0


def _leaves(tree, prefix=""):
    """(name, tensor) of every tensor of a tree of dataclasses and
    dicts, in field order."""
    import dataclasses
    if tree is None:
        return []
    if torch.is_tensor(tree):
        return [(prefix, tree)]
    if dataclasses.is_dataclass(tree):
        items = [(f.name, getattr(tree, f.name))
                 for f in dataclasses.fields(tree)]
    elif hasattr(tree, "_asdict"):
        items = list(tree._asdict().items())
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        items = list(tree.items())
    return [leaf for k, v in items
            for leaf in _leaves(v, f"{prefix}.{k}" if prefix else k)]


def _carry_distance(a, b):
    """Per leaf of two carries: ulps for float32 leaves, equality for the
    others, and the relative error of finite float entries."""
    out = {}
    for (name, x), (_, y) in zip(_leaves(a), _leaves(b)):
        x, y = x.detach().cpu(), y.detach().cpu()
        if not x.is_floating_point():
            out[name] = dict(equal=bool(torch.equal(x, y)))
            continue
        fin = torch.isfinite(y)
        same_nonfinite = bool(torch.equal(x[~fin], y[~fin]))
        d = (x[fin].double() - y[fin].double()).abs()
        scale = float(y[fin].double().abs().max()) if fin.any() else 0.0
        out[name] = dict(ulps=ulps(x, y), equal=bool(torch.equal(x, y)),
                         rel_err=float(d.max()) / max(scale, 1e-30)
                         if d.numel() else 0.0,
                         nonfinite_equal=same_nonfinite)
    return out


def cpu_draw_service(cfg, device):
    """A `SchedulingService` on `device` whose every draw (each session's
    fleet, each request's round draws, selections and minibatch uniforms)
    is made on the CPU from the service's own keys and moved across, so a
    service on the card and one on the CPU serve the same draws."""
    import dataclasses
    from repro_torch.core.scenario import (fleet_round_draws,
                                           init_fleet_draws, round_key)
    from repro_torch.core.streaming import FLEET_STREAM
    from repro_torch.fl.engine import init_carry
    from repro_torch.launch import serve

    class CpuDraws(serve.SchedulingService):
        def _n(self):
            return self.cfg.n_fleet or 2 * (self.cfg.n_sov + self.cfg.n_opv)

        def _new_carry(self, session):
            gen = torch.Generator().manual_seed(round_key(
                self.session_seed(session), FLEET_STREAM, 0))
            draws = init_fleet_draws(gen, self.mob, self.sc, 1, self._n(),
                                     "cpu")
            return init_carry(_to_device(draws, self.device), self.sc,
                              self.mob,
                              dataclasses.replace(self._stream, batch=1),
                              self.params0, ch=self.ch, device=self.device)

        def _column(self, req, L):
            keys, sel, mb_u = serve.request_draws(
                int(req.seed), int(req.n_rounds), self.shards.n_clients,
                self.cfg.n_sov, self.cfg.batch_size, "cpu")
            draws = [_to_device(fleet_round_draws(
                torch.Generator().manual_seed(k), self.sc, 1, self._n(),
                "cpu"), self.device) for k in keys]
            return (serve._pad_rows(draws, L),
                    serve._pad_rows(sel.to(self.device), L),
                    serve._pad_rows(mb_u.to(self.device), L),
                    np.arange(L) < int(req.n_rounds))

    return CpuDraws(cfg, device=device)


def phase_serve_reference(device):
    """The reference's own `ServeConfig()` (madca, B 4, L 4, S 4, U 3,
    T 10, `default_problem` of 10 clients): 6 sessions over 3 waves of
    1-4 rounds, repeat sessions in the later waves, served on the card
    and on the CPU from the same draws (`cpu_draw_service`). Each
    response's success and n_success must be equal, its losses within
    SERVE_LOSS_RTOL, and every stored carry's floats within
    SERVE_CARRY_RTOL of their leaf's scale (integer and boolean fields
    equal)."""
    from repro_torch.kernels.veds_score.ops import veds_dt_score
    from repro_torch.launch.serve import ServeConfig, ServeRequest
    res = {}
    for dev in ("cpu", device):
        svc = cpu_draw_service(ServeConfig(), dev)
        veds_dt_score.launches = 0
        resps = [svc.run_batch([ServeRequest(*r) for r in wave])
                 for wave in SERVE_REF_WAVES]
        res[str(dev)] = (svc, resps, veds_dt_score.launches)
    cpu_svc, cpu, _ = res["cpu"]
    svc, card, launches = res[str(device)]
    loss_err = 0.0
    for cw, gw in zip(cpu, card):
        for c, g in zip(cw, gw):
            check(np.array_equal(c.success, g.success)
                  and np.array_equal(c.n_success, g.n_success),
                  f"serve reference: {c.session}'s decisions differ "
                  f"between card and CPU")
            check(c.tier == g.tier, "serve reference: tiers differ")
            loss_err = max(loss_err, float(np.max(
                np.abs(g.loss - c.loss) / np.abs(c.loss))))
    check(loss_err <= SERVE_LOSS_RTOL, f"serve reference: losses differ by "
          f"{loss_err:.2e} relative, beyond {SERVE_LOSS_RTOL}")
    carries = {s: _carry_distance(svc.sessions[s], cpu_svc.sessions[s])
               for s in sorted(cpu_svc.sessions)}
    worst = max(d.get("rel_err", 0.0) for c in carries.values()
                for d in c.values())
    check(all(d["equal"] or d.get("rel_err", 1.0) <= SERVE_CARRY_RTOL
              and d["nonfinite_equal"] for c in carries.values()
              for d in c.values()),
          f"serve reference: a stored carry differs between card and CPU "
          f"beyond {SERVE_CARRY_RTOL} of its scale: {carries}")
    check(set(svc.sessions) == set(cpu_svc.sessions), "serve sessions")
    bitwise = sorted({k for c in carries.values() for k, d in c.items()
                      if d["equal"]})
    n_succ = [[r.n_success.tolist() for r in w] for w in card]
    log("serve_reference", f"ServeConfig() (madca, B 4, L 4, S 4, U 3, "
        f"T 10, 10 clients): 6 sessions over 3 waves, card vs CPU on the "
        f"same draws: decisions identical (n_success {n_succ}); losses "
        f"{loss_err:.2e} relative (tolerance {SERVE_LOSS_RTOL}); stored "
        f"carries within {worst:.2e} of their scale (tolerance "
        f"{SERVE_CARRY_RTOL}), bit for bit in {bitwise}; veds_score "
        f"launches {launches}")
    return dict(n_success=n_succ, loss_rel_err=loss_err,
                carry_rel_err=worst, carries=carries, bitwise=bitwise,
                launches={"veds_score": launches})


def _serve_fig10_config():
    from repro_torch.fl.simulator import FLSimConfig
    from repro_torch.launch.serve import ServeConfig
    sim = FLSimConfig()
    return ServeConfig(**SERVE_FIG10, alpha=sim.alpha, V=sim.V,
                       q_bits=sim.q_bits)


def _serve_requests():
    """The load: SERVE_SESSIONS sessions, each sending SERVE_MIX's round
    counts in turn (the reference's `serve_tier_sweep` mix), one request
    in flight a session."""
    from repro_torch.launch.serve import ServeRequest
    return {(c, j): ServeRequest(f"client-{c}", r, seed=1000 * c + j)
            for c in range(SERVE_SESSIONS) for j, r in enumerate(SERVE_MIX)}


def first_parting(cfg, reqs, carries, idx, device):
    """Where a packed cell first parts from its solo run: the dispatch of
    `reqs` from the sessions' stored `carries` (None: a fresh session) at
    its tier beside request `idx` alone at B = 1 from the same carry,
    stepped round by round and, inside the schedule, slot by slot
    (`solve_slot`), cell `idx` compared after each step. A slot that
    parts is split into its candidates (`_slot_candidates`) to name the
    stage. `cfg.scheduler` is one of VEDS's (`veds`, `v2i_only`). Returns
    (round, stage, field, ulps) of the first difference, or None."""
    import dataclasses
    from repro_torch.core.baselines import get_scheduler
    from repro_torch.core.scenario import fleet_round
    from repro_torch.core.scheduler import map_tree
    from repro_torch.core.streaming import (pack_cells, round_carry,
                                            sched_round_step, warm_p4)
    from repro_torch.core import veds as V
    from repro_torch.launch.serve import SchedulingService
    svc = SchedulingService(cfg, device=device)
    L, B = svc.route(reqs)
    scheds = [map_tree(lambda x: x.to(device), c).sched if c is not None
              else svc.session_carry(r.session).sched
              for r, c in zip(reqs, carries)]
    fleets = [pack_cells(scheds + [scheds[0]] * (B - len(reqs))),
              scheds[idx]]
    cols = [svc._column(r, L) for r in reqs]
    cols += [cols[0]] * (B - len(reqs))
    sched = get_scheduler(cfg.scheduler)
    warm = warm_p4(sched, svc.prm)
    streams = [dataclasses.replace(svc._stream, batch=b) for b in (B, 1)]
    prm, ch = svc.prm, svc.ch

    def parted(r, stage, p, s):
        for (name, x), (_, y) in zip(_leaves(p), _leaves(s)):
            x = x[idx:idx + 1] if x.ndim else x
            if not torch.equal(x, y):
                return (r, stage, name, ulps(x, y)
                        if x.is_floating_point() else None)
        return None

    for r in range(int(reqs[idx].n_rounds)):
        keys = [[c[0][r] for c in cols], [cols[idx][0][r]]]
        outs = [fleet_round(k, f, svc.sc, svc.mob, ch, prm)
                for k, f in zip(keys, fleets)]
        # the round's inputs and selections; the fleet it advanced is
        # compared after the round's scatter
        found = parted(r, "scenario: fleet_round", *(o[1:] for o in outs))
        if found:
            return found
        rnds = [rnd.with_batch_axis() for _, rnd, _ in outs]
        states = [V._round_state(rnd, prm, ch, sched.enable_cot, round_carry(
            fl, sel, warm, cfg.carry_queues)[0])
            for (fl, _, sel), rnd in zip(outs, rnds)]
        for t in range(svc.sc.n_slots):
            at = torch.full((), t, dtype=torch.int64, device=device)
            nxt = [V.solve_slot(at, st, rnd, prm, ch,
                                enable_cot=sched.enable_cot)
                   for st, rnd in zip(states, rnds)]
            found = parted(r, f"schedule: slot {t}, the selection and the "
                              f"queue update (_select_slot, lyapunov)",
                           *nxt)
            if found:
                dt, cot = zip(*(V._slot_candidates(at, st, rnd, prm, ch,
                                                   sched.enable_cot)
                                for st, rnd in zip(states, rnds)))
                return (parted(r, f"schedule: slot {t}, the DT candidates "
                                  f"(veds_score)", *dt)
                        or parted(r, f"schedule: slot {t}, the COT "
                                     f"candidates (_cot_candidates: the "
                                     f"batched P4 interior-point solve)",
                                  *cot)
                        or found)
            states = [st for st, _ in nxt]
        fleets = [sched_round_step(f, k, sched, svc.sc, svc.mob, ch, prm,
                                   c)[0]
                  for f, k, c in zip(fleets, keys, streams)]
        found = parted(r, "schedule: the round's scatter into the fleet",
                       *fleets)
        if found:
            return found
    return None


def phase_serve(device):
    """The scheduling service at fig10's width: VEDS with COT and the warm
    P4 table (`ipm_warm_iters` STREAM_WARM_ITERS), S=U=10, T=60, fleets
    of 40, batch 32 on `default_problem`'s 40 clients, B 8 on the tier
    ladder (2, 4, 8) x (1, 2, 4, 8), at most 4 sessions on the card.
    `warmup()` captures and pins the slot graph of every occupancy rung;
    then SERVE_SESSIONS sessions send SERVE_MIX's round counts, one
    request in flight a session, packed from a plain loop into windows
    of up to SERVE_WINDOW requests, each window split by horizon rung
    (shortest first) as the reference's front end splits it. Every
    dispatch is timed on the host around `run_batch`, which ends by
    reading its outputs to the host. The load must capture no slot
    graph, and `veds_score` must run T times for every packed round by
    its own count. Then: requests of two sessions replayed alone at
    B = 1 on a fresh service (masks identical, the floats' distance in
    ulps reported, and where they part, the first operation that parts
    them), the first dispatch replayed on a fresh service (bit for bit),
    and its first cell served beside other neighbours at the same B (bit
    for bit)."""
    import dataclasses
    from repro_torch.core import veds as V
    from repro_torch.core.scheduler import map_tree
    from repro_torch.kernels.veds_score.ops import veds_dt_score
    from repro_torch.launch.serve import (SchedulingService, ServeRequest,
                                          _pct)
    cfg = _serve_fig10_config()
    reqs = _serve_requests()
    rung = {r: next(h for h in cfg.horizons if h >= r) for r in SERVE_MIX}
    svc = SchedulingService(cfg, device=device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    svc.warmup()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log("serve", f"fig10 service: {cfg}; warmup {warm_s:.2f} s, slot "
        f"graphs captured {svc.warmup_captures}, pinned "
        f"{len(svc._pins)}")

    def snap(name):
        # a copy of the stored carry, without touching the LRU order (a
        # session of a full window may already be spilled)
        st = svc.sessions
        return map_tree(lambda x: x.detach().cpu().clone(),
                        st._hot[name] if name in st._hot
                        else st._spilled[name])

    pending = sorted(reqs, key=lambda k: (k[1], k[0]))     # arrival order
    done, t_sub, out, snaps, pre, dispatches = set(), {}, {}, {}, {}, []
    veds_dt_score.launches = 0
    captures = V._SlotGraph.captures
    t_load = time.perf_counter()
    for c in range(SERVE_SESSIONS):
        t_sub[(c, 0)] = t_load
    while pending:
        window, busy = [], set()
        for c, j in pending:
            if len(window) == SERVE_WINDOW:
                break
            if c in busy or (j and (c, j - 1) not in done):
                continue
            window.append((c, j))
            busy.add(c)
        for h in cfg.horizons:
            group = [k for k in window if rung[reqs[k].n_rounds] == h]
            if not group:
                continue
            batch = [reqs[k] for k in group]
            st = svc.sessions
            before = [st._hot.get(r.session, st._spilled.get(r.session))
                      for r in batch]
            for i, k in enumerate(group):
                if k in SERVE_TRACK:
                    pre[k] = (batch, before, i)
            t_start = time.perf_counter()
            resps = svc.run_batch(batch)     # ends reading to the host
            t_end = time.perf_counter()
            svc.metrics.observe_batch(batch, [t_sub[k] for k in group],
                                      t_start, t_end)
            d = dict(tier=resps[0].tier, occupancy=len(group),
                     compute_ms=(t_end - t_start) * 1e3,
                     sessions=[reqs[k].session for k in group])
            dispatches.append(d)
            log("serve", f"dispatch {len(dispatches) - 1}: tier "
                f"{d['tier']}, occupancy {d['occupancy']}, compute "
                f"{d['compute_ms']:.1f} ms")
            for k, r in zip(group, resps):
                out[k] = r
                done.add(k)
                t_sub[(k[0], k[1] + 1)] = t_end
                if k in SERVE_TRACK or len(dispatches) == 1:
                    snaps[k] = snap(r.session)
        pending = [k for k in pending if k not in done]
    launches = veds_dt_score.launches
    load_captures = V._SlotGraph.captures - captures
    summary = svc.metrics.summary()
    comp = [1e3 * x for x in svc.metrics.compute_s]
    packed_rounds = sum(int(d["tier"][1:].split("x")[0])
                        for d in dispatches)
    want = packed_rounds * cfg.n_slots
    log("serve", f"load: {len(reqs)} requests of {SERVE_MIX} rounds from "
        f"{SERVE_SESSIONS} sessions in {len(dispatches)} dispatches: "
        f"compute p50 {_pct(comp, 50):.1f} ms, p99 {_pct(comp, 99):.1f} "
        f"ms; total p50 {summary['p50_ms']:.1f} ms, p99 "
        f"{summary['p99_ms']:.1f} ms; {summary['rounds_per_s']:.2f} "
        f"rounds/s; mean occupancy {summary['mean_occupancy']:.2f}; pad "
        f"fractions rounds {summary['pad_frac_rounds']:.3f}, cells "
        f"{summary['pad_frac_cells']:.3f}; tier hits "
        f"{summary['tier_hits']}; spills {summary['n_spills']}, restores "
        f"{summary['n_restores']}; slot graphs captured in warmup "
        f"{svc.warmup_captures}, in the load {load_captures} (metrics "
        f"{summary['n_captures']}); veds_score launches {launches} "
        f"(expected {want} = {packed_rounds} packed rounds x T "
        f"{cfg.n_slots})")
    check(load_captures == 0 and summary["n_captures"] == 0,
          f"serve: the load captured {load_captures} slot graphs after "
          f"warmup")
    check(launches == want, f"serve: veds_score launched {launches} "
          f"times, expected {want}")
    check(summary["n_spills"] > 0 and summary["n_restores"] > 0,
          "serve: max_sessions 4 of 12 sessions spilled or restored none")
    check(all(0 <= int(n) <= cfg.n_sov for r in out.values()
              for n in r.n_success)
          and all(np.isfinite(r.loss).all() for r in out.values()),
          "serve: n_success out of range or a loss not finite")

    # requests of two sessions alone at B = 1 on a fresh service
    solo = SchedulingService(dataclasses.replace(cfg, batch=1,
                                                 batch_tiers=None),
                             device=device)
    solo.warmup()
    veds_dt_score.launches = 0
    solo_rows, solo_rounds, solo_s = [], 0, 0.0
    for k in SERVE_TRACK:
        t_start = time.perf_counter()
        r = solo.run_batch([reqs[k]])[0]
        solo_s += time.perf_counter() - t_start
        solo_rounds += r.n_rounds
        p = out[k]
        check(np.array_equal(r.success, p.success)
              and np.array_equal(r.n_success, p.n_success),
              f"serve: {k}'s masks differ between packed ({p.tier}) and "
              f"solo")
        dist = _carry_distance(solo.sessions._hot[r.session], snaps[k])
        row = dict(request=list(k), tier=p.tier,
                   loss_ulps=ulps(torch.from_numpy(p.loss),
                                  torch.from_numpy(r.loss)),
                   carry_ulps={n: d.get("ulps") for n, d in dist.items()
                               if not d["equal"]})
        solo_rows.append(row)
        log("serve", f"solo replay of {k} (packed at {p.tier}): masks "
            f"identical; loss {row['loss_ulps']} ulps; carry leaves "
            f"differing: {row['carry_ulps'] or 'none'}")
    solo_launches = veds_dt_score.launches
    solo_rps = solo_rounds / solo_s
    bitwise = all(r["loss_ulps"] == 0 and not r["carry_ulps"]
                  for r in solo_rows)
    parting = None
    for row in solo_rows:
        k = tuple(row["request"])
        if row["loss_ulps"] or row["carry_ulps"]:
            parting = dict(request=list(k), at=first_parting(
                cfg, *pre[k], device))
            log("serve", f"{k} packed ({row['tier']}) first parts from "
                f"solo at (round, stage, field, ulps) {parting['at']}")
            break
    log("serve", f"solo B=1: {solo_rounds} rounds in {solo_s:.3f} s, "
        f"{solo_rps:.2f} rounds/s; packed load {summary['rounds_per_s']:.2f}"
        f" rounds/s = {summary['rounds_per_s'] / solo_rps:.2f}x; packed "
        f"== solo bit for bit: {bitwise}; veds_score launches "
        f"{solo_launches}")

    # the first dispatch again on a fresh service, and its first cell
    # beside other neighbours at the same B: both bit for bit
    first = [reqs[k] for k in sorted(reqs, key=lambda k: (k[1], k[0]))
             if reqs[k].session in dispatches[0]["sessions"] and k[1] == 0]
    others = [first[0]] + [ServeRequest(f"other-{i}", first[0].n_rounds,
                                        seed=5000 + i)
                           for i in range(len(first) - 1)]
    stages = {}
    for label, batch in (("replayed", first), ("other neighbours", others)):
        again = SchedulingService(cfg, device=device)
        again.warmup()
        records = stages.setdefault(label, [])
        hook = _stage_timer(records)
        hook.start()
        resps = again.run_batch(batch, stage_hook=hook)
        for r in resps[:len(first) if label == "replayed" else 1]:
            k = (int(r.session.split("-")[1]), 0)
            _assert_bitwise(r, out[k], again.sessions[r.session], snaps[k],
                            f"serve: the first dispatch {label}, {k}")
        log("serve", f"the first dispatch ({dispatches[0]['tier']}) "
            f"{label} on a fresh service: bit for bit; its rounds' stages "
            f"(each closed by a synchronisation; round 0's scenario "
            f"includes the dispatch's set-up) " + "; ".join(
                ", ".join(f"{k[:-3]} {v:.1f}" for k, v in rec.items())
                + " ms" for rec in records))
        again.close()
    # the same request's stages alone at B = 1
    records = stages.setdefault("solo", [])
    hook = _stage_timer(records)
    hook.start()
    solo.run_batch([ServeRequest("stage-probe", first[0].n_rounds,
                                 seed=first[0].seed)], stage_hook=hook)
    log("serve", f"{first[0].n_rounds} rounds alone at B = 1: " + "; ".join(
        ", ".join(f"{k[:-3]} {v:.1f}" for k, v in rec.items()) + " ms"
        for rec in records))
    svc.close()
    solo.close()
    return dict(config=str(cfg), warmup_s=warm_s,
                warmup_captures=svc.warmup_captures,
                load_captures=load_captures, dispatches=dispatches,
                summary=summary, compute_p50_ms=_pct(comp, 50),
                compute_p99_ms=_pct(comp, 99), solo=solo_rows,
                solo_rounds_per_s=solo_rps,
                packed_over_solo=summary["rounds_per_s"] / solo_rps,
                bitwise_vs_solo=bitwise, first_parting=parting,
                stages=stages,
                launches={"veds_score": launches},
                solo_launches={"veds_score": solo_launches})


def _assert_bitwise(r, want, carry, want_carry, what):
    check(np.array_equal(r.success, want.success)
          and np.array_equal(r.n_success, want.n_success)
          and np.array_equal(r.loss, want.loss), f"{what}: the response "
          f"differs")
    dist = _carry_distance(carry, want_carry)
    check(all(d["equal"] for d in dist.values()), f"{what}: the stored "
          f"carry differs: {dist}")


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
    t_start = time.perf_counter()
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
    entry = ""
    for line in lib.log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1] if "'" in line else line.strip()
        elif "registers" in line or "spill" in line:
            log("build", f"{entry}: {line.strip()}")

    # the serving path's [B, S] at fig10's width on its occupancy rungs
    # (B 1 is the stream shape's)
    serve_shapes = {f"serve_b{b}": (b, SERVE_FIG10["n_sov"])
                    for b in (2, 4, 8)}
    kernels = phase_kernels({"main": (ROUND_BATCH, 10), "vfl": (1, 4),
                             "stream": (1, 10), "v2i_only": (1, 10),
                             **serve_shapes, "large": (1 << 22,)},
                            device, graphed=("main", "vfl", "stream",
                                             "v2i_only", *serve_shapes))
    llm_kernels = phase_kernels_llm(device)
    ssd_kernels = phase_kernels_ssd(device)
    main_res, setup = phase_main(device, ROUNDS, ROUND_BATCH)
    stages = phase_stages(device, setup)
    ref = phase_reference(device)
    stream = phase_stream(device, setup)
    stream_ref = phase_stream_reference(device)
    compare = phase_compare(device, setup)
    compare_ref = phase_compare_reference(device)
    stream_compare = phase_stream_compare(device, setup)
    del setup
    free()
    serve_ref = phase_serve_reference(device)
    serve = phase_serve(device)
    free()
    vfl = phase_vfl(device, vfl_config("qwen3-32b", VFL_REPS), VFL_WARMUP,
                    VFL_ROUNDS, VFL_BATCH, VFL_SEQ, VFL_LR,
                    RECORDED_MASKS["qwen3-32b"])
    free()
    stream_vfl = phase_stream_vfl(device, vfl_config("qwen3-32b", VFL_REPS),
                                  STREAM_VFL_ROUNDS, VFL_BATCH, VFL_SEQ,
                                  VFL_LR)
    free()
    zcfg = vfl_config("zamba2-2.7b", ZAMBA2_REPS)
    zamba2 = phase_vfl(device, zcfg, VFL_WARMUP, VFL_ROUNDS, VFL_BATCH,
                       VFL_SEQ, ZAMBA2_LR, RECORDED_MASKS["zamba2-2.7b"])
    share = zamba2["changed_bf16_round0"]
    check(share >= ZAMBA2_MIN_CHANGED, f"zamba2 round 0 changed "
          f"{share:.4f} of the bf16 entries, below {ZAMBA2_MIN_CHANGED}")
    free()
    gcfg = vfl_config("granite-moe-1b-a400m", GRANITE_REPS)
    granite = phase_vfl(device, gcfg, VFL_WARMUP, VFL_ROUNDS, VFL_BATCH,
                        VFL_SEQ, GRANITE_LR,
                        RECORDED_MASKS["granite-moe-1b-a400m"])
    free()
    moe = phase_moe(device, gcfg, VFL_BATCH, VFL_SEQ)
    free()
    # the last two families at full width and depth: xLSTM, and whisper's
    # encoder with the cross-attention fed from it
    new_vfl = {}
    for arch, reps, lr in (("xlstm-1.3b", XLSTM_REPS, XLSTM_LR),
                           ("whisper-small", WHISPER_REPS, WHISPER_LR)):
        cfg = vfl_config(arch, reps)
        res = phase_vfl(device, cfg, VFL_WARMUP, VFL_ROUNDS, VFL_BATCH,
                        VFL_SEQ, lr, RECORDED_MASKS[arch])
        free()
        if arch == "xlstm-1.3b":
            res["blocks"] = phase_xlstm_blocks(device, cfg, VFL_BATCH,
                                               VFL_SEQ, res)
            free()
        new_vfl[arch] = (cfg, res)
    xlstm, whisper = new_vfl["xlstm-1.3b"][1], new_vfl["whisper-small"][1]
    sensitivity = {
        "qwen3-32b": forward_sensitivity(
            device, vfl_config("qwen3-32b", VFL_REPS), VFL_SEQ),
        "zamba2-2.7b": forward_sensitivity(device, zcfg, VFL_SEQ),
        "granite-moe-1b-a400m": forward_sensitivity(device, gcfg, VFL_SEQ),
        **{arch: forward_sensitivity(device, cfg, VFL_SEQ)
           for arch, (cfg, _) in new_vfl.items()}}
    free()
    vfl_ref = {"qwen3-32b": phase_vfl_reference(device, "qwen3-32b", 2,
                                                atol=2e-4),
               "zamba2-2.7b": phase_vfl_reference(device, "zamba2-2.7b", 2,
                                                  update_rtol=1e-1)}
    # the configurations without qk-norm, held as their CPU tests hold
    # them (tests/torch_ref_vfl.py MODEL_TOL)
    for arch in ("granite-moe-1b-a400m", "llama4-scout-17b-a16e",
                 "starcoder2-15b", "codeqwen1.5-7b", "minitron-4b"):
        vfl_ref[arch] = phase_vfl_reference(device, arch, 2,
                                            update_rtol=2e-2)
    # the last three families, whisper's and llama-3.2-vision's with src;
    # whisper at one encoder layer and one repetition, where the
    # reference's round is well conditioned at its init, as its CPU test
    # holds it (tests/test_torch_encdec.py)
    vfl_ref["xlstm-1.3b"] = phase_vfl_reference(device, "xlstm-1.3b", 1,
                                                update_rtol=2e-2)
    vfl_ref["whisper-small"] = phase_vfl_reference(
        device, "whisper-small", 1, update_rtol=2e-2, encoder_layers=1)
    vfl_ref["llama-3.2-vision-90b"] = phase_vfl_reference(
        device, "llama-3.2-vision-90b", 1, update_rtol=2e-2)

    def by_path(name):
        out = {"vfl_qwen3": vfl["launches"][name],
               "vfl_zamba2": zamba2["launches"][name],
               "vfl_granite": granite["launches"][name],
               "vfl_xlstm": xlstm["launches"][name],
               "vfl_whisper": whisper["launches"][name]}
        if name in stream_vfl["launches"]:
            out["stream_vfl_qwen3"] = stream_vfl["launches"][name]
        if name == "veds_score":
            out["run_fl"] = main_res["launches"][name]
            out["stream_run_fl"] = stream["warm"]["launches"][name]
            out["stream_run_fl_cold"] = stream["cold"]["launches"][name]
            for task in ("cifar", "traj"):
                for sched in ("veds", "v2i_only"):
                    out[f"compare_{task}_{sched}"] = compare[task][
                        "schedulers"][sched]["launches"][name]
            out["stream_compare_v2i_only"] = stream_compare["v2i_only"][
                "launches"][name]
            out["serve_reference_madca"] = serve_ref["launches"][name]
            out["serve_fig10"] = serve["launches"][name]
            out["serve_fig10_solo"] = serve["solo_launches"][name]
        return out

    def timed(r, **extra):
        return dict(ms=r["ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=r.get("library_ms"), **extra)

    def graphed_shape(label):
        r = kernels[label]
        return timed(r, shape=r["shape"], max_abs_err=r["max_abs_err"],
                     graph_ms=r["graph_ms"],
                     graph_floor_ms=r["graph_floor_ms"])

    def max_err(res, key="max_abs_err"):
        return max(r[key] for r in res.values() if isinstance(r, dict))

    # launches: this slice's path (the zamba2 VFL round), which runs all
    # four kernels; times at its shapes (fedavg_agg: the qwen3 embedding
    # leaf, its largest)
    k = kernels["main"]
    fa = llm_kernels["flash_attention"]
    fd = llm_kernels["fedavg_agg"]
    ss = ssd_kernels["main"]
    line = {"kernels": [{
        "name": "veds_score", "route": "cuda",
        "source": "src/repro_torch/kernels/veds_score/csrc/veds_score.cu",
        "replaces": "src/repro/kernels/veds_score/veds_score.py:25",
        "launches": zamba2["launches"]["veds_score"],
        "launches_by_path": by_path("veds_score"),
        "max_abs_err": max_err(kernels),
        **timed(k, shape=k["shape"], graph_ms=k["graph_ms"],
                graph_floor_ms=k["graph_floor_ms"],
                vfl_shape=graphed_shape("vfl"),
                stream_shape=graphed_shape("stream"),
                v2i_only_shape=graphed_shape("v2i_only"),
                serve_shapes={label: graphed_shape(label)
                              for label in serve_shapes})}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/"
                  "flash_attention_sm90.cu",
        "variant": "bf16 (the main path): wgmma + TMA, "
                   + fa["zamba2"]["entry"] + "; fp32: CUDA cores, "
                   "flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/flash_attention.py:29",
        "launches": zamba2["launches"]["flash_attention"],
        "launches_by_path": by_path("flash_attention"),
        "max_abs_err": max_err(fa), "rel_err": max_err(fa, "rel_err"),
        **timed(fa["zamba2"], shape={"q": fa["zamba2"]["shape_q"],
                                     "kv": fa["zamba2"]["shape_kv"]}),
        "qwen3_shape": timed(fa["main"], shape={"q": fa["main"]["shape_q"],
                                                "kv": fa["main"]["shape_kv"]}),
        **{f"{label}_shape": timed(fa[label],
                                   shape={"q": fa[label]["shape_q"],
                                          "kv": fa[label]["shape_kv"]},
                                   causal=fa[label]["causal"],
                                   entry=fa[label]["entry"])
           for label in TIMED_FLASH if label not in ("main", "zamba2")}
    }, {
        "name": "fedavg_agg", "route": "cuda",
        "source": "src/repro_torch/kernels/fedavg_agg/csrc/fedavg_agg.cu",
        "replaces": "src/repro/kernels/fedavg_agg/fedavg_agg.py:20",
        "launches": zamba2["launches"]["fedavg_agg"],
        "launches_by_path": by_path("fedavg_agg"),
        "max_abs_err": max_err(fd),
        **timed(fd["main"], shape=fd["main"]["shape"]),
        "granite_shape": timed(fd["granite"], shape=fd["granite"]["shape"]),
        "xlstm_shape": timed(fd["xlstm"], shape=fd["xlstm"]["shape"])
    }, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_sm90.cu",
        "variant": "bf16 (the main path): mma.sync + cp.async, "
                   + ss["entry"] + "; fp32: CUDA cores, ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:22",
        "launches": zamba2["launches"]["ssd_scan"],
        "launches_by_path": by_path("ssd_scan"),
        "max_abs_err": max_err(ssd_kernels),
        "rel_err": max_err(ssd_kernels, "rel_err"),
        **timed(ss, shape={"v": ss["shape_v"], "bc": ss["shape_bc"],
                           "chunk": ss["chunk"]})}]}
    out = ROOT / "chiprun_out" / "chip_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(
        smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s, kernels=kernels, llm_kernels=llm_kernels,
        ssd_kernels=ssd_kernels, main=main_res, stages=stages,
        reference=ref, stream=stream, stream_reference=stream_ref,
        compare=compare, compare_reference=compare_ref,
        stream_compare=stream_compare, serve_reference=serve_ref,
        serve=serve,
        stream_vfl=stream_vfl, vfl=vfl, vfl_zamba2=zamba2,
        vfl_granite=granite, moe=moe, vfl_xlstm=xlstm, vfl_whisper=whisper,
        sensitivity=sensitivity,
        vfl_reference=vfl_ref), indent=1, default=str))
    log("device", f"chip_smoke.py took {time.perf_counter() - t_start:.1f} "
        f"s, the kernels' build included")
    log("device", smi)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
