"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

It builds the port's CUDA kernels from the sources in the checkout, holds
each kernel against its plain PyTorch version on the card (`flash_attention`
and `ssd_scan` in both variants: bf16 inputs on the tensor-core kernels,
fp32 on the CUDA-core ones, each case checked to reach its dtype's entry
point; `p4_solve` on a VEDS slot's candidates at fig10's width, cold, warm
and adaptive), and drives the port's three main paths, each checked and
each with its kernel launches counted from 0:

- `run_fl`, blocked, VEDS + CNN FedAvg at the paper's full width (40
  clients, S=U=10 vehicles, T=60 slots, batch 32, the 6-conv CIFAR CNN),
  with its stages timed and traced and the block's schedule run again
  with the slot step eager, then the card against the CPU on a small
  input. On the card `veds_round` replays one captured CUDA graph of the
  VEDS slot step per slot, its P4 solves one `p4_solve` launch; every
  phase that schedules logs the graphs it captured, and the graph is
  held to the eager step bit for bit;
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

- LLM serving, prefill then decode with caches (`models/engine.py`,
  `phase_decode`): qwen3-32b at full width cut to 2 repetitions at
  decode_32k's shape (batch 128, a cache of 32768 slots, 34.4 GB), 128
  prompts of 64 tokens through `forward(..., last_logit_only=True,
  seq_shard=True)` (2 `flash_attention` launches), then `decode_step`
  over the prompts and 64 greedy tokens (no kernel launch), its logits
  at position 63 held to the prefill's within 5e-2 of max|logit|, each
  step timed beside two bytes bounds (every slot, as the plain
  algorithm reads them, and the valid slots only); zamba2-2.7b at full
  width and depth at batch 8 (45 `ssd_scan` and 9 `flash_attention`
  launches a prefill); then `decode_step` at the smoke configs of seven
  archs (whisper's and llama-3.2-vision's cross slots from
  `build_cross_cache`, qwen3's sliding-window ring) on the card against
  the CPU. `flash_attention` is also timed at qwen3's prefill shape,
  `ssd_scan` held at zamba2's (one padded chunk).
- the scheduling service (`launch/serve.py`): the reference's own
  `ServeConfig()` (madca, B 4, L 4) over 3 waves of 6 sessions on the card
  against the CPU on the same draws, then VEDS with the warm P4 table at
  fig10's width (S=U=10, T=60, fleets of 40, B 8 on the tier ladder (2,
  4, 8) x (1, 2, 4, 8), 4 sessions on the card) under 12 sessions'
  mixed load, each dispatch timed, no slot graph captured after
  `warmup()`, and requests replayed alone at B = 1 (masks identical, the
  floats' distance in ulps, and where they part, the first operation
  that parts them); then its asyncio front end at the same width
  (`phase_serve_front`): `drive()`'s closed loop with the sequential
  B = 1 baseline, a Poisson load through `BatchServer` at half the
  closed loop's request rate whose dispatch log is replayed on a fresh
  service bit for bit, and `main()` with no `--device`, each dispatch
  checked to run on the server's executor thread, to capture no slot
  graph and to launch `veds_score` T times a packed round.
- the model mesh axis (`sharding/model_axis.py`, `phase_model_axis`):
  qwen3-32b at full width (2 repetitions) split over a model axis, (a)
  on a one-rank NCCL world, bit for bit the path without a mesh (the
  serving prefill and 16 decode steps at decode_32k's batch and cache,
  and a smoke VFL round); (b) on two ranks sharing the one card over
  gloo (NCCL refuses two ranks on a card): the serving path in head mode
  (128 prompts of 64 tokens, 16 steps, the 32768-slot cache cut over the
  ranks) and in forced row mode (8 prompts of 4096 tokens through the
  sequence-sharded core, 16 steps), and under the `dp` profile (head
  mode's shape, every head on each rank, the cache's slots cut over the
  ranks and the flash-decode merged over them), held to the one-rank
  path (5e-2 of max|logit|, argmax in 0.9 of the rows); (c) one VFL
  round of
  `launch/train.py`'s `train` on a (2, 2) mesh of four ranks on the
  card against the one-process round (masks identical, each leaf's
  update within `MA_VFL_WITNESS_RATIO` of its one-ulp witness); then
  (`phase_model_axis_ssm`) zamba2-2.7b at full width and depth and
  xlstm-1.3b at full width split over two ranks on the card: serving (8
  and 128 prompts of 64 tokens, 16 steps; Mamba2 by heads, the mLSTM by
  its head dim, the sLSTM replicated) held to one rank through a one-ulp
  witness measured in the run, the smoke configs in fp32 within 1e-4 of
  max|logit|, xlstm's mLSTM and sLSTM sub-blocks forward and backward,
  and one zamba2 VFL round on a (1, 2) mesh against one process; with
  `ssd_scan` and `flash_attention` held and timed at those per-rank
  shapes in the kernel phases. Shared-card walls are logged, not
  compared: the ranks measure no tensor-parallel speed-up.
- the sharded rollout (`sharding/mesh_exec.py`, `phase_mesh`) on a
  one-rank NCCL world: 4 cells of the `rsu_grid` with handoff at fig10's
  width (VEDS with warm P4), 10 rounds through `fused_rollout` and
  `mesh_fused_rollout` from the same carry and keys, then `stream_rounds`
  beside `mesh_stream_rounds`, each mesh run bit for bit its one-device
  run with its collectives run (the exchange's all-gathers,
  `gather_result`), `veds_score` T x R times on each; the exchange timed
  alone. After whisper-small's VFL loop, its last params go through the
  npz checkpoint (`phase_checkpoint`: saved by `train(ckpt=...)`, loaded
  to the card, the eval loss equal to the run's, saved again byte for
  byte).

- the dry run (`launch/dryrun.py`, `phase_dryrun`): three cases on one
  rank (zamba2-2.7b's train step at full width and depth, 4 vehicles of
  4 x 1024 tokens; qwen3-32b's decode_32k step at 2 of 64 repetitions;
  llama4-scout-17b-a16e's prefill at 1 of 48 repetitions, 8 x 32768
  tokens), each run for real under the op counter and `FlopCounterMode`
  and traced on fake CUDA tensors in a background worker, each repeated
  loop scaled from a few checked iterations: argument bytes and FLOPs
  equal, each kernel's calls in the trace equal to its launches, the
  fake peak within 10% of `max_memory_allocated`; then the fake
  production sweep of llama4-scout and llama-3.2-vision over fake
  worlds of 256 and 512 ranks, every shape, and of xlstm-1.3b's
  train_4k at both, with its time and its critical path (records under
  `chiprun_out/dryrun_torch/`).

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
import asyncio
import concurrent.futures
import contextlib
import functools
import gc
import io
import json
import math
import statistics
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent

# the card's peaks used for the bounds (NVIDIA H100 SXM data sheet)
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_OPS_PER_S = 67e12
PEAK_BF16_OPS_PER_S = 989e12       # dense tensor-core rate
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
# xlstm's path times XLSTM_ROUNDS rounds after its warm-up (its rounds,
# ~20-25 s each in its sLSTM's host-bound time loop, were the script's
# largest share; cut from VFL_ROUNDS to keep the whole script well inside
# its time limit as the model-axis phases grew)
XLSTM_ROUNDS = 1
WHISPER_REPS, WHISPER_LR = 12, 1e-22
# the model mesh axis (phase_model_axis): qwen3-32b's serving path as
# (batch, prompt, cache slots, decode steps) in head mode at decode_32k's
# batch and cache, and in forced row mode with prompts long enough for the
# sequence-sharded core (T >= 4 attn_chunk), on MA_SERVE_RANKS ranks of
# the one card; held to the one-rank path within MA_TOL of max|logit|
# (phase_decode's bound for bf16 at two layers) with argmax equal in at
# least MA_ARGMAX of the rows; one VFL round on a (MA_VFL_VEHICLES,
# MA_VFL_MODEL) mesh (MA_VFL_BATCH sequences of VFL_SEQ tokens a vehicle)
# held to one process: masks identical, and each leaf's update no
# further from one process's than MA_VFL_WITNESS_RATIO times the witness:
# how far one process's own update of that leaf moves when every bf16
# weight moves by one ulp (bf16: each rank's partial sums are rounded to
# bf16 before the all-reduce, so the split moves the update as rounding
# does); that bound must stay below the update's norm, so that a zero or
# a doubled update (1 of the norm away) fails it. On an NVIDIA H100 80GB
# HBM3 at 700 W the split's worst leaf reads 0.27 of its witness and the
# largest witness is 1.25 (a zero update would read 0.8 of it): 0.5 lies
# between, with room on each side (PERF.md section 6)
MA_HEAD, MA_ROW = (128, 64, 32768, 16), (8, 4096, 4096, 16)
# the serving modes of the model axis's 2-rank world: head and row mode
# split the model; the `dp` profile's decode (every head on every rank,
# each cache's sequence cut over the ranks, the flash-decode merged
# over them) runs MA_HEAD's shape and is held to the same one-rank path
MA_MODES = ("head", "row", "dp")
MA_SERVE_RANKS, MA_TOL, MA_ARGMAX = 2, 5e-2, 0.9
MA_VFL_VEHICLES, MA_VFL_MODEL = 2, 2
MA_VFL_WITNESS_RATIO = 0.5
# the (2, 2) round's batch a vehicle, cut from VFL_BATCH's 4 sequences to
# 2: four ranks of 4 x 1024 tokens ran out of the card's 80 GB
MA_VFL_BATCH = 2
# the dry run (phase_dryrun): three cases on one rank, each run for real
# on the card and traced on fake CUDA tensors, then the fake production
# sweep of DRYRUN_SWEEP_ARCHS at both meshes, every shape, and of
# DRYRUN_EXTRA's cases at both meshes (xlstm-1.3b's train_4k, whose
# traces never finished before each repeated loop was scaled from a few
# checked iterations, `launch/op_costs.py scaled_trace`); the fake peak
# held to the card's within DRYRUN_PEAK_TOL. The fake traces are host
# work, so they run DRYRUN_WORKERS at a time, one process a case, after
# the phases whose times are compared across runs and beside those that
# hold values (`fake_traces`); each may take DRYRUN_JOB_TIMEOUT_S (the
# longest, xlstm's train_4k at pod16x16, took 364.9 s on the host of an
# NVIDIA H100 80GB HBM3 at 700 W: PERF.md section 5)
DRYRUN_SWEEP_ARCHS = ("llama4-scout-17b-a16e", "llama-3.2-vision-90b")
DRYRUN_EXTRA = (("xlstm-1.3b", "train_4k"),)
DRYRUN_WORKERS = 4
DRYRUN_PEAK_TOL = 0.10
DRYRUN_OUT = ROOT / "chiprun_out" / "dryrun_torch"
DRYRUN_JOB_TIMEOUT_S = 600
# the flash_attention cases of phase_kernels_llm timed beside their bounds
TIMED_FLASH = ("main", "zamba2", "granite", "whisper_encoder",
               "whisper_cross", "whisper_self", "vlm_cross", "qwen3_prefill",
               "ma_head", "ma_row_rank0", "ma_row_rank1", "ma_zamba2",
               "ma_zamba2_prefill")
# the C entry point each dtype must reach: bf16 the tensor-core kernels,
# fp32 the CUDA-core ones
FLASH_ENTRY = {torch.bfloat16: "flash_attention_fwd_bf16_sm90",
               torch.float32: "flash_attention_fwd_f32"}
SSD_ENTRY = {torch.bfloat16: "ssd_scan_fwd_bf16_sm90",
             torch.float32: "ssd_scan_fwd_f32"}
# the ssd_scan cases of phase_kernels_ssd timed beside their bounds
SSD_TIMED = ("main", "serve_prefill", "ma_main", "ma_serve_prefill")
# the device events of a traced schedule listed by name, most first
TRACE_TOP_OPS = 20
# the VFL rounds' schedule masks as measured with the CUDA-core kernels
# (NVIDIA H100 80GB HBM3, 700 W, PERF.md section 5); the model's kernels
# do not touch the schedule, and `p4_solve` makes the decisions the plain
# P4 made, so they must be the same
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
# the sharded rollout (`sharding/mesh_exec.py`) on a one-rank NCCL world:
# fig10's width (S=U=10, T=60, fleets of 40, batch 32, warm P4) on
# MESH_BATCH cells of the rsu_grid with handoff, MESH_ROUNDS rounds, each
# path beside its one-device loop; the exchange timed MESH_EXCHANGE_REPS
# times on the run's fleet
MESH_BATCH, MESH_ROUNDS, MESH_SEED, MESH_EXCHANGE_REPS = 4, 10, 17, 21
# the serving path (`models/engine.py decode_step`): decode_32k's shape
# (configs/base.py: batch 128, a cache of 32768 slots) at qwen3-32b's full
# width cut to VFL_REPS repetitions, prompts of DECODE_PROMPT tokens then
# DECODE_NEW greedy ones, its decode at the prompt's last position held to
# the prefill within DECODE_QWEN3_TOL of max|logit| (the loosest bound of
# tests/test_decode_consistency.py); zamba2-2.7b at full depth with the
# batch cut to DECODE_ZAMBA2_BATCH (at 128 rows its cache would be 387 GB);
# the smoke configs card against CPU (DECODE_SMOKE: run -> (prefill vs
# decode bound, card vs CPU bound)). whisper's card vs CPU is held at one
# encoder layer ("+enc1"), where the CPU's own logits move by 9.2e-5 of
# their largest when every weight moves by half an ulp; at its smoke
# depth they move by 1.6e-3 (an encoder of chaotic fp32 softmaxes at the
# reference's init, ROADMAP queue 3), so there its distance is logged
# beside that move and beside the card with the encoder's attention
# through its plain version instead of the kernel, as the CPU tests hold
# whisper's VFL round at one encoder layer
DECODE_PROMPT, DECODE_NEW, DECODE_QWEN3_TOL = 64, 64, 5e-2
DECODE_ZAMBA2_BATCH, DECODE_CPU_TOL = 8, 1e-3
DECODE_SMOKE = {"qwen3-32b": (1e-3, DECODE_CPU_TOL),
                "zamba2-2.7b": (5e-3, DECODE_CPU_TOL),
                "xlstm-1.3b": (5e-3, DECODE_CPU_TOL),
                "granite-moe-1b-a400m": (5e-2, DECODE_CPU_TOL),
                "whisper-small+enc1": (5e-3, DECODE_CPU_TOL),
                "whisper-small": (5e-3, None),
                "llama4-scout-17b-a16e": (5e-2, DECODE_CPU_TOL),
                "llama-3.2-vision-90b": (5e-3, DECODE_CPU_TOL),
                "qwen3-32b+swa": (1e-3, DECODE_CPU_TOL)}
# the model axis of Mamba2, the mLSTM and the sLSTM (phase_model_axis_ssm),
# on MA_SERVE_RANKS ranks of the one card, each run held to one rank:
# zamba2-2.7b at full width and depth and xlstm-1.3b at full width and
# XLSTM_REPS repetitions served as (batch, prompt, cache slots, decode
# steps) at DECODE_ZAMBA2_BATCH rows and at decode_32k's 128, the logits
# within MA_SERVE_WITNESS_RATIO times a witness measured in the same run
# (how far one rank's own logits move when every weight moves by one ulp,
# `bf16_ulp_moved`); their smoke configs in fp32 (MA_FP32_SERVE) within
# MA_FP32_TOL of max|logit|; zamba2's Mamba2 and xlstm's mLSTM and sLSTM
# sub-blocks at full width, forward and backward on VFL_BATCH x VFL_SEQ
# tokens, every gradient within MA_BLOCK_WITNESS_RATIO times its witness;
# zamba2's VFL round on a (1, MA_SERVE_RANKS) mesh at ZAMBA2_LR on
# MA_SSM_VFL_BATCH sequences of VFL_SEQ tokens, at full depth in bf16
# (masks and launches checked, the updates logged beside their witness)
# and at 1 repetition in fp32, the updates within MA_SSM_VFL_RATIO times
# their witness over the leaves where that bound would fail a zero update,
# which must hold MA_SSM_VFL_HELD of the entries. At the reference's init
# a one-ulp move moves zamba2's and xlstm's bf16 logits at full depth by
# about their largest entry and zamba2's bf16 updates by more than their
# norm (the split's distances alike), so there the witness bound guards
# against gross faults only; the sub-blocks, the fp32 smoke configs and
# the 1-repetition fp32 round, where the witness is small, are the holds
# that tell a right split from a wrong one (PERF.md section 6; NVIDIA
# H100 80GB HBM3, 700 W: split over witness up to 0.97 and 0.86 for the
# logits, 0.05 for the mLSTM's gradients, 0.92 for the 1-repetition
# round)
MA_ZAMBA2_SERVE = (DECODE_ZAMBA2_BATCH, DECODE_PROMPT, 32768, 16)
MA_XLSTM_SERVE = (128, DECODE_PROMPT, 32768, 16)
MA_FP32_SERVE, MA_FP32_TOL = (2, 64, 128, 8), 1e-4
MA_SERVE_WITNESS_RATIO, MA_BLOCK_WITNESS_RATIO = 2.0, 0.5
MA_SSM_VFL_BATCH, MA_SSM_VFL_RATIO, MA_SSM_VFL_HELD = 4, 2.0, 0.99
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


def p4_slot_inputs(device, B: int, slot: int, warm: bool, sov: int = 10,
                   opv: int = 10):
    """The arguments of `solve_p4` at slot `slot` of an eager VEDS round
    of B cells of `sov` SOVs and `opv` OPVs (fig10's width S = U = 10 by
    default; T = slot + 1, seed 0): cold, or warm at STREAM_WARM_ITERS
    from the seed table carried over the slots before, as the slot step
    threads it. Recorded by wrapping `core/veds.py`'s `solve_p4`; returns
    the contiguous (cw, a, q, d, p_max), p_init (None cold) and the
    keyword arguments."""
    from unittest import mock
    from repro_torch.channel.mobility import ManhattanParams
    from repro_torch.channel.v2x import ChannelParams
    from repro_torch.core import veds as V
    from repro_torch.core.lyapunov import VedsParams
    from repro_torch.core.scenario import (ScenarioParams, make_round,
                                           round_generator)
    from repro_torch.core.scheduler import SchedulerCarry
    from repro_torch.core.solver import p4_seed_table
    sc = ScenarioParams(n_sov=sov, n_opv=opv, n_slots=slot + 1)
    prm = VedsParams(ipm_warm_iters=STREAM_WARM_ITERS if warm else 0)
    ch = ChannelParams()
    rnd = V.RoundInputs.stack([
        make_round(round_generator(0, r, device), sc, ManhattanParams(), ch,
                   prm) for r in range(B)])
    carry = SchedulerCarry(
        qs=torch.zeros((B, sov), device=device),
        qu=torch.zeros((B, opv), device=device),
        p4=p4_seed_table((B, sov, opv, opv + 1), ch.p_max, device)) \
        if warm else None
    calls, real = [], V.solve_p4

    def record(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)
    with mock.patch.object(V, "solve_p4", record):
        V._veds_round(rnd, prm, ch, enable_cot=True, carry=carry,
                      graphed=False)
    args, kw = calls[slot]
    p_init = kw.pop("p_init")
    return ([x.contiguous() for x in args],
            None if p_init is None else p_init.contiguous(), kw)


def p4_kernel_cases(device):
    """`p4_solve` against its plain version on the card at the main path's
    shapes (`p4_slot_inputs`): run_fl's block cold ([3, 10, 10, 11]), the
    streaming path's warm solve ([1, 10, 10, 11] at slot 5), the
    service's B 8, and the adaptive budget (warm 10, far 25, the far
    threshold split at the seeds' median): powers within 2e-5 W plus the
    rtol and values within the rtol (1e-4 cold, 5e-2 warm), in the box
    and finite; adaptive: each candidate's tier (its result is bit for
    bit its near- or far-tier solve) is the plain version's far mask.
    Each timed eagerly beside the plain version, and from a CUDA graph of
    10 launches (bit for bit its eager launch) beside the floor of that
    setting, with its bound from `p4_work` at the tiers the data takes."""
    from repro_torch.kernels.p4_solve.ops import (
        _polish_count, _project_feasible, p4_budget, p4_solve,
        p4_solve_plain, p4_work, seed_grad_norms, split_far_tol)
    cases = {"main": (ROUND_BATCH, 0, False, {}),
             "stream": (1, 5, True, {}),
             "serve_b8": (8, 5, True, {}),
             "adaptive": (1, 5, True, dict(far_iters=25))}
    one = torch.zeros(1, device=device)
    floor_ms, _ = graph_ms(lambda: one.add_(1.0))
    res = {"graph_floor_ms": floor_ms}
    for label, (B, slot, warm, extra) in cases.items():
        cand, p_init, kw = p4_slot_inputs(device, B, slot, warm)
        kw.update(extra)
        cw, a, q, d, pm = cand
        g0 = None
        if extra:
            g0 = seed_grad_norms(
                cw, a, q, _project_feasible(p_init, d, pm, margin=0.5))
            kw["far_grad_tol"] = split_far_tol(g0)
        rtol = 5e-2 if warm else 1e-4

        def kernel(**over):
            with p4_solve.uncounted():
                return p4_solve(*cand, p_init, **{**kw, **over})
        p, v = kernel()
        rp, rv = p4_solve_plain(*cand, p_init, **kw)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(p).all() and torch.isfinite(v).all()
                   and ((p >= 0) & (p <= pm)).all()),
              f"p4_solve {label}: powers not finite or outside the box")
        check(bool(((p - rp).abs() <= 2e-5 + rtol * rp.abs()).all()
                   and ((v - rv).abs() <= 1e-9 + rtol * rv.abs()).all()),
              f"p4_solve {label}: kernel disagrees with the plain version "
              f"beyond rtol {rtol}")
        err = max(float((p - rp).abs().max()), float((v - rv).abs().max()))
        n, n_cand = a.shape[-1], cw.numel()
        adaptive, n_it, n_run = p4_budget(kw["iters"], warm,
                                          kw["warm_iters"], kw["far_iters"],
                                          kw["far_grad_tol"])
        n_far = n_cand
        if adaptive:
            near = kernel(far_iters=0, far_grad_tol=0.0)[0]
            far = kernel(warm_iters=kw["far_iters"], far_iters=0,
                         far_grad_tol=0.0)[0]
            is_near, is_far = (p == near).all(-1), (p == far).all(-1)
            told = ~(is_near & is_far)
            want = g0 > kw["far_grad_tol"]
            parted = told & (is_far != want)
            check(bool((is_near | is_far).all()) and not bool(parted.any()),
                  f"p4_solve {label}: the kernel's tiers part from the "
                  f"plain version's far mask (threshold "
                  f"{kw['far_grad_tol']!r}, seed norms "
                  f"{g0[parted].tolist()})")
            n_far = int(want.sum())
        ops, nbytes = (x + y for x, y in zip(
            p4_work(n_far, n, n_run, _polish_count(n_run, kw["iters"]),
                    warm, adaptive),
            p4_work(n_cand - n_far, n, n_it, _polish_count(n_it,
                                                           kw["iters"]),
                    warm, adaptive)))
        t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
        t_ops = ops / PEAK_FP32_OPS_PER_S * 1e3
        ms = time_ms(kernel, 50)
        plain_ms = time_ms(lambda: p4_solve_plain(*cand, p_init, **kw), 2,
                           samples=7, warmup=2)
        # 10 launches a graph: at ~0.3 ms a launch, 100 would take ~16 s
        g_ms, g_out = graph_ms(kernel, reps=10, inner=5)
        check(torch.equal(g_out[0], p) and torch.equal(g_out[1], v),
              f"p4_solve {label}: launched from a CUDA graph, the kernel "
              f"differs from its eager launch")
        res[label] = dict(
            shape=list(a.shape), warm=warm, adaptive=adaptive,
            n_far=n_far, newton_steps=[n_run, n_it], max_abs_err=err,
            tolerance=f"2e-5 W + rtol {rtol} (p), 1e-9 + rtol {rtol} "
                      f"(value)", ms=ms, plain_ms=plain_ms,
            graph_ms=g_ms, graph_floor_ms=floor_ms,
            bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            ops=ops, bytes=nbytes, library_ms=None)
        log("kernels", f"p4_solve {label} {list(a.shape)}"
            f"{' warm' if warm else ' cold'}"
            f"{f' adaptive ({n_far} of {n_cand} far)' if adaptive else ''}:"
            f" max_abs_err {err:.3e} (tolerance {res[label]['tolerance']})"
            f" kernel {ms:.5f} ms plain {plain_ms:.5f} ms; from a CUDA "
            f"graph of 10 launches {g_ms:.5f} ms a launch, bit for bit its "
            f"eager launch (floor {floor_ms:.5f} ms); bound "
            f"{res[label]['bound_ms']:.7f}"
            f" ms ({res[label]['bound_by']}: {ops} fp32 ops, {nbytes} B)")
    return res


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
    """Least time for `veds_score` over n candidates: its bytes and fp32
    operations (`kernels/veds_score/ops.py veds_dt_score_cost`)."""
    from repro_torch.kernels.veds_score.ops import (VEDS_BYTES_PER_ELEM,
                                                    VEDS_OPS_PER_ELEM)
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
    that setting: a one-element PyTorch op captured the same way. Then
    `p4_solve` at the main path's shapes (`p4_kernel_cases`), under the
    result's key "p4_solve"."""
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
    res["p4_solve"] = p4_kernel_cases(device)
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
    from repro_torch.kernels.p4_solve.ops import p4_solve
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
    p4_solve.launches = 0
    captures = _SlotGraph.captures
    t0 = time.perf_counter()
    hist = run_fl(0, params, cnn_loss, client_data, sim, eval_fn=eval_fn,
                  eval_every=1, device=device)
    wall = time.perf_counter() - t0          # run_fl synchronises at exit
    launches = {"veds_score": veds_dt_score.launches,
                "p4_solve": p4_solve.launches}
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
        f"veds_score and p4_solve {want} each = {n_blocks} blocks x T "
        f"{sim.n_slots}); slot graphs captured: {captures}")
    for k in ("veds_score", "p4_solve"):
        check(launches[k] == want, f"{k} launched {launches[k]} times on "
              f"the main path, expected {want}")
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
    trace must see one `veds_score` and one `p4_solve` run a slot. The
    same trace then holds the schedule alone, which must see the same,
    and whose device events are listed by name.
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
    log("stages", "the traced schedule's device events by name (a slot, "
        "ms in all): " + "; ".join(f"{name[:60]} {c:.2f}, {ms:.3f}"
                                   for name, c, ms in sched_res["by_name"]))
    # one veds_score run and one p4_solve run a slot seen by the
    # profiler, apart from the kernels' own counts, in each part
    for part, res in (("block", prof_res), ("schedule", sched_res)):
        for k in ("veds_score", "p4_solve"):
            check(res[f"{k}_events"] == sim.n_slots,
                  f"stages: the traced {part} ran {k} {res[f'{k}_events']}"
                  f" times on the card, expected one a slot "
                  f"({sim.n_slots})")
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
    # the device events by name: count a slot and total ms, most first
    by_name = {}
    for e in events:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.device_time_total / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TRACE_TOP_OPS]
    return dict(traced_wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_events=len(events), veds_score_events=n_veds,
                p4_solve_events=sum("p4_solve" in e.name for e in events),
                idle_share=(1.0 - busy_ms / wall_ms) if whole else None,
                opener_seen=seen, slot_events=slot_events,
                by_name=[[name, c / n_slots, ms] for name, (c, ms) in top])


def trace_line(res) -> str:
    idle = (f"{res['idle_share']:.3f}" if res["idle_share"] is not None
            else "not measured (the trace lost veds_score runs or its "
                 "openers)")
    return (f"wall {res['traced_wall_ms']:.1f} ms, device busy "
            f"{res['device_busy_ms']:.1f} ms in {res['device_events']} "
            f"device events ({res['veds_score_events']} of veds_score, "
            f"{res['p4_solve_events']} of p4_solve; "
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
    from repro_torch.kernels.p4_solve.ops import p4_solve
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
        p4_solve.launches = 0
        captures = _SlotGraph.captures
        t0 = time.perf_counter()
        hook.start()
        hist = run_fl(STREAM_SEED, params, cnn_loss, client_data, s,
                      eval_fn=eval_fn if every else None,
                      eval_every=every or 1, device=device,
                      stage_hook=hook)
        wall = time.perf_counter() - t0      # run_fl synchronises at exit
        launches = veds_dt_score.launches
        p4_launches = p4_solve.launches
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
            + f"; veds_score and p4_solve launches {launches}, "
            f"{p4_launches} (expected {want} each = {rounds} x T "
            f"{s.n_slots}); slot graphs captured {captures}; peak memory "
            f"{peak_gb:.3f} GB; history {hist}")
        for k, n in (("veds_score", launches), ("p4_solve", p4_launches)):
            check(n == want, f"stream {label}: {k} launched {n} times, "
                  f"expected {want}")
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
                          launches={"veds_score": launches,
                                    "p4_solve": p4_launches},
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
    before and read just after (and `p4_solve`'s). Returns the history,
    the per-round stage times, the recorded rounds and the launches of
    each."""
    from repro_torch.core.baselines import get_scheduler
    from repro_torch.fl import simulator
    from repro_torch.kernels.p4_solve.ops import p4_solve
    from repro_torch.kernels.veds_score.ops import veds_dt_score
    rec = _Recorder(get_scheduler(sim.scheduler))
    records = []
    hook = _stage_timer(records)
    real = simulator.get_scheduler
    simulator.get_scheduler = lambda name: rec
    try:
        torch.cuda.synchronize()
        veds_dt_score.launches = 0
        p4_solve.launches = 0
        t0 = time.perf_counter()
        hook.start()
        hist = simulator.run_fl(seed, params, loss_fn, client_data, sim,
                                eval_fn=eval_fn, eval_every=every,
                                device=device, stage_hook=hook)
        wall = time.perf_counter() - t0
        launches = {"veds_score": veds_dt_score.launches,
                    "p4_solve": p4_solve.launches}
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
    its own count and never under the others, `p4_solve` rounds x T
    times under `veds` alone; every metric is finite.
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
            want = {"veds_score": s.rounds * s.n_slots
                    if name in ("veds", "v2i_only") else 0,
                    "p4_solve": s.rounds * s.n_slots if name == "veds"
                    else 0}
            log("compare", f"{task} {name}: wall {wall:.3f} s; median of "
                f"rounds 1.. " + ", ".join(f"{k[:-3]} {v:.2f} ms"
                                           for k, v in med.items())
                + f"; n_success {n_succ}; COT slots {sum(n_cot)}, DT slots "
                f"{sum(n_dt)}; {metric} {[round(m, 4) for m in hist['metric']]}"
                f" at rounds {hist['round']}; launches {launches}"
                f" (expected {want}); slot graphs captured {captures}")
            check(len(rounds) == s.rounds and len(records) == s.rounds,
                  f"compare {task} {name}: {len(rounds)} rounds scheduled, "
                  f"{len(records)} timed, expected {s.rounds}")
            check(launches == want, f"compare {task} {name}: launches "
                  f"{launches}, expected {want}")
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
                             launches=launches, graph_captures=captures)
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
    from repro_torch.kernels.p4_solve.ops import p4_solve
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
    p4_solve.launches = 0
    captures = _SlotGraph.captures
    t0 = time.perf_counter()
    mark[0] = t0
    out, stats = run(params_v, batches_v, torch.ones(V, device=device), 0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention_fwd.launches,
                "fedavg_agg": fedavg_agg.launches,
                "veds_score": veds_dt_score.launches,
                "p4_solve": p4_solve.launches}
    captures = _SlotGraph.captures - captures
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    n_attn = cfg.n_rep * sum(k in ("attn", "attn_swa", "cross")
                             for k in cfg.pattern)
    want = {"flash_attention": rounds * V * n_attn * 2,
            "fedavg_agg": rounds * len(tree_leaves(decl)),
            "veds_score": rounds * VFL_SLOTS,
            "p4_solve": rounds * VFL_SLOTS}
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
    masks keep, counted on these shapes:
    `kernels/flash_attention/ops.py flash_attention_cost`) over the dense
    tensor-core rate of bf16 (the fp32 CUDA-core rate for fp32 inputs)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_cost
    ops, nbytes = flash_attention_cost(q, k, k, causal, window, q_offset)
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
                      prefill_shape=(128, 64, 64, 8, 128),
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
    from torch.nn.attention.bias import causal_lower_right
    from repro_torch.kernels.fedavg_agg.ops import (fedavg_agg,
                                                    fedavg_agg_cost,
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
    pb, pt, ph, pkv, pd = prefill_shape
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
        # qwen3-32b's serving prefill at decode_32k's batch: 128 prompts
        # of 64 tokens (phase_decode)
        "qwen3_prefill": (pb, pt, pt, ph, pkv, pd, torch.bfloat16, True,
                          None, 0),
        # its calls a rank over a model axis of MA_SERVE_RANKS
        # (phase_model_axis): head mode's H/n query heads on their block
        # of KV heads; forced row mode's sequence-sharded core, rank r's
        # T/n queries at offset r T/n against the whole K and V
        "ma_head": (MA_HEAD[0], MA_HEAD[1], MA_HEAD[1], ph // MA_SERVE_RANKS,
                    pkv // MA_SERVE_RANKS, pd, torch.bfloat16, True, None,
                    0),
        **{f"ma_row_rank{r}": (MA_ROW[0], MA_ROW[1] // MA_SERVE_RANKS,
                               MA_ROW[1], ph, pkv, pd, torch.bfloat16, True,
                               None, r * MA_ROW[1] // MA_SERVE_RANKS)
           for r in range(MA_SERVE_RANKS)},
        # zamba2's shared attention a rank over the model axis (head mode:
        # H/n of its 32 heads of 80), in its VFL round (phase_model_axis_ssm
        # (c)) and at its serving prefill
        "ma_zamba2": (MA_SSM_VFL_BATCH, zt, zt, zh // MA_SERVE_RANKS,
                      zh // MA_SERVE_RANKS, zd, torch.bfloat16, True, None,
                      0),
        "ma_zamba2_prefill": (MA_ZAMBA2_SERVE[0], MA_ZAMBA2_SERVE[1],
                              MA_ZAMBA2_SERVE[1], zh // MA_SERVE_RANKS,
                              zh // MA_SERVE_RANKS, zd, torch.bfloat16, True,
                              None, 0),
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
        # the plain version over batch slices whose fp32 scores [b, H, T,
        # S] stay within 4 GiB (row mode's per-rank call needs 17 GB)
        step = max(1, (1 << 32) // (h * t * s_ * 4))

        def plain():
            if step >= b:
                return flash_attention_plain(q, k, v, **kw)
            return tuple(torch.cat(x) for x in zip(*(
                flash_attention_plain(q[i:i + step], k[i:i + step],
                                      v[i:i + step], **kw)
                for i in range(0, b, step))))
        ref, ref_lse = plain()
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
            r["plain_ms"] = time_ms(plain, 3, samples=7, warmup=2)
            (r["bound_ms"], r["bound_by"], r["flops"],
             r["bytes"]) = flash_bound_ms(q, k, causal, window, off)
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            # SDPA's causal mask is aligned to the first key; the queries
            # at an offset of S - T (the sequence-sharded core's last
            # rank) take the mask aligned to the last key
            mask = dict(is_causal=causal) if not off else dict(
                attn_mask=causal_lower_right(t, s_))
            try:
                lib = F.scaled_dot_product_attention(
                    qt, kt, vt, enable_gqa=True, **mask)
                r["library_err"] = float(
                    (lib.transpose(1, 2).float() - ref.float()).abs().max())
                r["library_ms"] = time_ms(
                    lambda: F.scaled_dot_product_attention(
                        qt, kt, vt, enable_gqa=True, **mask), 20,
                    samples=7, warmup=2)
            except (RuntimeError, TypeError) as e:  # the yardstick only
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
            ops, nbytes = fedavg_agg_cost(x, w, old)
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
    does them (`kernels/ssd_scan/ops.py ssd_scan_cost`), over the dense
    tensor-core rate of bf16 (the fp32 CUDA-core rate for fp32 inputs)."""
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_cost
    ops, nbytes = ssd_scan_cost(v, b, b, None, chunk)
    peak = PEAK_BF16_OPS_PER_S if v.dtype == torch.bfloat16 \
        else PEAK_FP32_OPS_PER_S
    t_ops, t_bytes = ops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes"), ops, nbytes


def phase_kernels_ssd(device, main_shape=(4, 1024, 80, 128)):
    """ssd_scan against its plain version on the card: at the zamba2
    path's shape (v [4, 1024, 80, 64], b/c [4, 1024, 64], chunk 128) in
    bf16 and fp32, at a ragged T (pad path), at zamba2's serving prefill
    (v [8, 64, 80, 64] bf16: a T below the chunk, one padded chunk), at
    both shapes' calls a rank over a model axis of 2 (40 heads), at
    H = 1 (the Pallas layout), with an initial state at the smoke
    config's chunk, and at chunk 128 with dt ~ 0.7 (zamba2's init), where
    the reference model's jnp scan overflows; timed at the zamba2 paths'
    shapes (SSD_TIMED) beside their bounds. log_a = -softplus(normal)
    elsewhere, so a chunk of 128 decays by ~100 too.
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
        # zamba2's serving prefill: 64 tokens run as one padded chunk
        "serve_prefill": (8, 64, H, C, torch.bfloat16, False),
        # a rank's calls over a model axis of MA_SERVE_RANKS
        # (phase_model_axis_ssm): H/n heads, in the VFL round and at the
        # serving prefill
        "ma_main": (MA_SSM_VFL_BATCH, T, H // MA_SERVE_RANKS, C,
                    torch.bfloat16, False),
        "ma_serve_prefill": (MA_ZAMBA2_SERVE[0], MA_ZAMBA2_SERVE[1],
                             H // MA_SERVE_RANKS, C, torch.bfloat16, False),
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
        if label in SSD_TIMED:
            r["ms"] = time_ms(lambda: ssd_scan_fwd(v, b, cm, la, c), 20,
                              samples=7, warmup=2)
            r["plain_ms"] = time_ms(lambda: ssd_scan_plain(v, b, cm, la, c),
                                    2, samples=5, warmup=1)
            (r["bound_ms"], r["bound_by"], r["flops"],
             r["bytes"]) = ssd_bound_ms(v, b, c)
            r["library_ms"] = None   # no PyTorch call computes the scan
        if label == "main":
            r.update(zip(("smem_bytes", "ctas_per_sm"),
                         sm90_resources("ssd_scan", c)))
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
                f"{r['bytes'] / 1e6:.1f} MB, {r['flops'] / 1e9:.2f} GFLOP)"
                if "ms" in r else "") + (
                f"; Function forward + backward {r['fn_fwd_bwd_ms']:.3f} ms; "
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
              lr: float, masks=None, ckpt=None):
    """The VFL loop of `launch/train.py` (`make_train_step` with the
    scheduler inline) on the card, every kernel count set to 0 first:
    per round the wall time, its stages (each closed by a device
    synchronisation), the schedule's outcome, the eval loss and the peak
    memory; then the launch counts against those the code implies, and
    the masks against `masks` (an entry of RECORDED_MASKS) where given.
    A model that reads `src` gets its batches from `src_lm_batch`.
    `ckpt` is passed to `train`, which saves vehicle 0's params there
    after the last round."""
    from repro_torch.data.synthetic import src_lm_batch
    from repro_torch.kernels.fedavg_agg.ops import fedavg_agg
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_fwd
    from repro_torch.core.veds import _SlotGraph
    from repro_torch.kernels.p4_solve.ops import p4_solve
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
    p4_solve.launches = 0
    captures = _SlotGraph.captures
    mark[0] = time.perf_counter()
    with round0_share() as changed:
        hist = train(cfg, rounds=warmup + rounds, batch_per_vehicle=batch,
                     seq=seq, lr=lr, seed=0, device=device,
                     log=lambda m: log(phase, m), stage_hook=hook,
                     on_round=on_round, batch_fn=src_lm_batch(cfg),
                     ckpt=ckpt)
    captures = _SlotGraph.captures - captures
    launches = {"flash_attention": flash_attention_fwd.launches,
                "fedavg_agg": fedavg_agg.launches,
                "ssd_scan": ssd_scan_fwd.launches,
                "veds_score": veds_dt_score.launches,
                "p4_solve": p4_solve.launches}

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
        # one each per slot of the round's schedule
        "veds_score": n * VFL_SLOTS,
        "p4_solve": n * VFL_SLOTS,
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


def _bits_equal(a, b) -> bool:
    """Two trees of tensors (dataclasses, dicts, tuples) equal bit for
    bit."""
    from repro_torch.core.scheduler import zip_tree

    def raw(x):
        x = x.reshape(-1).contiguous()
        return x.view(torch.uint8) if x.is_floating_point() else x

    same = []
    zip_tree(lambda x, y: same.append(
        x.shape == y.shape and x.dtype == y.dtype
        and torch.equal(raw(x), raw(y))), a, b)
    if not all(same):
        gaps = []
        zip_tree(lambda x, y: gaps.append(float((x.double() - y.double())
                                                .abs().max())), a, b)
        log("mesh", f"differing leaves {[i for i, k in enumerate(same) if not k]}"
            f" of {len(same)}; largest gaps {gaps}")
    return all(same)


def phase_mesh(device, setup):
    """The sharded rollout (`sharding/mesh_exec.py`) on a one-rank NCCL
    world (a `file://` store in a temporary directory): MESH_BATCH cells
    of the `rsu_grid` with handoff at fig10's width (the CNN and data of
    `make_fl_setup`, S=U=10, T=60, fleets of 40, batch 32, VEDS with warm
    P4 at `ipm_warm_iters` STREAM_WARM_ITERS), MESH_ROUNDS rounds through
    `fused_rollout` and through `mesh_fused_rollout` from the same carry
    and keys, then `stream_rounds` beside `mesh_stream_rounds`. The
    collectives run at world size 1 (the exchange's all-gathers,
    `gather_result`), and each mesh run must be its one-device run bit
    for bit: masks, decisions, `cell_id`, every fleet field, params and
    losses (cuDNN's deterministic algorithms for the phase: its default
    convolution backward may sum in another order from run to run).
    `veds_score` must run T x R times on each path. One untimed round
    first captures the slot graph and warms cuDNN. Logs each path's wall
    time a round, the exchange's time (all-gather plus permutation, on
    the run's final fleet) and the migrated fraction."""
    import dataclasses
    import tempfile
    import torch.distributed as dist
    from repro_torch.channel.mobility import ManhattanParams
    from repro_torch.channel.v2x import ChannelParams
    from repro_torch.core.baselines import get_scheduler
    from repro_torch.core.lyapunov import VedsParams
    from repro_torch.core.scenario import (ScenarioParams, exchange_fleet,
                                           migrated_fraction)
    from repro_torch.core.streaming import (StreamConfig, round_keys,
                                            stream_rounds)
    from repro_torch.core.veds import _SlotGraph
    from repro_torch.fl.engine import ClientShards, fused_rollout, init_carry
    from repro_torch.kernels.veds_score.ops import veds_dt_score
    from repro_torch.launch.mesh import init_world
    from repro_torch.models.cnn import cnn_loss
    from repro_torch.sharding import mesh_exec
    params, client_data, _, sim = setup
    mob, ch = ManhattanParams(v_max=sim.v_max), ChannelParams()
    prm = VedsParams(alpha=sim.alpha, V=sim.V, Q=sim.q_bits, slot=0.1,
                     ipm_warm_iters=STREAM_WARM_ITERS)
    sc = ScenarioParams(n_sov=sim.n_sov, n_opv=sim.n_opv,
                        n_slots=sim.n_slots, batch_size=sim.batch_size)
    R, B = MESH_ROUNDS, MESH_BATCH
    cfg = StreamConfig(n_rounds=R, batch=B, fresh_fleet=False,
                       carry_queues=True, handoff=True)
    sched = get_scheduler("veds")
    shards = ClientShards.from_ragged(client_data, device)
    g = torch.Generator(device=device).manual_seed(MESH_SEED)
    sel = torch.randint(0, sim.n_clients, (R, B, sim.n_sov), generator=g,
                        device=device)
    mb_u = torch.rand((R, B, sim.n_sov, sim.batch_size), generator=g,
                      device=device)
    keys = round_keys(MESH_SEED, cfg, R)
    out = {}

    def carry():
        return init_carry(MESH_SEED, sc, mob, cfg, params, ch=ch,
                          device=device)

    def timed(label, fn):
        torch.cuda.synchronize()
        veds_dt_score.launches = 0
        captures = _SlotGraph.captures
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = veds_dt_score.launches
        out[label] = dict(wall_s=wall, round_ms=wall / R * 1e3,
                          launches={"veds_score": launches},
                          graph_captures=_SlotGraph.captures - captures)
        log("mesh", f"{label}: {R} rounds of {B} cells in {wall:.3f} s, "
            f"{wall / R * 1e3:.2f} ms a round; veds_score launches "
            f"{launches} (expected {R * sc.n_slots}); slot graphs captured "
            f"{out[label]['graph_captures']}")
        check(launches == R * sc.n_slots, f"mesh {label}: veds_score "
              f"launched {launches} times, expected {R * sc.n_slots}")
        return res

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    fused_rollout(keys[:1], sel[:1], mb_u[:1], sched, sc, mob, ch, prm, cfg,
                  cnn_loss, shards, carry(), lr=sim.lr)
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        init_world(0, 1, f"{tmp}/store", "cuda")
        try:
            check(dist.get_backend() == "nccl", "mesh: the world is not NCCL")
            mesh = mesh_exec.fleet_mesh(1)
            out["init_s"] = time.perf_counter() - t0
            log("mesh", f"one-rank NCCL world and mesh {mesh} in "
                f"{out['init_s']:.3f} s")
            fleet0 = carry().sched
            one = timed("run_fl", lambda: fused_rollout(
                keys, sel, mb_u, sched, sc, mob, ch, prm, cfg, cnn_loss,
                shards, carry(), lr=sim.lr))
            local = timed("mesh_run_fl", lambda: mesh_exec.mesh_fused_rollout(
                mesh, keys, sel, mb_u, sched, sc, mob, ch, prm, cfg,
                cnn_loss, shards, carry(), lr=sim.lr))
            got = mesh_exec.gather_result(mesh, local)
            for k in ("outputs", "fleet", "params", "loss", "carry"):
                check(_bits_equal(getattr(got, k), getattr(one, k)),
                      f"mesh_fused_rollout's {k} differ from fused_rollout's")
            s_one = timed("stream", lambda: stream_rounds(
                MESH_SEED, sched, sc, mob, ch, prm, cfg, device=device))
            s_got = mesh_exec.gather_result(mesh, timed(
                "mesh_stream", lambda: mesh_exec.mesh_stream_rounds(
                    mesh, MESH_SEED, sched, sc, mob, ch, prm, cfg)))
            for k in ("outputs", "fleet", "carry"):
                check(_bits_equal(getattr(s_got, k), getattr(s_one, k)),
                      f"mesh_stream_rounds's {k} differ from "
                      f"stream_rounds's")
            check(bool(torch.isfinite(got.loss).all()) and all(
                bool(torch.isfinite(v).all()) for v in got.params.values()),
                "mesh: losses or params not finite")
            # the exchange alone on the run's final fleet: the all-gathered
            # one and the one-device permutation
            ex = mesh_exec.allgather_exchange(mesh.get_group("data"))
            fl = local.fleet
            ex_ms = [], []
            for _ in range(MESH_EXCHANGE_REPS):
                for i, fn in enumerate((ex, exchange_fleet)):
                    torch.cuda.synchronize()
                    t1 = time.perf_counter()
                    moved = fn(fl, mob)
                    torch.cuda.synchronize()
                    ex_ms[i].append((time.perf_counter() - t1) * 1e3)
            check(_bits_equal(moved, ex(fl, mob)), "mesh: the all-gathered "
                  "exchange differs from the one-device one")
            out["exchange_ms"] = statistics.median(ex_ms[0])
            out["exchange_one_device_ms"] = statistics.median(ex_ms[1])
            out["migrated_per_exchange"] = migrated_fraction(fl, moved)
            out["migrated_over_run"] = migrated_fraction(fleet0, got.fleet)
            out["parked"] = int((got.fleet.cell_id < 0).sum())
        finally:
            dist.destroy_process_group()
            torch.backends.cudnn.deterministic = deterministic
    out["n_success"] = [int(x) for x in got.outputs.n_success.sum(0)]
    log("mesh", f"exchange a round: {out['exchange_ms']:.3f} ms all-gathered "
        f"(median of {MESH_EXCHANGE_REPS}; one-device permutation alone "
        f"{out['exchange_one_device_ms']:.3f} ms); migrated "
        f"{out['migrated_per_exchange']:.4f} of the vehicles in one exchange "
        f"of the final fleet, {out['migrated_over_run']:.4f} over the run; "
        f"{out['parked']} parked; successes by cell {out['n_success']}; "
        f"mesh / one-device wall a round: fused "
        f"{out['mesh_run_fl']['round_ms'] / out['run_fl']['round_ms']:.3f}, "
        f"stream "
        f"{out['mesh_stream']['round_ms'] / out['stream']['round_ms']:.3f}; "
        f"masks, cell_id, fleet, params and losses bit for bit equal")
    return out


def phase_checkpoint(device, cfg, path: str, loss: float, seq: int):
    """The npz checkpoint of `cfg`'s VFL run that `train(ckpt=path)` wrote
    (vehicle 0's params after the last round): loaded into the model's
    template on the card (timed), its eval loss on `train`'s eval batch
    equal to the last round's `loss`, saved again (timed) to a file whose
    arrays are the first's byte for byte, and both files removed."""
    import os
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.data.synthetic import src_lm_batch
    from repro_torch.fl.vfl import lm_loss
    from repro_torch.launch.train import EVAL_STREAM, _generator
    from repro_torch.models import engine
    from repro_torch.models.module import materialize, tree_leaves
    decl = engine.model_decl(cfg, "head")
    like = materialize(torch.Generator(device=device).manual_seed(1), decl)
    size = os.path.getsize(path)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = load_checkpoint(path, like)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    check([(x.dtype, x.shape) for x in tree_leaves(got)]
          == [(x.dtype, x.shape) for x in tree_leaves(like)],
          "checkpoint: leaves of other dtypes or shapes")
    batch = src_lm_batch(cfg)(_generator(0, EVAL_STREAM, 0, device), 8, seq,
                              cfg.vocab_size)
    with torch.no_grad():
        again = float(lm_loss(got, batch, cfg, "head"))
    check(again == loss, f"checkpoint: eval loss {again!r} of the loaded "
          f"params, {loss!r} in the run")
    path2 = path.replace(".npz", "") + ".again.npz"
    t0 = time.perf_counter()
    save_checkpoint(path2, got)
    save_s = time.perf_counter() - t0
    with np.load(path) as a, np.load(path2) as b:
        check(list(a.keys()) == list(b.keys()) and all(
            a[k].dtype.str == b[k].dtype.str and a[k].tobytes()
            == b[k].tobytes() for k in a.keys()),
            "checkpoint: the second save's arrays differ from the first's")
        n_bf16 = sum(a[k].dtype.str == "|V2" for k in a.keys())
    for f in (path, path2):
        os.remove(f)
        os.remove(f.replace(".npz", "") + ".meta.json")
    out = dict(file_bytes=size, load_s=load_s, save_s=save_s,
               leaves=len(tree_leaves(got)), bf16_leaves=n_bf16,
               eval_loss=again)
    log("checkpoint", f"{cfg.name}: {size / 1e6:.1f} MB, {out['leaves']} "
        f"leaves ({n_bf16} bf16 as |V2); load to the card {load_s:.3f} s, "
        f"save from it {save_s:.3f} s; eval loss of the loaded params "
        f"{again:.6f} = the run's; the second save byte for byte the first")
    return out


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
    from repro_torch.models.module import materialize
    params = materialize(torch.Generator(device=device).manual_seed(seed),
                         engine.model_decl(cfg, "head"))
    batch = (src_lm_batch(cfg) or lm_batch)(
        _generator(seed, EVAL_STREAM, 0, device), 8, seq, cfg.vocab_size)
    g = torch.Generator(device=device).manual_seed(seed + 1)

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
        ulp = [loss({}, bf16_ulp_moved(params, g, device))
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
        res["cpu_half_ulp_update_rel"] = update_err(
            run("cpu", half_ulp_moved(params, 23)))
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
# LLM decode with caches (`models/engine.py decode_step`): prefill, then
# decode, at decode_32k's shape; the smoke configs card against CPU
# ---------------------------------------------------------------------------

def _decode_counts():
    from repro_torch.kernels.fedavg_agg.ops import fedavg_agg
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.kernels.p4_solve.ops import p4_solve
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_fwd
    from repro_torch.kernels.veds_score.ops import veds_dt_score
    return {"flash_attention": flash_attention_fwd,
            "ssd_scan": ssd_scan_fwd, "fedavg_agg": fedavg_agg,
            "veds_score": veds_dt_score, "p4_solve": p4_solve}


def _zero_counts():
    for fn in _decode_counts().values():
        fn.launches = 0


def _read_counts():
    return {k: fn.launches for k, fn in _decode_counts().items()}


def decode_serve(device, cfg, batch: int, seq_len: int, prompt: int,
                 new: int, want_prefill, tol=None):
    """Serving `cfg` as the reference's `launch/specs.py` builds it:
    `forward(..., last_logit_only=True, seq_shard=True)` over `batch`
    prompts of `prompt` tokens (a seeded `torch.Generator`), then
    `decode_step` from a zero cache of `seq_len` slots over the prompt's
    tokens and `new` greedy tokens, every kernel count set to 0 just
    before each part. The prefill must launch `want_prefill`, the decode
    steps no kernel (the reference's decode reaches no Pallas kernel).
    The decode's logits at the prompt's last position are held to the
    prefill's within `tol` of max|logit| where given (logged always,
    with the share of equal argmaxes, beside the same distance between
    the prefill and a prefill with every bf16 weight moved by one ulp:
    the model's own sensitivity); every logit must be finite. Times:
    the prefill (after one untimed call), each step between CUDA events
    (median), tokens/s, beside two bytes bounds: the plain algorithm's,
    which reads every slot of the cache as the reference's decode does
    (the cache, every parameter but the embedding table, of which B rows
    are read, and the LM head, read once, over the memory rate), and the
    function's, which needs of each self-attention cache only the slots
    0..pos written so far (the median over the timed steps' positions)."""
    from repro_torch.models import engine
    from repro_torch.models.module import (materialize, param_bytes,
                                           tree_leaves)
    phase = f"decode {cfg.name}"
    torch.cuda.synchronize()
    free()
    torch.cuda.reset_peak_memory_stats()
    decl = engine.model_decl(cfg, "head")
    params = materialize(torch.Generator(device=device).manual_seed(0),
                         decl)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt),
                            generator=torch.Generator(device=device)
                            .manual_seed(1), device=device)
    cdecl = engine.cache_decl(cfg, batch, seq_len)
    cache_bytes = param_bytes(cdecl)
    emb = 0 if cfg.tie_embeddings else \
        math.prod(decl["embed"]["table"].shape) * cfg.pdtype.itemsize
    step_bytes = cache_bytes + param_bytes(decl) - emb
    bound_ms = step_bytes / PEAK_BYTES_PER_S * 1e3

    def needed_bytes(pos):
        n = param_bytes(decl) - emb
        for kind, c in zip(cfg.pattern, cdecl):
            for d in tree_leaves(c):
                size = math.prod(d.shape) * d.dtype.itemsize
                if kind != "cross" and "cache_seq" in d.axes:
                    S = d.shape[d.axes.index("cache_seq")]
                    size = size // S * min(pos + 1, S)
                n += size
        return n
    needed_ms = [needed_bytes(t) / PEAK_BYTES_PER_S * 1e3
                 for t in range(prompt + new)]
    valid_bound_ms = statistics.median(needed_ms)
    log(phase, f"{cfg.name} pattern {cfg.pattern} x n_rep {cfg.n_rep} "
        f"d_model {cfg.d_model} vocab {cfg.vocab_size} {cfg.param_dtype}: "
        f"{param_bytes(decl) / 1e9:.3f} GB of params; batch {batch}, "
        f"prompts of {prompt} tokens, then {new} greedy; cache of "
        f"{seq_len} slots: {cache_bytes / 1e9:.2f} GB")

    def prefill():
        return engine.forward(params, prompts, cfg, tp="head",
                              last_logit_only=True, seq_shard=True)[0][:, 0]

    with torch.no_grad():
        prefill()                                   # untimed
        torch.cuda.synchronize()
        _zero_counts()
        t0 = time.perf_counter()
        ref = prefill()
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_counts = _read_counts()
        # the model's own sensitivity at its init: the prefill again with
        # every nonzero bf16 weight moved by one ulp, up or down at random
        kept = params
        params = bf16_ulp_moved(
            kept, torch.Generator(device=device).manual_seed(5), device)
        moved = prefill()
        params = kept
        cache = engine.zero_cache(cdecl, device)
        positions = torch.arange(prompt + new, device=device)
        finite = torch.ones((), dtype=torch.bool, device=device)
        events = [torch.cuda.Event(enable_timing=True)
                  for _ in range(prompt + new + 1)]
        torch.cuda.synchronize()
        _zero_counts()
        tok = prompts[:, 0]
        events[0].record()
        for t in range(prompt + new):
            logits, cache = engine.decode_step(params, cache, tok,
                                               positions[t], cfg, None,
                                               tp="head")
            events[t + 1].record()
            finite &= torch.isfinite(logits).all()
            if t == prompt - 1:
                at_prompt = logits.clone()
            tok = prompts[:, t + 1] if t + 1 < prompt else \
                logits.argmax(dim=-1)
        torch.cuda.synchronize()
        step_counts = _read_counts()
    steps_ms = [events[i].elapsed_time(events[i + 1])
                for i in range(prompt + new)]
    step_ms = statistics.median(steps_ms)
    scale = float(ref.abs().max())
    dist = float((at_prompt - ref).abs().max()) / scale
    agree = float((at_prompt.argmax(-1) == ref.argmax(-1)).float().mean())
    ulp_dist = float((moved - ref).abs().max()) / scale
    ulp_agree = float((moved.argmax(-1) == ref.argmax(-1)).float().mean())
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(phase, f"prefill {prefill_ms:.2f} ms "
        f"({batch * prompt / prefill_ms * 1e3:.0f} tokens/s), launches "
        f"{prefill_counts} (expected {want_prefill}); "
        f"decode {step_ms:.3f} ms a step, median of {prompt + new} (first "
        f"{steps_ms[0]:.3f}, min {min(steps_ms):.3f}, max "
        f"{max(steps_ms):.3f}), {batch / step_ms * 1e3:.0f} tokens/s, "
        f"the plain algorithm's bytes bound (every slot) {bound_ms:.3f} ms "
        f"({step_bytes / 1e9:.2f} GB a step), the function's (the valid "
        f"slots) {valid_bound_ms:.4f} ms median ({needed_ms[0]:.4f} at "
        f"position 0 to {needed_ms[-1]:.4f} at {prompt + new - 1}): the "
        f"step is {step_ms / bound_ms:.2f}x and "
        f"{step_ms / valid_bound_ms:.1f}x them; launches {step_counts}; "
        f"peak memory {peak_gb:.2f} GB; "
        f"{smi_line()}")
    log(phase, f"decode logits at position {prompt - 1} vs the prefill's: "
        f"max abs {dist * scale:.4e} = {dist:.4e} of max|logit| "
        f"{scale:.4e}" + (f" (tolerance {tol})" if tol else " (logged, "
                          "not bounded)")
        + f"; argmax equal in {agree:.4f} of the rows. The prefill with "
        f"every bf16 weight moved by one ulp: {ulp_dist:.4e} of max|logit| "
        f"from it, argmax equal in {ulp_agree:.4f} of the rows")
    check(bool(finite) and bool(torch.isfinite(ref).all()),
          f"{phase}: logits not finite")
    for k, w in want_prefill.items():
        check(prefill_counts[k] == w, f"{phase}: prefill launched {k} "
              f"{prefill_counts[k]} times, expected {w}")
    check(not any(step_counts.values()), f"{phase}: the decode steps "
          f"launched {step_counts}, expected no kernel")
    if tol is not None:
        check(dist <= tol, f"{phase}: prefill vs decode {dist:.4e} of "
              f"max|logit| > {tol}")
    res = dict(batch=batch, seq_len=seq_len, prompt=prompt, new=new,
               cache_gb=cache_bytes / 1e9, prefill_ms=prefill_ms,
               prefill_launches=prefill_counts, step_ms=step_ms,
               steps_ms=steps_ms, tokens_per_s=batch / step_ms * 1e3,
               step_bytes=step_bytes, bound_ms=bound_ms,
               valid_slots_bound_ms=valid_bound_ms,
               valid_slots_bound_ms_range=[needed_ms[0], needed_ms[-1]],
               step_launches=step_counts, prefill_decode_rel=dist,
               argmax_agree=agree, prefill_ulp_move_rel=ulp_dist,
               prefill_ulp_move_argmax_agree=ulp_agree, tolerance=tol,
               max_memory_gb=peak_gb)
    del params, kept, cache, ref, moved, logits, at_prompt
    free()
    return res


def smoke_decode_config(run: str):
    """(config, force_swa, steps) of a DECODE_SMOKE run, "arch[+opt...]"
    ("swa": the attention forced to the window-64 ring over 80 tokens;
    "enc1": one encoder layer): the smoke config in fp32 as
    `tests/test_decode_consistency.py` sets it, but with the SSM chunk
    32, a chunk the `ssd_scan` kernels take (the reference test's 8 is
    not; the chunk does not change the function)."""
    from repro_torch.configs.registry import get_smoke_config
    arch, *opts = run.split("+")
    swa = "swa" in opts
    cfg = get_smoke_config(arch).replace(
        compute_dtype="float32", param_dtype="float32", remat=False,
        ssm_chunk=32, attn_chunk=16, capacity_factor=4.0)
    if "enc1" in opts:
        cfg = cfg.replace(encoder_layers=1)
    return cfg, swa, 80 if swa else 24


def smoke_decode(run: str, device, params=None):
    """(decode logits [2, steps, V], prefill logits [2, steps, V]) of a
    DECODE_SMOKE run on `device`, on the CPU: its init drawn on the CPU
    from seed 0 (or `params`), tokens (and `src` = 0.1 N(0, 1) for the
    audio and vlm families) from seed 1, `decode_step` from a zero cache
    (the cross slots from `build_cross_cache`); the prefill's attention
    is the same window as the decode's ring."""
    from repro_torch.models import engine
    from repro_torch.models.module import materialize, tree_map
    cfg, swa, steps = smoke_decode_config(run)
    if params is None:
        params = materialize(torch.Generator().manual_seed(0),
                             engine.model_decl(cfg, "head"))
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, steps), generator=gen)
    src = None
    if cfg.family in ("vlm", "audio"):
        src = (0.1 * torch.randn(2, cfg.num_src_tokens, cfg.src_dim,
                                 generator=gen)).to(device)
    p = tree_map(lambda a: a.to(device), params)
    toks = toks.to(device)
    cache = engine.zero_cache(engine.cache_decl(cfg, 2, steps,
                                                force_swa=swa), device)
    if src is not None:
        cache = engine.build_cross_cache(cfg, p, cache, src, "head")
    pcfg = cfg.replace(pattern=tuple(
        "attn_swa" if swa and k == "attn" else k for k in cfg.pattern))
    outs = []
    with torch.no_grad():
        for t in range(steps):
            lg, cache = engine.decode_step(
                p, cache, toks[:, t], torch.tensor(t, device=device), cfg,
                None, tp="head", force_swa=swa)
            outs.append(lg)
        pre, _ = engine.forward(p, toks, pcfg, tp="head", src=src)
    return torch.stack(outs, 1).cpu(), pre.cpu()


def bf16_ulp_moved(params, g: torch.Generator, device,
                   dtype=torch.bfloat16):
    """Every nonzero weight of `dtype` (bf16, or fp32) moved by one ulp of
    it, up or down at random (the signs drawn from `g` on `device`, leaf
    by leaf); other leaves as they are."""
    from repro_torch.models.module import tree_map
    bits = {torch.bfloat16: torch.int16, torch.float32: torch.int32}[dtype]

    def move(x):
        if x.dtype != dtype:
            return x
        step = 2 * torch.randint(0, 2, x.shape, generator=g, device=device,
                                 dtype=bits) - 1
        return (x.view(bits) + step * (x != 0)).view(dtype)
    return tree_map(move, params)


def half_ulp_moved(params, seed: int):
    """Every fp32 weight moved by half an ulp, x (1 +- 6e-8), the signs
    drawn from `seed` on the CPU."""
    from repro_torch.models.module import tree_map
    g = torch.Generator().manual_seed(seed)
    return tree_map(lambda x: x * (1.0 + 6e-8 * (2.0 * torch.randint(
        0, 2, x.shape, generator=g) - 1.0).to(x.device)), params)


@contextlib.contextmanager
def plain_flash_attention():
    """The models' `flash_attention` through its plain version, not the
    kernel, while the block runs: a witness that takes the kernel out of
    a path and leaves every other operation as it was."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_plain
    from repro_torch.models import attention
    kept = attention._fa

    def plain(q, k, v, *, causal, window, q_offset, bwd_chunk):
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     q_offset=q_offset)[0]
    attention._fa = plain
    try:
        yield
    finally:
        attention._fa = kept


def phase_decode_reference(device):
    """`decode_step` at the smoke configs in fp32 (DECODE_SMOKE: the seven
    archs of `tests/test_decode_consistency.py`, whisper's and vlm's cross
    slots from `build_cross_cache`, and qwen3 with its attention forced to
    the window-64 ring over 80 tokens, so that it wraps): the card's
    logits against the CPU's within DECODE_CPU_TOL of max|logit| (the CPU
    tests' bound against the reference; for whisper at its smoke depth
    logged instead, beside two witnesses: the CPU's own move under a
    half-ulp change of the weights, and the card with the encoder's
    `flash_attention` through its plain version, not the kernel, against
    the CPU: an encoder that amplifies any rounding gives it a distance
    like the kernel's, a kernel fault a much smaller one), and the card's
    prefill (through the fp32 kernels) against its decode within the
    reference test's own bound."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.models import engine
    from repro_torch.models.module import materialize, tree_map
    out = {}
    for run, (tol, cpu_tol) in DECODE_SMOKE.items():
        cfg, _, _ = smoke_decode_config(run)
        params = materialize(torch.Generator().manual_seed(0),
                             engine.model_decl(cfg, "head"))
        cpu, _ = smoke_decode(run, "cpu", params)
        n0 = flash_attention_fwd.launches
        dec, pre = smoke_decode(run, device, params)
        n_flash = flash_attention_fwd.launches - n0
        steps = cpu.shape[1]
        scale = float(cpu.abs().max())
        err = float((dec - cpu).abs().max()) / scale
        rel = float((dec - pre).abs().max()) / float(pre.abs().max())
        r = dict(steps=steps, card_vs_cpu=err, prefill_vs_decode=rel,
                 flash_attention_launches=n_flash,
                 tolerance=dict(card_vs_cpu=cpu_tol, prefill_vs_decode=tol))
        note = f"tolerance {cpu_tol}"
        if cpu_tol is None:
            moved, _ = smoke_decode(run, "cpu", half_ulp_moved(params, 23))
            r["cpu_half_ulp_move"] = float((moved - cpu).abs().max()) / scale
            # the encoder's memory itself, kernel against plain version
            src = (0.1 * torch.randn(2, cfg.num_src_tokens, cfg.src_dim,
                                     generator=torch.Generator()
                                     .manual_seed(2))).to(device)
            p = tree_map(lambda a: a.to(device), params)
            with torch.no_grad():
                mem = engine.source_memory(p, cfg, src, "head")
                with plain_flash_attention():
                    mem_plain = engine.source_memory(p, cfg, src, "head")
            r["encoder_memory_kernel_vs_plain"] = \
                float((mem - mem_plain).abs().max()) / \
                float(mem_plain.abs().max())
            del p
            n0 = flash_attention_fwd.launches
            with plain_flash_attention():
                plain, _ = smoke_decode(run, device, params)
            check(n_flash > 0 and flash_attention_fwd.launches == n0,
                  f"decode {run}: the kernel ran {n_flash} times, the "
                  f"witness without it {flash_attention_fwd.launches - n0}")
            r["card_plain_attention_vs_cpu"] = \
                float((plain - cpu).abs().max()) / scale
            r["card_kernel_vs_plain_attention"] = \
                float((dec - plain).abs().max()) / scale
            note = (f"logged: the CPU's own logits move by "
                    f"{r['cpu_half_ulp_move']:.3e} when every weight moves "
                    f"by half an ulp; the card with the plain attention, "
                    f"not the kernel, is "
                    f"{r['card_plain_attention_vs_cpu']:.3e} from the CPU "
                    f"and {r['card_kernel_vs_plain_attention']:.3e} from "
                    f"the card with the kernel; the encoder's memory with "
                    f"the kernel is "
                    f"{r['encoder_memory_kernel_vs_plain']:.3e} of its max "
                    f"from the plain version's")
        log("decode_reference", f"{run} smoke config, fp32, {steps} steps: "
            f"card vs CPU logits {err:.3e} of max|logit| ({note}); prefill "
            f"vs decode on the card {rel:.3e} (tolerance {tol}); "
            f"{n_flash} flash_attention launches")
        check(bool(torch.isfinite(dec).all()), f"decode {run}: not finite")
        check(cpu_tol is None or err <= cpu_tol, f"decode {run}: card vs "
              f"CPU {err:.3e} of max|logit| > {cpu_tol}")
        check(rel < tol, f"decode {run}: prefill vs decode on the card "
              f"{rel:.3e} of max|logit| >= {tol}")
        out[run] = r
    return out


def phase_decode(device):
    """The serving path: qwen3-32b at full width (VFL_REPS repetitions) at
    decode_32k's batch and cache, then zamba2-2.7b at full width and
    depth at DECODE_ZAMBA2_BATCH rows (its cache at 128 rows would be
    387 GB), then the smoke configs card against CPU."""
    from repro_torch.configs.base import SHAPES_BY_NAME
    shape = SHAPES_BY_NAME["decode_32k"]
    qcfg = vfl_config("qwen3-32b", VFL_REPS)

    def n_attn(c):
        return c.n_rep * sum(k in ("attn", "attn_swa") for k in c.pattern)
    qwen3 = decode_serve(device, qcfg, shape.global_batch, shape.seq_len,
                         DECODE_PROMPT, DECODE_NEW,
                         {"flash_attention": n_attn(qcfg), "ssd_scan": 0,
                          "fedavg_agg": 0, "veds_score": 0},
                         tol=DECODE_QWEN3_TOL)
    zcfg = vfl_config("zamba2-2.7b", ZAMBA2_REPS)
    zamba2 = decode_serve(device, zcfg, DECODE_ZAMBA2_BATCH, shape.seq_len,
                          DECODE_PROMPT, DECODE_NEW,
                          {"flash_attention": n_attn(zcfg),
                           "ssd_scan": zcfg.n_rep * zcfg.pattern.count(
                               "mamba"), "fedavg_agg": 0, "veds_score": 0})
    return dict(qwen3=qwen3, zamba2=zamba2,
                smoke=phase_decode_reference(device))


# ---------------------------------------------------------------------------
# the model mesh axis (`sharding/model_axis.py`): a one-rank NCCL world,
# then two and four ranks sharing the one card over gloo
# ---------------------------------------------------------------------------

def _named(tree, prefix=""):
    """{path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(_named(v, f"{prefix}/{k}"))
    return out


def _logit_distance(ours, ref):
    """(max|ours - ref| / max|ref|, the share of rows whose argmax agrees)
    of two logit tensors [..., V]."""
    scale = float(ref.abs().max())
    dist = float((ours - ref).abs().max()) / scale
    agree = float((ours.argmax(-1) == ref.argmax(-1)).float().mean())
    return dist, agree


def serve_logits(params, cfg, tp: str, prompts, cache_len: int, steps: int,
                 mesh=None):
    """The serving path of `decode_serve` on `params` (this rank's block
    over `mesh`): the prefill's last-position logits [B, V]
    (`forward(..., last_logit_only=True, seq_shard=True)`), then
    `decode_step` over the prompts' first `steps` tokens from a zero
    cache of `cache_len` slots ([steps, B, V]); the walls of the prefill
    and of the steps (ms, after a device synchronisation), the
    launches of every kernel in the prefill and in the steps
    (`prefill_counts`, `step_counts`), and the cache's bytes on this
    rank."""
    from repro_torch.models import engine
    device = prompts.device
    with torch.no_grad():
        _sync(device)
        _zero_counts()
        t0 = time.perf_counter()
        pre = engine.forward(params, prompts, cfg, tp=tp,
                             last_logit_only=True, seq_shard=True,
                             mesh=mesh)[0][:, 0]
        _sync(device)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_counts = _read_counts()
        cache = engine.zero_cache(engine.cache_decl(cfg, prompts.shape[0],
                                                    cache_len), device,
                                  mesh=mesh)
        cache_bytes = sum(x.numel() * x.element_size()
                          for x in _named(cache).values())
        positions = torch.arange(steps, device=device)
        out = []
        _sync(device)
        _zero_counts()
        t0 = time.perf_counter()
        for t in range(steps):
            logits, cache = engine.decode_step(params, cache, prompts[:, t],
                                               positions[t], cfg, mesh,
                                               tp=tp)
            out.append(logits)
        _sync(device)
        step_ms = (time.perf_counter() - t0) * 1e3 / steps
    return dict(prefill=pre, decode=torch.stack(out), prefill_ms=prefill_ms,
                step_ms=step_ms, prefill_counts=prefill_counts,
                step_counts=_read_counts(),
                cache_gb=cache_bytes / 1e9)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def _peak_gb(device, reset: bool = False) -> float:
    """The peak memory allocated on `device` since the last reset (GB; 0
    off the card), and with `reset` a new reset."""
    if device.type != "cuda":
        return 0.0
    gb = torch.cuda.max_memory_allocated() / 1e9
    if reset:
        torch.cuda.reset_peak_memory_stats()
    return gb


@contextlib.contextmanager
def _alloc_conf(conf: str):
    """PYTORCH_CUDA_ALLOC_CONF set to `conf` for the processes spawned in
    the block (ranks sharing the card: less memory lost to
    fragmentation), restored after."""
    old = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    try:
        yield
    finally:
        if old is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = old


def _ma_prompts(batch: int, length: int, vocab: int, device):
    return torch.randint(0, vocab, (batch, length), device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(1))


def _ma_params(cfg, device):
    from repro_torch.models import engine
    from repro_torch.models.module import materialize
    return materialize(torch.Generator(device=device).manual_seed(0),
                       engine.model_decl(cfg, "head"))


def _model_axis_serve_rank(rank: int, out_dir: str, cfg, shapes) -> None:
    """One rank of a (1, world) mesh on the shared card: `cfg`'s serving
    path in head mode, in row mode and under the `dp` profile (`shapes`:
    the (batch, prompt, cache slots, steps) of each) on this rank's block
    of the seeded parameters (under `dp` all of them, the cache's slots
    cut over the ranks); rank 0 saves the logits, every rank its walls,
    launches and peak memory."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import engine
    from repro_torch.sharding.fsdp import layout_axis
    from repro_torch.sharding.mesh_exec import world_device
    from repro_torch.sharding.model_axis import shard_params
    torch.backends.cuda.matmul.allow_tf32 = False
    device = world_device()
    mesh = make_host_mesh(torch.distributed.get_world_size())
    res = {}
    for mode, (batch, prompt, cache_len, steps) in zip(MA_MODES, shapes):
        tp = "head" if mode == "dp" else mode
        _peak_gb(device, reset=True)
        params = _ma_params(cfg, device)
        ax = layout_axis(mesh, "dp") if mode == "dp" else mesh
        if mode != "dp":
            params = shard_params(mesh, params, engine.model_decl(cfg, tp))
        r = serve_logits(params, cfg, tp, _ma_prompts(
            batch, prompt, cfg.vocab_size, device), cache_len, steps, ax)
        r["max_memory_gb"] = _peak_gb(device)
        if rank == 0:
            torch.save({k: r.pop(k).cpu() for k in ("prefill", "decode")},
                       f"{out_dir}/{mode}_logits.pt")
        else:
            del r["prefill"], r["decode"]
        res[mode] = r
        del params
        if device.type == "cuda":
            torch.cuda.empty_cache()
    torch.save(res, f"{out_dir}/serve_rank{rank}.pt")


@contextlib.contextmanager
def round0_params(move=None):
    """Inside the block, `launch/train.py`'s first step records in the
    yielded dict vehicle 0's parameters before ("old") and after ("new")
    round 0 and its mask, as `round0_share` wraps `make_train_step`;
    `move`, where given, maps the parameters round 0 starts from."""
    import repro_torch.launch.train as tr
    from repro_torch.models.module import tree_map
    make, out = tr.make_train_step, {}

    def wrapped(*args, **kw):
        step = make(*args, **kw)

        def first_recorded(params_v, *rest):
            if "new" not in out and move is not None:
                params_v = move(params_v)
            new_v, stats = step(params_v, *rest)
            if "new" not in out:
                out["old"] = tree_map(lambda x: x[0].clone(), params_v)
                out["new"] = tree_map(lambda x: x[0].clone(), new_v)
                out["mask"] = stats["mask"].tolist()
            return new_v, stats
        return first_recorded
    tr.make_train_step = wrapped
    try:
        yield out
    finally:
        tr.make_train_step = make


def _model_axis_vfl_rank(rank: int, out_dir: str, cfg, model: int,
                         batch: int, seq: int, lr: float) -> None:
    """One rank of a (vehicles, `model`) mesh on the shared card: one
    round of `launch/train.py`'s `train` for `cfg` (this rank's block of
    its vehicle's model); vehicle 0's ranks gather its whole parameters
    before and after the round (on the CPU) and its first rank saves
    them; every rank saves its mask, loss, stage walls, launches and
    peak memory."""
    torch.backends.cuda.matmul.allow_tf32 = False
    _vfl_round_on_mesh(rank, out_dir, cfg, model, batch, seq, lr)


def _vfl_round_on_mesh(rank: int, out_dir: str, cfg, model: int, batch: int,
                       seq: int, lr: float) -> None:
    """`_model_axis_vfl_rank`'s round, in a world already started."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.train import train
    from repro_torch.models import engine
    from repro_torch.models.module import tree_map
    from repro_torch.sharding.mesh_exec import world_device
    from repro_torch.sharding.model_axis import gather_params
    device = world_device()
    mesh = make_host_mesh(model)
    stages = []
    mark = [time.perf_counter()]

    def hook(name):
        _sync(device)
        now = time.perf_counter()
        stages.append((name, (now - mark[0]) * 1e3))
        mark[0] = now
    _peak_gb(device, reset=True)
    _zero_counts()
    with round0_params() as got:
        hist = train(cfg, rounds=1, batch_per_vehicle=batch, seq=seq,
                     lr=lr, seed=0, device=device, log=lambda m: None,
                     stage_hook=hook, mesh=mesh)
    counts = _read_counts()
    res = dict(mask=got["mask"], loss=hist[0]["loss"],
               wall_s=hist[0]["wall_s"], stages=stages,
               launches={k: counts[k] for k in ("flash_attention",
                                                "veds_score", "p4_solve",
                                                "ssd_scan")},
               max_memory_gb=_peak_gb(device))
    if mesh.get_local_rank("data") == 0:
        decl = engine.model_decl(cfg, "head")
        whole = {k: _named(gather_params(mesh, tree_map(
            lambda x: x.cpu(), got[k]), decl)) for k in ("old", "new")}
        if mesh.get_local_rank("model") == 0:
            torch.save(whole, f"{out_dir}/vfl_params.pt")
        del whole
    torch.save(res, f"{out_dir}/vfl_rank{rank}.pt")


def phase_model_axis(device, cfg=None, head=MA_HEAD, row=MA_ROW,
                     batch=MA_VFL_BATCH, seq=VFL_SEQ, lr=VFL_LR):
    """The model mesh axis (`sharding/model_axis.py` and the split layers
    of `models/`), qwen3-32b at full width cut to VFL_REPS repetitions:
    (a) a one-rank NCCL world, a (1, 1) mesh: the serving path (prefill
    and MA_HEAD's decode steps at decode_32k's batch and cache) and one
    smoke VFL round through the model-axis code, each bit for bit the
    path without a mesh; (b) MA_SERVE_RANKS ranks on the one card over
    gloo (`run_world(shared_card=True)`), a (1, 2) mesh: the serving path
    in head mode (MA_HEAD: the cache's sequence cut over the ranks), in
    forced row mode (MA_ROW: prompts long enough for the
    sequence-sharded core) and under the `dp` profile (MA_HEAD: the
    parameters whole on each rank, the cache's sequence cut over the
    ranks, the flash-decode merged), each against the one-rank path on
    the same
    parameters and prompts (logits within MA_TOL of max|logit|, argmax
    equal in at least MA_ARGMAX of the rows, `flash_attention` launches
    as predicted); (c) one VFL round of `train` on a (MA_VFL_VEHICLES,
    MA_VFL_MODEL) mesh, four ranks on the card, against the one-process
    round at the same seed: masks identical, each leaf's update within
    MA_VFL_WITNESS_RATIO of the change one process's own update of that
    leaf takes when every bf16 weight moves by one ulp (logged beside
    it). Each multi-rank run and its one-rank
    counterpart run one after the other. Ranks that share a card measure
    no tensor-parallel speed-up: their walls are logged beside the
    one-rank path's, not compared. `cfg` (qwen3-32b's by default), the
    serving shapes and the VFL batch may be cut to rehearse the phase on
    the CPU (gloo ranks on the CPU, no launch counted)."""
    import tempfile
    import torch.distributed as dist
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data.synthetic import lm_batch
    from repro_torch.fl.vfl import make_vfl_round
    from repro_torch.launch.mesh import init_world, make_host_mesh, run_world
    from repro_torch.launch.train import train
    from repro_torch.models import engine
    from repro_torch.models.module import materialize, tree_leaves, tree_map
    phase = "model_axis"
    cfg = cfg or vfl_config("qwen3-32b", VFL_REPS)
    vcfg = cfg.replace(num_vehicles=MA_VFL_VEHICLES)
    on_card = device.type == "cuda"
    n_attn = cfg.n_rep * sum(k == "attn" for k in cfg.pattern)
    out = {}
    free()
    # (a) a one-rank NCCL world: the model-axis code with a group of one
    with tempfile.TemporaryDirectory() as tmp:
        init_world(0, 1, f"{tmp}/store", device.type)
        try:
            check(dist.get_backend() == ("nccl" if on_card else "gloo"),
                  f"{phase}: not NCCL")
            mesh = make_host_mesh(1)
            params = _ma_params(cfg, device)
            b, prompt, cache_len, steps = head
            prompts = _ma_prompts(b, prompt, cfg.vocab_size, device)
            one = serve_logits(params, cfg, "head", prompts, cache_len, steps)
            one = {k: v.cpu() if torch.is_tensor(v) else v
                   for k, v in one.items()}
            free()
            on_mesh = serve_logits(params, cfg, "head", prompts, cache_len,
                                   steps, mesh)
            for k in ("prefill", "decode"):
                check(torch.equal(on_mesh[k].cpu(), one[k]), f"{phase}: the "
                      f"(1, 1) mesh's {k} logits differ from the path "
                      f"without a mesh")
            # the one-rank walls from the second, warm run
            one.update({k: v for k, v in on_mesh.items()
                        if not torch.is_tensor(v)})
            del params, on_mesh
            free()
            scfg = get_smoke_config("qwen3-32b").replace(num_vehicles=1,
                                                         grad_accum=1)
            sp = materialize(torch.Generator(device=device).manual_seed(3),
                             engine.model_decl(scfg, "head"))
            sp_v = tree_map(lambda x: x[None], sp)
            sb = lm_batch(torch.Generator(device=device).manual_seed(4), 4,
                          128, scfg.vocab_size)
            sb_v = {k: x[None] for k, x in sb.items()}
            m, w = torch.ones(1, device=device), torch.ones(1, device=device)
            r0 = make_vfl_round(scfg, None, "head", lr=lr)(sp_v, sb_v, m, w)
            r1 = make_vfl_round(scfg, mesh, "head", lr=lr)(sp_v, sb_v, m, w)
            check(all(torch.equal(x, y) for x, y in zip(tree_leaves(r0),
                                                        tree_leaves(r1))),
                  f"{phase}: the smoke VFL round on the (1, 1) mesh differs "
                  f"from the round without a mesh")
            del sp, sp_v, r0, r1
        finally:
            dist.destroy_process_group()
    log(phase, f"(a) one-rank NCCL world, (1, 1) mesh: {cfg.name} prefill "
        f"{b} x {prompt} and {steps} decode steps (cache {cache_len}) and "
        f"a smoke VFL round bit for bit the path without a mesh; one rank: "
        f"prefill {one['prefill_ms']:.1f} ms, a step {one['step_ms']:.2f} ms")
    out["one_rank_head"] = {k: v for k, v in one.items()
                            if not torch.is_tensor(v)}
    free()
    # (b) two ranks on the one card: head mode, then forced row mode
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with _alloc_conf("expandable_segments:True"):
            run_world(_model_axis_serve_rank, MA_SERVE_RANKS, tmp, cfg,
                      (head, row, head), device=device.type,
                      shared_card=on_card, timeout_s=600)
        world_s = time.perf_counter() - t0
        ranks = [torch.load(f"{tmp}/serve_rank{r}.pt", weights_only=False)
                 for r in range(MA_SERVE_RANKS)]
        got = {tp: torch.load(f"{tmp}/{tp}_logits.pt", weights_only=False)
               for tp in MA_MODES}
    b, prompt, cache_len, steps = row
    params = _ma_params(cfg, device)
    row_one = serve_logits(params, cfg, "head", _ma_prompts(
        b, prompt, cfg.vocab_size, device), cache_len, steps)
    row_one = {k: v.cpu() if torch.is_tensor(v) else v
               for k, v in row_one.items()}
    del params
    free()
    refs = {"head": one, "row": row_one, "dp": one}
    # per rank: head mode runs each layer's kernel on its H/n heads, row
    # mode on its T/n queries (the sequence-sharded core); no kernel in
    # the decode steps
    want = {"head": (n_attn, 0), "row": (n_attn, 0), "dp": (n_attn, 0)}
    res = {"world_s": world_s}
    launches = {tp: [(x[tp]["prefill_counts"]["flash_attention"],
                      x[tp]["step_counts"]["flash_attention"])
                     for x in ranks] for tp in MA_MODES}
    for tp in MA_MODES:
        ref = refs[tp]
        dists = {k: _logit_distance(got[tp][k], ref[k])
                 for k in ("prefill", "decode")}
        rows = torch.cat([got[tp]["prefill"][None], got[tp]["decode"]])
        ref_rows = torch.cat([ref["prefill"][None], ref["decode"]])
        dist_all, agree = _logit_distance(rows, ref_rows)
        r = dict(distance=dists, distance_all=dist_all, argmax_agree=agree,
                 ranks=[x[tp] for x in ranks],
                 one_rank={k: v for k, v in ref.items()
                           if not torch.is_tensor(v)})
        res[tp] = r
        b, p, c, s = row if tp == "row" else head
        log(phase, f"(b) {tp} mode, {MA_SERVE_RANKS} ranks on one card "
            f"over gloo, batch {b}, prompts of {p}, {s} steps, cache {c} "
            f"({[round(x[tp]['cache_gb'], 2) for x in ranks]} GB a rank): "
            f"prefill {dists['prefill'][0]:.4e} of max|logit| (argmax "
            f"{dists['prefill'][1]:.4f}), decode {dists['decode'][0]:.4e} "
            f"(argmax {dists['decode'][1]:.4f}), all {dist_all:.4e}, argmax "
            f"equal in {agree:.4f} of the {rows.shape[0] * rows.shape[1]} "
            f"rows; walls rank 0 prefill {ranks[0][tp]['prefill_ms']:.1f} ms"
            f", a step {ranks[0][tp]['step_ms']:.2f} ms (one rank: "
            f"{ref['prefill_ms']:.1f}, {ref['step_ms']:.2f}); flash launches "
            f"a rank {launches[tp]}"
            f" (expected {want[tp]}); peak memory a rank "
            f"{[round(x[tp]['max_memory_gb'], 2) for x in ranks]} GB; "
            f"{smi_line()}")
        check(dist_all <= MA_TOL, f"{phase}: {tp} mode logits "
              f"{dist_all:.4e} of max|logit| from one rank > {MA_TOL}")
        check(agree >= MA_ARGMAX, f"{phase}: {tp} mode argmax equal in "
              f"{agree:.4f} of the rows < {MA_ARGMAX}")
        for got_launches in launches[tp] if on_card else ():
            check(got_launches == want[tp], f"{phase}: {tp} mode flash "
                  f"launches {got_launches}, expected {want[tp]}")
    out["serve"] = res
    del got, refs, one, row_one
    free()
    # (c) one VFL round on a (2, 2) mesh, four ranks on the card
    n = MA_VFL_VEHICLES * MA_VFL_MODEL
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        with _alloc_conf("expandable_segments:True"):
            run_world(_model_axis_vfl_rank, n, tmp, vcfg, MA_VFL_MODEL,
                      batch, seq, lr, device=device.type,
                      shared_card=on_card, timeout_s=900)
        world_s = time.perf_counter() - t0
        ranks = [torch.load(f"{tmp}/vfl_rank{r}.pt", weights_only=False)
                 for r in range(n)]
        whole = torch.load(f"{tmp}/vfl_params.pt", weights_only=False)
    res = _vfl_against_one_process(
        device, vcfg, ranks, whole, batch, seq, lr, phase,
        f"(c) ({MA_VFL_VEHICLES}, {MA_VFL_MODEL}) mesh, the world "
        f"{world_s:.1f} s:")
    res["world_s"] = world_s
    out["vfl"] = res
    # per rank and round: each attention forward and its remat
    # recomputation, and the eval forward; one veds_score and one p4_solve
    # a slot
    want = {"flash_attention": n_attn * 3, "veds_score": VFL_SLOTS,
            "p4_solve": VFL_SLOTS, "ssd_scan": 0}
    for x in ranks if on_card else ():
        check(x["launches"] == want, f"{phase}: launches {x['launches']}, "
              f"expected {want}")
    del whole
    free()
    return out


def _vfl_against_one_process(device, vcfg, ranks, whole, batch: int,
                             seq: int, lr: float, phase: str, label: str,
                             bound=MA_VFL_WITNESS_RATIO,
                             min_held: float = 1.0):
    """The one-process round of `launch/train.py`'s `train` for `vcfg` at
    seed 0 beside the ranks' (`ranks`: each rank's saved result; `whole`:
    vehicle 0's parameters before and after, gathered), then again with
    every weight of the parameters' dtype (bf16, or fp32) moved by one
    ulp, alike in every vehicle's copy: masks identical, and each held
    leaf's update no further from one process's than `bound` times how
    far the move shifts one process's own update of that leaf (the
    witness). A leaf is held where `bound` times its witness stays below
    1 (a zero update would fail); the held leaves must hold at least
    `min_held` of the entries (1: every leaf). `bound` None logs the
    distances and holds none. `label` names the run in the log."""
    from repro_torch.launch.train import train
    from repro_torch.models.module import tree_map

    # the one-process round, then again with every bf16 weight moved by
    # one ulp (the least move bf16 has), alike in every vehicle's copy
    # (copies moved apart would part the aggregate from them): how far
    # that moves each leaf's update is the model's own sensitivity at
    # bf16 (the witness)
    def moved_alike(params_v):
        first = bf16_ulp_moved(tree_map(lambda x: x[:1], params_v),
                               torch.Generator(device=device).manual_seed(23),
                               device, vcfg.pdtype)
        return tree_map(lambda m, x: m.expand_as(x).contiguous(), first,
                        params_v)
    one = {}
    for tag, move in (("one", None), ("moved", moved_alike)):
        _peak_gb(device, reset=True)
        with round0_params(move) as got:
            hist = train(vcfg, rounds=1, batch_per_vehicle=batch, seq=seq,
                         lr=lr, seed=0, device=device, log=lambda m: None)
        one[tag] = dict(new=_named(got["new"]), old=_named(got["old"]),
                        mask=got["mask"], wall_s=hist[0]["wall_s"],
                        loss=hist[0]["loss"], peak_gb=_peak_gb(device))
    mine, moved = one["one"], one["moved"]
    upd, wit, equal, total = {}, {}, 0, 0
    for k, b0 in mine["new"].items():
        check(torch.equal(whole["old"][k].to(device), mine["old"][k]),
              f"{phase}: the ranks' initial {k} is not one process's")
        a = whole["new"][k].to(device)
        step = b0.float() - mine["old"][k].float()
        norm = float(step.norm()) or 1.0
        upd[k] = float((a.float() - b0.float()).norm()) / norm
        wit[k] = float((moved["new"][k].float() - moved["old"][k].float()
                        - step).norm()) / norm
        equal += int((a == b0).sum())
        total += a.numel()
    ratio = {k: upd[k] / wit[k] if wit[k] else (0.0 if upd[k] == 0 else
                                                math.inf) for k in upd}
    worst, worst_wit = max(ratio, key=ratio.get), max(wit, key=wit.get)
    masks = [x["mask"] for x in ranks]
    res = dict(masks=masks, one_mask=mine["mask"],
               moved_mask=moved["mask"], update_distance=upd,
               ulp_witness=wit, witness_ratio=ratio,
               equal_share=equal / total, ranks=ranks,
               one_wall_s=mine["wall_s"], one_loss=mine["loss"],
               one_max_memory_gb=mine["peak_gb"])
    log(phase, f"{label} one VFL round, {len(ranks)} ranks on one card "
        f"over gloo, {vcfg.name} {vcfg.n_rep} reps, "
        f"{batch} x {seq} tokens a vehicle, lr {lr}: masks "
        f"{masks} (one process {mine['mask']}, weights moved one ulp "
        f"{moved['mask']}); losses {[round(x['loss'], 4) for x in ranks]} "
        f"(one process {mine['loss']:.4f}); each leaf's update from one "
        f"process's, norm-wise: worst {max(upd.values()):.4e} "
        f"({max(upd, key=upd.get)}); the witness, one process's update "
        f"moved by a one-ulp move of every weight: worst {wit[worst_wit]:.4e} "
        f"({worst_wit}); largest ratio of the two {ratio[worst]:.4f} "
        f"({worst}: {upd[worst]:.4e} against {wit[worst]:.4e}); by leaf "
        f"{ {k: (round(upd[k], 5), round(wit[k], 5)) for k in upd} }; bf16 "
        f"entries equal {equal / total:.4f}; walls "
        f"{[round(x['wall_s'], 2) for x in ranks]} s a rank (one process "
        f"{mine['wall_s']:.2f} s), stages rank 0 "
        f"{[(s, round(ms, 1)) for s, ms in ranks[0]['stages']]}; launches "
        f"{[x['launches'] for x in ranks]}; peak memory a rank "
        f"{[round(x['max_memory_gb'], 2) for x in ranks]} GB (one process "
        f"{mine['peak_gb']:.2f}); {smi_line()}")
    check(all(m == mine["mask"] for m in masks + [moved["mask"]]),
          f"{phase}: masks {masks} (moved weights {moved['mask']}) differ "
          f"from one process's {mine['mask']}")
    if bound is not None:
        held = [k for k in wit if bound * wit[k] < 1.0]
        size = {k: x.numel() for k, x in mine["new"].items()}
        share = sum(size[k] for k in held) / sum(size.values())
        res.update(held=held, held_share=share)
        log(phase, f"{label} held to {bound} x the witness: "
            f"{len(held)} of {len(wit)} leaves, {share:.6f} of the entries"
            f" (not held, their witness above 1 / {bound}: "
            f"{sorted(set(wit) - set(held))})")
        check(share >= min_held, f"{phase}: a one-ulp move of the weights "
              f"moves {worst_wit}'s update by {wit[worst_wit]:.4e} of its "
              f"norm; the leaves where a bound of {bound} times the witness "
              f"would fail a zero update hold {share:.6f} of the entries < "
              f"{min_held}")
        worst = max(held, key=ratio.get)
        check(ratio[worst] <= bound, f"{phase}: {worst}'s update "
              f"{upd[worst]:.4e} from one process's, {ratio[worst]:.4f} "
              f"times its one-ulp witness {wit[worst]:.4e} > {bound}")
    del one, mine, moved
    free()
    return res


def _ssm_serve_runs(zcfg, xcfg, zshape, xshape, fp32_shape):
    """(tag, config, (batch, prompt, cache slots, steps)) of
    phase_model_axis_ssm's serving runs: zamba2 and xlstm as given (bf16),
    then their smoke configs in fp32 (the SSM chunk 32, a chunk both
    `ssd_scan` kernels take)."""
    from repro_torch.configs.registry import get_smoke_config
    fp32 = dict(compute_dtype="float32", param_dtype="float32", remat=False,
                ssm_chunk=32)
    return [("zamba2", zcfg, zshape), ("xlstm", xcfg, xshape),
            ("zamba2_fp32", get_smoke_config("zamba2-2.7b").replace(**fp32),
             fp32_shape),
            ("xlstm_fp32", get_smoke_config("xlstm-1.3b").replace(**fp32),
             fp32_shape)]


def _ssm_vfl_runs(zcfg, batch: int, seq: int, lr: float):
    """(tag, config, batch, seq, lr, held) of phase_model_axis_ssm's VFL
    rounds, one vehicle each: zamba2 as given in bf16 (logged beside its
    witness, not held: at full depth a one-ulp move of the weights moves
    its update by more than its norm), then at 1 repetition in fp32, held
    to MA_SSM_VFL_RATIO times its witness."""
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    vcfg = zcfg.replace(num_vehicles=1)
    return [("zamba2", vcfg, batch, seq, lr, False),
            ("zamba2_1rep_fp32", vcfg.replace(n_rep=1, **fp32), batch, seq,
             lr, True)]


def block_grads(device, cfg, kinds, batch: int, seq: int, mesh=None,
                moved: bool = False):
    """The sub-blocks `kinds` of `cfg` (each at its first position in the
    pattern) as `phase_xlstm_blocks` runs them (its seeds: the init as
    `engine.model_decl` casts it, x and ct [batch, seq, d_model] in the
    config's dtype): y and the gradients of sum(y * ct) for every
    parameter and for x, with `moved` every bf16 weight moved by one ulp
    first (`bf16_ulp_moved`), over `mesh` (this rank's block of the
    parameters; the gradients gathered whole) or on one device. Returns
    {kind: dict(y, grads {name: tensor}, replicated {name: this rank's
    gradient of each leaf no dim of which is split}, ms)}, tensors on
    the CPU."""
    from repro_torch.models import blocks as B
    from repro_torch.models import engine
    from repro_torch.models.module import (materialize, tree_leaves,
                                           tree_map, tree_unflatten)
    from repro_torch.sharding.model_axis import gather_params, shard_params
    from repro_torch.sharding.rules import default_rules
    rules = default_rules()
    decl = engine.model_decl(cfg.replace(n_rep=1), "head")
    params = materialize(torch.Generator(device=device).manual_seed(41),
                         decl)
    if moved:
        params = bf16_ulp_moved(params, torch.Generator(
            device=device).manual_seed(43), device)
    local = params if mesh is None else shard_params(mesh, params, decl)
    del params
    g = torch.Generator(device=device).manual_seed(42)
    x = torch.randn((batch, seq, cfg.d_model), generator=g,
                    device=device).to(cfg.dtype)
    ct = torch.randn(x.shape, generator=g, device=device).to(cfg.dtype)
    out = {}
    for kind in kinds:
        apply = getattr(B, f"{kind}_apply")
        i = cfg.pattern.index(kind)
        p = tree_map(lambda a: a[0], local["blocks"][i])
        leaves = [a.detach().requires_grad_() for a in tree_leaves(p)]
        xx = x.detach().requires_grad_()
        _sync(device)
        t0 = time.perf_counter()
        y = apply(tree_unflatten(p, leaves), xx, cfg, mesh=mesh)
        gr = torch.autograd.grad((y.float() * ct.float()).sum(),
                                 leaves + [xx])
        _sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        gtree = tree_unflatten(p, list(gr[:-1]))
        whole = gtree if mesh is None else tree_map(
            lambda a: a[0], gather_params(mesh, tree_map(
                lambda a: a[None], gtree), decl["blocks"][i]))
        rep = {k for k, d in _named(decl["blocks"][i]).items()
               if all(rules.mesh_axis(a) != "model" for a in d.axes)}
        out[kind] = dict(
            y=y.detach().cpu(), ms=ms,
            grads={**{k: v.cpu() for k, v in _named(whole).items()},
                   "/x": gr[-1].cpu()},
            replicated={k: v.cpu() for k, v in _named(gtree).items()
                        if k in rep})
        del y, gr, gtree, whole, leaves, xx
    return out


def _ssm_axis_rank(rank: int, out_dir: str, serve_runs, blocks, shape,
                   vfl_runs) -> None:
    """One rank of phase_model_axis_ssm's world (a (1, n) mesh on the
    shared card): each serving run of `serve_runs` on this rank's block
    of the seeded parameters (rank 0 saves the logits; every rank its
    walls, launches and peak memory); then for each (config, kinds) of
    `blocks` those sub-blocks forward and backward on `shape` = (batch,
    seq) tokens (`block_grads`: rank 0 saves the outputs and gradients,
    every rank its replicated leaves' gradients); then each round of
    `vfl_runs` (`_ssm_vfl_runs`) through `launch/train.py`'s `train` on
    the same mesh (`_vfl_round_on_mesh`, into out_dir/<tag>)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import engine
    from repro_torch.sharding.mesh_exec import world_device
    from repro_torch.sharding.model_axis import shard_params
    from repro_torch.sharding.policy import attention_tp_mode
    torch.backends.cuda.matmul.allow_tf32 = False
    device = world_device()
    n = torch.distributed.get_world_size()
    mesh = make_host_mesh(n)
    res = {}
    for tag, cfg, (batch, prompt, cache_len, steps) in serve_runs:
        t0 = time.perf_counter()
        _peak_gb(device, reset=True)
        tp = attention_tp_mode(cfg.num_heads, n)
        params = shard_params(mesh, _ma_params(cfg, device),
                              engine.model_decl(cfg, tp))
        r = serve_logits(params, cfg, tp, _ma_prompts(
            batch, prompt, cfg.vocab_size, device), cache_len, steps, mesh)
        r["max_memory_gb"] = _peak_gb(device)
        logits = {k: r.pop(k).cpu() for k in ("prefill", "decode")}
        if rank == 0:
            torch.save(logits, f"{out_dir}/{tag}_logits.pt")
        del params, logits
        free()
        r["wall_s"] = time.perf_counter() - t0
        res[tag] = r
    for cfg, kinds in blocks:
        t0 = time.perf_counter()
        _peak_gb(device, reset=True)
        got = block_grads(device, cfg, kinds, *shape, mesh)
        res[cfg.name] = dict(wall_s=time.perf_counter() - t0,
                             max_memory_gb=_peak_gb(device),
                             ms={k: v["ms"] for k, v in got.items()})
        torch.save({k: v["replicated"] for k, v in got.items()},
                   f"{out_dir}/{cfg.name}_replicated{rank}.pt")
        if rank == 0:
            torch.save({k: dict(y=v["y"], grads=v["grads"])
                        for k, v in got.items()}, f"{out_dir}/{cfg.name}.pt")
        del got
        free()
    for tag, cfg, batch, seq, lr, _ in vfl_runs:
        t0 = time.perf_counter()
        _vfl_round_on_mesh(rank, f"{out_dir}/{tag}", cfg, n, batch, seq, lr)
        res[f"vfl_{tag}"] = dict(wall_s=time.perf_counter() - t0)
        free()
    torch.save(res, f"{out_dir}/ssm_rank{rank}.pt")


def _norm_distance(a, b) -> float:
    """|a - b| / |b|, norm-wise, in float64 (0 where both are 0)."""
    a, b = a.double(), b.double()
    d, nb = float((a - b).norm()), float(b.norm())
    return d / nb if nb else (0.0 if d == 0 else math.inf)


def _blocks_against_one_rank(device, cfg, kinds, shape, got, got_rep, ranks,
                             phase: str):
    """phase_model_axis_ssm (b'): the ranks' sub-blocks `kinds` of `cfg`
    (`got`: rank 0's outputs and whole gradients; `got_rep`: each rank's
    gradients of the replicated leaves) against one rank and its one-ulp
    witness (`block_grads`), norm-wise name by name: every ratio within
    MA_BLOCK_WITNESS_RATIO, every witness below 1 / that (so that a zero
    would fail), the replicated leaves' gradients bit for bit equal on
    every rank."""
    t0 = time.perf_counter()
    one = block_grads(device, cfg, kinds, *shape)
    moved = block_grads(device, cfg, kinds, *shape, moved=True)

    def pick(d, k):
        return d["y"] if k == "/y" else d["grads"][k]
    res = {}
    for kind in kinds:
        names = ["/y"] + list(one[kind]["grads"])
        dist = {k: _norm_distance(pick(got[kind], k), pick(one[kind], k))
                for k in names}
        wit = {k: _norm_distance(pick(moved[kind], k), pick(one[kind], k))
               for k in names}
        ratio = {k: dist[k] / wit[k] if wit[k] else
                 (0.0 if dist[k] == 0 else math.inf) for k in names}
        worst, worst_wit = max(ratio, key=ratio.get), max(wit, key=wit.get)
        rep = got_rep[0][kind]
        equal = all(torch.equal(rep[k], x[kind][k]) for x in got_rep[1:]
                    for k in rep)
        ms = [x[cfg.name]["ms"][kind] for x in ranks]
        res[kind] = dict(distance=dist, witness=wit, witness_ratio=ratio,
                         replicated_equal=equal, replicated=sorted(rep),
                         one_rank_ms=one[kind]["ms"], ranks_ms=ms)
        log(phase, f"(b') {cfg.name} {kind} sub-block at full width "
            f"({cfg.param_dtype}), {shape[0]} x {shape[1]} tokens, forward "
            f"and backward, {len(ranks)} ranks against one: norm-wise "
            f"distance worst {max(dist.values()):.4e} "
            f"({max(dist, key=dist.get)}); the witness (one rank, every bf16 "
            f"weight moved one ulp) worst {wit[worst_wit]:.4e} "
            f"({worst_wit}); largest ratio {ratio[worst]:.4f} ({worst}: "
            f"{dist[worst]:.4e} against {wit[worst]:.4e}); by name "
            f"{ {k: (round(dist[k], 6), round(wit[k], 6)) for k in names} }"
            f"; replicated leaves {sorted(rep)} bit for bit equal on every "
            f"rank: {equal}; walls a rank {[round(x, 1) for x in ms]} ms "
            f"(one rank {one[kind]['ms']:.1f})")
        check(equal, f"{phase}: {kind}'s replicated gradients differ "
              f"between the ranks")
        check(MA_BLOCK_WITNESS_RATIO * wit[worst_wit] < 1.0, f"{phase}: a "
              f"one-ulp move moves {kind}'s {worst_wit} by "
              f"{wit[worst_wit]:.4e} of its norm: a bound of "
              f"{MA_BLOCK_WITNESS_RATIO} times that would pass a zero")
        check(ratio[worst] <= MA_BLOCK_WITNESS_RATIO, f"{phase}: {kind}'s "
              f"{worst} {dist[worst]:.4e} from one rank, {ratio[worst]:.4f} "
              f"times its witness {wit[worst]:.4e} > "
              f"{MA_BLOCK_WITNESS_RATIO}")
    res["one_rank_s"] = time.perf_counter() - t0
    return res


def phase_model_axis_ssm(device, zcfg=None, xcfg=None,
                         block_shape=(VFL_BATCH, VFL_SEQ),
                         parts=("b", "b'", "c"), serve_runs=None,
                         vfl_runs=None):
    """The model axis of Mamba2, the mLSTM and the sLSTM on MA_SERVE_RANKS
    ranks sharing the card over gloo (`run_world(shared_card=True)`), a
    (1, n) mesh, one world for the whole phase, each run against one
    rank (one process, no mesh) on the same seeds:

    (b) the serving path (`serve_logits`: prefill, then decode steps from
    a zero cache of this rank's block) of zamba2-2.7b at full width and
    depth at DECODE_ZAMBA2_BATCH rows (the cache's 32768 slots cut to
    16384 a rank, Mamba2's state by heads) and of xlstm-1.3b at full
    width (XLSTM_REPS repetitions) at decode_32k's 128 rows (the mLSTM's
    C and n by rows of the head dim), each within MA_SERVE_WITNESS_RATIO
    times the witness (one rank's own logits moved by a one-ulp move of
    every weight), argmax agreement logged; the smoke configs in fp32
    within MA_FP32_TOL of max|logit| (the fp32 `ssd_scan` kernel at 4
    heads a rank); launches a rank: `ssd_scan` 45 and `flash_attention`
    9 in zamba2's prefill, none in its steps, none of either on xlstm.
    (b') zamba2's Mamba2 and xlstm's mLSTM and sLSTM sub-blocks at full
    width, forward and backward (`_blocks_against_one_rank`).
    (c) the VFL rounds of `_ssm_vfl_runs` on the (1, n) mesh against one
    process (`_vfl_against_one_process`: masks identical, launches a
    rank as counted; the held round's updates within MA_SSM_VFL_RATIO of
    their witness).

    `parts` names the parts to run; `serve_runs` and `vfl_runs`, where
    given, replace (b)'s and (c)'s runs (`_ssm_serve_runs`,
    `_ssm_vfl_runs` at other shapes). The configurations and shapes may
    be cut to rehearse the phase on the CPU (gloo ranks, no launch
    counted)."""
    import tempfile
    from repro_torch.launch.mesh import run_world
    phase = "model_axis_ssm"
    t_phase = time.perf_counter()
    on_card = device.type == "cuda"
    zcfg = zcfg or vfl_config("zamba2-2.7b", ZAMBA2_REPS)
    xcfg = xcfg or vfl_config("xlstm-1.3b", XLSTM_REPS)
    runs = serve_runs or (
        _ssm_serve_runs(zcfg, xcfg, MA_ZAMBA2_SERVE, MA_XLSTM_SERVE,
                        MA_FP32_SERVE) if "b" in parts else [])
    blocks = ([(zcfg, ("mamba",)), (xcfg, ("mlstm", "slstm"))]
              if "b'" in parts else [])
    vfl_runs = vfl_runs or (
        _ssm_vfl_runs(zcfg, MA_SSM_VFL_BATCH, VFL_SEQ, ZAMBA2_LR)
        if "c" in parts else [])
    n = MA_SERVE_RANKS
    out = {}
    free()
    with tempfile.TemporaryDirectory() as tmp:
        for tag, *_ in vfl_runs:
            os.makedirs(f"{tmp}/{tag}")
        t0 = time.perf_counter()
        with _alloc_conf("expandable_segments:True"):
            run_world(_ssm_axis_rank, n, tmp, runs, blocks, block_shape,
                      vfl_runs, device=device.type, shared_card=on_card,
                      timeout_s=900)
        world_s = time.perf_counter() - t0

        def load(name):
            return torch.load(f"{tmp}/{name}.pt", weights_only=False)
        ranks = [load(f"ssm_rank{r}") for r in range(n)]
        got = {tag: load(f"{tag}_logits") for tag, _, _ in runs}
        got_blocks = {cfg.name: (load(cfg.name), [
            load(f"{cfg.name}_replicated{r}") for r in range(n)])
            for cfg, _ in blocks}
        got_vfl = {tag: ([load(f"{tag}/vfl_rank{r}") for r in range(n)],
                         load(f"{tag}/vfl_params"))
                   for tag, *_ in vfl_runs}
    out["world_s"] = world_s
    walls = {k: [round(x[k]["wall_s"], 1) for x in ranks] for k in ranks[0]}
    log(phase, f"the world of {n} ranks on one card over gloo: {world_s:.1f}"
        f" s; walls a rank {walls} s")

    # (b) serving against one rank
    serve = {}
    for tag, cfg, (batch, prompt, cache_len, steps) in runs:
        t0 = time.perf_counter()
        params = _ma_params(cfg, device)
        prompts = _ma_prompts(batch, prompt, cfg.vocab_size, device)
        one = serve_logits(params, cfg, "head", prompts, cache_len, steps)
        one = {k: v.cpu() if torch.is_tensor(v) else v
               for k, v in one.items()}
        moved = serve_logits(bf16_ulp_moved(params, torch.Generator(
            device=device).manual_seed(29), device, cfg.pdtype), cfg,
            "head", prompts, cache_len, steps)
        moved = {k: moved[k].cpu() for k in ("prefill", "decode")}
        del params
        free()

        def rows(r):
            return torch.cat([r["prefill"][None], r["decode"]])
        dist, agree = _logit_distance(rows(got[tag]), rows(one))
        wit, wit_agree = _logit_distance(rows(moved), rows(one))
        r = dict(distance=dist, argmax_agree=agree, witness=wit,
                 witness_argmax_agree=wit_agree,
                 witness_ratio=dist / wit if wit else math.inf,
                 distance_prefill=_logit_distance(got[tag]["prefill"],
                                                  one["prefill"]),
                 distance_decode=_logit_distance(got[tag]["decode"],
                                                 one["decode"]),
                 ranks=[x[tag] for x in ranks],
                 one_rank={k: v for k, v in one.items()
                           if not torch.is_tensor(v)})
        bound = (f"the witness {wit:.4e} (argmax {wit_agree:.4f}) x "
                 f"{MA_SERVE_WITNESS_RATIO}: ratio {r['witness_ratio']:.4f}")
        ok = dist <= MA_SERVE_WITNESS_RATIO * wit
        if cfg.param_dtype == "float32":
            bound = f"{MA_FP32_TOL} of max|logit| (beside {bound})"
            ok = dist <= MA_FP32_TOL
        n_mamba = cfg.n_rep * cfg.pattern.count("mamba")
        n_attn = cfg.n_rep * cfg.pattern.count("attn")
        want = ({"flash_attention": n_attn, "ssd_scan": n_mamba,
                 "fedavg_agg": 0, "veds_score": 0, "p4_solve": 0},
                {"flash_attention": 0, "ssd_scan": 0, "fedavg_agg": 0,
                 "veds_score": 0, "p4_solve": 0})
        launches = [(x[tag]["prefill_counts"], x[tag]["step_counts"])
                    for x in ranks]
        r["want_launches"] = want
        serve[tag] = r
        log(phase, f"(b) {tag} ({cfg.name}, {cfg.n_rep} reps, "
            f"{cfg.param_dtype}), batch {batch}, prompts of {prompt}, "
            f"{steps} steps, cache {cache_len} "
            f"({[round(x[tag]['cache_gb'], 3) for x in ranks]} GB a rank, "
            f"one rank {one['cache_gb']:.3f}): logits from one rank "
            f"{dist:.4e} of max|logit| (prefill "
            f"{r['distance_prefill'][0]:.4e}, decode "
            f"{r['distance_decode'][0]:.4e}), argmax equal in {agree:.4f} "
            f"of the {rows(one).shape[0] * rows(one).shape[1]} rows; bound "
            f"{bound}; rank 0 prefill {ranks[0][tag]['prefill_ms']:.1f} ms, "
            f"a step {ranks[0][tag]['step_ms']:.2f} ms (one rank "
            f"{one['prefill_ms']:.1f}, {one['step_ms']:.2f}); launches a "
            f"rank (prefill, steps) {launches}; peak memory a rank "
            f"{[round(x[tag]['max_memory_gb'], 2) for x in ranks]} GB; "
            f"one rank's runs {time.perf_counter() - t0:.1f} s; "
            f"{smi_line()}")
        check(ok, f"{phase}: {tag} logits {dist:.4e} of max|logit| from one "
              f"rank, beyond {bound}")
        for x in launches if on_card else ():
            check(x == want, f"{phase}: {tag} launches {x}, expected {want}")
        del moved
    out["serve"] = serve

    # (b') the sub-blocks, forward and backward
    out["blocks"] = {}
    for cfg, kinds in blocks:
        out["blocks"][cfg.name] = _blocks_against_one_rank(
            device, cfg, kinds, block_shape, *got_blocks.pop(cfg.name),
            ranks, phase)
        free()

    # (c) the VFL rounds on the (1, n) mesh
    out["vfl"] = {}
    for tag, vcfg, batch, seq, lr, held in vfl_runs:
        vfl_ranks, whole = got_vfl.pop(tag)
        res = _vfl_against_one_process(
            device, vcfg, vfl_ranks, whole, batch, seq, lr, phase,
            f"(c) {tag}, (1, {n}) mesh:",
            bound=MA_SSM_VFL_RATIO if held else None,
            min_held=MA_SSM_VFL_HELD)
        n_attn = vcfg.n_rep * vcfg.pattern.count("attn")
        n_mamba = vcfg.n_rep * vcfg.pattern.count("mamba")
        # per rank: each sub-block's forward and its remat recomputation,
        # and the eval forward; one veds_score and one p4_solve a slot
        want = {"flash_attention": n_attn * 3, "ssd_scan": n_mamba * 3,
                "veds_score": VFL_SLOTS, "p4_solve": VFL_SLOTS}
        for x in vfl_ranks if on_card else ():
            check(x["launches"] == want, f"{phase}: (c) {tag} launches "
                  f"{x['launches']}, expected {want}")
        res["want_launches"] = want
        out["vfl"][tag] = res
        del whole
        free()
    out["wall_s"] = time.perf_counter() - t_phase
    log(phase, f"the phase took {out['wall_s']:.1f} s")
    return out


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


@contextlib.contextmanager
def _dispatch_log():
    """Log every `SchedulingService.run_batch` call made inside the
    block, whichever service makes it: the service, its device, the
    thread it ran on, its requests and responses, its tier, the slot
    graphs it captured and its `veds_score` launches (read on that
    thread before and after; reading synchronises, and `run_batch` ends
    synchronised anyway). Yields the list of records."""
    from repro_torch.core import veds as V
    from repro_torch.kernels.veds_score.ops import veds_dt_score
    from repro_torch.launch.serve import SchedulingService
    real = SchedulingService.run_batch
    records = []

    def logged(self, reqs, **kw):
        n0, c0 = veds_dt_score.launches, V._SlotGraph.captures
        out = real(self, reqs, **kw)
        records.append(dict(
            service=id(self), device=str(self.device),
            thread=threading.get_ident(), reqs=list(reqs), resps=out,
            tier=out[0].tier, captures=V._SlotGraph.captures - c0,
            launches=veds_dt_score.launches - n0))
        return out

    SchedulingService.run_batch = logged
    try:
        yield records
    finally:
        SchedulingService.run_batch = real


def _horizon(tier: str) -> int:
    return int(tier[1:].split("x")[0])


def _check_dispatches(records, n_slots: int, phase: str):
    """Each service's dispatches all ran on one thread that is not this
    (the event loop's) thread, captured no slot graph, and launched
    `veds_score` T times a packed round."""
    main_thread = threading.get_ident()
    by_service = {}
    for r in records:
        by_service.setdefault(r["service"], set()).add(r["thread"])
    check(all(len(t) == 1 and main_thread not in t
              for t in by_service.values()),
          f"{phase}: dispatches off their server's one executor thread: "
          f"{by_service}, event loop {main_thread}")
    check(all(r["captures"] == 0 for r in records),
          f"{phase}: a dispatch captured a slot graph")
    bad = [(r["tier"], r["launches"]) for r in records
           if r["launches"] != n_slots * _horizon(r["tier"])]
    check(not bad, f"{phase}: veds_score launches differ from T x L: {bad}")


def _summary_line(s) -> str:
    return (f"{s['n_requests']} requests in {s['n_batches']} dispatches, "
            f"{s['rounds_per_s']:.2f} rounds/s, mean occupancy "
            f"{s['mean_occupancy']:.2f}, tier hits {s['tier_hits']}; "
            f"queue wait p50 {s['p50_queue_wait_ms']:.1f} / p99 "
            f"{s['p99_queue_wait_ms']:.1f} ms, compute p50 "
            f"{s['p50_compute_ms']:.1f} / p99 {s['p99_compute_ms']:.1f} ms, "
            f"total p50 {s['p50_ms']:.1f} / p99 {s['p99_ms']:.1f} ms; "
            f"spills {s['n_spills']}, restores {s['n_restores']}, slot "
            f"graphs captured {s['n_captures']}")


def phase_serve_front(device):
    """The service's asyncio front end at fig10's width (the service of
    `phase_serve`). (a) `drive()`: a closed loop of SERVE_SESSIONS
    clients each sending SERVE_MIX's round counts, through `BatchServer`,
    then the sequential B = 1 baseline, each service warmed up before its
    server opens. (b) A Poisson load through `BatchServer` at half (a)'s
    batched requests/s, its dispatch log replayed through `run_batch` on
    a fresh service: every response and stored carry bit for bit. (c)
    `main()` with no `--device`: the command line runs on the card. In
    every load each dispatch runs on its server's executor thread,
    captures no slot graph and launches `veds_score` T times a packed
    round; `veds_score`'s count over (a) and over (b)'s load is reported
    per path."""
    import dataclasses
    from repro_torch.kernels.veds_score.ops import veds_dt_score
    from repro_torch.launch import serve as S
    cfg = _serve_fig10_config()
    T = cfg.n_slots
    seq_cfg = dataclasses.replace(cfg, batch=1, batch_tiers=None)
    warm_rounds = cfg.horizons[0] * (len(cfg.occupancies)
                                     + len(seq_cfg.occupancies))
    n_rounds = SERVE_SESSIONS * sum(SERVE_MIX)

    # (a) the closed loop and the sequential baseline
    with _dispatch_log() as closed_log:
        veds_dt_score.launches = 0
        t0 = time.perf_counter()
        closed = S.drive(cfg, n_clients=SERVE_SESSIONS,
                         n_requests=len(SERVE_MIX), n_rounds=SERVE_MIX,
                         device=device)
        closed_s = time.perf_counter() - t0
        closed_launches = veds_dt_score.launches
    _check_dispatches(closed_log, T, "serve_front closed")
    b, q = closed["batched"], closed["sequential"]
    check(b["n_captures"] == 0 and q["n_captures"] == 0,
          "serve_front closed: the loads captured slot graphs")
    check(b["n_requests"] == q["n_requests"]
          == SERVE_SESSIONS * len(SERVE_MIX)
          and b["n_batches"] + q["n_batches"] == len(closed_log),
          "serve_front closed: requests or dispatches lost")
    check(q["mean_occupancy"] == 1.0 and q["n_batches"] == q["n_requests"],
          "serve_front closed: the sequential baseline packed requests")
    want = T * (sum(_horizon(r["tier"]) for r in closed_log) + warm_rounds)
    check(closed_launches == want, f"serve_front closed: veds_score "
          f"launched {closed_launches} times over drive(), expected {want}")
    check(all(np.isfinite(r.loss).all() for d in closed_log
              for r in d["resps"]), "serve_front closed: a loss not finite")
    log("serve_front", f"(a) drive() closed loop, {SERVE_SESSIONS} clients x "
        f"{SERVE_MIX} rounds, window {1e3 * cfg.window_s:.1f} ms, in "
        f"{closed_s:.1f} s: batched: {_summary_line(b)}")
    log("serve_front", f"(a) sequential B = 1: {_summary_line(q)}")
    log("serve_front", f"(a) speedup {closed['speedup']:.2f}x rounds/s; "
        f"veds_score launches {closed_launches} (= T {T} x ({len(closed_log)}"
        f" load dispatches' horizons + {warm_rounds} warm-up rounds)); "
        f"dispatch threads {len({r['thread'] for r in closed_log})}, none "
        f"the event loop's")

    # (b) a Poisson load at half the closed loop's request rate
    rate = 0.5 * b["rounds_per_s"] * b["n_requests"] / n_rounds
    svc = S.SchedulingService(cfg, device=device)
    svc.warmup()
    loop_thread = []

    async def go():
        loop_thread.append(threading.get_ident())
        async with S.BatchServer(svc) as srv:
            return await S.poisson_load(
                srv, n_clients=SERVE_SESSIONS, rate_hz=rate,
                n_requests=len(SERVE_MIX), n_rounds=SERVE_MIX)

    with _dispatch_log() as poisson_log:
        veds_dt_score.launches = 0
        t0 = time.perf_counter()
        got = asyncio.run(go())
        poisson_s = time.perf_counter() - t0
        poisson_launches = veds_dt_score.launches
    _check_dispatches(poisson_log, T, "serve_front poisson")
    check(loop_thread == [threading.get_ident()], "serve_front poisson: "
          "the event loop ran off the main thread")
    p = svc.metrics.summary()
    check(p["n_captures"] == 0, "serve_front poisson: the load captured "
          "slot graphs")
    check(len(got) == SERVE_SESSIONS * len(SERVE_MIX), "serve_front "
          "poisson: requests lost")
    want = T * sum(_horizon(r["tier"]) for r in poisson_log)
    check(poisson_launches == want, f"serve_front poisson: veds_score "
          f"launched {poisson_launches} times, expected {want}")
    log("serve_front", f"(b) Poisson at {rate:.3f} requests/s in "
        f"{poisson_s:.1f} s: {_summary_line(p)}; veds_score launches "
        f"{poisson_launches}")
    fresh = S.SchedulingService(cfg, device=device)
    fresh.warmup()
    for i, d in enumerate(poisson_log):
        for r, want_r in zip(fresh.run_batch(d["reqs"]), d["resps"]):
            check(r.tier == want_r.tier, "serve_front replay: tiers differ")
            _assert_bitwise(r, want_r, None, None,
                            f"serve_front replay, dispatch {i}")
    check(set(fresh.sessions) == set(svc.sessions), "serve_front replay: "
          "sessions differ")
    for s in sorted(svc.sessions):
        dist = _carry_distance(fresh.sessions[s], svc.sessions[s])
        check(all(d["equal"] for d in dist.values()),
              f"serve_front replay: {s}'s stored carry differs: {dist}")
    log("serve_front", f"(b) the dispatch log ({len(poisson_log)} dispatches)"
        f" replayed through run_batch on a fresh service: every response "
        f"and every stored carry ({len(svc.sessions)} sessions) bit for bit")
    svc.close()
    fresh.close()

    # (c) the command line with no --device
    buf = io.StringIO()
    with _dispatch_log() as main_log, contextlib.redirect_stdout(buf):
        rc = S.main(["--json", "--clients", "3", "--requests", "2"])
    out = json.loads(buf.getvalue())
    check(rc == 0 and all(r["device"].startswith("cuda") for r in main_log)
          and main_log, "serve_front main: did not serve on the card")
    check(all(math.isfinite(out[k]["rounds_per_s"])
              and math.isfinite(out[k]["p99_ms"])
              for k in ("batched", "sequential"))
          and math.isfinite(out["speedup"]), f"serve_front main: {out}")
    log("serve_front", f"(c) main(['--json', '--clients', '3', '--requests', "
        f"'2']) on {main_log[0]['device']}: batched "
        f"{out['batched']['rounds_per_s']:.1f} rounds/s, sequential "
        f"{out['sequential']['rounds_per_s']:.1f}, speedup "
        f"{out['speedup']:.2f}x")
    return dict(config=str(cfg), closed=closed, closed_s=closed_s,
                closed_dispatches=[dict(tier=r["tier"], n=len(r["reqs"]),
                                        launches=r["launches"])
                                   for r in closed_log],
                poisson_rate_hz=rate, poisson=p, poisson_s=poisson_s,
                poisson_dispatches=len(poisson_log), replay_bitwise=True,
                main=out,
                launches={"veds_score": {"closed": closed_launches,
                                         "poisson": poisson_launches}})


def _assert_bitwise(r, want, carry, want_carry, what):
    check(np.array_equal(r.success, want.success)
          and np.array_equal(r.n_success, want.n_success)
          and np.array_equal(r.loss, want.loss), f"{what}: the response "
          f"differs")
    if carry is None:
        return
    dist = _carry_distance(carry, want_carry)
    check(all(d["equal"] for d in dist.values()), f"{what}: the stored "
          f"carry differs: {dist}")


def dryrun_cases():
    """The one-rank cases of phase_dryrun: name -> (config, shape, how
    each was cut to one card)."""
    from repro_torch.configs.base import SHAPES_BY_NAME, ShapeConfig
    from repro_torch.configs.registry import get_config
    return {
        "zamba2_train": (
            get_config("zamba2-2.7b").replace(num_vehicles=4, grad_accum=1),
            ShapeConfig("train_16x1024", 1024, 16, "train"),
            "full width and depth; 4 vehicles of 4 x 1024 tokens and "
            "grad_accum 1 (phase_vfl's), the inline 50-slot VEDS round"),
        "qwen3_decode": (
            get_config("qwen3-32b").replace(n_rep=2),
            SHAPES_BY_NAME["decode_32k"],
            "depth cut to 2 of 64 repetitions; batch 128, 32768 slots"),
        "llama4_prefill": (
            get_config("llama4-scout-17b-a16e").replace(n_rep=1),
            ShapeConfig("prefill_8x32k", 32768, 8, "prefill"),
            "depth cut to 1 of 48 repetitions; batch cut from 32 to 8 "
            "(the fake trace's peak: 47.0 GB at 8), sequence 32768 whole"),
    }


def fake_case_main(name: str, out: str) -> int:
    """A background worker of phase_dryrun: the one-rank case `name`
    traced on fake CUDA tensors, its record written to `out`."""
    from repro_torch.launch.dryrun import trace_case
    cfg, shape, _ = dryrun_cases()[name]
    t0 = time.perf_counter()
    res = trace_case(cfg, shape, {"data": 1, "model": 1},
                     torch.device("cuda"), fake=True)
    res.pop("outputs")
    res["wall_s"] = time.perf_counter() - t0
    Path(out).write_text(json.dumps(res, indent=1))
    return 0


def sweep_cases():
    """(arch, shape, mesh) of phase_dryrun's production sweep."""
    from repro_torch.configs.base import SHAPES_BY_NAME
    pairs = [(a, s) for a in DRYRUN_SWEEP_ARCHS for s in SHAPES_BY_NAME]
    return [(a, s, m) for a, s in pairs + list(DRYRUN_EXTRA)
            for m in ("pod16x16", "pod2x16x16")]


def _run_fake_trace(name: str, argv) -> tuple:
    """One fake trace of phase_dryrun, its output to its own log under
    DRYRUN_OUT: (exit code, seconds, its end on the host's clock)."""
    t0 = time.perf_counter()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    with open(DRYRUN_OUT / f"{name}.log", "w") as logf:
        rc = subprocess.run(argv, cwd=ROOT, env=env, stdout=logf,
                            stderr=subprocess.STDOUT,
                            timeout=DRYRUN_JOB_TIMEOUT_S).returncode
    end = time.perf_counter()
    return rc, end - t0, end


@contextlib.contextmanager
def fake_traces():
    """The fake traces of phase_dryrun, run beside the phases inside this
    block: the three one-rank cases and the production sweep
    (`sweep_cases`), one process a case, DRYRUN_WORKERS at a time, the
    train cases (the longest) first. Yields ({name: future of
    `_run_fake_trace`'s tuple}, start); on leaving, the traces not
    started are cancelled and the running ones waited for."""
    DRYRUN_OUT.mkdir(parents=True, exist_ok=True)
    jobs = [(f"fake_{name}", [sys.executable, str(ROOT / "chip_smoke.py"),
                              "--fake-case", name, "--out",
                              str(DRYRUN_OUT / f"fake_{name}.json")])
            for name in dryrun_cases()]
    jobs += [(f"sweep_{arch}__{shape}__{mesh}", [
        sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
        "--shape", shape, "--out", str(DRYRUN_OUT), "--force"] + (
            ["--multi-pod"] if mesh == "pod2x16x16" else []))
        for arch, shape, mesh in sweep_cases()]
    jobs.sort(key=lambda j: "train" not in j[0])     # stable otherwise
    pool = concurrent.futures.ThreadPoolExecutor(DRYRUN_WORKERS)
    t0 = time.perf_counter()
    try:
        yield {name: pool.submit(_run_fake_trace, name, argv)
               for name, argv in jobs}, t0
    finally:
        pool.shutdown(wait=True, cancel_futures=True)


def phase_dryrun(device, traces):
    """The dry run held to the card: each one-rank case of `dryrun_cases`
    run for real (inputs drawn from a seed, the step under
    `FlopCounterMode`, the VEDS slot step eager as on fake tensors, every
    kernel count set to 0 first), then against its fake trace (`traces`):
    argument bytes and FLOPs equal, each kernel's calls in the trace equal
    to its launches on the card, the fake peak of live bytes within
    DRYRUN_PEAK_TOL of `max_memory_allocated` (both from the bytes live
    before the step, less the arguments); then the fake production sweep
    (`sweep_cases`), with its time and its critical path. `traces`: what
    `fake_traces` yields."""
    from unittest import mock
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.core import veds as veds_mod
    from repro_torch.kernels.fedavg_agg.ops import fedavg_agg
    from repro_torch.kernels.flash_attention.ops import flash_attention_fwd
    from repro_torch.kernels.p4_solve.ops import p4_solve
    from repro_torch.kernels.ssd_scan.ops import ssd_scan_fwd
    from repro_torch.kernels.veds_score.ops import veds_dt_score
    from repro_torch.launch.dryrun import storage_bytes
    from repro_torch.launch.op_costs import FLOP_FORMULAS
    from repro_torch.launch.specs import build_case
    counters = {"repro::flash_attention_fwd": flash_attention_fwd,
                "repro::ssd_scan_fwd": ssd_scan_fwd,
                "repro::fedavg_agg": fedavg_agg,
                "repro::veds_dt_score": veds_dt_score,
                "repro::p4_solve": p4_solve}
    res = {"cases": {}, "sweep": {}}
    for name, (cfg, shape, cut) in dryrun_cases().items():
        free()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        step, args = build_case(cfg, shape, {"data": 1, "model": 1}, device)
        args_b = storage_bytes(args)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with mock.patch.object(veds_mod, "_slots_graphed",
                               veds_mod._slots_eager), \
                FlopCounterMode(display=False,
                                custom_mapping=FLOP_FORMULAS) as fc:
            out = step(*args)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        real_peak = torch.cuda.max_memory_allocated() - base + args_b
        if shape.kind == "train":
            stats = out[1]
            log("dryrun", f"{name}: {int(stats['n_success'])} of "
                f"{cfg.num_vehicles} uploads succeeded")
        else:
            logits = out[0] if shape.kind == "decode" else out
            check(bool(torch.isfinite(logits).all()),
                  f"dryrun {name}: logits not finite")
            check(logits.shape[0] == shape.global_batch,
                  f"dryrun {name}: logits {tuple(logits.shape)}")
        del out, step, args
        launches = {op: c.launches for op, c in counters.items()}
        res["cases"][name] = dict(
            cut=cut, argument_bytes=args_b, build_s=build_s, step_s=step_s,
            launches=launches, flop_counter=fc.get_total_flops(),
            real_peak_bytes=real_peak)
        log("dryrun", f"{name} ({cut}) on the card: inputs built in "
            f"{build_s:.1f} s, the step (VEDS slots eager, under "
            f"FlopCounterMode) {step_s:.1f} s: arguments {args_b / 1e9:.3f} "
            f"GB, FLOPs {fc.get_total_flops():.4e}, peak "
            f"{real_peak / 1e9:.3f} GB, launches "
            f"{ {k.split('::')[1]: v for k, v in launches.items()} }")
        free()

    futures, t0 = traces
    done = {name: f.result() for name, f in futures.items()}
    sweep_s = max(end for _, _, end in done.values()) - t0
    for name, (rc, secs, _) in sorted(done.items()):
        log("dryrun", f"fake trace {name}: exit {rc} in {secs:.1f} s")
        check(rc == 0, f"fake trace {name} exited {rc} (see "
              f"chiprun_out/dryrun_torch/{name}.log)")
    for name, r in res["cases"].items():
        fake = json.loads((DRYRUN_OUT / f"fake_{name}.json").read_text())
        r["fake"] = fake
        calls = fake["kernels"]
        peak_err = abs(fake["peak_bytes"] - r["real_peak_bytes"]) / \
            r["real_peak_bytes"]
        r["peak_rel_err"] = peak_err
        log("dryrun", f"{name}: fake trace {fake['wall_s']:.1f} s, "
            f"{fake['n_ops']} ops in {fake['n_traces']} traces, scaled loops "
            f"{fake['scaled_loops']}; arguments "
            f"{fake['memory']['argument_bytes']}"
            f" B (card {r['argument_bytes']}), FLOPs "
            f"{fake['deep_cost']['dot_flops']:.6e} (card "
            f"{r['flop_counter']:.6e}), peak {fake['peak_bytes'] / 1e9:.3f} "
            f"GB (card {r['real_peak_bytes'] / 1e9:.3f}, {peak_err:.4f} "
            f"apart), kernel calls {calls}")
        check(fake["memory"]["argument_bytes"] == r["argument_bytes"],
              f"dryrun {name}: fake and card argument bytes differ")
        check(fake["deep_cost"]["dot_flops"] == r["flop_counter"],
              f"dryrun {name}: fake FLOPs {fake['deep_cost']['dot_flops']} "
              f"against the card's {r['flop_counter']}")
        for op, n in r["launches"].items():
            check(calls.get(op, 0) == n,
                  f"dryrun {name}: {op} called {calls.get(op, 0)} times in "
                  f"the trace, launched {n} times on the card")
        check(peak_err <= DRYRUN_PEAK_TOL,
              f"dryrun {name}: fake peak {fake['peak_bytes']} B against the "
              f"card's {r['real_peak_bytes']} B")
    zl = res["cases"]["zamba2_train"]["launches"]
    check(all(n > 0 for n in zl.values()),
          f"dryrun zamba2_train launched some kernel no time: {zl}")
    for arch, shape, mesh in sweep_cases():
        tag = f"{arch}__{shape}__{mesh}"
        rec = json.loads((DRYRUN_OUT / f"{tag}.json").read_text())
        rec["job_s"] = done[f"sweep_{tag}"][1]
        res["sweep"][tag] = rec
        m = rec["memory"]
        log("dryrun", f"sweep {arch} {shape} {mesh} rank 0: arguments "
            f"{m['argument_bytes'] / 1e9:.3f} GB, temp "
            f"{m['temp_bytes'] / 1e9:.3f} GB, FLOPs "
            f"{rec['cost']['flops']:.4e}, collectives "
            f"{ {k: v for k, v in rec['collectives_bytes'].items() if v} }, "
            f"{rec['n_ops']} ops in {rec['n_traces']} traces, traced in "
            f"{rec['timings']['trace_s']} s ({rec['job_s']:.1f} s with "
            f"start-up)")
    res["sweep_wall_s"] = sweep_s
    slowest = max(done, key=lambda name: done[name][1])
    res["critical_path"] = dict(name=slowest, seconds=done[slowest][1])
    log("dryrun", f"the fake traces (3 one-rank cases and the "
        f"{len(res['sweep'])}-case sweep, {DRYRUN_WORKERS} at a time) took "
        f"{sweep_s:.1f} s from the first's start to the last's end")
    log("time", f"the dry run's fake traces: {len(done)} in {sweep_s:.1f} "
        f"s, {DRYRUN_WORKERS} at a time; critical path {slowest} "
        f"{done[slowest][1]:.1f} s")
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fake-case", help=argparse.SUPPRESS)
    ap.add_argument("--out", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
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
    if args.fake_case:
        return fake_case_main(args.fake_case, args.out)
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

    return run_phases(device, smi, build_s, t_start)


def run_phases(device, smi, build_s, t_start) -> int:
    """Every phase after the build, in order: first those whose times are
    compared across runs, then, beside the dry run's fake traces (host
    work, `fake_traces`), those that hold values and the dry run. Each
    group of phases logs its wall time and the script's time so far."""
    last = [time.perf_counter()]

    def mark(done: str) -> None:
        now = time.perf_counter()
        log("time", f"{done}: {now - last[0]:.1f} s (script at "
            f"{now - t_start:.1f} s)")
        last[0] = now
    # the serving path's [B, S] at fig10's width on its occupancy rungs
    # (B 1 is the stream shape's)
    serve_shapes = {f"serve_b{b}": (b, SERVE_FIG10["n_sov"])
                    for b in (2, 4, 8)}
    kernels = phase_kernels({"main": (ROUND_BATCH, 10), "vfl": (1, 4),
                             "stream": (1, 10), "v2i_only": (1, 10),
                             **serve_shapes, "large": (1 << 22,)},
                            device, graphed=("main", "vfl", "stream",
                                             "v2i_only", *serve_shapes))
    p4_kernels = kernels.pop("p4_solve")
    llm_kernels = phase_kernels_llm(device)
    ssd_kernels = phase_kernels_ssd(device)
    mark("kernels")
    decode = phase_decode(device)
    mark("decode")
    main_res, setup = phase_main(device, ROUNDS, ROUND_BATCH)
    stages = phase_stages(device, setup)
    ref = phase_reference(device)
    stream = phase_stream(device, setup)
    stream_ref = phase_stream_reference(device)
    compare = phase_compare(device, setup)
    compare_ref = phase_compare_reference(device)
    stream_compare = phase_stream_compare(device, setup)
    mesh = phase_mesh(device, setup)
    mark("run_fl, streaming, the comparison and the mesh")
    del setup
    free()
    serve_ref = phase_serve_reference(device)
    serve = phase_serve(device)
    free()
    serve_front = phase_serve_front(device)
    mark("serving")
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
    mark("the VFL rounds of qwen3, zamba2 and granite")
    free()
    # the last two families at full width and depth: xLSTM, and whisper's
    # encoder with the cross-attention fed from it
    new_vfl = {}
    ckpt_dir = tempfile.mkdtemp()
    for arch, reps, lr, rounds in (
            ("xlstm-1.3b", XLSTM_REPS, XLSTM_LR, XLSTM_ROUNDS),
            ("whisper-small", WHISPER_REPS, WHISPER_LR, VFL_ROUNDS)):
        cfg = vfl_config(arch, reps)
        # whisper-small (279 M parameters) saves its last round's params
        ckpt = (f"{ckpt_dir}/{arch}.npz" if arch == "whisper-small"
                else None)
        res = phase_vfl(device, cfg, VFL_WARMUP, rounds, VFL_BATCH,
                        VFL_SEQ, lr,
                        RECORDED_MASKS[arch][:VFL_WARMUP + rounds],
                        ckpt=ckpt)
        free()
        if arch == "xlstm-1.3b":
            res["blocks"] = phase_xlstm_blocks(device, cfg, VFL_BATCH,
                                               VFL_SEQ, res)
            free()
        else:
            res["checkpoint"] = phase_checkpoint(
                device, cfg, ckpt, res["rounds"][-1]["loss"], VFL_SEQ)
            os.rmdir(ckpt_dir)
            free()
        new_vfl[arch] = (cfg, res)
    xlstm, whisper = new_vfl["xlstm-1.3b"][1], new_vfl["whisper-small"][1]
    mark("the VFL rounds of xlstm and whisper")
    # no time below is compared across runs: the phases hold values (the
    # model axis's ranks share the one card over gloo) beside the dry
    # run's fake traces
    with fake_traces() as traces:
        model_axis = phase_model_axis(device)
        mark("model_axis (beside the fake traces)")
        model_axis_ssm = phase_model_axis_ssm(device)
        mark("model_axis_ssm (beside the fake traces)")
        sensitivity = {
            "qwen3-32b": forward_sensitivity(
                device, vfl_config("qwen3-32b", VFL_REPS), VFL_SEQ),
            "zamba2-2.7b": forward_sensitivity(device, zcfg, VFL_SEQ),
            "granite-moe-1b-a400m": forward_sensitivity(device, gcfg,
                                                        VFL_SEQ),
            **{arch: forward_sensitivity(device, cfg, VFL_SEQ)
               for arch, (cfg, _) in new_vfl.items()}}
        free()
        vfl_ref = {"qwen3-32b": phase_vfl_reference(
                       device, "qwen3-32b", 2, atol=2e-4),
                   "zamba2-2.7b": phase_vfl_reference(
                       device, "zamba2-2.7b", 2, update_rtol=1e-1)}
        # the configurations without qk-norm, held as their CPU tests hold
        # them (tests/torch_ref_vfl.py MODEL_TOL)
        for arch in ("granite-moe-1b-a400m", "llama4-scout-17b-a16e",
                     "starcoder2-15b", "codeqwen1.5-7b", "minitron-4b"):
            vfl_ref[arch] = phase_vfl_reference(device, arch, 2,
                                                update_rtol=2e-2)
        # the last three families, whisper's and llama-3.2-vision's with
        # src; whisper at one encoder layer and one repetition, where the
        # reference's round is well conditioned at its init, as its CPU
        # test holds it (tests/test_torch_encdec.py)
        vfl_ref["xlstm-1.3b"] = phase_vfl_reference(
            device, "xlstm-1.3b", 1, update_rtol=2e-2)
        vfl_ref["whisper-small"] = phase_vfl_reference(
            device, "whisper-small", 1, update_rtol=2e-2, encoder_layers=1)
        vfl_ref["llama-3.2-vision-90b"] = phase_vfl_reference(
            device, "llama-3.2-vision-90b", 1, update_rtol=2e-2)
        mark("sensitivity and the card-vs-CPU rounds")
        free()
        dryrun = phase_dryrun(device, traces)
    mark("dryrun")

    def by_path(name):
        out = {"vfl_qwen3": vfl["launches"][name],
               "vfl_zamba2": zamba2["launches"][name],
               "vfl_granite": granite["launches"][name],
               "vfl_xlstm": xlstm["launches"][name],
               "vfl_whisper": whisper["launches"][name]}
        if name in stream_vfl["launches"]:
            out["stream_vfl_qwen3"] = stream_vfl["launches"][name]
        if name in ("flash_attention", "ssd_scan"):
            for arch in ("qwen3", "zamba2"):
                d = decode[arch]
                out[f"decode_{arch}_prefill"] = d["prefill_launches"][name]
                out[f"decode_{arch}_steps"] = d["step_launches"][name]
            # a rank's launches on the model axis of Mamba2, the mLSTM and
            # the sLSTM (ranks sharing the card over gloo)
            for tag, r in model_axis_ssm["serve"].items():
                out[f"model_axis_{tag}_prefill_per_rank"] = [
                    x["prefill_counts"][name] for x in r["ranks"]]
                out[f"model_axis_{tag}_steps_per_rank"] = [
                    x["step_counts"][name] for x in r["ranks"]]
        if name in ("flash_attention", "ssd_scan", "veds_score",
                    "p4_solve"):
            for tag, r in model_axis_ssm["vfl"].items():
                out[f"model_axis_{tag}_vfl_per_rank"] = [
                    x["launches"][name] for x in r["ranks"]]
        if name in ("flash_attention", "veds_score", "p4_solve"):
            # a rank's launches on the model axis's paths (ranks sharing
            # the card over gloo)
            ma = model_axis
            if name == "flash_attention":
                for tp in MA_MODES:
                    out[f"model_axis_{tp}_prefill_per_rank"] = [
                        x["prefill_counts"][name] for x in ma["serve"][tp][
                            "ranks"]]
                    out[f"model_axis_{tp}_steps_per_rank"] = [
                        x["step_counts"][name]
                        for x in ma["serve"][tp]["ranks"]]
            out["model_axis_vfl_per_rank"] = [
                x["launches"][name] for x in ma["vfl"]["ranks"]]
        op = {"veds_score": "repro::veds_dt_score",
              "p4_solve": "repro::p4_solve",
              "flash_attention": "repro::flash_attention_fwd",
              "ssd_scan": "repro::ssd_scan_fwd",
              "fedavg_agg": "repro::fedavg_agg"}[name]
        for case, r in dryrun["cases"].items():
            out[f"dryrun_{case}"] = r["launches"][op]
        if name == "p4_solve":
            out["run_fl"] = main_res["launches"][name]
            out["stream_run_fl"] = stream["warm"]["launches"][name]
            out["stream_run_fl_cold"] = stream["cold"]["launches"][name]
            for task in ("cifar", "traj"):
                out[f"compare_{task}_veds"] = compare[task]["schedulers"][
                    "veds"]["launches"][name]
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
            out["serve_front_closed"] = serve_front["launches"][name][
                "closed"]
            out["serve_front_poisson"] = serve_front["launches"][name][
                "poisson"]
            out["mesh_run_fl"] = mesh["mesh_run_fl"]["launches"][name]
            out["mesh_stream"] = mesh["mesh_stream"]["launches"][name]
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

    from repro_torch.kernels.p4_solve.ops import p4_solve
    zero_pivots = p4_solve.zero_pivots
    log("kernels", f"p4_solve met {zero_pivots} exactly-zero pivots in "
        f"this process's counted launches")
    check(zero_pivots == 0, f"p4_solve met {zero_pivots} exactly-zero "
          f"pivots on the paths")

    # launches: the zamba2 VFL round's path, which runs all five kernels;
    # times at its shapes (fedavg_agg: the qwen3 embedding leaf, its
    # largest; p4_solve: run_fl's block at fig10's width)
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
        "name": "p4_solve", "route": "cuda",
        "source": "src/repro_torch/kernels/p4_solve/csrc/p4_solve.cu",
        "replaces": "src/repro/core/solver.py:91",
        "replaces_note": "no Pallas kernel: the reference's solve_p4, "
                         "vmapped inside its jitted slot scan",
        "launches": zamba2["launches"]["p4_solve"],
        "launches_by_path": by_path("p4_solve"),
        "max_abs_err": max(r["max_abs_err"] for r in p4_kernels.values()
                           if isinstance(r, dict)),
        "zero_pivots": zero_pivots,
        **timed(p4_kernels["main"], shape=p4_kernels["main"]["shape"],
                graph_ms=p4_kernels["main"]["graph_ms"],
                graph_floor_ms=p4_kernels["graph_floor_ms"]),
        **{f"{label}_shape": timed(p4_kernels[label],
                                   shape=p4_kernels[label]["shape"],
                                   graph_ms=p4_kernels[label]["graph_ms"])
           for label in ("stream", "serve_b8", "adaptive")}}, {
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
                           "chunk": ss["chunk"]}),
        **{f"{label}_shape": timed(
            ssd_kernels[label],
            shape={"v": ssd_kernels[label]["shape_v"],
                   "bc": ssd_kernels[label]["shape_bc"],
                   "chunk": ssd_kernels[label]["chunk"]})
           for label in SSD_TIMED if label != "main"}}]}
    out = ROOT / "chiprun_out" / "chip_smoke.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(
        smi=smi, torch=torch.__version__, cuda=torch.version.cuda,
        build_s=build_s, kernels=kernels, p4_kernels=p4_kernels,
        p4_zero_pivots=zero_pivots, llm_kernels=llm_kernels,
        ssd_kernels=ssd_kernels, main=main_res, stages=stages,
        reference=ref, stream=stream, stream_reference=stream_ref,
        compare=compare, compare_reference=compare_ref,
        stream_compare=stream_compare, mesh=mesh, serve_reference=serve_ref,
        serve=serve, serve_front=serve_front,
        decode=decode, model_axis=model_axis,
        model_axis_ssm=model_axis_ssm, stream_vfl=stream_vfl,
        vfl=vfl, vfl_zamba2=zamba2,
        vfl_granite=granite, moe=moe, vfl_xlstm=xlstm, vfl_whisper=whisper,
        sensitivity=sensitivity,
        vfl_reference=vfl_ref, dryrun=dryrun), indent=1, default=str))
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
