"""Measurements on the card behind decisions of the MoE and xLSTM slices,
from the root of a checkout on a machine with one NVIDIA GPU (no jax
needed):

    python3 tests/torch_chip_probes.py grads      # granite's gradients at init
    python3 tests/torch_chip_probes.py lr-sweep   # granite's lr, 0.5 .. 1e-20
    python3 tests/torch_chip_probes.py lr-sweep xlstm-1.3b [e]
    python3 tests/torch_chip_probes.py lr-sweep whisper-small [e]
    python3 tests/torch_chip_probes.py bitwise    # schedulers, card vs CPU
    python3 tests/torch_chip_probes.py decode     # smoke decode, card vs CPU
    python3 tests/torch_chip_probes.py decode-loops [pairs]
    python3 tests/torch_chip_probes.py gloo-cuda  # collectives, 2 ranks a card
    python3 tests/torch_chip_probes.py model-axis # two phases of chip_smoke
    python3 tests/torch_chip_probes.py model-axis-ssm [no-kernels]
    python3 tests/torch_chip_probes.py model-axis-ssm-depth
    python3 tests/torch_chip_probes.py kernel-times
    python3 tests/torch_chip_probes.py schedule-times [reps]
    python3 tests/torch_chip_probes.py vfl-rounds [arch ...]
    python3 tests/torch_chip_probes.py p4-tables
    python3 tests/torch_chip_probes.py p4-bits OUT [INPUTS]
    python3 tests/torch_chip_probes.py p4-bits-compare A B

`grads [arch]`: granite-moe-1b-a400m (or the arch named) at full width
and depth (bf16, the init `launch/train.py` draws for seed 0), the LM
loss's gradient on each vehicle's batch of rounds 0 and 1 (4 x 1024
tokens): the largest entry of each leaf, and vehicle 0's bf16 gradients beside their fp32
evaluation on the same weights, norm-wise.

`lr-sweep`: `chip_smoke.py phase_vfl` for granite (1 warm-up and 3
rounds) at lr 0.5 (`launch/train.py`'s), then 10^-1, 10^-2, ... until
every round's eval loss is finite,
then the share of bf16 entries its round 0 changes
(`chip_smoke.round0_share`). This is how `chip_smoke.GRANITE_LR` was set.
`lr-sweep xlstm-1.3b` and `lr-sweep whisper-small` run the same sweep
through `launch/train.py`'s `train` (whisper's batches with `src`,
`data/synthetic.py` `src_lm_batch`), stopping an lr at its first
non-finite eval loss (with `e`, from 10^-e down); this is how `XLSTM_LR` and
`WHISPER_LR` were set. `grads xlstm-1.3b` and `grads whisper-small` log
the eval loss at init with each sub-block's largest output, and each
vehicle's gradients of rounds 0 and 1, as for granite.

`decode [run ...]`: `chip_smoke.smoke_decode` of each DECODE_SMOKE run
(all, or those named), card against CPU step by step (the largest
logit difference over max|logit|), beside the CPU's own move when every
weight moves by half an ulp (x (1 +- 6e-8)), and the card's prefill
against its decode: how far the fp32 decode's card-vs-CPU distance is
the model's conditioning at its init.

`decode-loops [pairs]`: zamba2-2.7b's decode step at full depth,
`chip_smoke.DECODE_ZAMBA2_BATCH` rows and decode_32k's 32768-slot cache
(bf16, the init of `chip_smoke.decode_serve`), with
`models/attention.py _decode_core`'s two loops: over the 32 KV heads,
each batched over the rows, and over the 8 rows, each batched over the
heads (the one it takes at these sizes), in the order A B B A
repeated `pairs` (3) times after one warm-up of each; a segment is 32
steps from position 0 between CUDA events. Logs each segment's ms a
step, the medians, and the two loops' largest logit difference.

`gloo-cuda`: two ranks on the one card in a gloo world (the shared-card
world of `launch/mesh.py run_world(shared_card=True)`): which of
`all_reduce` (SUM, MAX), `all_gather`, `all_gather_into_tensor` and
`broadcast` run on CUDA tensors of float32 and bfloat16 and give the
right values, then the mean wall of an `all_reduce` (SUM) and an
`all_gather` of a bf16 [128 * 64, 5120] CUDA tensor (qwen3-32b's
activations at the serving prefill of `chip_smoke.phase_model_axis`)
over 5 calls after one.

`model-axis`: `chip_smoke.phase_kernels_llm` (`flash_attention` at the
model axis's per-rank shapes among its cases) and
`chip_smoke.phase_model_axis` alone, as the whole script runs them.

`model-axis-ssm`: `chip_smoke.phase_kernels_ssd` and
`chip_smoke.phase_kernels_llm` (`ssd_scan` and `flash_attention` at the
per-rank shapes of zamba2's model axis among their cases), then
`chip_smoke.phase_model_axis_ssm` with its checks logged instead of
raised: how each witness and ratio reads before the bounds are set
(`no-kernels`: the phase alone).

`model-axis-ssm-depth`: where zamba2's and xlstm's split is held to one
rank: the serving path of `phase_model_axis_ssm` (b) over 2 ranks at
full width in fp32 (zamba2 at full depth and at 1 repetition, xlstm at
1), and in bf16 at zamba2's 1 repetition and xlstm's batch of 8, each
beside its one-ulp witness; then (c)'s VFL round of zamba2 at 1
repetition in fp32 and in bf16. Checks logged, not raised.

`kernel-times`: each kernel's wrapper timed eagerly at the shapes of
`chip_smoke.py`'s kernel phases, as the whole script times them:
`veds_score` at the main path's, the service's and the large shapes
(`phase_kernels`), then `phase_kernels_ssd` and `phase_kernels_llm`.
Copied into another checkout and run from there, it times that
checkout's wrappers, so two commits' can be compared on one card.

`schedule-times [reps]`: the VEDS schedule at fig10's width (S = U =
10, T = 60) on the card, as the main paths run it: run_fl's block of
`chip_smoke.ROUND_BATCH` cells cold, and one cell warm at
`chip_smoke.STREAM_WARM_ITERS` from the table of the round before; each
from its slot graph (after the round that captures it), `reps` (5)
rounds a kind, each closed by a device synchronisation; then one of each
under `torch.profiler`: its device events a slot and their busy time,
by name. Only `veds_round`'s public API is used, so copied into another
checkout it times that checkout's schedule.

`vfl-rounds [arch ...]`: `chip_smoke.phase_vfl` of granite-moe-1b-a400m
and qwen3-32b (or the archs named) as the whole script runs it (1
warm-up and 3 rounds), each round's wall and stages logged; copied into
another checkout it times that checkout's rounds.

`p4-tables`: how far `p4_solve` and its plain version part on warm
seeds: the candidates of VEDS slots at fig10's width (B 3, slots 5, 20
and 40) from the table the slot step carried there, from interior seeds
drawn in (0, 0.3) W, and from a synthetic table with 30% of its entries
at the box floor of 1e-9 W (`tests/torch_port_util.py p4_table`); for
each, the candidates beyond the warm tolerance (2e-5 W + 5e-2 |p|, 5e-2
|value|) and the largest differences, for the kernel against the plain
version on the card and for the plain version on the card against
itself on the CPU; and the kernel's exactly-zero pivots.

`p4-bits OUT [INPUTS]`: `p4_solve`'s (p, value) saved to OUT for the
four `chip_smoke.py p4_kernel_cases`, the `p4-tables` tables (slots 5,
20, 40: carried, interior, 30% at the floor), the width edges n = 2, 16,
17 and 32 (VEDS slot inputs at U = 1, 15, 16, 31, cold and warm), an
odd candidate count (9) and exact pivot ties (every OPV a copy of OPV
1, cold and warm); then the four `p4_kernel_cases` timed eagerly and
from a CUDA graph of 10 launches. The inputs are read from INPUTS where
that file exists, else made and saved there: copied into another
checkout and run from there with the same INPUTS, it solves the same
inputs with that checkout's kernel. `p4-bits-compare A B` counts the
elements whose bits differ between two such files, case by case (exit
1 if any), and needs no card.

`bitwise`: one round of each of the five schedulers on fig10 batches
(three heterogeneous cells, a carry) for seeds 5-8, card against CPU:
the decisions, and how many entries of zeta, qs, qu and the energies
differ and by how many ulps; then again with `madca`'s and `sa`'s log2
taken in float32 (`torch.log2`) instead of `core/baselines.py _log2`.
"""
import os
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def _leaf_names(tree, pre=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaf_names(tree[k], f"{pre}{k}.")
    elif isinstance(tree, list):
        for i, t in enumerate(tree):
            yield from _leaf_names(t, f"{pre}{i}.")
    else:
        yield pre[:-1]


REPS = {"granite-moe-1b-a400m": cs.GRANITE_REPS,
        "xlstm-1.3b": cs.XLSTM_REPS, "whisper-small": cs.WHISPER_REPS}


def grads(device, arch: str = "granite-moe-1b-a400m") -> None:
    from repro_torch.data.synthetic import lm_batch, src_lm_batch
    from repro_torch.fl.vfl import lm_loss
    from repro_torch.launch.train import EVAL_STREAM, _generator
    from repro_torch.models import engine
    from repro_torch.models.module import (materialize, tree_leaves,
                                           tree_map, tree_unflatten)
    cfg = cs.vfl_config(arch, REPS[arch])
    make = src_lm_batch(cfg) or lm_batch
    params = materialize(torch.Generator(device=device).manual_seed(0),
                         engine.model_decl(cfg, "head"))
    names = list(_leaf_names(params))

    # the eval forward at init, each sub-block's output's largest entry
    peaks = []
    kept = dict(engine._APPLY)

    def peak(kind, fn):
        def call(*a, **k):
            out = fn(*a, **k)
            y = out[0] if isinstance(out, tuple) else out
            peaks.append((kind, float(y.float().abs().max())))
            return out
        return call
    engine._APPLY.update({k: peak(k, f) for k, f in kept.items()})
    try:
        with torch.no_grad():
            ev = make(_generator(0, EVAL_STREAM, 0, device), 8, cs.VFL_SEQ,
                      cfg.vocab_size)
            loss = float(lm_loss(params, ev, cfg, "head"))
    finally:
        engine._APPLY.update(kept)
    cs.log("grads", f"{arch} eval loss at init {loss:.4f}; each sub-block's "
           f"largest |output| in order: " + ", ".join(
               f"{k} {m:.3g}" for k, m in peaks))

    def grad(p, batch, c):
        leaves = [a.detach().clone().requires_grad_() for a in tree_leaves(p)]
        loss = lm_loss(tree_unflatten(p, leaves), batch, c, "head")
        return float(loss.detach()), torch.autograd.grad(loss, leaves)

    V, b, seq = cfg.num_vehicles, cs.VFL_BATCH, cs.VFL_SEQ
    g0 = None
    for r in (0, 1):
        batch = make(_generator(0, 1, r, device), V * b, seq, cfg.vocab_size)
        for v in range(V):
            mb = {k: x[b * v: b * (v + 1)] for k, x in batch.items()}
            loss, g = grad(params, mb, cfg)
            big = [(n, float(x.float().abs().max())) for n, x in
                   zip(names, g)]
            bad = [n for n, x in zip(names, g) if not torch.isfinite(x).all()]
            cs.log("grads", f"{arch} round {r} vehicle {v}: loss {loss:.4f}; "
                   f"non-finite leaves {bad}; largest |grad| by leaf "
                   + ", ".join(f"{n} {m:.2e}" for n, m in big))
            if r == v == 0:
                g0 = g
            del g
    c32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    batch = make(_generator(0, 1, 0, device), V * b, seq, cfg.vocab_size)
    loss, g32 = grad(tree_map(lambda a: a.float(), params),
                     {k: x[:b].float() if k == "src" else x[:b]
                      for k, x in batch.items()}, c32)
    cs.log("grads", f"{arch} round 0 vehicle 0 in fp32: loss {loss:.4f}; "
           f"non-finite leaves "
           f"{[n for n, x in zip(names, g32) if not torch.isfinite(x).all()]}"
           f"; largest |grad| {max(float(x.abs().max()) for x in g32):.2e}; "
           f"the bf16 gradient's distance from it, norm-wise, by leaf "
           + ", ".join(f"{n} {float((a.float() - w).norm() / w.norm()):.2e}"
                       for n, a, w in zip(names, g0, g32)))


def lr_sweep(device, arch: str = "granite-moe-1b-a400m",
             start: str = "") -> None:
    """With `start` = e, the sweep begins at 10^-e, below the powers of
    ten an earlier sweep already found non-finite."""
    if arch == "granite-moe-1b-a400m":
        _granite_lr_sweep(device)
        return
    from repro_torch.data.synthetic import src_lm_batch
    from repro_torch.launch.train import train
    cfg = cs.vfl_config(arch, REPS[arch])
    n = cs.VFL_WARMUP + cs.VFL_ROUNDS

    def stop(rec):
        if not np.isfinite(rec["loss"]):
            raise FloatingPointError(f"round {rec['round']}: eval loss "
                                     f"{rec['loss']}")
    lrs = ([10.0 ** -e for e in range(int(start), int(start) + 16)] if start
           else [0.5] + [10.0 ** -e for e in range(1, 21)])
    for lr in lrs:
        try:
            with cs.round0_share() as changed:
                hist = train(cfg, rounds=n, batch_per_vehicle=cs.VFL_BATCH,
                             seq=cs.VFL_SEQ, lr=lr, seed=0, device=device,
                             log=lambda m: cs.log(f"lr-sweep {arch}", m),
                             on_round=stop, batch_fn=src_lm_batch(cfg))
        except FloatingPointError as err:
            cs.log("lr-sweep", f"{arch} lr {lr:g}: {err}")
            cs.free()
            continue
        cs.log("lr-sweep", f"{arch} lr {lr:g}: every eval loss finite "
               f"{[r['loss'] for r in hist]}; round 0 changed "
               f"{changed['share']:.4f} of the bf16 entries")
        cs.free()
        return


def _granite_lr_sweep(device) -> None:
    cfg = cs.vfl_config("granite-moe-1b-a400m", cs.GRANITE_REPS)
    masks = cs.RECORDED_MASKS["granite-moe-1b-a400m"]
    for lr in [0.5] + [10.0 ** -e for e in range(1, 21)]:
        try:
            res = cs.phase_vfl(device, cfg, cs.VFL_WARMUP, cs.VFL_ROUNDS,
                               cs.VFL_BATCH, cs.VFL_SEQ, lr, masks)
        except RuntimeError as err:
            cs.log("lr-sweep", f"lr {lr:g}: {err}")
            cs.free()
            continue
        cs.log("lr-sweep", f"lr {lr:g}: every eval loss finite "
               f"{[r['loss'] for r in res['rounds']]}; round 0 changed "
               f"{res['changed_bf16_round0']:.4f} of the bf16 entries")
        return


def bitwise(device) -> None:
    from repro_torch.channel.mobility import ManhattanParams
    from repro_torch.channel.v2x import ChannelParams
    from repro_torch.core import baselines
    from repro_torch.core.lyapunov import VedsParams
    from repro_torch.core.scenario import ScenarioParams, make_round_batch
    from repro_torch.core.scheduler import SchedulerCarry
    sc = ScenarioParams(n_sov=10, n_opv=10, n_slots=60)
    prm, ch = VedsParams(), ChannelParams()

    def ulps(a, b):
        return int((a.view(torch.int32).long()
                    - b.view(torch.int32).long()).abs().max())

    def run(tag):
        for seed in (5, 6, 7, 8):
            rnd = make_round_batch(seed, sc, ManhattanParams(), ch, prm, 3,
                                   hetero_fleet=True, device="cpu")
            rng = np.random.default_rng(seed)
            qs, qu = (torch.from_numpy(rng.uniform(0, 0.02, (3, 10)).astype(
                np.float32)) for _ in range(2))
            for name in cs.COMPARE_SCHEDULERS:
                s = baselines.get_scheduler(name)
                cpu = s.solve_round(rnd, prm, ch, SchedulerCarry(qs=qs, qu=qu))
                card = s.solve_round(rnd.to(device), prm, ch, SchedulerCarry(
                    qs=qs.to(device), qu=qu.to(device)))
                same = all(torch.equal(card[k].cpu(), cpu[k]) for k in
                           ("success", "n_success", "n_cot_slots",
                            "n_dt_slots"))
                parts = []
                for k, a, b in (
                        ("zeta", card.zeta, cpu.zeta),
                        ("qs", card.carry.qs, cpu.carry.qs),
                        ("qu", card.carry.qu, cpu.carry.qu),
                        ("energy_sov", card.energy_sov, cpu.energy_sov),
                        ("energy_opv", card.energy_opv, cpu.energy_opv)):
                    a = a.cpu()
                    n = int((a != b).sum())
                    parts.append(f"{k} {n}"
                                 + (f" (up to {ulps(a, b)} ulp)" if n else ""))
                cs.log("bitwise", f"[{tag}] seed {seed} {name}: decisions "
                       f"equal {same}; entries that differ: "
                       + ", ".join(parts))

    run("log2 in float64")
    kept = baselines._log2
    baselines._log2 = torch.log2
    try:
        run("log2 in float32")
    finally:
        baselines._log2 = kept


def decode(device, *runs) -> None:
    from repro_torch.models import engine
    from repro_torch.models.module import materialize
    for run in runs or tuple(cs.DECODE_SMOKE):
        cfg, _, _ = cs.smoke_decode_config(run)
        params = materialize(torch.Generator().manual_seed(0),
                             engine.model_decl(cfg, "head"))
        cpu, _ = cs.smoke_decode(run, "cpu", params)
        moved, _ = cs.smoke_decode(run, "cpu", cs.half_ulp_moved(params, 23))
        card, pre = cs.smoke_decode(run, device, params)
        scale = float(cpu.abs().max())

        def by_step(a):
            return [float((a[:, t] - cpu[:, t]).abs().max()) / scale
                    for t in range(cpu.shape[1])]
        card_s, moved_s = by_step(card), by_step(moved)
        cs.log("probe decode", f"{run}: card vs CPU {max(card_s):.3e} of "
               f"max|logit| {scale:.3e}, the CPU's half-ulp move "
               f"{max(moved_s):.3e}, card prefill vs decode "
               f"{float((card - pre).abs().max()) / float(pre.abs().max()):.3e}"
               f"; by step, card: "
               f"{' '.join(f'{e:.1e}' for e in card_s)}; half-ulp: "
               f"{' '.join(f'{e:.1e}' for e in moved_s)}")


def decode_loops(device, pairs: str = "3") -> None:
    import functools
    import statistics
    from repro_torch.configs.base import SHAPES_BY_NAME
    from repro_torch.models import attention, engine
    from repro_torch.models.module import materialize, tree_leaves
    cfg = cs.vfl_config("zamba2-2.7b", cs.ZAMBA2_REPS)
    B, steps = cs.DECODE_ZAMBA2_BATCH, 32
    params = materialize(torch.Generator(device=device).manual_seed(0),
                         engine.model_decl(cfg, "head"))
    cache = engine.zero_cache(engine.cache_decl(
        cfg, B, SHAPES_BY_NAME["decode_32k"].seq_len), device)
    toks = torch.randint(0, cfg.vocab_size, (B, steps), device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(1))
    pos = torch.arange(steps, device=device)
    core = attention._decode_core
    cores = {over: functools.partial(core, over=over)
             for over in ("heads", "rows")}

    def segment(name):
        for a in tree_leaves(cache):        # the same steps each time
            a.zero_()
        attention._decode_core = cores[name]
        try:
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            with torch.no_grad():
                start.record()
                for t in range(steps):
                    logits, _ = engine.decode_step(
                        params, cache, toks[:, t], pos[t], cfg, None,
                        tp="head")
                end.record()
            torch.cuda.synchronize()
        finally:
            attention._decode_core = core
        return start.elapsed_time(end) / steps, logits

    _, ref = segment("heads")
    _, rows = segment("rows")
    times = {"heads": [], "rows": []}
    for _ in range(int(pairs)):
        for name in ("heads", "rows", "rows", "heads"):
            ms, _ = segment(name)
            times[name].append(ms)
            cs.log("probe decode-loops", f"{name}: {ms:.3f} ms a step")
    cs.log("probe decode-loops", f"zamba2-2.7b, B {B}, {steps} steps a "
           f"segment: median ms a step, KV-head loop "
           f"{statistics.median(times['heads']):.3f} "
           f"{sorted(times['heads'])}, row loop "
           f"{statistics.median(times['rows']):.3f} "
           f"{sorted(times['rows'])}; last logits' largest difference "
           f"{float((ref - rows).abs().max()):.3e} of max|logit| "
           f"{float(ref.abs().max()):.3e}")


def _gloo_cuda_rank(rank: int, store: str) -> None:
    import datetime
    import json
    import time
    import torch.distributed as dist
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=2,
                            timeout=datetime.timedelta(seconds=120))
    dev = torch.device("cuda", 0)

    def gathered(x):
        out = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(out, x)
        return torch.cat(out)

    def into_tensor(x):
        out = torch.empty(2 * x.numel(), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x)
        return out

    def bcast(x):
        dist.broadcast(x, 0)
        return x
    cases = {
        "all_reduce SUM": (lambda x: (dist.all_reduce(x), x)[1], [3.0]),
        "all_reduce MAX": (lambda x: (dist.all_reduce(
            x, op=dist.ReduceOp.MAX), x)[1], [2.0]),
        "all_gather": (gathered, [1.0, 2.0]),
        "all_gather_into_tensor": (into_tensor, [1.0, 2.0]),
        "broadcast": (bcast, [1.0]),
    }
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        for name, (op, want) in cases.items():
            x = torch.full((1024,), rank + 1.0, dtype=dt, device=dev)
            try:
                y = op(x)
                torch.cuda.synchronize()
                got = sorted(set(y.float().cpu().tolist()))
                ok = y.device == dev and got == sorted(set(want))
                res[f"{name} {dt}"] = "runs" if ok else f"wrong {got}"
            except (RuntimeError, ValueError) as e:
                res[f"{name} {dt}"] = f"raises {type(e).__name__}: " \
                    f"{str(e).splitlines()[0][:160]}"
    x = torch.randn(128 * 64, 5120, device=dev).to(torch.bfloat16)
    walls = {}
    for name, op in (("all_reduce", lambda: dist.all_reduce(x.clone())),
                     ("all_gather", lambda: gathered(x))):
        try:
            op()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                op()
            torch.cuda.synchronize()
            t1 = time.perf_counter()  # reprolint: disable=timer-no-block -- torch.cuda.synchronize() above closes the window
            walls[name] = (t1 - t0) / 5 * 1e3
        except (RuntimeError, ValueError) as e:
            walls[name] = f"raises {type(e).__name__}"
    if rank == 0:
        cs.log("probe gloo-cuda", json.dumps(res, indent=1))
        cs.log("probe gloo-cuda", f"bf16 [{128 * 64}, 5120] "
               f"({x.numel() * 2 / 1e6:.1f} MB) on CUDA, ms a call over 5: "
               f"{walls}")
    dist.destroy_process_group()


def gloo_cuda(device) -> None:
    import tempfile
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_gloo_cuda_rank, args=(f"{tmp}/store",),
                           nprocs=2, start_method="spawn")


def model_axis(device) -> None:
    cs.phase_kernels_llm(device)
    cs.phase_model_axis(device)


def model_axis_ssm(device, kernels: str = "kernels") -> None:
    if kernels != "no-kernels":
        cs.phase_kernels_ssd(device)
        cs.phase_kernels_llm(device)

    def logged(cond, msg):
        if not cond:
            cs.log("probe", f"check FAILED: {msg}")
    cs.check = logged
    cs.phase_model_axis_ssm(device)


def model_axis_ssm_depth(device) -> None:
    fp32 = dict(param_dtype="float32", compute_dtype="float32")
    z, x = (cs.vfl_config(a, r) for a, r in (
        ("zamba2-2.7b", cs.ZAMBA2_REPS), ("xlstm-1.3b", cs.XLSTM_REPS)))
    z1 = z.replace(n_rep=1)
    runs = [("zamba2_fp32_full", z.replace(**fp32), (2, 64, 128, 8)),
            ("zamba2_1rep_fp32", z1.replace(**fp32), (2, 64, 128, 8)),
            ("zamba2_1rep", z1, (8, 64, 128, 8)),
            ("xlstm_fp32", x.replace(**fp32), (8, 64, 128, 8)),
            ("xlstm_b8", x, (8, 64, 128, 8))]

    def logged(cond, msg):
        if not cond:
            cs.log("probe", f"check FAILED: {msg}")
    cs.check = logged
    vfl = [(f"zamba2_1rep_{d}", z1.replace(num_vehicles=1, param_dtype=d,
                                           compute_dtype=d),
            cs.MA_SSM_VFL_BATCH, cs.VFL_SEQ, cs.ZAMBA2_LR, True)
           for d in ("float32", "bfloat16")]
    cs.phase_model_axis_ssm(device, parts=("b", "c"), serve_runs=runs,
                            vfl_runs=vfl)


def kernel_times(device) -> None:
    serve = {f"serve_b{b}": (b, cs.SERVE_FIG10["n_sov"]) for b in (2, 4, 8)}
    cs.phase_kernels({"main": (cs.ROUND_BATCH, 10), **serve,
                      "large": (1 << 22,)}, device)
    cs.phase_kernels_ssd(device)
    cs.phase_kernels_llm(device)


def _sched_rounds(device, B: int, seed: int, n: int):
    """`n` rounds of B fig10 cells (S = U = 10, T = 60) on `device`."""
    from repro_torch.channel.mobility import ManhattanParams
    from repro_torch.channel.v2x import ChannelParams
    from repro_torch.core.lyapunov import VedsParams
    from repro_torch.core.scenario import (ScenarioParams, make_round,
                                           round_generator)
    from repro_torch.core.veds import RoundInputs
    sc = ScenarioParams(n_sov=10, n_opv=10, n_slots=60)
    return [RoundInputs.stack([
        make_round(round_generator(seed, B * r + b, device), sc,
                   ManhattanParams(), ChannelParams(), VedsParams())
        for b in range(B)]) for r in range(n)]


def schedule_times(device, reps: str = "5") -> None:
    import time
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.channel.v2x import ChannelParams
    from repro_torch.core.lyapunov import VedsParams
    from repro_torch.core.scheduler import SchedulerCarry
    from repro_torch.core.solver import p4_seed_table
    from repro_torch.core.veds import veds_round
    n, ch = int(reps), ChannelParams()
    kinds = {"cold": (cs.ROUND_BATCH, VedsParams()),
             "warm": (1, VedsParams(ipm_warm_iters=cs.STREAM_WARM_ITERS))}
    for kind, (B, prm) in kinds.items():
        rounds = _sched_rounds(device, B, 3, n + 2)
        carry = None
        if kind == "warm":
            carry = SchedulerCarry(
                qs=torch.zeros((B, 10), device=device),
                qu=torch.zeros((B, 10), device=device),
                p4=p4_seed_table((B, 10, 10, 11), ch.p_max, device))
        out = veds_round(rounds[0], prm, ch, carry=carry)   # captures
        ms = []
        for rnd in rounds[1:n + 1]:
            if kind == "warm":
                carry = out.carry
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = veds_round(rnd, prm, ch, carry=carry)
            torch.cuda.synchronize()
            # the device synchronisation above closes the timed region
            t1 = time.perf_counter()  # reprolint: disable=timer-no-block
            ms.append((t1 - t0) * 1e3)
        if kind == "warm":
            carry = out.carry
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            veds_round(rounds[n + 1], prm, ch, carry=carry)
            torch.cuda.synchronize()
        events = [e for e in prof.events() if e.device_type ==
                  DeviceType.CUDA]
        by_name = {}
        for e in events:
            c, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (c + 1, t + e.device_time_total / 1e3)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:25]
        cs.log("schedule", f"{kind} [{B}, 10, 10] x T 60: ms a round "
               f"{[round(x, 3) for x in ms]}, median "
               f"{cs._median(ms):.3f}; traced: "
               f"{len(events) / 60:.1f} device events a slot, busy "
               f"{sum(e.device_time_total for e in events) / 1e3:.3f} ms")
        cs.log("schedule", f"{kind} by name (a slot, ms in all, most time "
               f"first): " + "; ".join(f"{k[:70]} {c / 60:.2f}, {t:.3f}"
                                       for k, (c, t) in top))


def vfl_rounds(device, *archs) -> None:
    lrs = {"granite-moe-1b-a400m": (cs.GRANITE_REPS, cs.GRANITE_LR),
           "qwen3-32b": (cs.VFL_REPS, cs.VFL_LR)}
    for arch in archs or tuple(lrs):
        reps, lr = lrs[arch]
        res = cs.phase_vfl(device, cs.vfl_config(arch, reps), cs.VFL_WARMUP,
                           cs.VFL_ROUNDS, cs.VFL_BATCH, cs.VFL_SEQ, lr,
                           cs.RECORDED_MASKS[arch])
        cs.log("vfl-rounds", f"{arch}: timed walls "
               f"{[round(w, 4) for w in res['timed_wall_s']]} s")
        cs.free()


def p4_tables(device) -> None:
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_util import p4_table
    from repro_torch.kernels.p4_solve.ops import p4_solve, p4_solve_plain

    def parted(p, v, rp, rv):
        bad = (((p - rp).abs() > 2e-5 + 5e-2 * rp.abs()).any(-1)
               | ((v - rv).abs() > 1e-9 + 5e-2 * rv.abs()))
        return (int(bad.sum()), float((p - rp).abs().max()),
                float(((v - rv).abs() / rv.abs().clamp_min(1e-30)).max()))
    for slot in (5, 20, 40):
        cand, carried, kw = cs.p4_slot_inputs(device, 3, slot, True)
        shape = cand[1].shape
        g = torch.Generator(device=device).manual_seed(slot)
        tables = {"carried": carried,
                  "interior": 0.3 * torch.rand(shape, generator=g,
                                               device=device),
                  "floor30": p4_table(tuple(shape), slot, device=device)}
        for name, tab in tables.items():
            p, v = p4_solve(*cand, tab, **kw)
            rp, rv = p4_solve_plain(*cand, tab, **kw)
            cp, cv = p4_solve_plain(*[x.cpu() for x in cand], tab.cpu(),
                                    **kw)
            cs.log("p4-tables", f"slot {slot} {name}: kernel vs plain "
                   f"(candidates beyond, max |dp|, max rel dv) "
                   f"{parted(p, v, rp, rv)} of {v.numel()}; plain card vs "
                   f"CPU {parted(rp, rv, cp.to(device), cv.to(device))}")
    cs.log("p4-tables", f"exactly-zero pivots: {p4_solve.zero_pivots}")


def _p4_bits_cases(device):
    """The inputs of `p4-bits`, name -> (cw, a, q, d, p_max, p_init or
    None, keyword arguments), all on the card."""
    sys.path.insert(0, str(ROOT / "tests"))
    from torch_port_util import p4_table
    from repro_torch.kernels.p4_solve.ops import (_project_feasible,
                                                  seed_grad_norms,
                                                  split_far_tol)
    cases = {}

    def add(name, cand, p_init, kw):
        cases[name] = (*cand, p_init, dict(kw))
    # chip_smoke.py p4_kernel_cases
    for label, (B, slot, warm, extra) in {
            "main": (cs.ROUND_BATCH, 0, False, {}),
            "stream": (1, 5, True, {}),
            "serve_b8": (8, 5, True, {}),
            "adaptive": (1, 5, True, dict(far_iters=25))}.items():
        cand, p_init, kw = cs.p4_slot_inputs(device, B, slot, warm)
        kw.update(extra)
        if extra:
            cw, a, q, d, pm = cand
            kw["far_grad_tol"] = split_far_tol(seed_grad_norms(
                cw, a, q, _project_feasible(p_init, d, pm, margin=0.5)))
        add(label, cand, p_init, kw)
    # the p4-tables probe's tables
    for slot in (5, 20, 40):
        cand, carried, kw = cs.p4_slot_inputs(device, 3, slot, True)
        shape = cand[1].shape
        g = torch.Generator(device=device).manual_seed(slot)
        for name, tab in {
                "carried": carried,
                "interior": 0.3 * torch.rand(shape, generator=g,
                                             device=device),
                "floor30": p4_table(tuple(shape), slot,
                                    device=device)}.items():
            add(f"tables_s{slot}_{name}", cand, tab, kw)
    # the width edges: n = 2, 16, 17, 32, and an odd candidate count
    for label, (B, S, U) in {"n2": (2, 4, 1), "n16": (2, 4, 15),
                             "n17": (2, 4, 16), "n32": (2, 4, 31),
                             "odd": (1, 3, 3)}.items():
        for warm in (False, True):
            cand, p_init, kw = cs.p4_slot_inputs(device, B, 3, warm, S, U)
            add(f"{label}_{'warm' if warm else 'cold'}", cand, p_init, kw)
    # exact pivot ties: every OPV a copy of OPV 1
    for label, (B, slot, warm) in {"ties_cold": (1, 0, False),
                                   "ties_warm": (1, 5, True)}.items():
        cand, p_init, kw = cs.p4_slot_inputs(device, B, slot, warm)
        for x in cand[1:] + ([p_init] if warm else []):
            x[..., 2:] = x[..., 1:2]
        add(label, cand, p_init, kw)
    return cases


def p4_bits(device, out: str, inputs: str = "") -> None:
    """Solve every `_p4_bits_cases` case with this checkout's `p4_solve`
    and save each (p, value) to `out`; the inputs come from `inputs`
    where that file exists, else they are made and saved there, so that
    two checkouts solve the same inputs. Then time the four
    `p4_kernel_cases`, eagerly and from a CUDA graph of 10 launches."""
    from repro_torch.kernels.p4_solve.ops import p4_solve, p4_solve_plain
    if inputs and Path(inputs).is_file():
        cases = {k: tuple(x.to(device) if torch.is_tensor(x) else x
                          for x in v)
                 for k, v in torch.load(inputs).items()}
    else:
        cases = _p4_bits_cases(device)
        if inputs:
            Path(inputs).parent.mkdir(parents=True, exist_ok=True)
            torch.save(cases, inputs)
    res = {}
    with p4_solve.uncounted():
        for name, (*cand, p_init, kw) in cases.items():
            p, v = p4_solve(*cand, p_init, **kw)
            res[name] = {"p": p.cpu(), "v": v.cpu()}
            rp, rv = p4_solve_plain(*cand, p_init, **kw)
            rtol = 1e-4 if p_init is None else 5e-2
            ok, rok = (torch.isfinite(x).all(-1) & torch.isfinite(y)
                       for x, y in ((p, v), (rp, rv)))
            both = ok & rok
            beyond = both & (((p - rp).abs() > 2e-5 + rtol * rp.abs())
                             .any(-1) | ((v - rv).abs()
                                         > 1e-9 + rtol * rv.abs()))
            cs.log("p4-bits", f"{name} {list(cand[1].shape)}: non-finite "
                   f"kernel {int((~ok).sum())}, plain {int((~rok).sum())}"
                   f", both {int((~ok & ~rok).sum())} of {ok.numel()}; "
                   f"beyond rtol {rtol} {int(beyond.sum())}")
    Path(out).parent.mkdir(parents=True, exist_ok=True)
    torch.save(res, out)
    cs.log("p4-bits", f"zero pivots {p4_solve.zero_pivots}; saved {out}")
    for name in ("main", "stream", "serve_b8", "adaptive"):
        *cand, p_init, kw = cases[name]

        def kernel():
            with p4_solve.uncounted():
                return p4_solve(*cand, p_init, **kw)
        ms = cs.time_ms(kernel, 50)
        g_ms, _ = cs.graph_ms(kernel, reps=10, inner=5)
        cs.log("p4-bits", f"time {name} {list(cand[1].shape)}: eager "
               f"{ms:.5f} ms, from a CUDA graph {g_ms:.5f} ms a launch")


def p4_bits_compare(a: str, b: str) -> int:
    """The elements whose bits differ between two `p4-bits` files, case
    by case; returns their total."""
    x, y = torch.load(a), torch.load(b)
    total = 0
    for name in x:
        diff = sum(int((x[name][k].view(torch.int32)
                        != y[name][k].view(torch.int32)).sum())
                   for k in ("p", "v"))
        total += diff
        cs.log("p4-bits", f"{name}: {diff} of "
               f"{x[name]['p'].numel() + x[name]['v'].numel()} elements "
               f"differ")
    cs.log("p4-bits", f"{a} vs {b}: {total} elements differ in "
           f"{len(x)} cases")
    return total


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    probes = {"grads": grads, "lr-sweep": lr_sweep, "bitwise": bitwise,
              "decode": decode, "decode-loops": decode_loops,
              "gloo-cuda": gloo_cuda, "model-axis": model_axis,
              "model-axis-ssm": model_axis_ssm,
              "model-axis-ssm-depth": model_axis_ssm_depth,
              "kernel-times": kernel_times,
              "schedule-times": schedule_times, "vfl-rounds": vfl_rounds,
              "p4-tables": p4_tables, "p4-bits": p4_bits}
    if argv and argv[0] == "p4-bits-compare":
        return 1 if p4_bits_compare(*argv[1:]) else 0
    if not argv or argv[0] not in probes:
        print(f"usage: torch_chip_probes.py {{{','.join(probes)}}}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("torch_chip_probes: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    os.chdir(ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels.build import load_library
    load_library()
    cs.log("device", cs.smi_line())
    probes[argv[0]](torch.device("cuda"), *argv[1:])
    cs.log("device", cs.smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
