"""The dry run's scaled trace (`launch/op_costs.py scaled_trace`): each
repeated loop (`op_costs.loop`: the layer stack, the encoder's layers,
the microbatches, the VEDS slots, the mLSTM's chunks, the sLSTM's steps)
runs a few checked iterations and the records are scaled to its trip
count, as the reference's HLO counter scales a `while` body.

(a) For the smoke configs of the dense, hybrid, MoE, xLSTM,
    encoder-decoder and vision families, each on a train, a prefill and
    a decode shape on a one-rank fake mesh: the scaled trace and the
    full trace (`full_trace=True`, every iteration dispatched) agree
    exactly on the operations, FLOPs, bytes, argument bytes, collectives
    (bytes and count by kind, and each loop body once), kernel calls and
    op count; the peak of live bytes within the counter's own 1/512.
    The widths are the smoke configs'; the depths, the slots, the
    microbatches and the mLSTM's chunk are set so that each family's
    loops run past the traced iterations, and past the check in the
    dense, MoE, xLSTM and encoder-decoder cases;
(b) a loop whose iterations do not settle raises, naming the loop;
(c) a real (non-fake) run under `OpCosts` dispatches every iteration,
    and `scaled_trace` refuses real tensors;
(d) a scaled trace's op log reads back (`analyze`) to its record's
    totals.
"""
import dataclasses

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_smoke_config
from repro_torch.launch import dryrun, specs
from repro_torch.launch.op_costs import (OpCosts, analyze, loop, read_log,
                                         scaled_trace)

SHAPES = {"train": ShapeConfig("train_s", 16, 4, "train"),
          "prefill": ShapeConfig("prefill_s", 16, 2, "prefill"),
          "decode": ShapeConfig("decode_s", 32, 2, "decode")}
# family -> (arch, the depths and loop counts set on its smoke config):
# 5 runs a loop past its check, 4 to the traced iterations' second, and
# 3 or fewer whole; the train cases federate one vehicle
FAMILIES = {
    "dense": ("qwen3-32b", dict(n_rep=5)),
    "hybrid": ("zamba2-2.7b", dict(n_rep=4)),
    "moe": ("granite-moe-1b-a400m", dict(n_rep=4)),
    # 4 mLSTM chunks of 2 and 8 sLSTM steps at T = 8
    "xlstm": ("xlstm-1.3b", dict(ssm_chunk=2)),
    "encdec": ("whisper-small", dict(encoder_layers=5)),
    "vision": ("llama-3.2-vision-90b", dict(n_rep=4)),
}
# the decode step's one loop is the layer stack
DECODE_REPS = {"xlstm": 4, "encdec": 4}
# the VEDS round's slots in the train cases; the dense train case runs 5,
# and splits its 5 rows into 5 microbatches
N_SLOTS, DENSE_SLOTS = 3, 5


def _case(family, kind):
    arch, rep = FAMILIES[family]
    cfg = get_smoke_config(arch).replace(**rep)
    shape = SHAPES[kind]
    if family == "xlstm" and kind != "decode":
        shape = dataclasses.replace(shape, seq_len=8)
    if kind == "decode" and family in DECODE_REPS:
        cfg = cfg.replace(n_rep=DECODE_REPS[family])
    if kind == "train":
        cfg = cfg.replace(num_vehicles=1)
    if family == "dense" and kind == "train":
        cfg = cfg.replace(n_rep=2, grad_accum=5)
        shape = ShapeConfig("train_s", 16, 5, "train")
    return cfg, shape


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("kind", tuple(SHAPES))
@pytest.mark.parametrize("family", tuple(FAMILIES))
def test_scaled_trace_equals_the_full_trace(family, kind, tmp_path,
                                           monkeypatch):
    """(a) and (d): every total equal, the peak within 1/512, each loop
    past its traced iterations scaled, and the scaled log's analysis its
    record's."""
    monkeypatch.setattr(specs, "N_SLOTS", DENSE_SLOTS if (family, kind) ==
                        ("dense", "train") else N_SLOTS)
    cfg, shape = _case(family, kind)
    one = {"data": 1, "model": 1}
    log = str(tmp_path / "scaled.ops.jsonl.gz")
    scaled = dryrun.trace_case(cfg, shape, one, "cpu", log=log)
    full = dryrun.trace_case(cfg, shape, one, "cpu", full_trace=True)
    for key in ("deep_cost", "kernels", "collectives_bytes",
                "collectives_count", "collectives_bytes_periter", "n_ops"):
        assert scaled[key] == full[key], key
    assert scaled["memory"]["argument_bytes"] == \
        full["memory"]["argument_bytes"] > 0
    assert abs(scaled["peak_bytes"] - full["peak_bytes"]) <= \
        full["peak_bytes"] / 512
    assert scaled["scaled_loops"] and not full["scaled_loops"]
    for name, rec in scaled["scaled_loops"].items():
        assert rec["trip_count"] > rec["iterations"][0], name
    back = analyze(read_log(log))
    assert back["dot_flops"] == scaled["deep_cost"]["dot_flops"]
    assert back["hbm_bytes"] == scaled["deep_cost"]["hbm_bytes"]
    assert back["collectives_count"] == scaled["collectives_count"]
    assert back["collectives_bytes_periter"] == \
        scaled["collectives_bytes_periter"]
    assert back["n_ops"] == scaled["n_ops"]


N_TOY = 20


def _step(x):
    """A loop whose odd iterations dispatch one op more than its even
    ones: no count of iterations after which they all add the same."""
    for i in loop("toy", N_TOY):
        x = x + 1
        if i % 2:
            x = x * 2
    return x


def test_an_iteration_that_differs_raises_with_the_loops_name():
    """(b) The odd iterations' extra op: no traced iterations settle, and
    the trace raises, naming the loop; the full trace runs it whole."""
    with FakeTensorMode():
        x = torch.zeros(3)
        with pytest.raises(ValueError, match="'toy'"):
            scaled_trace(_step, (x,))
        tr = scaled_trace(_step, (x,), full=True)
    assert tr.totals["n_ops"] == N_TOY * 3 // 2 and tr.loops == {}


def test_a_real_run_dispatches_every_iteration():
    """(c) On real tensors `loop` is `range`: every iteration runs under
    `OpCosts` (an add each, a multiply every other), and `scaled_trace`
    refuses them."""
    x = torch.zeros(3)
    with OpCosts(keep=True) as costs:
        y = _step(x)
    want = 0.0
    for i in range(N_TOY):
        want = (want + 1) * (2 if i % 2 else 1)
    assert costs.totals.n == N_TOY * 3 // 2
    assert [r["op"] for r in costs.records].count("aten::add") == N_TOY
    assert torch.equal(y, torch.full((3,), want))
    with pytest.raises(ValueError, match="fake tensors only"):
        scaled_trace(_step, (x,))
