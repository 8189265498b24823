"""Op-level cost extraction: the port's counterpart of the reference's
`launch/hlo_costs.py`.

The reference reads its costs from the compiled HLO text, where a
`while` loop's body appears once and is multiplied by its trip count
(`hlo_costs.py:_trip_count`). The port has no graph: `OpCosts` is a
`TorchDispatchMode` that sees every op the step dispatches, after
autograd (the backward's ops included) and Python control flow. Under a
`FakeTensorMode` it records the ops without running them
(`launch/dryrun.py`).

It records one entry per op (`record`: the op's name, its arguments with
every tensor written as its shape, dtype and bytes, its outputs), which
`analyze` reads, so that stored logs can be analysed again
(`launch/reanalyze.py`):

  * dot_flops   every op with a FLOP formula in `torch.utils.flop_counter`
                (mm, bmm, addmm, baddbmm, convolutions, attention) plus
                each custom kernel's own count (`kernels.KERNEL_COSTS`),
                what `FlopCounterMode` reports for the same run;
  * hbm_bytes   each op's inputs (each tensor once) plus its outputs: in
                eager PyTorch an op is a fusion boundary, the place the
                reference's estimate counts at. View ops move nothing; a
                custom kernel counts its own bytes (inputs read once,
                outputs written once);
  * collectives_bytes / collectives_count, by the reference's five kinds,
                from the `c10d` ops: the bytes of each op's output
                tensors (its first argument), as the reference sums each
                collective's output shape;
  * kernel_calls each custom kernel's calls.

Live, it also tracks the bytes of every storage an op creates until the
storage is freed (`torch.multiprocessing.reductions.StorageWeakRef`),
with the step's arguments counted from the start: `peak_bytes`. The
running total counts freed storages until a sweep finds them, so it
never reads low: when it passes the peak by more than 1/512 of it (by
anything, `exact`), the storages tracked since the last sweep are swept,
then (if the total is still above) all of them, and the peak is read.
`peak_bytes` is thus at most 1/512 below the true peak (the true peak
at every op's end, `exact`), and each storage is swept about once (a
sweep of all of them only when the freed ones outweigh that margin, or
when their number has doubled), where sweeping all at every new high
made a long recurrence (xlstm's sLSTM, ~20 M ops) quadratic.

Repeated loops (`loop`, `fill`). The step's Python loops that repeat one
body (the layer stack, the encoder's layers, the gradient accumulation's
microbatches, the VFL round's vehicles, the VEDS slots, the mLSTM's
chunks, the sLSTM's time steps) iterate through `loop(name, n)`, which is
`range(n)` except inside `scaled_trace`, where each such loop runs a few
iterations and the totals of a handful of traces are combined into the
whole step's, the way the reference multiplies a `while` body by its
trip count. Every total is multilinear in the loops' counts: a body's
ops, bytes and collectives repeat with each iteration, a nested body's
with the product of its loops', and loops that run one after the other
add. The first iterations may legitimately differ (the first microbatch
has no accumulator, the first use of zamba2's weight-tied block no
gradient to add to, autograd accumulates the mLSTM's first chunks'
gradients otherwise): each loop is traced alone at 1, 2, 3, ...
iterations until those after some b add the same ops (names, shapes,
dtypes, bytes; integers and floats in an op's arguments may differ) and
the same totals, or `scaled_trace` raises, naming the loop. Then a trace
for each set of nested loops, those at b + 1 iterations and the others
at b, gives the totals at the trip counts exactly (`_weights`).

The peak of live bytes is measured, in a trace with every loop at p >= 3
iterations, where a loop of n > p counts its n - p skipped iterations
(`OpCosts._loop_end`): each storage its second iteration still holds at
the loop's end (a steady iteration's keep: saved activations, the slots'
decisions, the sLSTM's outputs) counts n - p + 1 times while it lives.
A backward frees the second iteration's keep second to last, so the
loop's backward reads as the whole loop's only while p - 2 iterations
or fewer are done; p is the loop's first count from which its traces
alone read the same peak, in at least three of them.
`collectives_bytes_periter` is a trace with every loop at one
iteration: each loop body counted once, the reference's per-iteration
view. A loop whose iterations' outputs are
stacked after it pads them to its trip count with `fill`, whose pads no
`OpCosts` counts, so the stack sees the whole loop's inputs.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import gzip
import itertools
import json
import math
from typing import Any, Callable, Dict, Iterable, List, Optional

import torch
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import KERNEL_COSTS

_COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
                "collective-permute")

# the c10d ops (and the functional collectives) of each kind
_C10D_KINDS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "recv_": "collective-permute",
}

# how often (in ops) the storages tracked since the last sweep are swept
# even below the peak, so that the entries of freed ones do not pile up
_SWEEP_EVERY = 4096


class TensorDesc:
    """A tensor as the log keeps it: shape, dtype and the bytes it
    stands for (0 for a repeat within one op's inputs). It answers what
    the FLOP and cost formulas ask of a tensor."""

    __slots__ = ("shape", "dtype", "nbytes")

    def __init__(self, shape, dtype, nbytes: int):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.nbytes = int(nbytes)

    def numel(self) -> int:
        return self.shape.numel()

    def element_size(self) -> int:
        return self.dtype.itemsize


def _tensor_bytes(t: torch.Tensor) -> int:
    """What reading or writing `t` moves: its elements, at most its
    storage (an expanded view reads its storage once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".")[-1]


def _encode(x, seen: set):
    """`x` (an op's argument or output) in JSON: a tensor as
    {"T": shape, "d": dtype, "b": bytes}, a dtype as {"dtype": name},
    lists and tuples as lists, anything else a number, a bool, None or
    its string."""
    if isinstance(x, torch.Tensor):
        b = 0 if id(x) in seen else _tensor_bytes(x)
        seen.add(id(x))
        return {"T": list(x.shape), "d": _dtype_name(x.dtype), "b": b}
    if isinstance(x, torch.dtype):
        return {"dtype": _dtype_name(x)}
    if isinstance(x, (list, tuple)):
        return [_encode(v, seen) for v in x]
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    return str(x)


def _decode(x):
    if isinstance(x, dict) and "T" in x:
        return TensorDesc(x["T"], getattr(torch, x["d"]), x["b"])
    if isinstance(x, dict) and "dtype" in x:
        return getattr(torch, x["dtype"])
    if isinstance(x, list):
        return [_decode(v) for v in x]
    return x


def _descs(x) -> List[TensorDesc]:
    if isinstance(x, TensorDesc):
        return [x]
    if isinstance(x, list):
        return [d for v in x for d in _descs(v)]
    return []


def _shapes(x):
    """Formula arguments as `torch.utils.flop_counter`'s shape wrapper
    gives them: each tensor as its shape."""
    if isinstance(x, TensorDesc):
        return x.shape
    if isinstance(x, list):
        return [_shapes(v) for v in x]
    return x


def _without_dtypes(packet):
    """`torch.utils.flop_counter`'s formula of `packet` taking the
    `.dtype` overload's positional `out_dtype` too (torch 2.11's and
    2.13's matmul formulas read a third positional argument as their
    output shape: `torch.bmm(a, b, out_dtype=...)` breaks them)."""
    formula = flop_registry[packet]

    def count(*args, out_val=None, **kwargs):
        return formula(*(a for a in args if not isinstance(a, torch.dtype)),
                       out_val=out_val, **kwargs)
    count._get_raw = True             # `formula` takes the shapes itself
    return count


# the FLOP formulas of the matmuls that have a `.dtype` overload, safe for
# it: `analyze` uses them, and `FlopCounterMode(custom_mapping=...)` can
FLOP_FORMULAS = {pk: _without_dtypes(pk) for pk in (
    torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm,
    torch.ops.aten.baddbmm)}


def _packet(name: str):
    """The `torch.ops` packet of a logged op's name ("aten::mm"), or
    None if this process does not have it."""
    ns, _, op = name.partition("::")
    try:
        return getattr(getattr(torch.ops, ns), op)
    except (AttributeError, RuntimeError):
        return None


class Totals:
    """The running totals of a log: `add` one `record` entry at a time,
    `result()` the totals so far. A marker entry of a scaled trace's log
    (`{"trace": ..., "weight": w, "base": b}`, `scaled_trace`) sets the
    weight of the entries after it; those of the trace with every loop at
    one iteration (`base`) also make up `collectives_bytes_periter`.
    Before any marker the weight is 1 and every entry is the base's."""

    def __init__(self):
        self.flops = 0                 # integers: exact past 2^53
        self.hbm = 0
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.coll_n = {k: 0 for k in _COLLECTIVES}
        self.coll_base = {k: 0 for k in _COLLECTIVES}
        self.kernels: Dict[str, int] = {}
        self.n = 0
        self.weight = 1
        self.base = True
        self._packets: Dict[str, Any] = {}

    def add(self, rec: Dict[str, Any]) -> None:
        if "weight" in rec:
            self.weight, self.base = int(rec["weight"]), bool(rec["base"])
            return
        w = self.weight
        self.n += w
        name = rec["op"]
        args = _decode(rec["args"])
        kwargs = {k: _decode(v) for k, v in rec.get("kwargs", {}).items()}
        out = _decode(rec["out"])
        if name in KERNEL_COSTS:
            ops, nbytes = KERNEL_COSTS[name](*args, **kwargs)
            self.kernels[name] = self.kernels.get(name, 0) + w
            self.flops += w * ops
            self.hbm += w * nbytes
            return
        if name not in self._packets:
            self._packets[name] = _packet(name)
        pk = self._packets[name]
        formula = FLOP_FORMULAS.get(pk) or flop_registry.get(pk)
        if formula is not None:
            self.flops += w * formula(
                *_shapes(args), out_val=_shapes(out),
                **{k: _shapes(v) for k, v in kwargs.items()})
        kind = _C10D_KINDS.get(name.partition("::")[2]) \
            if name.startswith(("c10d::", "_c10d_functional::")) else None
        if kind is not None:
            b = sum(d.numel() * d.element_size() for d in _descs(args[0]))
            self.coll[kind] += w * b
            self.coll_n[kind] += w
            if self.base:
                self.coll_base[kind] += b
        if not rec.get("view"):
            self.hbm += w * (sum(d.nbytes for d in _descs(args)) + sum(
                d.nbytes for v in kwargs.values() for d in _descs(v)) + sum(
                d.numel() * d.element_size() for d in _descs(out)))

    def result(self) -> Dict[str, Any]:
        return {"dot_flops": self.flops, "hbm_bytes": self.hbm,
                "collectives_bytes": dict(self.coll),
                "collectives_count": dict(self.coll_n),
                "collectives_bytes_periter": dict(self.coll_base),
                "kernel_calls": dict(self.kernels), "n_ops": self.n}


def analyze(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """dot_flops, hbm_bytes, collectives_bytes/_count (by kind),
    collectives_bytes_periter, kernel_calls and n_ops of a log of
    `record` entries (a scaled trace's: its traces' weighted sum)."""
    totals = Totals()
    for rec in records:
        totals.add(rec)
    return totals.result()


class _Frame:
    """A repeated loop running inside `OpCosts` (`scaled_trace`): its trip
    count n, the iterations run k, the storages created in its second
    iteration, and the exact peak of live bytes in its last iteration
    (`win`, None until that iteration starts)."""
    __slots__ = ("n", "k", "j", "made", "win")

    def __init__(self, n: int, k: int):
        self.n, self.k, self.j = n, k, -1
        self.made: List[tuple] = []      # (storage key, serial)
        self.win: Optional[int] = None


class OpCosts(TorchDispatchMode):
    """Adds every op dispatched inside it to its `totals`, to `records`
    with `keep`, and to the gzipped op log `log` (a path, opened and
    closed with the mode, or an open text file; one JSON entry a line),
    and tracks the peak of live bytes (`peak_bytes`, within 1/512 below
    the true peak, or the true peak with `exact`), counting the storages
    of `arguments` (the step's inputs, `add_arguments`) from the start.

    Inside `scaled_trace` a repeated loop that runs k of its n
    iterations stands for all n in the peak (`_loop_end`): each storage
    its second iteration made and still holds at the loop's end (a
    steady iteration's keep: saved activations, the slots' decisions,
    the sLSTM's outputs) counts n - k + 1 times while it lives, and in
    the loop's last iteration. A nested loop's storages counted so are
    counted again with its outer loop's."""

    def __init__(self, arguments=None, *, log=None, keep: bool = False,
                 exact: bool = False):
        super().__init__()
        self.totals = Totals()
        self.records: Optional[List[Dict[str, Any]]] = [] if keep else None
        self._log_path = log if isinstance(log, str) else None
        self._log = None if isinstance(log, str) else log
        self._shift = None if exact else 9
        # storage key -> (weakref, bytes, serial); a key may come back for
        # a new storage once the old one is swept
        self._live: Dict[int, tuple] = {}
        self._serial = 0
        self._young: List[int] = []    # tracked since the last sweep
        self._swept_size = 0           # len(_live) after the last full one
        self._cur = 0
        self._frames: List[_Frame] = []
        self.peak_bytes = 0
        self.argument_bytes = 0
        if arguments is not None:
            self.add_arguments(arguments)

    def add_arguments(self, tree) -> None:
        """Count the storages of every tensor in `tree` (each once) as
        live and as arguments."""
        before = self._cur
        for t in tree_tensors(tree):
            self._track(t)
        self.argument_bytes += self._cur - before
        self._sweep_all()

    def _track(self, t: torch.Tensor) -> None:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return
        key = st._cdata
        if key in self._live:
            return
        nb = st.nbytes()
        self._serial += 1
        self._live[key] = (StorageWeakRef(st), nb, self._serial)
        self._young.append(key)
        self._cur += nb
        for f in self._frames:
            if f.j == 1:
                f.made.append((key, self._serial))

    def _sweep(self, keys) -> None:
        for k in keys:
            entry = self._live.get(k)
            if entry is not None and entry[0].expired():
                self._cur -= self._live.pop(k)[1]

    def _sweep_young(self) -> None:
        young, self._young = self._young, []
        self._sweep(young)

    def _sweep_all(self) -> None:
        self._young = []
        self._sweep(list(self._live))
        self._swept_size = len(self._live)
        self._seen(self._cur)

    def _seen(self, live: int) -> None:
        """`live` bytes were live at once: a candidate for the peak and
        for every open last iteration's."""
        self.peak_bytes = max(self.peak_bytes, live)
        for f in self._frames:
            if f.win is not None:
                f.win = max(f.win, live)

    def _account(self) -> None:
        """Keep `peak_bytes` within its margin of the true peak (see the
        module's docstring), and each open last iteration's exact."""
        top = self.peak_bytes if self._shift is None else \
            self.peak_bytes + (self.peak_bytes >> self._shift)
        for f in self._frames:
            if f.win is not None:
                top = min(top, f.win)
        if self._cur > top:
            self._sweep_young()
            if self._cur > top:
                self._sweep_all()
        elif self.totals.n % _SWEEP_EVERY == 0:
            self._sweep_young()
            if len(self._live) > 2 * self._swept_size + _SWEEP_EVERY:
                self._sweep_all()

    def _loop_begin(self, n: int, k: int) -> _Frame:
        f = _Frame(n, k)
        self._frames.append(f)
        return f

    def _iteration(self, f: _Frame) -> None:
        f.j += 1
        if f.j == f.k - 1 and 3 <= f.k < f.n:
            self._sweep_all()
            f.win = self._cur

    def _loop_end(self, f: _Frame) -> None:
        """The loop of frame `f` ran its k iterations: each storage of its
        second that is still live counts n - k + 1 times from now on, and
        its last iteration's peak with the n - k copies of them is a
        moment of the whole loop."""
        self._frames.remove(f)
        if not 3 <= f.k < f.n:
            return
        self._sweep_all()
        extra = 0
        for key, serial in f.made:
            entry = self._live.get(key)
            if entry is not None and entry[2] == serial:
                self._live[key] = (entry[0], entry[1] * (f.n - f.k + 1),
                                   serial)
                extra += entry[1] * (f.n - f.k)
        self._cur += extra
        self._seen(max(f.win + extra, self._cur))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim" or (_SCALING is not None
                                        and _SCALING.padding):
            return out   # a fake tensor's metadata query; `fill`'s pads
        seen: set = set()
        rec = {"op": func.overloadpacket._qualified_op_name,
               "args": _encode(list(args), seen),
               "out": _encode(out, set())}
        if kwargs:
            rec["kwargs"] = {k: _encode(v, seen) for k, v in kwargs.items()}
        if func.is_view:
            rec["view"] = True
        self.totals.add(rec)
        if self.records is not None:
            self.records.append(rec)
        if self._log is not None:
            self._log.write(json.dumps(rec, separators=(",", ":")) + "\n")
        for t in tree_tensors(out):
            self._track(t)
        # fake tensors' dispatch leaves reference cycles (its closures)
        # that hold op outputs until a collection: collected after each op
        # (the automatic collector is off inside the mode), the live bytes
        # are what the step holds, and the same in every trace
        gc.collect(0)
        self._account()
        return out

    def __enter__(self):
        if self._log_path:
            self._log = gzip.open(self._log_path, "wt")
        self._gc = gc.isenabled()
        gc.disable()
        return super().__enter__()

    def __exit__(self, *exc):
        if self._log_path and self._log is not None:
            self._log.close()
            self._log = None
        if self._gc:
            gc.enable()
        return super().__exit__(*exc)

    def analyze(self) -> Dict[str, Any]:
        return self.totals.result()


def tree_tensors(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts, lists, tuples and dataclasses
    (`RoundInputs`)."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        tree = list(tree.values())
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in tree_tensors(x)]
    return []


# ---------------------------------------------------------------------------
# repeated loops: a scaled trace
# ---------------------------------------------------------------------------

class _Scaling:
    """One trace of `scaled_trace`: the iterations each repeated loop runs
    (`counts`; a loop not named runs `default`, capped at its trip
    count), and what the trace met: each loop's trip count (`trips`) and
    the loops running where it started (`outer`). `costs` is the trace's
    `OpCosts`; `padding` is set while `fill` makes its pads."""

    def __init__(self, counts: Dict[str, int], default: int):
        self.counts = counts
        self.default = default
        self.trips: Dict[str, int] = {}
        self.outer: Dict[str, set] = {}
        self.running: List[str] = []
        self.costs: Optional[OpCosts] = None
        self.padding = False

    def iterate(self, name: str, n: int):
        seen = self.trips.setdefault(name, n)
        if seen != n:
            raise ValueError(f"the repeated loop {name!r} has trip counts "
                             f"{seen} and {n} in one step; give them "
                             f"different names")
        self.outer.setdefault(name, set()).update(self.running)
        k = min(n, self.counts.get(name, self.default))
        costs = self.costs
        f = costs._loop_begin(n, k)
        self.running.append(name)
        for i in range(k):
            costs._iteration(f)
            yield i
        self.running.remove(name)
        costs._loop_end(f)


_SCALING: Optional[_Scaling] = None


def loop(name: str, n: int):
    """The iterations of the repeated loop `name` of trip count `n`:
    `range(n)`, except inside `scaled_trace`, which runs fewer and
    scales the step's totals and peak to `n`. Every iteration must
    dispatch the same ops on the same shapes, apart from the first few."""
    s = _SCALING
    return range(n) if s is None else s.iterate(name, n)


def _pads(like, m: int) -> list:
    """`m` uncounted tensors (or dicts of them) like `like`: views of one
    new storage each leaf."""
    if isinstance(like, dict):
        cols = {k: _pads(v, m) for k, v in like.items()}
        return [{k: cols[k][j] for k in like} for j in range(m)]
    return list(torch.empty((m,) + tuple(like.shape), dtype=like.dtype,
                            device=like.device).unbind(0))


def fill(items: list, n: int) -> list:
    """`items`, the outputs of a repeated loop's iterations (tensors, or
    dicts of them), as `n` of them: as they are after a whole loop;
    inside `scaled_trace`, which ran fewer iterations, padded with
    tensors like the last, which no `OpCosts` counts (so the ops after
    the loop see its trip count's outputs and the totals stay
    multilinear in the iterations run)."""
    s = _SCALING
    if len(items) == n:
        return items
    if s is None or not items:
        raise ValueError(f"fill: {len(items)} outputs of a loop of {n}")
    s.padding = True
    try:
        return list(items) + _pads(items[-1], n - len(items))
    finally:
        s.padding = False


@dataclasses.dataclass
class Trace:
    """What `scaled_trace` gives: the step's totals (`analyze`'s keys),
    the peak of live bytes and the arguments' bytes, each scaled loop's
    trip count and the iterations traced (`loops`), the number of traces
    and the step's outputs (the peak trace's)."""
    totals: Dict[str, Any]
    peak_bytes: int
    argument_bytes: int
    loops: Dict[str, Dict[str, Any]]
    n_traces: int
    outputs: Any


def _run(step: Callable, args, counts: Optional[Dict[str, int]],
         default: int, *, keep: bool = False, log=None):
    """One trace of `step(*args)` under an exact `OpCosts`, the repeated
    loops at `counts` (every loop whole where None): (costs, outputs,
    the `_Scaling` that ran it, None where None)."""
    global _SCALING
    prev = _SCALING
    _SCALING = None if counts is None else _Scaling(counts, default)
    scaling = _SCALING
    try:
        costs = OpCosts(args, keep=keep, log=log, exact=counts is not None)
        if scaling is not None:
            scaling.costs = costs
        with costs:
            out = step(*args)
    finally:
        _SCALING = prev
    return costs, out, scaling


def _signature(x):
    """An op log entry with the integers and floats among its arguments
    left out (its tensors kept whole): what must repeat from one
    iteration of a loop to the next."""
    if isinstance(x, dict):
        if "T" in x:
            return x
        return {k: _signature(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_signature(v) for v in x]
    if isinstance(x, (int, float)) and not isinstance(x, bool):
        return "#"
    return x


def _signatures(records) -> collections.Counter:
    return collections.Counter(
        json.dumps(_signature(r), separators=(",", ":")) for r in records)


def _flat(totals: Dict[str, Any]) -> Dict[str, int]:
    """The additive numbers of `analyze`'s result, by one flat key."""
    out = {}
    for k, v in totals.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": vv for kk, vv in v.items()})
        else:
            out[k] = v
    return out


# a loop runs at most this many iterations in the traces that check it
_MAX_CHECKED = 8


def _steady(name: str, n: int, traces) -> Optional[tuple]:
    """(b, p) for loop `name` of trip count n from `traces` ((costs,
    signatures) of the loop at 1, 2, ... iterations, every other loop at
    one): b, the iterations after which every traced one adds the same
    ops and totals (the first b may legitimately differ; at least two
    past b, or b = n - 1 where every iteration was traced); p, the
    iterations (at least 3) from which the peak of the whole loop reads
    the same in every trace (at least three, or up to n: the last is the
    whole loop's). None while the traces do not show them yet."""
    diffs = []
    for (c0, s0), (c1, s1) in zip(traces, traces[1:]):
        d = collections.Counter(s1)
        d.subtract(s0)
        t0, t1 = _flat(c0.totals.result()), _flat(c1.totals.result())
        diffs.append(({k: v for k, v in d.items() if v},
                      {k: v for k, v in ((k, t1.get(k, 0) - t0.get(k, 0))
                                         for k in set(t0) | set(t1)) if v}))
    m = len(traces)
    b = next((b for b in range(1, len(diffs))
              if all(d == diffs[b - 1] for d in diffs[b:])),
             n - 1 if m == n else None)
    peaks = [c.peak_bytes for c, _ in traces]
    p = next((p for p in range(3, m + 1) if len(set(peaks[p - 1:])) == 1
              and (m - p >= 2 or m == n)), None)
    return None if b is None or p is None else (b, p)


def _unsteady(name: str, traces) -> ValueError:
    d0, d1 = (collections.Counter(s) for _, s in traces[-2:])
    d1.subtract(d0)
    return ValueError(
        f"the repeated loop {name!r} cannot be scaled: up to "
        f"{len(traces)} iterations its iterations do not add the same ops "
        f"and totals, or the peak of the whole loop does not settle (peaks "
        f"from 1 iteration: {[c.peak_bytes for c, _ in traces]}; the last "
        f"iteration's ops: {sorted(k for k, v in d1.items() if v)[:2]})")


def _weighted(parts) -> Dict[str, Any]:
    """sum of weight * totals over `parts` [(weight, totals)], keeping
    `analyze`'s nesting."""
    out: Dict[str, Any] = {}
    for w, tot in parts:
        for k, v in tot.items():
            if isinstance(v, dict):
                d = out.setdefault(k, {})
                for kk, vv in v.items():
                    d[kk] = d.get(kk, 0) + w * vv
            else:
                out[k] = out.get(k, 0) + w * v
    return {k: ({kk: vv for kk, vv in v.items() if vv or k !=
                 "kernel_calls"} if isinstance(v, dict) else v)
            for k, v in out.items()}


def _marker(log, counts, weight: int, base: bool) -> None:
    if log is not None:
        log.write(json.dumps({"trace": counts, "weight": weight,
                              "base": base}, separators=(",", ":")) + "\n")


def _chains(loops: List[str], outer: Dict[str, set]) -> List[tuple]:
    """Every set of `loops` (as a sorted tuple) in which each two are
    nested, one running inside the other: the products of trip counts
    the step's totals may hold (loops that run one after the other add)."""
    def nested(a, b):
        return a in outer.get(b, ()) or b in outer.get(a, ())
    out = []
    for r in range(len(loops) + 1):
        for c in itertools.combinations(loops, r):
            if all(nested(a, b) for a, b in itertools.combinations(c, 2)):
                out.append(c)
    return out


def _weights(chains: List[tuple], trips: Dict[str, int],
             base: Dict[str, int]) -> Dict[tuple, int]:
    """The weight of each chain's trace (its loops at base + 1
    iterations, the others at base) in the totals at the trip counts:
    the totals are sum over chains S of prod_{i in S} (n_i - base_i)
    times S's mixed difference, sum over T in S of (-1)^|S - T| times
    T's trace."""
    w = {c: 0 for c in chains}
    for big in chains:
        m = math.prod(trips[i] - base[i] for i in big)
        for r in range(len(big) + 1):
            for c in itertools.combinations(big, r):
                w[c] += (-1) ** (len(big) - r) * m
    return w


def scaled_trace(step: Callable, args, *, full: bool = False,
                 log: Optional[str] = None) -> Trace:
    """The costs of `step(*args)` on fake tensors (see the module's
    docstring). Each repeated loop (`loop`) of trip count n >= 3 is first
    traced alone at 2, 3, ... iterations, every other loop at one (at
    least to 5, at most to `_MAX_CHECKED`), until its iterations after
    some b add the same ops and totals and its peak reads the same from
    some p >= 3 on (`_steady`), or raises naming it. The totals: a trace
    for each set of nested loops, those at b + 1 iterations and the
    others at b (b = 1 for a loop of n = 2), combined at the trip counts
    (`_weights`). The peak: one trace with every loop at its p.
    `collectives_bytes_periter`: a trace with every loop at one
    iteration. With `full` the step runs whole instead (every iteration
    dispatched, the peak within 1/512), beside the one-iteration trace.
    `log`: the gzipped op log, every trace's entries after a marker of
    its counts and weight (`analyze` reads it back)."""
    from torch._guards import detect_fake_mode
    if detect_fake_mode() is None:
        raise ValueError("scaled_trace runs on fake tensors only: a real "
                         "step dispatches every iteration")
    f = gzip.open(log, "wt") if log else None
    try:
        once, out, sc = _run(step, args, {}, 1, keep=True)
        trips = sc.trips
        if full:
            _marker(f, None, 1, False)
            costs, out, _ = _run(step, args, None, 0, log=f)
            _marker(f, {}, 0, True)
            write_records(f, once.records)
            totals = costs.totals.result()
            totals["collectives_bytes_periter"] = \
                once.totals.result()["collectives_bytes"]
            return Trace(totals, costs.peak_bytes, costs.argument_bytes,
                         {}, 2, out)

        def run(counts, default=1, keep=False, log=None):
            costs, out, s = _run(step, args, counts, default, keep=keep,
                                 log=log)
            if s.trips != trips:
                raise ValueError(f"the repeated loops changed with their "
                                 f"counts {counts}: {s.trips} against "
                                 f"{trips}")
            return costs, out

        def ones(counts):
            return tuple(sorted((k, v) for k, v in counts.items() if v != 1))

        loops = sorted(k for k, n in trips.items() if n >= 2)
        base = {k: 1 for k in loops}
        peak_at = {k: min(trips[k], 3) for k in loops}
        traces = {(): once}           # counts other than 1 -> costs
        n_traces, checked = 1, {}
        once_sig = (once, _signatures(once.records))
        for k in loops:
            seq = [once_sig]
            found = None
            while found is None and len(seq) < min(trips[k], _MAX_CHECKED):
                i = len(seq) + 1
                costs = traces[((k, i),)] = run({k: i}, keep=True)[0]
                seq.append((costs, _signatures(costs.records)))
                n_traces += 1
                if i >= min(trips[k], 5):
                    found = _steady(k, trips[k], seq)
            if trips[k] >= 3:
                if found is None:
                    raise _unsteady(k, seq)
                base[k], peak_at[k] = found
                checked[k] = list(range(1, len(seq) + 1))
                for i in range(2, len(seq) + 1):    # keep the corners'
                    if i not in (base[k], base[k] + 1):
                        del traces[((k, i),)]
        chains = _chains(loops, sc.outer)
        weights = _weights(chains, trips, base)
        parts = []
        for c in chains:
            counts = {k: base[k] + (k in c) for k in loops}
            w = weights[c]
            if w:
                _marker(f, counts, w, False)
            costs = traces.get(ones(counts))
            if costs is None:
                costs = run(counts, log=f if w else None)[0]
                n_traces += 1
            elif w:
                write_records(f, costs.records)
            parts.append((w, costs.totals.result()))
        _marker(f, {}, 0, True)
        write_records(f, once.records)
        peak_trace, out = run(peak_at, 3)
        n_traces += 1
        totals = _weighted(parts)
        totals["collectives_bytes_periter"] = \
            once.totals.result()["collectives_bytes"]
        scaled = {k: {"trip_count": trips[k], "steady_from": base[k],
                      "peak_from": peak_at[k],
                      "iterations": checked.get(k, [1, 2])}
                  for k in loops}
        return Trace(totals, peak_trace.peak_bytes, once.argument_bytes,
                     scaled, n_traces, out)
    finally:
        if f is not None:
            f.close()


def write_records(f, records: Iterable[Dict[str, Any]]) -> None:
    if f is not None:
        for rec in records:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")


def write_log(path: str, records: Iterable[Dict[str, Any]]) -> None:
    with gzip.open(path, "wt") as f:
        write_records(f, records)


def read_log(path: str) -> Iterable[Dict[str, Any]]:
    with gzip.open(path, "rt") as f:
        for line in f:
            yield json.loads(line)
