"""Op-level cost extraction: the port's counterpart of the reference's
`launch/hlo_costs.py`.

The reference reads its costs from the compiled HLO text, where a
`while` loop's body appears once and must be multiplied by its trip
count. The port has no graph: `OpCosts` is a `TorchDispatchMode` that
sees every op the step dispatches, after autograd (the backward's ops
included) and Python control flow: each iteration of a Python loop (the
layer stack, the gradient accumulation, the VEDS slots, the attention's
chunks) dispatches its ops again, so no trip count is needed and none is
unknown. Under a `FakeTensorMode` it records the same ops without
running them (`launch/dryrun.py`).

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
never reads low: when it passes the peak by more than 1/512 of it, the
storages tracked since the last sweep are swept, then (if the total is
still above) all of them, and the peak is read. `peak_bytes` is thus at
most 1/512 below the true peak, and each storage is swept about once
(a sweep of all of them only when the freed ones outweigh that margin,
or when their number has doubled), where sweeping all at every new high
made a long recurrence (xlstm's sLSTM, ~20 M ops) quadratic.
"""
from __future__ import annotations

import dataclasses
import gzip
import json
from typing import Any, Dict, Iterable, List, Optional

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
    `result()` the totals so far."""

    def __init__(self):
        self.flops = 0                 # integers: exact past 2^53
        self.hbm = 0
        self.coll = {k: 0 for k in _COLLECTIVES}
        self.coll_n = {k: 0 for k in _COLLECTIVES}
        self.kernels: Dict[str, int] = {}
        self.n = 0
        self._packets: Dict[str, Any] = {}

    def add(self, rec: Dict[str, Any]) -> None:
        self.n += 1
        name = rec["op"]
        args = _decode(rec["args"])
        kwargs = {k: _decode(v) for k, v in rec.get("kwargs", {}).items()}
        out = _decode(rec["out"])
        if name in KERNEL_COSTS:
            ops, nbytes = KERNEL_COSTS[name](*args, **kwargs)
            self.kernels[name] = self.kernels.get(name, 0) + 1
            self.flops += ops
            self.hbm += nbytes
            return
        if name not in self._packets:
            self._packets[name] = _packet(name)
        pk = self._packets[name]
        formula = FLOP_FORMULAS.get(pk) or flop_registry.get(pk)
        if formula is not None:
            self.flops += formula(
                *_shapes(args), out_val=_shapes(out),
                **{k: _shapes(v) for k, v in kwargs.items()})
        kind = _C10D_KINDS.get(name.partition("::")[2]) \
            if name.startswith(("c10d::", "_c10d_functional::")) else None
        if kind is not None:
            self.coll[kind] += sum(d.numel() * d.element_size()
                                   for d in _descs(args[0]))
            self.coll_n[kind] += 1
        if not rec.get("view"):
            self.hbm += sum(d.nbytes for d in _descs(args)) + sum(
                d.nbytes for v in kwargs.values() for d in _descs(v)) + sum(
                d.numel() * d.element_size() for d in _descs(out))

    def result(self) -> Dict[str, Any]:
        return {"dot_flops": self.flops, "hbm_bytes": self.hbm,
                "collectives_bytes": dict(self.coll),
                "collectives_count": dict(self.coll_n),
                "kernel_calls": dict(self.kernels), "n_ops": self.n}


def analyze(records: Iterable[Dict[str, Any]]) -> Dict[str, Any]:
    """dot_flops, hbm_bytes, collectives_bytes/_count (by kind),
    kernel_calls and n_ops of a log of `record` entries."""
    totals = Totals()
    for rec in records:
        totals.add(rec)
    return totals.result()


class OpCosts(TorchDispatchMode):
    """Adds every op dispatched inside it to its `totals`, to `records`
    with `keep`, and to the gzipped op log at `log` (one JSON entry a
    line; closed when the mode exits), and tracks the peak of live bytes
    (`peak_bytes`), counting the storages of `arguments` (the step's
    inputs, `add_arguments`) from the start."""

    def __init__(self, arguments=None, *, log: Optional[str] = None,
                 keep: bool = False):
        super().__init__()
        self.totals = Totals()
        self.records: Optional[List[Dict[str, Any]]] = [] if keep else None
        self._log_path = log
        self._log = None
        self._live: Dict[int, tuple] = {}
        self._young: List[int] = []    # tracked since the last sweep
        self._swept_size = 0           # len(_live) after the last full one
        self._cur = 0
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
        self._live[key] = (StorageWeakRef(st), nb)
        self._young.append(key)
        self._cur += nb

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
        self.peak_bytes = max(self.peak_bytes, self._cur)

    def _account(self) -> None:
        """Keep `peak_bytes` within 1/512 of the true peak (see the
        module's docstring)."""
        if self._cur > self.peak_bytes + (self.peak_bytes >> 9):
            self._sweep_young()
            if self._cur > self.peak_bytes + (self.peak_bytes >> 9):
                self._sweep_all()
        elif self.totals.n % _SWEEP_EVERY == 0:
            self._sweep_young()
            if len(self._live) > 2 * self._swept_size + _SWEEP_EVERY:
                self._sweep_all()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "prim":
            return out               # a fake tensor's metadata query
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
        self._account()
        return out

    def __enter__(self):
        if self._log_path:
            self._log = gzip.open(self._log_path, "wt")
        return super().__enter__()

    def __exit__(self, *exc):
        if self._log is not None:
            self._log.close()
            self._log = None
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


def write_log(path: str, records: Iterable[Dict[str, Any]]) -> None:
    with gzip.open(path, "wt") as f:
        for rec in records:
            f.write(json.dumps(rec, separators=(",", ":")) + "\n")


def read_log(path: str) -> Iterable[Dict[str, Any]]:
    with gzip.open(path, "rt") as f:
        for line in f:
            yield json.loads(line)
