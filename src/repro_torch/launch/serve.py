"""Scheduling as a service: the packing core that batches per-cell
rollout requests into one dispatch.

Port of the synchronous core of `repro/launch/serve.py` (`ServeConfig`
through `SchedulingService`). The paper's VEDS is an online scheduler:
each round an RSU must answer "which vehicles upload, with what
cooperation and power" against the current fleet state, under latency
pressure. Many clients submit per-cell requests (`ServeRequest`: a
session id, a round count, a seed); `SchedulingService.run_batch` packs
up to B of them into the [B] cell axis of ONE fused rollout
(`repro_torch.fl.engine.fused_segment`) and slices each client's results
back out.

Cost follows the requested work, not the padded work: the service keeps
a ladder of tiers, horizons `ServeConfig.horizons` x occupancies
`ServeConfig.occupancies`, and `route` sends a batch to the smallest
tier that fits its longest request and its request count. In the
reference each tier is a compiled program; here a tier is a loop length
and a cell count, and what is built once per tier is the VEDS slot graph
of its occupancy (`repro_torch.core.veds`, one CUDA graph a round shape,
captured at the first round of that shape). `warmup()` captures the
graph of every occupancy rung and pins it, so no graph is captured, or
evicted by another service's shapes, inside a timed dispatch.

Session state is bounded: `SessionStore` keeps at most
`ServeConfig.max_sessions` carries on the device (LRU) and spills colder
ones to the host as CPU tensors in their own dtypes, so that a restored
carry is the spilled one bit for bit (bf16 leaves included).

The exactness contract: a packed cell is the same request run alone at
B = 1 at any tier, decisions identical. Three pieces make it hold:

  per-cell keys    the packed rollout gets `keys [L][B]`: every cell its
                   own request's round key, from which `fleet_round`
                   draws cell b's mobility and channels exactly as a
                   B = 1 call with that key draws them.
  per-cell active  requests of ragged round counts pack at the tier's
                   horizon L: `active [L, B]` keeps cell b live for its
                   own R_b rounds; inactive rounds and padding cells are
                   computed and discarded, their carry passing through
                   untouched.
  session cache    each session's state (persistent fleet with the P4
                   warm-start table, model params, optimizer state)
                   lives server-side as a B = 1 `RolloutCarry`, packed
                   into the batch (`pack_cells`) and sliced back out
                   after it (`unpack_cell`), so repeat clients ride the
                   warm P4 path across requests.

Training runs cell by cell, so its bits never depend on the batch. The
scheduling step runs on the whole [B] batch; its elementwise work is the
same per cell at any B. Its P4 solve is batch-invariant on the card: the
`p4_solve` kernel gives each candidate one warp and shares no work
across candidates, where the plain version's batched solves and
reductions may pick other algorithms by batch size. Packed floats are
still held to solo decisions exactly and to their own run bit for bit,
and their distance from solo is measured (`chip_smoke.py phase_serve`),
not assumed: the step's other reductions remain.

The asyncio front end: `BatchServer` collects concurrent requests into
windows and hands each window to `run_batch`; `closed_loop_load` and
`poisson_load` are the reference's synthetic clients, `drive` runs a
batched service and the sequential B = 1 baseline under one of them, and
`main` is the command line (`python -m repro_torch.launch.serve`). Its
threading and CUDA-graph design:

  capture first    slot graphs are captured only in `warmup()`, which the
                   caller runs before `BatchServer.__aenter__` (`drive`
                   does; its sequential baseline warms up only after the
                   batched server has closed). `torch.cuda.graph` captures
                   in the global mode, where a CUDA call from any other
                   thread during a capture invalidates it, so no capture
                   may overlap a running server. A dispatch that captures
                   anyway is counted (`ServeMetrics.n_captures`), and a
                   load is held to 0.
  one thread       `run_batch` runs on the server's one-thread executor,
                   so every CUDA call of a dispatch (the draws, the copies
                   into the slot graph's static buffers, the replays, the
                   read-back) is made from that thread on its current
                   stream, and dispatches never overlap. The server opens
                   no side stream. The event loop's thread touches no CUDA
                   tensor: a `ServeResponse` holds numpy arrays and the
                   metrics hold floats.
  errors shown     a dispatch that raises fails every future of its batch
                   with the exception; the loads `gather` without
                   `return_exceptions`, so the error reaches `drive` and
                   `main`. Nothing is retried or rerun on the CPU or a
                   plain version: a CUDA error is sticky, and the next
                   dispatch fails the same way.
  timing           `run_batch` reads every output to the host before it
                   returns, so the time taken when the executor's future
                   resolves closes on finished device work; the event
                   loop never synchronises the device.

All requests' draws come from their seeds alone (`request_draws`, on the
port's stream scheme of `round_key`), and a session's fleet from
(`ServeConfig.seed`, crc32 of the session id), so a request's response
does not depend on what it was packed with.
"""
from __future__ import annotations

import argparse
import asyncio
import collections
import concurrent.futures
import dataclasses
import json
import sys
import time
import weakref
import zlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.channel.mobility import ManhattanParams
from repro_torch.channel.v2x import ChannelParams
from repro_torch.core import veds
from repro_torch.core.lyapunov import VedsParams
from repro_torch.core.scenario import ScenarioParams, round_key
from repro_torch.core.scheduler import RolloutCarry, map_tree
from repro_torch.core.streaming import (ROUND_STREAM, StreamConfig,
                                        pack_cells, unpack_cell)
from repro_torch.fl.engine import ClientShards, fused_segment, init_carry
from repro_torch.fl.simulator import client_draws


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Static service configuration (fixes the tier ladder).

      batch        B: max packed cell slots per dispatch
      max_rounds   L: the round horizon; requests with fewer rounds pad
                   with inactive tail rounds, more are rejected. Ignored
                   when `tiers` is set (the ladder's max wins)
      tiers        optional ascending horizon ladder, e.g. (8, 32, 128):
                   each batch routes to the smallest horizon >= its max
                   `n_rounds`. None = the single `max_rounds` horizon
      batch_tiers  optional ascending occupancy ladder (max must equal
                   `batch`): each batch routes to the smallest bucket
                   >= its request count. None = powers of two up to
                   `batch` when `tiers` is set, else the single `batch`
      max_sessions optional bound on DEVICE-resident sessions: beyond it
                   the LRU session's carry spills to the host and
                   restores bitwise on its next request. None = every
                   session stays on the device
      window_s     `BatchServer`'s batching window: how long the collector
                   waits after a window's first request for more
      bucket_rounds `BatchServer` splits a window by horizon rung before
                   routing, shortest rung first
    """
    batch: int = 4
    max_rounds: int = 4
    tiers: Optional[Tuple[int, ...]] = None
    batch_tiers: Optional[Tuple[int, ...]] = None
    max_sessions: Optional[int] = None
    bucket_rounds: bool = True
    window_s: float = 0.002
    scheduler: str = "madca"
    n_sov: int = 4
    n_opv: int = 3
    n_slots: int = 10
    batch_size: int = 8          # minibatch size per selected client
    n_clients: int = 10          # default service-wide dataset size
    n_fleet: Optional[int] = None
    carry_queues: bool = True
    ipm_warm_iters: int = 0      # VEDS+COT: warm P4 budget per candidate
    ipm_iters: Optional[int] = None
    lr: float = 0.05
    alpha: float = 2.0
    V: float = 0.2
    q_bits: float = 1e7
    seed: int = 0

    @property
    def horizons(self) -> Tuple[int, ...]:
        """The ascending horizon ladder (a single rung without tiers)."""
        if self.tiers is None:
            return (int(self.max_rounds),)
        return tuple(sorted({int(t) for t in self.tiers}))

    @property
    def occupancies(self) -> Tuple[int, ...]:
        """The ascending occupancy ladder. Defaults to powers of two up
        to `batch` when horizon tiers are on (partial windows then pay
        for their bucket, not for B), else the single full `batch`."""
        B = int(self.batch)
        if self.batch_tiers is not None:
            return tuple(sorted({int(b) for b in self.batch_tiers}))
        if self.tiers is None:
            return (B,)
        ladder = []
        b = 1
        while b < B:
            ladder.append(b)
            b *= 2
        return tuple(ladder) + (B,)


@dataclasses.dataclass(frozen=True)
class ServeRequest:
    """One client request: roll `n_rounds` scheduling+training rounds of
    the session's cell forward, with draws derived from `seed`."""
    session: str
    n_rounds: int
    seed: int = 0


@dataclasses.dataclass
class ServeResponse:
    """Per-request results sliced out of the packed dispatch, plus the
    request's latency decomposition (filled by the front end)."""
    session: str
    n_rounds: int
    success: np.ndarray          # [R, S] bool upload-success masks
    n_success: np.ndarray        # [R]
    loss: np.ndarray             # [R] weighted mean local training loss
    tier: str = ""               # "L{L}xB{B}" tier that served it
    queue_wait_s: float = 0.0
    compute_s: float = 0.0
    total_s: float = 0.0


def _linear_softmax_loss(p, b):
    logp = torch.log_softmax(b["x"] @ p["w"], -1)
    return -torch.gather(logp, -1, b["y"][:, None]).mean()


def default_problem(n_clients: int = 10, dim: int = 8, classes: int = 3,
                    seed: int = 42, device=None):
    """The tiny linear-softmax FL problem the service trains by default
    (the serving benchmarks' workload): `n_clients` ragged clients of
    24, 28 or 32 samples around `classes` prototypes. Drawn on the CPU
    from a generator seeded with `seed`, then moved to `device` (CUDA
    unless the caller names another), so every device serves the same
    problem. Returns (params, loss_fn, ClientShards)."""
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(int(seed))
    protos = torch.randn((classes, dim), generator=gen)
    data = []
    for i in range(n_clients):
        n = 24 + 4 * (i % 3)
        y = torch.randint(0, classes, (n,), generator=gen)
        x = protos[y] + 0.5 * torch.randn((n, dim), generator=gen)
        data.append({"x": x, "y": y})
    params = {"w": torch.zeros((dim, classes), device=device)}
    return (params, _linear_softmax_loss,
            ClientShards.from_ragged(data, device))


def request_draws(seed: int, n_rounds: int, n_clients: int, n_sov: int,
                  batch_size: int, device=None):
    """A request's draws, from its seed alone (the streaming loop's
    scheme, `fl/simulator.py`): per-round scheduling keys [R] (ints, one
    generator each), client selections `sel [R, S]` and uniform
    minibatch draws `mb_u [R, S, bs]` on `device`. The solo B = 1 run
    and the packed cell consume the same draws because both call this."""
    device = resolve_device(device)
    keys = [round_key(seed, ROUND_STREAM, r) for r in range(n_rounds)]
    sel, mb_u = client_draws(seed, n_rounds, n_clients, n_sov, batch_size,
                             device)
    return keys, sel, mb_u


def _pad_rows(x, length: int):
    """Pad `[R, ...]` (a tensor or a list) to `[length, ...]` by
    repeating the last row: the tail rows belong to inactive rounds,
    computed then discarded."""
    R = len(x)
    if R == length:
        return x
    if isinstance(x, list):
        return x + [x[-1]] * (length - R)
    return torch.cat([x, x[-1:].expand((length - R,) + x.shape[1:])])


def _padded_draws(seed: int, R: int, L: int, n_clients: int, n_sov: int,
                  batch_size: int, device):
    """The draw column of an R-round request at horizon L:
    `request_draws` padded from R rounds to L, and its active mask [L]
    on the host."""
    keys, sel, mb_u = request_draws(seed, R, n_clients, n_sov, batch_size,
                                    device)
    return (_pad_rows(keys, L), _pad_rows(sel, L), _pad_rows(mb_u, L),
            np.arange(L) < R)


def _assemble(carries, cols, actives):
    """Batch assembly: pack the session carries along the cell axis and
    lay the per-request draw columns out as the tier's inputs, keys
    [L][B], sel [L, B, S], mb_u [L, B, S, bs] and active [L, B]. The
    caller pads every list to the tier occupancy (replicas of slot 0,
    all-inactive active columns)."""
    carry = pack_cells(carries)
    keys = [list(ks) for ks in zip(*(c[0] for c in cols))]
    sel = torch.stack([c[1] for c in cols], 1)
    mb_u = torch.stack([c[2] for c in cols], 1)
    active = np.stack(actives, 1)
    return carry, keys, sel, mb_u, active


def _split_cells(state, n: int):
    """The first `n` cells back out as B=1 states, each a copy of its
    own (so a stored session keeps no packed batch alive)."""
    return tuple(map_tree(torch.clone, unpack_cell(state, b))
                 for b in range(n))


def _pct(xs: Sequence[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if len(xs) else \
        float("nan")


@dataclasses.dataclass
class ServeMetrics:
    """Per-request latency decomposition + batch occupancy counters +
    padding/tier accounting (what fraction of the computed round-slots
    and cell slots was padding, and which tier served each dispatch) +
    session spill/restore counts + slot graphs captured by dispatches
    outside warm-up."""
    queue_wait_s: List[float] = dataclasses.field(default_factory=list)
    compute_s: List[float] = dataclasses.field(default_factory=list)
    total_s: List[float] = dataclasses.field(default_factory=list)
    rounds: List[int] = dataclasses.field(default_factory=list)
    occupancy: List[int] = dataclasses.field(default_factory=list)
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    rounds_active: int = 0       # requested rounds over real cells
    rounds_computed: int = 0     # L_tier x real cells: round-slots paid
    cells_active: int = 0        # real cells packed
    cells_computed: int = 0      # B_tier per dispatch: cell slots paid
    tier_hits: Dict[str, int] = dataclasses.field(
        default_factory=lambda: collections.defaultdict(int))
    n_spills: int = 0            # session carries spilled device->host
    n_restores: int = 0          # spilled carries restored host->device
    n_captures: int = 0          # slot graphs captured outside warm-up

    def observe_dispatch(self, reqs: Sequence[ServeRequest], L: int,
                         B: int) -> None:
        """Account one packed dispatch's padding against the tier
        (L, B) that served it."""
        self.rounds_active += sum(int(r.n_rounds) for r in reqs)
        self.rounds_computed += L * len(reqs)
        self.cells_active += len(reqs)
        self.cells_computed += B
        self.tier_hits[f"L{L}xB{B}"] += 1

    def observe_batch(self, reqs: Sequence[ServeRequest],
                      t_submit: Sequence[float], t_start: float,
                      t_end: float) -> None:
        for r, ts in zip(reqs, t_submit):
            self.queue_wait_s.append(t_start - ts)
            self.compute_s.append(t_end - t_start)
            self.total_s.append(t_end - ts)
            self.rounds.append(int(r.n_rounds))
            self.t_first = ts if self.t_first is None \
                else min(self.t_first, ts)
        self.t_last = t_end if self.t_last is None \
            else max(self.t_last, t_end)
        self.occupancy.append(len(reqs))

    def summary(self) -> Dict[str, float]:
        """Aggregate view: p50/p99 total latency, mean queue-wait and
        compute, aggregate rounds/s over the observed wall span, mean
        batch occupancy (packed cells per dispatch), padding shares, tier
        hits, spills, restores and slot graphs captured in the load; and,
        beyond the reference's keys, p50/p99 of the queue wait and of the
        compute."""
        wall = (self.t_last - self.t_first
                if self.total_s and self.t_last > self.t_first else
                float("nan"))
        return {
            "n_requests": len(self.total_s),
            "n_batches": len(self.occupancy),
            "p50_ms": 1e3 * _pct(self.total_s, 50),
            "p99_ms": 1e3 * _pct(self.total_s, 99),
            "mean_queue_wait_ms": 1e3 * float(
                np.mean(self.queue_wait_s)) if self.queue_wait_s
            else float("nan"),
            "mean_compute_ms": 1e3 * float(np.mean(self.compute_s))
            if self.compute_s else float("nan"),
            "p50_queue_wait_ms": 1e3 * _pct(self.queue_wait_s, 50),
            "p99_queue_wait_ms": 1e3 * _pct(self.queue_wait_s, 99),
            "p50_compute_ms": 1e3 * _pct(self.compute_s, 50),
            "p99_compute_ms": 1e3 * _pct(self.compute_s, 99),
            "rounds_per_s": sum(self.rounds) / wall,
            "mean_occupancy": float(np.mean(self.occupancy))
            if self.occupancy else float("nan"),
            # padding actually paid for: the share of real cells'
            # computed round-slots that were inactive tail rounds, and
            # the share of computed cell slots that were padding cells
            "pad_frac_rounds": 1.0 - self.rounds_active
            / self.rounds_computed if self.rounds_computed
            else float("nan"),
            "pad_frac_cells": 1.0 - self.cells_active
            / self.cells_computed if self.cells_computed
            else float("nan"),
            "tier_hits": dict(self.tier_hits),
            "n_spills": self.n_spills,
            "n_restores": self.n_restores,
            "n_captures": self.n_captures,
        }


def _to_host(x: torch.Tensor) -> torch.Tensor:
    """A spilled leaf: a CPU copy in its own dtype (numpy has no bf16,
    and a cast on the way out would break the bitwise restore)."""
    return x.detach().to("cpu", copy=True)


class SessionStore:
    """Bounded session cache: at most `max_sessions` carries stay on the
    device (LRU); colder sessions spill to the host and restore bitwise
    on their next touch.

    `get`/`put` move the session to the LRU front; overflowing carries
    are copied leaf by leaf to CPU tensors of the same dtype and moved
    back to `device` on restore, so an evict -> restore round trip is
    bitwise and a spilled session's next request behaves exactly as if
    it had stayed on the device. `max_sessions=None` keeps every session
    on the device. Mapping-style access (`store[s]`, `s in store`,
    `iter`, `pop`) spans device and spilled sessions alike.

    Not thread-safe by itself: the service's batches are serialized,
    which is also what makes the LRU order meaningful.
    """

    def __init__(self, max_sessions: Optional[int] = None,
                 metrics: Optional[ServeMetrics] = None, device=None):
        if max_sessions is not None and int(max_sessions) < 1:
            raise ValueError("max_sessions must be >= 1 (or None)")
        self.max_sessions = (None if max_sessions is None
                             else int(max_sessions))
        self.metrics = metrics
        self.device = resolve_device(device)
        self._hot: "collections.OrderedDict[str, RolloutCarry]" = \
            collections.OrderedDict()
        self._spilled: Dict[str, RolloutCarry] = {}

    @property
    def n_device(self) -> int:
        """Sessions currently holding device memory."""
        return len(self._hot)

    @property
    def n_spilled(self) -> int:
        return len(self._spilled)

    def __len__(self) -> int:
        return len(self._hot) + len(self._spilled)

    def __iter__(self) -> Iterator[str]:
        return iter(list(self._hot) + list(self._spilled))

    def __contains__(self, session: str) -> bool:
        return session in self._hot or session in self._spilled

    def get(self, session: str) -> Optional[RolloutCarry]:
        """The session's device-resident carry (restored from a spill if
        needed), refreshed to most-recently-used; None if unknown."""
        if session in self._hot:
            self._hot.move_to_end(session)
            return self._hot[session]
        host = self._spilled.pop(session, None)
        if host is None:
            return None
        carry = map_tree(lambda x: x.to(self.device), host)
        if self.metrics is not None:
            self.metrics.n_restores += 1
        self.put(session, carry)
        return carry

    def put(self, session: str, carry: RolloutCarry) -> None:
        """Store/refresh the session at the LRU front, spilling the
        least-recently-used carries past `max_sessions` to the host."""
        self._spilled.pop(session, None)
        self._hot[session] = carry
        self._hot.move_to_end(session)
        while (self.max_sessions is not None
               and len(self._hot) > self.max_sessions):
            cold, c = self._hot.popitem(last=False)
            self._spilled[cold] = map_tree(_to_host, c)
            if self.metrics is not None:
                self.metrics.n_spills += 1

    def pop(self, session: str, default=None):
        if session in self._hot:
            return self._hot.pop(session)
        return self._spilled.pop(session, default)

    def __getitem__(self, session: str) -> RolloutCarry:
        carry = self.get(session)
        if carry is None:
            raise KeyError(session)
        return carry

    def __setitem__(self, session: str, carry: RolloutCarry) -> None:
        self.put(session, carry)


class SchedulingService:
    """The packing core: sessions, the tier ladder, `run_batch`.

    Synchronous and event-loop-free so it is directly testable. A custom
    FL workload plugs in via (`params`, `loss_fn`, `client_data`);
    omitted, the service trains `default_problem()`. Runs on `device`
    (CUDA unless the caller names another).

    On a CUDA device `warmup()` pins the slot graphs of its occupancy
    ladder for the service's lifetime; `close()` (or the service's
    collection) releases them.
    """

    def __init__(self, cfg: ServeConfig, *, params=None, loss_fn=None,
                 client_data=None, device=None):
        self.cfg = cfg
        if int(cfg.batch) < 1 or int(cfg.max_rounds) < 1:
            raise ValueError("batch and max_rounds must be >= 1")
        if cfg.horizons[0] < 1:
            raise ValueError(f"tiers must be >= 1, got {cfg.tiers}")
        if cfg.occupancies[0] < 1 or cfg.occupancies[-1] != int(cfg.batch):
            raise ValueError(f"batch_tiers must be within 1..batch and "
                             f"top out at batch={cfg.batch}, got "
                             f"{cfg.batch_tiers}")
        self.device = resolve_device(device)
        self.mob = ManhattanParams()
        self.ch = ChannelParams()
        prm_kw = {} if cfg.ipm_iters is None else \
            {"ipm_iters": int(cfg.ipm_iters)}
        self.prm = VedsParams(alpha=cfg.alpha, V=cfg.V, Q=cfg.q_bits,
                              slot=0.1,
                              ipm_warm_iters=cfg.ipm_warm_iters, **prm_kw)
        self.sc = ScenarioParams(n_sov=cfg.n_sov, n_opv=cfg.n_opv,
                                 n_slots=cfg.n_slots,
                                 batch_size=cfg.batch_size)
        if loss_fn is None:
            params, loss_fn, client_data = default_problem(
                cfg.n_clients, device=self.device)
        self.params0 = {k: v.detach().to(self.device)
                        for k, v in params.items()}
        self.loss_fn = loss_fn
        self.shards = (client_data.to(self.device)
                       if isinstance(client_data, ClientShards)
                       else ClientShards.from_ragged(client_data,
                                                     self.device))
        # no handoff in packed mode: cells are independent sessions, and
        # per-cell keys and active masks cannot compose with the exchange
        self._stream = StreamConfig(n_rounds=0, batch=int(cfg.batch),
                                    carry_queues=cfg.carry_queues,
                                    n_fleet=cfg.n_fleet)
        self._seg = {
            b: fused_segment(loss_fn, cfg.scheduler, self.sc, self.mob,
                             self.ch, self.prm,
                             dataclasses.replace(self._stream, batch=b),
                             cfg.lr, 1, None, 1)
            for b in cfg.occupancies}
        self.metrics = ServeMetrics()
        self.sessions = SessionStore(cfg.max_sessions, metrics=self.metrics,
                                     device=self.device)
        # per-horizon constants: step ids, the (empty) in-loop eval mask,
        # and the padding cells' all-inactive active column
        self._steps = {L: list(range(L)) for L in cfg.horizons}
        self._ev = {L: np.zeros(L, bool) for L in cfg.horizons}
        self._off = {L: np.zeros(L, bool) for L in cfg.horizons}
        self.warmup_captures = 0
        self._pins: set = set()
        self._unpin = weakref.finalize(self, veds.unpin_slot_graphs,
                                       self._pins)

    def close(self) -> None:
        """Release the pins on the slot graphs `warmup()` captured."""
        self._unpin()

    def session_seed(self, session: str) -> int:
        """The seed of a session's fleet: from (service seed, crc32 of
        the session id) alone."""
        return int(np.random.SeedSequence(
            [int(self.cfg.seed), zlib.crc32(session.encode())])
            .generate_state(1)[0])

    def _new_carry(self, session: str) -> RolloutCarry:
        return init_carry(self.session_seed(session), self.sc, self.mob,
                          dataclasses.replace(self._stream, batch=1),
                          self.params0, ch=self.ch, device=self.device)

    def _column(self, req: ServeRequest, L: int):
        """The request's draw column at horizon L: (keys [L], sel [L, S],
        mb_u [L, S, bs], active [L])."""
        return _padded_draws(int(req.seed), int(req.n_rounds), L,
                             self.shards.n_clients, self.cfg.n_sov,
                             self.cfg.batch_size, self.device)

    def session_carry(self, session: str) -> RolloutCarry:
        """The session's B=1 carry (persistent fleet incl. the P4
        warm-start table, model params, optimizer state), created
        deterministically from `session_seed` on first use, restored
        from a host spill on re-use past `max_sessions`."""
        carry = self.sessions.get(session)
        if carry is None:
            carry = self._new_carry(session)
            self.sessions.put(session, carry)
        return carry

    def route(self, reqs: Sequence[ServeRequest]) -> Tuple[int, int]:
        """The tier that serves this batch: the smallest horizon >= the
        batch's max `n_rounds` x the smallest occupancy bucket >= its
        request count (both ladders validated to cover the range)."""
        R = max(int(r.n_rounds) for r in reqs)
        L = next(h for h in self.cfg.horizons if h >= R)
        B = next(b for b in self.cfg.occupancies if b >= len(reqs))
        return L, B

    def warmup(self, rounds: Sequence[int] = ()) -> None:
        """Capture the slot graph of every occupancy rung outside any
        timed load and pin it for the service's lifetime. The warm-up
        dispatches run from a fresh carry that is never stored, so the
        sessions, their LRU order and the metrics stay untouched. A graph
        is keyed by the round's shape, which the occupancy sets and the
        horizon does not, so one dispatch a rung at the shortest horizon
        warms every tier. Schedulers without a slot graph capture
        nothing. Run it before a `BatchServer` takes requests: a capture
        must not overlap another thread's CUDA calls.

        `rounds` is the reference's hint of the load's round counts, for
        which it compiles its draw programs ahead of the load. The port's
        draws (`_padded_draws`) run eagerly and compile nothing, so the
        hint is accepted and changes nothing."""
        c0 = veds._SlotGraph.captures
        req = ServeRequest("warmup", n_rounds=self.cfg.horizons[0])
        carry = self._new_carry(req.session)
        try:
            with veds.pin_slot_graphs() as keys:
                for B in self.cfg.occupancies:
                    self._dispatch([req], [carry], req.n_rounds, B)
        finally:
            # one pin a graph for this service, however often it warms up
            veds.unpin_slot_graphs(keys & self._pins)
            self._pins |= keys
        self.warmup_captures += veds._SlotGraph.captures - c0

    def run_batch(self, reqs: Sequence[ServeRequest], *,
                  stage_hook=None) -> List[ServeResponse]:
        """Pack the requests into the cell axis of ONE dispatch of the
        smallest fitting tier and slice responses back out.

        Ragged batches pad on both axes of their tier: occupancy < B_t
        fills the spare cell slots with a replica of the first session
        under an all-inactive column, and R_b < L_t rounds pad with
        inactive tail rounds: padding is computed and discarded, never
        perturbing a real cell. Each session's refreshed carry is stored
        back in the (bounded) store before the responses return; reading
        the outputs to the host ends the dispatch's device work.
        `stage_hook(name)`, if given, is called after the "scenario",
        "schedule", "train" and "eval" stages of every round of the
        dispatch, as `run_fl`'s (a caller may time them)."""
        cfg = self.cfg
        max_B, max_L = cfg.occupancies[-1], cfg.horizons[-1]
        reqs = list(reqs)
        if not 0 < len(reqs) <= max_B:
            raise ValueError(f"{len(reqs)} requests for {max_B} cell "
                             "slots")
        if len({r.session for r in reqs}) != len(reqs):
            raise ValueError("duplicate sessions in one batch: packed "
                             "cells would race on one session's state")
        for r in reqs:
            if not 0 < int(r.n_rounds) <= max_L:
                raise ValueError(f"n_rounds={r.n_rounds} outside the "
                                 f"tier horizons 1..{max_L}")
        L, B = self.route(reqs)
        carries = [self.session_carry(r.session) for r in reqs]
        c0 = veds._SlotGraph.captures
        new, out = self._dispatch(reqs, carries, L, B, stage_hook)
        for r, c in zip(reqs, new):
            self.sessions.put(r.session, c)
        self.metrics.observe_dispatch(reqs, L, B)
        self.metrics.n_captures += veds._SlotGraph.captures - c0
        return out

    def _dispatch(self, reqs, carries, L: int, B: int, stage_hook=None):
        """One dispatch of tier (L, B) from the requests' B=1 `carries`:
        returns their refreshed carries and the responses, and stores
        nothing."""
        cols = [self._column(r, L) for r in reqs]
        n_pad = B - len(reqs)
        actives = [c[3] for c in cols] + [self._off[L]] * n_pad
        carries = list(carries) + [carries[0]] * n_pad
        cols = cols + [cols[0]] * n_pad
        carry, keys, sel, mb_u, active = _assemble(carries, cols, actives)
        res = self._seg[B](carry, keys, sel, mb_u, self.shards,
                           self._steps[L], active, self._ev[L],
                           stage_hook=stage_hook)
        fleets = _split_cells(res.fleet, len(reqs))
        params = _split_cells(res.params, len(reqs))
        opts = ((None,) * len(reqs) if res.opt_state is None
                else _split_cells(res.opt_state, len(reqs)))
        # one device->host transfer per output array, numpy slicing after
        succ = res.outputs.success.cpu().numpy()
        n_succ = res.outputs.n_success.cpu().numpy()
        loss = res.loss.cpu().numpy()
        new = [RolloutCarry(sched=fleets[b], params=params[b],
                            opt_state=opts[b]) for b in range(len(reqs))]
        out = [ServeResponse(session=r.session, n_rounds=int(r.n_rounds),
                             success=succ[:int(r.n_rounds), b],
                             n_success=n_succ[:int(r.n_rounds), b],
                             loss=loss[:int(r.n_rounds), b],
                             tier=f"L{L}xB{B}")
               for b, r in enumerate(reqs)]
        return new, out


class BatchServer:
    """Continuous-batching front end over a `SchedulingService`.

    `submit` enqueues a request and awaits its response. A collector
    task takes the first queued request, waits up to `window_s` for more
    (up to `max_batch`), then runs the packed dispatch on a one-thread
    executor: off the event loop, so arrivals keep flowing during
    compute, and serialized, so two batches never race on one session's
    state and every CUDA call of every dispatch comes from one thread
    (the module docstring's design). Warm the service up before entering
    the server.

    Deferral fairness: a request sharing a session with one already in
    the forming batch is deferred (a session's requests are sequential:
    each resumes the state the previous one left), and deferred requests
    seed the NEXT batch FIFO-first, ahead of any newer arrivals, so a
    session whose requests keep coming waits at most the batches its own
    predecessors occupy, never behind fresh traffic. A stop drains the
    deferred requests before the collector ends.

    Round bucketing (`ServeConfig.bucket_rounds`): a collected window is
    split by horizon rung before routing, shortest rung first. `route()`
    pads every cell of a dispatch to the batch's longest rung, so a
    1-round request packed with an L-round one would pay L - 1 inactive
    rounds; bucketed, each group goes to its own smallest tier. On a
    single-rung ladder the split is a no-op.

    A batch whose dispatch raises fails every one of its futures with
    the exception, and the collector goes on to the next batch."""

    def __init__(self, service: SchedulingService, *,
                 window_s: Optional[float] = None,
                 max_batch: Optional[int] = None):
        self.service = service
        self.window_s = float(service.cfg.window_s if window_s is None
                              else window_s)
        self.max_batch = int(service.cfg.batch if max_batch is None
                             else max_batch)
        if not 0 < self.max_batch <= int(service.cfg.batch):
            raise ValueError(f"max_batch={self.max_batch} outside "
                             f"1..{service.cfg.batch}")
        self._queue: asyncio.Queue = asyncio.Queue()
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="serve-dispatch")
        self._task: Optional[asyncio.Task] = None

    async def __aenter__(self) -> "BatchServer":
        self._task = asyncio.get_running_loop().create_task(self._run())
        return self

    async def __aexit__(self, *exc) -> None:
        self._queue.put_nowait(None)
        try:
            if self._task is not None:
                await self._task
        finally:
            self._pool.shutdown(wait=True)

    async def submit(self, req: ServeRequest) -> ServeResponse:
        fut = asyncio.get_running_loop().create_future()
        self._queue.put_nowait((req, fut, time.perf_counter()))
        return await fut

    async def _run(self) -> None:
        loop = asyncio.get_running_loop()
        deferred: List = []       # FIFO of session-conflicted holdovers
        stopping = False          # stop seen: drain, take no more
        while True:
            # the deferred requests seed the batch first, in arrival order
            batch: List = []
            sessions = set()
            keep: List = []
            for it in deferred:
                if (len(batch) < self.max_batch
                        and it[0].session not in sessions):
                    sessions.add(it[0].session)
                    batch.append(it)
                else:
                    keep.append(it)
            deferred = keep
            if not batch:
                if stopping:
                    return
                item = await self._queue.get()
                if item is None:
                    return
                batch = [item]
                sessions = {item[0].session}
            deadline = loop.time() + self.window_s
            while not stopping and len(batch) < self.max_batch:
                timeout = deadline - loop.time()
                try:
                    nxt = (self._queue.get_nowait() if timeout <= 0 else
                           await asyncio.wait_for(self._queue.get(),
                                                  timeout))
                except (asyncio.QueueEmpty, asyncio.TimeoutError):
                    break
                if nxt is None:
                    # drain: finish this batch, then serve the deferred
                    # requests until none is left
                    stopping = True
                    break
                if nxt[0].session in sessions:
                    deferred.append(nxt)
                    continue
                sessions.add(nxt[0].session)
                batch.append(nxt)
            for group in self._round_buckets(batch):
                await self._dispatch(loop, group)

    def _round_buckets(self, batch: List) -> List[List]:
        """The window's dispatch groups: split by horizon rung
        (ascending) when `bucket_rounds` is on, else the whole window as
        one group. A request beyond the ladder joins the top rung's group,
        so that `run_batch` raises its ValueError into that request's
        future instead of the collector failing on routing."""
        if not self.service.cfg.bucket_rounds or len(batch) <= 1:
            return [batch]
        horizons = self.service.cfg.horizons
        by_rung: Dict[int, List] = {}
        for it in batch:
            rung = next((h for h in horizons
                         if h >= int(it[0].n_rounds)), horizons[-1])
            by_rung.setdefault(rung, []).append(it)
        return [by_rung[h] for h in sorted(by_rung)]

    async def _dispatch(self, loop, batch: List) -> None:
        reqs = [b[0] for b in batch]
        t_start = time.perf_counter()
        try:
            resps = await loop.run_in_executor(
                self._pool, self.service.run_batch, reqs)
            # run_batch reads every output to the host before it returns,
            # so the device work has finished when its future resolves
            t_end = time.perf_counter()  # reprolint: disable=timer-no-block -- run_batch ends by copying its outputs to the host
            self.service.metrics.observe_batch(
                reqs, [b[2] for b in batch], t_start, t_end)
            for (req, fut, ts), resp in zip(batch, resps):
                resp.queue_wait_s = t_start - ts
                resp.compute_s = t_end - t_start
                resp.total_s = t_end - ts
                if not fut.done():
                    fut.set_result(resp)
        except Exception as e:          # noqa: BLE001 -- fail the batch
            for _, fut, _ in batch:
                if not fut.done():
                    fut.set_exception(e)


def _rounds_of(n_rounds: Union[int, Sequence[int]], i: int) -> int:
    """A request's round count under a mixed-`n_rounds` load: an int is
    every request's count; a sequence is cycled by request index, every
    client's i-th request taking `seq[i % len]`, so the load moves through
    phases of like-sized work (which horizon routing can exploit)."""
    if isinstance(n_rounds, int):
        return n_rounds
    seq = list(n_rounds)
    return int(seq[i % len(seq)])


def _request(c: int, i: int, n_rounds, seed: int) -> ServeRequest:
    """Client c's i-th request of a synthetic load."""
    return ServeRequest(session=f"client-{c}",
                        n_rounds=_rounds_of(n_rounds, i),
                        seed=seed + 1000 * c + i)


async def closed_loop_load(server: BatchServer, *, n_clients: int,
                           n_requests: int,
                           n_rounds: Union[int, Sequence[int]],
                           seed: int = 0) -> List[ServeResponse]:
    """Saturating load: every client keeps exactly one request in flight,
    submitting the next the moment its response lands. The batched
    against sequential rounds/s is measured under it. `n_rounds` may be a
    sequence (`_rounds_of`). Responses come back client by client; the
    first error raised by a dispatch is raised here."""
    async def client(c: int) -> List[ServeResponse]:
        return [await server.submit(_request(c, i, n_rounds, seed))
                for i in range(n_requests)]

    res = await asyncio.gather(*(client(c) for c in range(n_clients)))
    return [r for rs in res for r in rs]


async def poisson_load(server: BatchServer, *, n_clients: int,
                       rate_hz: float, n_requests: int,
                       n_rounds: Union[int, Sequence[int]],
                       seed: int = 0) -> List[ServeResponse]:
    """Open-loop Poisson arrivals: each client waits exponential gaps of
    mean `n_clients / rate_hz` seconds (drawn on the host from
    `numpy.random.default_rng(seed + c)`, as the reference draws them)
    before each request, so the aggregate is a Poisson process at
    `rate_hz` requests/s. The latency under a window is measured under
    it. `n_rounds` may be a sequence (`_rounds_of`)."""
    gap = n_clients / float(rate_hz)

    async def client(c: int) -> List[ServeResponse]:
        rng = np.random.default_rng(seed + c)
        out = []
        for i in range(n_requests):
            await asyncio.sleep(float(rng.exponential(gap)))
            out.append(await server.submit(_request(c, i, n_rounds, seed)))
        return out

    res = await asyncio.gather(*(client(c) for c in range(n_clients)))
    return [r for rs in res for r in rs]


def drive(cfg: ServeConfig, *, n_clients: int = 8, n_requests: int = 4,
          n_rounds: Union[int, Sequence[int], None] = None,
          rate_hz: float = 0.0, window_s: Optional[float] = None,
          baseline: bool = True, seed: int = 0,
          device=None) -> Dict[str, object]:
    """Build a service on `device` (CUDA unless the caller names
    another), warm it up, drive it under a synthetic load (closed loop,
    or Poisson at `rate_hz` > 0) through a `BatchServer`, and return its
    metrics summary as `batched`; with `baseline`, then the same load on
    the sequential B = 1 service (every request dispatched alone: batch
    1, no occupancy ladder, window 0) as `sequential`, and the ratio of
    their rounds/s as `speedup`. Each service warms up before its server
    opens and is closed after it, so no slot graph is captured while a
    server runs. `n_rounds` may be a sequence (`_rounds_of`)."""
    device = resolve_device(device)
    if n_rounds is None:
        n_rounds = cfg.horizons[-1]

    def load(service: SchedulingService, w: float, mb: int):
        try:
            service.warmup(rounds=(n_rounds,) if isinstance(n_rounds, int)
                           else n_rounds)

            async def go():
                async with BatchServer(service, window_s=w,
                                       max_batch=mb) as srv:
                    if rate_hz > 0:
                        await poisson_load(srv, n_clients=n_clients,
                                           rate_hz=rate_hz,
                                           n_requests=n_requests,
                                           n_rounds=n_rounds, seed=seed)
                    else:
                        await closed_loop_load(srv, n_clients=n_clients,
                                               n_requests=n_requests,
                                               n_rounds=n_rounds,
                                               seed=seed)

            asyncio.run(go())
            return service.metrics.summary()
        finally:
            service.close()

    w = float(cfg.window_s if window_s is None else window_s)
    out: Dict[str, object] = {
        "batched": load(SchedulingService(cfg, device=device), w,
                        int(cfg.batch))}
    if baseline:
        # the B = 1 lower bound keeps the horizon ladder but has no
        # occupancy to bucket (an explicit batch_tiers would not fit)
        seq = SchedulingService(dataclasses.replace(cfg, batch=1,
                                                    batch_tiers=None),
                                device=device)
        out["sequential"] = load(seq, 0.0, 1)
        out["speedup"] = (out["batched"]["rounds_per_s"]
                          / out["sequential"]["rounds_per_s"])
    return out


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Batched scheduling service under synthetic load")
    ap.add_argument("--batch", type=int, default=8,
                    help="B: packed cell slots per dispatch")
    ap.add_argument("--max-rounds", type=int, default=4,
                    help="L: the round horizon per dispatch")
    ap.add_argument("--tiers", type=str, default=None,
                    help="comma-separated horizon ladder (e.g. 8,32,128)"
                         ": route each batch to the smallest tier that "
                         "fits instead of padding to one max horizon")
    ap.add_argument("--max-sessions", type=int, default=None,
                    help="bound on device-resident sessions (LRU spill "
                         "to host beyond it; default unbounded)")
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="batching window after the first request")
    ap.add_argument("--clients", type=int, default=8)
    ap.add_argument("--requests", type=int, default=4,
                    help="requests per client")
    ap.add_argument("--rounds", type=int, default=None,
                    help="rounds per request (default: max-rounds)")
    ap.add_argument("--rate", type=float, default=0.0,
                    help="aggregate Poisson arrival rate in requests/s "
                         "(0 = saturating closed loop)")
    ap.add_argument("--scheduler", default="madca")
    ap.add_argument("--warm-iters", type=int, default=0,
                    help="VEDS+COT: warm P4 budget per candidate")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-baseline", action="store_true",
                    help="skip the sequential B=1 baseline")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON line instead of text")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' on request)")
    args = ap.parse_args(argv)

    tiers = (None if args.tiers is None else
             tuple(int(t) for t in args.tiers.split(",")))
    cfg = ServeConfig(batch=args.batch, max_rounds=args.max_rounds,
                      tiers=tiers, max_sessions=args.max_sessions,
                      window_s=1e-3 * args.window_ms,
                      scheduler=args.scheduler,
                      ipm_warm_iters=args.warm_iters, seed=args.seed)
    out = drive(cfg, n_clients=args.clients, n_requests=args.requests,
                n_rounds=args.rounds, rate_hz=args.rate,
                baseline=not args.no_baseline, seed=args.seed,
                device=args.device)
    if args.json:
        print(json.dumps(out))
        return 0
    b = out["batched"]
    print(f"batched  B={args.batch} window={args.window_ms}ms: "
          f"{b['rounds_per_s']:8.1f} rounds/s  p50={b['p50_ms']:.1f}ms "
          f"p99={b['p99_ms']:.1f}ms  occupancy={b['mean_occupancy']:.1f}")
    if "sequential" in out:
        s = out["sequential"]
        print(f"sequential B=1:          {s['rounds_per_s']:8.1f} rounds/s"
              f"  p50={s['p50_ms']:.1f}ms p99={s['p99_ms']:.1f}ms")
        print(f"speedup: {out['speedup']:.1f}x aggregate rounds/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
