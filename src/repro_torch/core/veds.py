"""V2V-Enhanced Dynamic Scheduling (VEDS) — Algorithms 1 and 2, batched.

Port of `repro/core/veds.py`. Every candidate of a slot is scored at
once: the [B, S] direct-transmission (DT) candidates through the
`veds_score` CUDA kernel, and the [B, S, U] cooperative (COT) candidates
through one batched interior-point solve of P4, cold or warm-started
from a carried table of previous optima. The leading batch axis `B`
(independent RSU cells, or independent rounds of one cell) rides through
the whole round.

The reference runs the round as one `lax.scan` under `jit`: one dispatch.
Here the slot step is the same function of a device-side slot index on
every device, with no value read back to the host. On the CPU the round
loops over it in Python. On a CUDA device the step is captured once per
round shape as a CUDA graph (`_SlotGraph`), `veds_score` launch included,
and the graph is replayed once per slot: the ~2,000 small launches of a
slot cost the device a node each instead of the host a round trip each.

Round inputs (precomputed from mobility + channel draws), single-cell
layout on the left, batched layout on the right:
  g_sr [T, S]    / [B, T, S]    SOV->RSU power gains per slot (0 = no link)
  g_or [T, U]    / [B, T, U]    OPV->RSU gains
  g_so [T, S, U] / [B, T, S, U] SOV->OPV gains
  t_cp [S]       / [B, S]       local-update latency [s]
  e_cp [S]       / [B, S]       local-update energy [J]
  e_sov [S], e_opv [U]  (+ [B]) energy budgets [J]
  valid_sov/valid_opv           optional padding masks for heterogeneous
                                fleets (None = all vehicles real)
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional

import torch

from repro_torch.channel.v2x import ChannelParams
from repro_torch.core import lyapunov as lyp
from repro_torch.core.scheduler import (RoundOutputs, SchedulerCarry,
                                        divisors, init_queues, map_tensors,
                                        masked_e_cp, unbatch)
from repro_torch.core.solver import solve_p4
from repro_torch.kernels.veds_score.ops import veds_dt_score

NEG = -1e30


@dataclasses.dataclass(frozen=True)
class RoundInputs:
    g_sr: torch.Tensor
    g_or: torch.Tensor
    g_so: torch.Tensor
    t_cp: torch.Tensor
    e_cp: torch.Tensor
    e_sov: torch.Tensor
    e_opv: torch.Tensor
    valid_sov: Optional[torch.Tensor] = None
    valid_opv: Optional[torch.Tensor] = None

    @property
    def batched(self) -> bool:
        return self.g_sr.ndim == 3

    @property
    def batch_size(self) -> int:
        return self.g_sr.shape[0] if self.batched else 1

    def with_batch_axis(self) -> "RoundInputs":
        """Add a leading B=1 axis to every field (no-op when batched)."""
        if self.batched:
            return self
        return map_tensors(lambda x: x[None], self)

    def cell(self, b: int) -> "RoundInputs":
        """Slice one cell out of a batched round."""
        return map_tensors(lambda x: x[b], self) if self.batched else self

    def to(self, device) -> "RoundInputs":
        return map_tensors(lambda x: x.to(device), self)

    @staticmethod
    def stack(rounds: List["RoundInputs"]) -> "RoundInputs":
        """Stack single-cell rounds on a new leading [B] axis."""
        names = [f.name for f in dataclasses.fields(RoundInputs)]
        return RoundInputs(**{
            n: (None if getattr(rounds[0], n) is None else
                torch.stack([getattr(r, n) for r in rounds]))
            for n in names})


def _dt_candidates(w, qs, g_sr, eligible, prm: lyp.VedsParams,
                   ch: ChannelParams):
    """Closed-form DT (Prop. 1) for the whole [B, S] candidate grid,
    through the `veds_score` kernel. Returns (y, p, z), each [B, S], with
    p/z zeroed and y pinned to NEG on ineligible candidates."""
    return veds_dt_score(
        g_sr.contiguous(), qs.contiguous(), w.contiguous(),
        eligible.contiguous(), V=prm.V, kappa=prm.slot, bw=ch.bandwidth,
        noise=ch.noise_power, p_max=ch.p_max)


def _cot_candidates(w, qs, qu, g_sr, g_or, g_so, eligible,
                    prm: lyp.VedsParams, ch: ChannelParams, div,
                    p_init=None):
    """P4 for every (cell b, SOV m, prefix size i). Proposition 2: only
    prefixes of OPVs sorted by h_{m,n} descending need be enumerated.

    Inputs are [B, S] / [B, U] / [B, S, U]. `p_init [B,S,U,1+U]`
    warm-starts every candidate's solve from the previous slot's or
    round's optimum with the `prm.ipm_warm_iters` budget (None = cold,
    the full `prm.ipm_iters`). Returns y [B,S,U], p_m [B,S,U],
    p_opv [B,S,U,U] (in *sorted* OPV order), order [B,S,U], z [B,S,U] and
    p_all [B,S,U,1+U] (this slot's warm-start table). `div`: the
    round's `divisors`.
    """
    B, S = g_sr.shape
    U = g_or.shape[-1]
    order = torch.argsort(-g_so, dim=-1, stable=True)            # [B,S,U]
    g_so_sorted = torch.gather(g_so, -1, order)                  # [B,S,U]
    g_or_sorted = torch.gather(g_or[:, None, :].expand(B, S, U), -1, order)
    qu_sorted = torch.gather(qu[:, None, :].expand(B, S, U), -1, order)

    noise = div["noise"]
    cw = prm.V * w * (prm.slot / 2.0) * ch.bandwidth / div["ln2"]  # [B,S]

    ar = torch.arange(U, device=g_sr.device)
    prefix = ar[:, None] >= ar[None, :]                          # [i,j] j<=i
    a_opv = torch.where(prefix, (g_or_sorted / noise)[..., None, :], 0.0)
    g_min = g_so_sorted                                # [B,S,i] weakest=ith
    a0 = (g_sr / noise)[..., None]                               # [B,S,1]
    d0 = (g_sr[..., None] - g_min) / noise                       # [B,S,U]
    feasible = d0 < 0.0                                  # strict interior

    a_full = torch.cat([a0.expand(B, S, U)[..., None], a_opv], dim=-1)
    d_full = torch.cat([d0[..., None], a_opv], dim=-1)
    q_sov = (qs * prm.slot / 2.0)[..., None, None].expand(B, S, U, 1)
    q_opv = (qu_sorted * prm.slot / 2.0)[..., None, :].expand(B, S, U, U) \
        * prefix
    q_full = torch.clamp_min(torch.cat([q_sov, q_opv], dim=-1), 1e-9)
    pmax_full = torch.full_like(a_full, ch.p_max)

    p_all, _ = solve_p4(cw[..., None].expand(B, S, U), a_full, q_full,
                        d_full, pmax_full, iters=prm.ipm_iters,
                        mu_final=prm.ipm_mu, p_init=p_init,
                        warm_iters=prm.ipm_warm_iters,
                        far_iters=prm.ipm_far_iters,
                        far_grad_tol=prm.ipm_far_grad_tol)
    # evaluate the exact objective y (21a) for each candidate
    sinr = (a_full * p_all).sum(-1)
    rate = ch.bandwidth * torch.log2(1.0 + sinr)
    z = (prm.slot / 2.0) * rate                                  # [B,S,U]
    e_sov_cm = (prm.slot / 2.0) * p_all[..., 0]
    e_opv_cm = (prm.slot / 2.0) * p_all[..., 1:]          # [B,S,U,U] sorted
    y = (prm.V * w[..., None] * z - qs[..., None] * e_sov_cm
         - (e_opv_cm * qu_sorted[..., None, :]).sum(-1))
    y = torch.where(feasible & eligible[..., None], y, NEG)
    return y, p_all[..., 0], p_all[..., 1:], order, z, p_all


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[b, idx[b]] for every cell b: x [B, K, ...], idx [B]."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _select_slot(y_dt, p_dt, z_dt, y_cot, pm_cot, po_cot, order, z_cot,
                 prm: lyp.VedsParams):
    """Pick each cell's transmission for the slot (Algorithm 1 lines
    9-13). Inputs are the candidate tables of all cells: y_dt/p_dt/z_dt
    [B,S], y_cot/pm_cot/z_cot [B,S,U], po_cot [B,S,U,U], order [B,S,U].
    `torch.argmax` returns the first maximum, as `jnp.argmax` does."""
    B, S = y_dt.shape
    U = y_cot.shape[-1]
    best_dt = torch.argmax(y_dt, dim=-1)                         # [B]
    y_dt_best = _take(y_dt, best_dt)
    flat = y_cot.reshape(B, S * U)
    best_cot = torch.argmax(flat, dim=-1)
    y_cot_best = _take(flat, best_cot)
    m_cot, i_cot = best_cot // U, best_cot % U

    use_any = torch.maximum(y_dt_best, y_cot_best) > 0.0
    use_cot = use_any & (y_cot_best > y_dt_best)
    use_dt = use_any & ~use_cot
    m_sel = torch.where(use_cot, m_cot, best_dt)

    # per-SOV delivered bits and energy this slot: one entry, at m_sel
    z_pick = torch.where(use_dt, _take(z_dt, best_dt),
                         torch.where(use_cot,
                                     _take(_take(z_cot, m_cot), i_cot), 0.0))
    e_pick = torch.where(
        use_dt, prm.slot * _take(p_dt, best_dt),
        torch.where(use_cot,
                    prm.slot / 2 * _take(_take(pm_cot, m_cot), i_cot), 0.0))
    z_vec = torch.zeros_like(y_dt).scatter_add_(1, m_sel[:, None],
                                                z_pick[:, None])
    e_sov_vec = torch.zeros_like(y_dt).scatter_add_(1, m_sel[:, None],
                                                    e_pick[:, None])
    # OPV energies: scheduled prefix i_cot in sorted order for SOV m_cot
    sched = torch.arange(U, device=y_dt.device)[None, :] <= i_cot[:, None]
    p_sched = torch.where(sched, _take(_take(po_cot, m_cot), i_cot), 0.0)
    e_opv_sorted = prm.slot / 2 * p_sched                        # [B,U]
    e_opv_cot = torch.zeros_like(e_opv_sorted).scatter_add_(
        1, _take(order, m_cot), e_opv_sorted)
    e_opv_vec = torch.where(use_cot[:, None], e_opv_cot, 0.0)
    return m_sel, use_dt, use_cot, z_vec, e_sov_vec, e_opv_vec


def _slot_start(t: torch.Tensor, slot: float) -> torch.Tensor:
    """Slot t's start time on t's device: one fp32 product, as the
    reference's `t.astype(jnp.float32) * prm.slot`."""
    return t.to(torch.float32) * slot


def _slot_candidates(t: torch.Tensor, state: Dict[str, torch.Tensor],
                     rnd: RoundInputs, prm: lyp.VedsParams,
                     ch: ChannelParams, enable_cot: bool):
    """Slot t's candidates before the selection (`solve_slot`'s first
    half): the DT triple (`_dt_candidates`, the `veds_score` kernel) and
    the COT tuple (`_cot_candidates`, the batched P4 solves; without COT,
    candidates that never win and the P4 table passed through)."""
    B, _, S = rnd.g_sr.shape
    U = rnd.g_or.shape[-1]
    zeta, qs, qu = state["zeta"], state["qs"], state["qu"]
    # `x[:, t]` would turn the 0-dim tensor into a host integer (a sync)
    at_t = t.reshape(1)
    g_sr, g_or, g_so = (x.index_select(1, at_t).squeeze(1)
                        for x in (rnd.g_sr, rnd.g_or, rnd.g_so))
    w = lyp.sigmoid_weight(zeta, prm, state["Q"])
    t_now = _slot_start(t, prm.slot)
    eligible = (rnd.t_cp <= t_now) & (zeta < prm.Q)
    if rnd.valid_sov is not None:
        eligible &= rnd.valid_sov

    dt = _dt_candidates(w, qs, g_sr, eligible, prm, ch)
    if enable_cot:
        cot = _cot_candidates(w, qs, qu, g_sr, g_or, g_so, eligible, prm,
                              ch, state, state.get("p4"))
    else:
        # no P4 solves without COT: a threaded table passes through
        cot = (torch.full((B, S, U), NEG, device=g_sr.device),
               torch.zeros((B, S, U), device=g_sr.device),
               torch.zeros((B, S, U, U), device=g_sr.device),
               torch.arange(U, device=g_sr.device).expand(B, S, U),
               torch.zeros((B, S, U), device=g_sr.device),
               state.get("p4"))
    return dt, cot


def solve_slot(t: torch.Tensor, state: Dict[str, torch.Tensor],
               rnd: RoundInputs, prm: lyp.VedsParams, ch: ChannelParams, *,
               enable_cot: bool = True):
    """Algorithm 1 for slot t, batch-native. `t` is a 0-dim int64 tensor
    on `rnd`'s device, as the reference's traced slot index: nothing here
    reads a value back to the host, so the step can be captured into a
    CUDA graph. `rnd` must be batched; state holds zeta [B,S], qs [B,S],
    qu [B,U] and the round's `divisors` (0-dim tensors: the slot count
    "T", "Q", "slot", "noise", "ln2"). An optional
    state["p4"] [B,S,U,1+U] threads the P4 warm-start table from slot to
    slot: each slot's candidate solves start from the previous slot's
    optima and write their own back.

    Returns (new state, decision dict of [B, ...] tensors)."""
    warm = "p4" in state
    zeta, qs, qu = state["zeta"], state["qs"], state["qu"]
    (y_dt, p_dt, z_dt), (y_cot, pm_cot, po_cot, order, z_cot, p_all) = \
        _slot_candidates(t, state, rnd, prm, ch, enable_cot)
    m_sel, use_dt, use_cot, z_vec, e_sov_vec, e_opv_vec = _select_slot(
        y_dt, p_dt, z_dt, y_cot, pm_cot, po_cot, order, z_cot, prm)

    new_state = {
        **state,
        "zeta": lyp.update_zeta(zeta, z_vec, prm),
        "qs": lyp.update_queue_sov(qs, e_sov_vec, rnd.e_sov, rnd.e_cp,
                                   state["T"]),
        "qu": lyp.update_queue_opv(qu, e_opv_vec, rnd.e_opv, state["T"]),
    }
    if warm:
        new_state["p4"] = p_all
    info = {"m": m_sel, "use_dt": use_dt, "use_cot": use_cot,
            "z": z_vec, "e_sov": e_sov_vec, "e_opv": e_opv_vec}
    return new_state, info


# the per-slot decisions that the round sums
_SUMMED = ("e_sov", "e_opv", "use_cot", "use_dt")


def _carried(state) -> tuple:
    """The state tensors a slot step advances: the delivered bits, the
    queues, and the P4 table where the round runs warm."""
    return ("zeta", "qs", "qu") + (("p4",) if "p4" in state else ())


def _slots_eager(rb: RoundInputs, state, prm, ch, enable_cot):
    """The round's slots one after another in Python. Returns the final
    state and the summed decisions stacked over slots ([T, B, ...])."""
    T = rb.g_sr.shape[1]
    ts = torch.arange(T, device=rb.g_sr.device)
    infos = []
    for t in range(T):
        state, info = solve_slot(ts[t], state, rb, prm, ch,
                                 enable_cot=enable_cot)
        infos.append(info)
    return state, {k: torch.stack([i[k] for i in infos]) for k in _SUMMED}


class _SlotGraph:
    """The slot step of one round shape, captured as a CUDA graph.

    It owns static buffers for the round's inputs, the state (zeta, qs,
    qu, and the P4 warm-start table on the warm path), the slot index
    `t`, which the graph advances itself, and the
    [T, B, ...] decisions that the round sums, one row written per slot.
    `run` copies a round in, replays the graph once per slot and returns
    what the eager loop returns, bit for bit: the same kernels on the
    same values. What it returns lies in the static buffers until the
    next `run`.
    """
    captures = 0      # graphs captured in this process

    def __init__(self, rb: RoundInputs, state, prm, ch, enable_cot):
        B, T, S = rb.g_sr.shape
        U = rb.g_or.shape[-1]
        dev = rb.g_sr.device
        self.T, self.prm, self.ch = T, prm, ch
        self.enable_cot = enable_cot
        self.rnd = map_tensors(torch.clone, rb)
        self.state = dict(state)
        self.carried = _carried(state)
        for k in self.carried:
            self.state[k] = state[k].clone(
                memory_format=torch.contiguous_format)
        self.t = torch.zeros((), dtype=torch.int64, device=dev)
        self.infos = {
            "e_sov": torch.zeros((T, B, S), device=dev),
            "e_opv": torch.zeros((T, B, U), device=dev),
            "use_cot": torch.zeros((T, B), dtype=torch.bool, device=dev),
            "use_dt": torch.zeros((T, B), dtype=torch.bool, device=dev)}
        self._capture()

    def _step(self):
        new, info = solve_slot(self.t, self.state, self.rnd, self.prm,
                               self.ch, enable_cot=self.enable_cot)
        for k in self.carried:
            self.state[k].copy_(new[k])
        at_t = self.t.reshape(1)
        for k, buf in self.infos.items():
            buf.index_copy_(0, at_t, info[k][None])
        self.t.add_(1)

    def _capture(self):
        # PyTorch's recipe: one run on a side stream first, so that lazy
        # set-up (the kernel library's module, cuBLAS and cuSOLVER
        # handles, workspaces) happens outside the capture. The run moves
        # only the static buffers, which `run` sets anew, and is not a
        # slot of any round, so its `veds_score` run is not counted.
        with torch.cuda.device(self.t.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side), veds_dt_score.uncounted():
                self._step()
            torch.cuda.current_stream().wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                self._step()
        _SlotGraph.captures += 1

    def run(self, rb: RoundInputs, state):
        for f in dataclasses.fields(RoundInputs):
            dst = getattr(self.rnd, f.name)
            if dst is not None:
                dst.copy_(getattr(rb, f.name))
        for k in self.carried:
            self.state[k].copy_(state[k])
        self.t.zero_()
        for _ in range(self.T):
            self.graph.replay()
        return self.state, self.infos


# at most this many unpinned slot graphs are kept; each holds its static
# buffers and its own memory pool until it is evicted, oldest first. A
# pinned graph (`pin_slot_graphs`) is never evicted while pinned.
_MAX_SLOT_GRAPHS = 8
_SLOT_GRAPHS: Dict[tuple, _SlotGraph] = {}
_PINS: Dict[tuple, int] = {}       # key -> number of holders
_PINNING: List[set] = []           # the key sets of open pin blocks


@contextlib.contextmanager
def pin_slot_graphs():
    """Pin every slot graph used inside the block: yields the set of
    their keys, each pinned once for this holder until
    `unpin_slot_graphs(keys)`. A pinned graph is never evicted, so a
    holder that warmed its round shapes (a scheduling service's
    occupancy ladder) never captures one again inside a timed run,
    however many other shapes are captured meanwhile."""
    keys: set = set()
    _PINNING.append(keys)
    try:
        yield keys
    finally:
        _PINNING.pop()


def unpin_slot_graphs(keys) -> None:
    """Release one holder's pins (`pin_slot_graphs`'s keys): a graph
    that no holder pins becomes evictable again."""
    for k in keys:
        n = _PINS.pop(k, 0) - 1
        if n > 0:
            _PINS[k] = n


def _slots_graphed(rb: RoundInputs, state, prm, ch, enable_cot):
    """`_slots_eager` through the slot graph of `rb`'s shape, captured at
    the first round of that shape. The key holds everything the graph
    bakes in: the device, each input's shape and dtype (B, T, S, U and
    which padding masks are present), whether a P4 table is carried,
    `enable_cot`, and the frozen parameter dataclasses. The queues and
    the table must be float32, as `veds_score` and the solver take them:
    the graph's buffers are."""
    for k in _carried(state)[1:]:
        if state[k].dtype != torch.float32:
            raise TypeError(f"veds_round: the slot graph runs float32 "
                            f"queues and P4 tables; the carry's {k} is "
                            f"{state[k].dtype}")
    key = (rb.g_sr.device, enable_cot, prm, ch, "p4" in state) + tuple(
        None if x is None else (tuple(x.shape), x.dtype)
        for x in (getattr(rb, f.name) for f in dataclasses.fields(rb)))
    graph = _SLOT_GRAPHS.get(key)
    if graph is None:
        unpinned = [k for k in _SLOT_GRAPHS if k not in _PINS]
        while len(unpinned) >= _MAX_SLOT_GRAPHS:
            del _SLOT_GRAPHS[unpinned.pop(0)]
        graph = _SLOT_GRAPHS[key] = _SlotGraph(rb, state, prm, ch,
                                               enable_cot)
    for keys in _PINNING:
        if key not in keys:
            keys.add(key)
            _PINS[key] = _PINS.get(key, 0) + 1
    return graph.run(rb, state)


def veds_round(rnd: RoundInputs, prm: lyp.VedsParams, ch: ChannelParams, *,
               enable_cot: bool = True,
               carry: Optional[SchedulerCarry] = None) -> RoundOutputs:
    """Algorithm 2: run every slot, return success mask + diagnostics.

    Accepts single-cell or batched rounds on any device; outputs match
    the input layout and device. On a CUDA device the slots are replays
    of one captured slot graph, on the CPU a Python loop over the same
    step. `carry` seeds the virtual energy queues (eqs. 19-20); None
    starts them at zero. The round-end queues come back in
    `RoundOutputs.carry`.

    When `carry.p4` holds a warm-start table, `prm.ipm_warm_iters > 0`
    and COT is on, the P4 candidate solves run warm-started: the table
    threads from slot to slot and the last slot's table comes back in
    `RoundOutputs.carry.p4`. Otherwise the cold path runs and
    `carry.p4` comes back None.
    """
    return _veds_round(rnd, prm, ch, enable_cot=enable_cot, carry=carry,
                       graphed=rnd.g_sr.is_cuda)


def _round_state(rb: RoundInputs, prm: lyp.VedsParams, ch: ChannelParams,
                 enable_cot: bool, carry: Optional[SchedulerCarry]):
    """The slot state at the start of batched round `rb`: zeta at zero,
    the queues from `carry`, the round's divisors, and the P4 table where
    the round runs warm."""
    B, T, S = rb.g_sr.shape
    U = rb.g_or.shape[-1]
    qs0, qu0 = init_queues(rb, carry)
    state = {"zeta": torch.zeros((B, S), device=rb.g_sr.device),
             "qs": qs0, "qu": qu0, **divisors(rb, prm, ch)}
    if (enable_cot and prm.ipm_warm_iters > 0 and carry is not None
            and carry.p4 is not None):
        state["p4"] = torch.broadcast_to(carry.p4, (B, S, U, U + 1))
    return state


def _veds_round(rnd: RoundInputs, prm: lyp.VedsParams, ch: ChannelParams,
                *, enable_cot: bool, carry: Optional[SchedulerCarry],
                graphed: bool) -> RoundOutputs:
    """`veds_round`, with the slot graph or the eager loop as asked; the
    card tests and `chip_smoke.py` hold the graph against the eager loop
    on the card."""
    batched = rnd.batched
    rb = rnd.with_batch_axis()
    state = _round_state(rb, prm, ch, enable_cot, carry)
    slots = _slots_graphed if graphed else _slots_eager
    state, infos = slots(rb, state, prm, ch, enable_cot)
    total = {k: infos[k].sum(0) for k in _SUMMED}
    success = state["zeta"] >= prm.Q
    if rb.valid_sov is not None:
        success &= rb.valid_sov
    out = RoundOutputs(
        success=success,
        n_success=success.sum(-1),
        # copies: the graph's state buffers are overwritten by its next run
        zeta=state["zeta"].clone(),
        energy_sov=total["e_sov"] + masked_e_cp(rb),
        energy_opv=total["e_opv"],
        n_cot_slots=total["use_cot"],
        n_dt_slots=total["use_dt"],
        carry=SchedulerCarry(
            qs=state["qs"].clone(), qu=state["qu"].clone(),
            p4=state["p4"].clone() if "p4" in state else None),
    )
    return unbatch(out, batched)
