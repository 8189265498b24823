"""V2V-Enhanced Dynamic Scheduling (VEDS) — Algorithms 1 and 2, batched.

Port of `repro/core/veds.py`, cold path. Every candidate of a slot is
scored at once: the [B, S] direct-transmission (DT) candidates through the
`veds_score` CUDA kernel, and the [B, S, U] cooperative (COT) candidates
through one batched interior-point solve of P4. The round is a Python loop
over slots, and the leading batch axis `B` (independent RSU cells, or
independent rounds of one cell) rides through the whole round.

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

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.channel.v2x import ChannelParams
from repro_torch.core import lyapunov as lyp
from repro_torch.core.scheduler import (RoundOutputs, SchedulerCarry,
                                        init_queues, map_tensors,
                                        masked_e_cp, unbatch)
from repro_torch.core.solver import solve_p4
from repro_torch.kernels.veds_score.ops import veds_dt_score

LN2 = 0.6931471805599453
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
                    prm: lyp.VedsParams, ch: ChannelParams):
    """P4 for every (cell b, SOV m, prefix size i). Proposition 2: only
    prefixes of OPVs sorted by h_{m,n} descending need be enumerated.

    Inputs are [B, S] / [B, U] / [B, S, U]. Returns y [B,S,U],
    p_m [B,S,U], p_opv [B,S,U,U] (in *sorted* OPV order), order [B,S,U]
    and z [B,S,U].
    """
    B, S = g_sr.shape
    U = g_or.shape[-1]
    order = torch.argsort(-g_so, dim=-1, stable=True)            # [B,S,U]
    g_so_sorted = torch.gather(g_so, -1, order)                  # [B,S,U]
    g_or_sorted = torch.gather(g_or[:, None, :].expand(B, S, U), -1, order)
    qu_sorted = torch.gather(qu[:, None, :].expand(B, S, U), -1, order)

    noise = ch.noise_power
    cw = prm.V * w * (prm.slot / 2.0) * ch.bandwidth / LN2         # [B,S]

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
                        mu_final=prm.ipm_mu)
    # evaluate the exact objective y (21a) for each candidate
    sinr = (a_full * p_all).sum(-1)
    rate = ch.bandwidth * torch.log2(1.0 + sinr)
    z = (prm.slot / 2.0) * rate                                  # [B,S,U]
    e_sov_cm = (prm.slot / 2.0) * p_all[..., 0]
    e_opv_cm = (prm.slot / 2.0) * p_all[..., 1:]          # [B,S,U,U] sorted
    y = (prm.V * w[..., None] * z - qs[..., None] * e_sov_cm
         - (e_opv_cm * qu_sorted[..., None, :]).sum(-1))
    y = torch.where(feasible & eligible[..., None], y, NEG)
    return y, p_all[..., 0], p_all[..., 1:], order, z


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


def solve_slot(t: int, state: Dict[str, torch.Tensor], rnd: RoundInputs,
               prm: lyp.VedsParams, ch: ChannelParams, *,
               enable_cot: bool = True):
    """Algorithm 1 for slot t, batch-native. `rnd` must be batched; state
    holds zeta [B,S], qs [B,S], qu [B,U] and the slot count T.

    Returns (new state, decision dict of [B, ...] tensors)."""
    B, _, S = rnd.g_sr.shape
    U = rnd.g_or.shape[-1]
    zeta, qs, qu = state["zeta"], state["qs"], state["qu"]
    g_sr, g_or, g_so = rnd.g_sr[:, t], rnd.g_or[:, t], rnd.g_so[:, t]
    w = lyp.sigmoid_weight(zeta, prm)
    # the slot's start time in fp32, as the reference computes it
    t_now = float(np.float32(t) * np.float32(prm.slot))
    eligible = (rnd.t_cp <= t_now) & (zeta < prm.Q)
    if rnd.valid_sov is not None:
        eligible &= rnd.valid_sov

    y_dt, p_dt, z_dt = _dt_candidates(w, qs, g_sr, eligible, prm, ch)
    if enable_cot:
        y_cot, pm_cot, po_cot, order, z_cot = _cot_candidates(
            w, qs, qu, g_sr, g_or, g_so, eligible, prm, ch)
    else:
        y_cot = torch.full((B, S, U), NEG, device=g_sr.device)
        pm_cot = torch.zeros((B, S, U), device=g_sr.device)
        po_cot = torch.zeros((B, S, U, U), device=g_sr.device)
        order = torch.arange(U, device=g_sr.device).expand(B, S, U)
        z_cot = torch.zeros((B, S, U), device=g_sr.device)

    m_sel, use_dt, use_cot, z_vec, e_sov_vec, e_opv_vec = _select_slot(
        y_dt, p_dt, z_dt, y_cot, pm_cot, po_cot, order, z_cot, prm)

    new_state = {
        "zeta": lyp.update_zeta(zeta, z_vec, prm),
        "qs": lyp.update_queue_sov(qs, e_sov_vec, rnd.e_sov, rnd.e_cp,
                                   state["T"]),
        "qu": lyp.update_queue_opv(qu, e_opv_vec, rnd.e_opv, state["T"]),
        "T": state["T"],
    }
    info = {"m": m_sel, "use_dt": use_dt, "use_cot": use_cot,
            "z": z_vec, "e_sov": e_sov_vec, "e_opv": e_opv_vec}
    return new_state, info


def veds_round(rnd: RoundInputs, prm: lyp.VedsParams, ch: ChannelParams, *,
               enable_cot: bool = True,
               carry: Optional[SchedulerCarry] = None) -> RoundOutputs:
    """Algorithm 2: loop over slots, return success mask + diagnostics.

    Accepts single-cell or batched rounds on any device; outputs match
    the input layout and device. `carry` seeds the virtual energy queues
    (eqs. 19-20); None starts them at zero. The round-end queues come
    back in `RoundOutputs.carry`. Only the cold P4 path is ported: where
    the reference would run warm-started (a warm budget and a carried
    `p4` table, with COT on), this raises.
    """
    if (enable_cot and prm.ipm_warm_iters > 0 and carry is not None
            and carry.p4 is not None):
        raise NotImplementedError(
            "warm-started P4 (VedsParams.ipm_warm_iters, carry.p4) comes "
            "with the streaming slice of the port")
    batched = rnd.batched
    rb = rnd.with_batch_axis()
    B, T, S = rb.g_sr.shape
    qs0, qu0 = init_queues(rb, carry)
    state = {"zeta": torch.zeros((B, S), device=rb.g_sr.device),
             "qs": qs0, "qu": qu0, "T": float(T)}
    infos = []
    for t in range(T):
        state, info = solve_slot(t, state, rb, prm, ch,
                                 enable_cot=enable_cot)
        infos.append(info)

    def total(k):
        return torch.stack([i[k] for i in infos]).sum(0)

    success = state["zeta"] >= prm.Q
    if rb.valid_sov is not None:
        success &= rb.valid_sov
    out = RoundOutputs(
        success=success,
        n_success=success.sum(-1),
        zeta=state["zeta"],
        energy_sov=total("e_sov") + masked_e_cp(rb),
        energy_opv=total("e_opv"),
        n_cot_slots=total("use_cot"),
        n_dt_slots=total("use_dt"),
        carry=SchedulerCarry(qs=state["qs"], qu=state["qu"]),
    )
    return unbatch(out, batched)
