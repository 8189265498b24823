"""Sub-block implementations for the unified decoder engine.

Port of `repro/models/blocks.py` (attention, MLP, MoE, Mamba2, mLSTM
and sLSTM). Each sub-block kind provides:

  <kind>_decl(cfg, tp)              -> parameter declarations
  <kind>_apply(p, x, ...)           -> training/prefill forward (residual
                                       included)
  <kind>_decode(p, x, cache, pos, cfg, mesh, ...)
                                    -> single-token step: (y, cache)
  <kind>_cache_decl(cfg, n_rep, B, ...) -> its decode cache's declarations

Over a model mesh axis (`mesh`, anything `sharding.model_axis.model_axis`
reads; None is one device) each rank holds its block of the parameters
under their logical axes (`model_axis.shard_params`) and the sub-blocks
run the reference's GSPMD partitioning written out, its TP modes
(`sharding/policy.py`):

* attention, "head": this rank's H/n query heads; `wk`/`wv` are
  replicated, so every rank computes all KV heads and keeps those of its
  query heads; `flash_attention` on the local heads; `wo` by heads, the
  partial outputs summed. "row": `x` cut on d (`row_in`), the partial
  q, k, v summed, the core replicated (or sequence-sharded with
  `seq_shard`, `attention.seq_sharded_flash_attention`), `wo` cut on
  head_dim (`row_head_dim`), summed. Decode takes q whole, as the
  reference's flash-decode over the sequence-sharded cache does.
* MLP: columns of `w_gate`/`w_up`, rows of `w_down` (`layers.mlp`).
* MoE: the router and the capacity plan are replicated, so every rank
  keeps the same slots; each rank runs its E/n experts and the combine
  is summed.
* Mamba2: this rank's ssm_heads/n heads, which are exactly its d_inner
  block (`w_x`, `w_z`, `conv_w` by columns; `w_dt`, `A_log`, `dt_bias`,
  `D` by heads); `w_bc` is replicated, so b and c are whole on every
  rank; `ssd_scan` on the local heads; `out_norm` over the whole d_inner
  (`layers.rmsnorm(..., mesh=)`); `w_out` by rows, the partial outputs
  summed.
* mLSTM: q, k, v by their head dim P (`row_head_dim`), v all-gathered;
  the scores, the readout of C and the normalizer sum their partial
  sums, so the core's output is whole; it is cut to this rank's d_inner
  block for `out_norm`, `w_o` and `w_out` (by rows, summed). The cache
  holds this rank's rows of C and n.
* sLSTM: every parameter and its cache are replicated; each rank runs
  the whole recurrence and no collective is needed.

`engine.check_model_axis` refuses, before any work, a model axis that
does not divide a dim the declarations split over it.

Each replicated tensor that enters split work passes `copy_to` (its
gradient is summed over the ranks) and each partial result
`reduce_from`, so every rank's replicated parameters get the whole
gradient. On one device every constraint is a no-op and "row" computes
what "head" does. A decode step's K/V append writes into the cache in
place (`attention._append`); the recurrent kinds return their new
states, which `engine.decode_step` writes back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.launch.op_costs import fill, loop
from repro_torch.models import attention as att
from repro_torch.models import layers as L
from repro_torch.models.module import declare
from repro_torch.sharding.fsdp import batch_mean
from repro_torch.sharding.model_axis import (LOCAL, ModelAxis, copy_to,
                                             gather_from, model_axis,
                                             reduce_from, scatter_to)


def constrain(x, spec_entries):
    """Sharding constraint of the reference: a no-op on one device."""
    return x


# ===========================================================================
# attention (self full / sliding-window / cross)
# ===========================================================================

def attn_decl(cfg: ModelConfig, tp: str, cross: bool = False):
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    in_ax = "embed" if tp == "head" else "row_in"
    p = {
        "ln": L.rmsnorm_decl(d),
        "wq": declare((d, H, Dh), (in_ax, "heads" if tp == "head" else "out",
                                   "head_dim")),
        "wk": declare((d, KV, Dh), (in_ax, "kv_heads", "head_dim")),
        "wv": declare((d, KV, Dh), (in_ax, "kv_heads", "head_dim")),
        "wo": declare((H, Dh, d),
                      ("heads", "head_dim", "embed") if tp == "head"
                      else ("out", "row_head_dim", "embed")),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = {"scale": declare((Dh,), ("head_dim",), init="ones")}
        p["k_norm"] = {"scale": declare((Dh,), ("head_dim",), init="ones")}
    return p


def _qkv(p, cfg: ModelConfig, h, src, positions, tp: str, cross: bool,
         ax: ModelAxis = LOCAL):
    """Project + norm + rope. Returns q [B,T,H,Dh], k/v [B,S,KV,Dh].
    Over a model axis, head mode: q of this rank's H/n heads from
    `copy_to(h)`, and every KV head (`wk`, `wv`, `k_norm` are whole on
    every rank; `q_norm`'s scale acts on the local heads only, so it
    passes `copy_to`); row mode: this rank's d/n columns of h (and of the
    source memory) against its rows of wq, wk, wv, the partial q, k, v
    summed, then the norms and rope on whole tensors."""
    kv_in = src if cross else h
    row = ax.size > 1 and tp == "row"
    if row:
        hq = scatter_to(h, ax, -1)
        kv_in = scatter_to(kv_in, ax, -1) if cross else hq
    else:
        hq = copy_to(h, ax)

    def proj(x, w, eq):
        y = torch.einsum(eq, x, w.to(h.dtype))
        return reduce_from(y, ax) if row else y
    q = proj(hq, p["wq"], "btd,dhk->bthk")
    k = proj(kv_in, p["wk"], "bsd,dhk->bshk")
    v = proj(kv_in, p["wv"], "bsd,dhk->bshk")
    if "q_norm" in p:
        scale = p["q_norm"]["scale"]
        q = L.rmsnorm({"scale": scale if row else copy_to(scale, ax)}, q)
        k = L.rmsnorm(p["k_norm"], k)
    if not cross and positions is not None:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def _local_kv(k, v, H: int, ax: ModelAxis):
    """The KV heads of this rank's H/n query heads (head mode), as
    (k, v, G): the block of whole KV heads, G query heads each, where
    the local query heads hold whole groups; else K and V repeated to
    the local query heads, G = 1 (the reference repeats to H and shards
    the heads)."""
    KV = k.shape[2]
    G = H // KV
    h0, hl = ax.block(H)
    if hl % G == 0:
        return (k.narrow(2, h0 // G, hl // G), v.narrow(2, h0 // G, hl // G),
                G)
    idx = torch.arange(h0, h0 + hl, device=k.device) // G
    return k.index_select(2, idx), v.index_select(2, idx), 1


def attn_apply(p, x, cfg: ModelConfig, *, tp: str, kind: str = "attn",
               src=None, positions=None, causal: bool = True,
               seq_shard: bool = False, mesh=None):
    ax = model_axis(mesh)
    cross = kind == "cross"
    h = L.rmsnorm(p["ln"], x)
    window = cfg.window if kind == "attn_swa" else None
    causal = causal and not cross
    q, k, v = _qkv(p, cfg, h, src, positions, tp, cross, ax)
    B, T, H, Dh = q.shape
    if ax.size > 1 and tp == "head":
        k, v, G = _local_kv(copy_to(k, ax), copy_to(v, ax),
                            cfg.num_heads, ax)
        out = att.flash_attention(q.reshape(B, T, H // G, G, Dh), k, v,
                                  causal=causal, window=window,
                                  q_chunk=cfg.attn_chunk)
    else:
        # the reference repeats K and V to H heads in head mode; the
        # kernel reads KV head h // G in place instead, which computes
        # the same attention
        KV = k.shape[2]
        qg = q.reshape(B, T, KV, H // KV, Dh)
        if seq_shard:
            out = att.seq_sharded_flash_attention(
                qg, k, v, causal=causal, window=window,
                q_chunk=cfg.attn_chunk, mesh=ax)
        else:
            out = att.flash_attention(qg, k, v, causal=causal,
                                      window=window, q_chunk=cfg.attn_chunk)
    out = out.reshape(B, T, H, Dh)
    if ax.size > 1 and tp == "row":
        out = scatter_to(out, ax, -1)
    y = torch.einsum("bthk,hkd->btd", out, p["wo"].to(x.dtype))
    return x + reduce_from(y, ax)


def attn_cache_decl(cfg: ModelConfig, n_rep: int, batch: int, seq_len: int,
                    kind: str, dtype):
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    S = min(cfg.window, seq_len) if kind == "attn_swa" else seq_len
    if kind == "cross":
        S = cfg.num_src_tokens
    shp = (n_rep, batch, S, KV, Dh)
    axes = ("layers", "batch", "cache_seq", "kv_heads", "head_dim")
    return {"k": declare(shp, axes, init="zeros", dtype=dtype),
            "v": declare(shp, axes, init="zeros", dtype=dtype)}


def attn_decode(p, x, cache, pos, cfg: ModelConfig, mesh, *, tp: str,
                kind: str = "attn"):
    """x [B,d] single token. cache {k,v} [B,S,KV,Dh] (over a model axis
    this rank's S/n slots). Returns (y, cache), the cache being the
    input's, with the new K/V row written in place (`cross`: read only,
    no rope). Over a model axis q is made whole on every rank (head
    mode: the local heads all-gathered; row mode: the partial sums
    reduced) and the attention output is cut again for `wo`. Under the
    `dp` profile (`ModelAxis.cache`: every head on every rank, the
    slots cut over the cache axis) the projections are local and only
    the flash-decode merges over the cache axis."""
    ax = model_axis(mesh)
    cross = kind == "cross"
    h = L.rmsnorm(p["ln"], x)
    B, d = h.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    row = ax.size > 1 and tp == "row"
    hp = scatter_to(h, ax, -1) if row else h

    def proj(w):
        y = torch.einsum("bd,dhk->bhk", hp, w.to(x.dtype))
        return reduce_from(y, ax) if row else y
    q = proj(p["wq"])
    if "q_norm" in p:
        q = L.rmsnorm(p["q_norm"], q)
    if not cross:
        k_new, v_new = proj(p["wk"]), proj(p["wv"])
        if "k_norm" in p:
            k_new = L.rmsnorm(p["k_norm"], k_new)
        q = L.rope(q, pos, cfg.rope_theta)
        k_new = L.rope(k_new, pos, cfg.rope_theta)
    if ax.size > 1 and tp == "head":
        q = gather_from(q, ax, 1)
    qg = q.reshape(B, KV, H // KV, Dh)
    window = cfg.window if kind == "attn_swa" else None
    if cross:
        out = att.decode_cross_attention(ax.seq, qg, cache["k"],
                                         cache["v"])
        ck, cv = cache["k"], cache["v"]
    else:
        out, ck, cv = att.decode_attention(
            ax.seq, qg, cache["k"], cache["v"], k_new, v_new, pos,
            window=window)
    out = out.reshape(B, H, Dh)
    if ax.size > 1:
        out = scatter_to(out, ax, -1 if row else 1)
    y = torch.einsum("bhk,hkd->bd", out, p["wo"].to(x.dtype))
    return x + reduce_from(y, ax), {"k": ck, "v": cv}


# ===========================================================================
# MLP
# ===========================================================================

def mlp_decl(cfg: ModelConfig, tp: str):
    return {"ln": L.rmsnorm_decl(cfg.d_model),
            "mlp": L.mlp_decl(cfg.d_model, cfg.d_ff,
                              gated=cfg.act == "silu")}


def mlp_apply(p, x, cfg: ModelConfig, mesh=None, **_):
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln"], x), act=cfg.act,
                     mesh=mesh)


def mlp_decode(p, x, cache, pos, cfg, mesh, **_):
    return mlp_apply(p, x, cfg, mesh=mesh), cache


# ===========================================================================
# MoE (token-choice top-k, sort-based fixed-capacity grouped matmul)
# ===========================================================================

def moe_decl(cfg: ModelConfig, tp: str):
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    p = {
        "ln": L.rmsnorm_decl(d),
        "router": declare((d, E), ("embed", None), init="normal",
                          scale=0.02, dtype=torch.float32),
        "w_gate": declare((E, d, f), ("experts", "embed", "expert_mlp")),
        "w_up": declare((E, d, f), ("experts", "embed", "expert_mlp")),
        "w_down": declare((E, f, d), ("experts", "expert_mlp", "embed")),
    }
    if cfg.shared_expert:
        p["shared"] = L.mlp_decl(d, cfg.moe_d_ff, gated=True)
    return p


def _router(p, h, cfg: ModelConfig, ax: ModelAxis = LOCAL):
    """Top-k routing of h [..., d]: (gate [..., k] f32, eidx [..., k]
    int64, the load-balance aux loss). `engine.model_decl` casts the
    fp32-declared router to the params' dtype; the reference's einsum of
    float32 h with it promotes it back to float32, as this cast does.
    Over a batch axis (`ax.batch`, training) the aux loss is the whole
    batch's: its two per-expert means are averaged over the ranks."""
    logits = torch.einsum("...d,de->...e", h.to(torch.float32),
                          p["router"].to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    # `jax.lax.top_k`: descending, the lower index first on ties. A
    # stable descending sort guarantees that order; `torch.topk` leaves
    # the order of ties unspecified.
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_tok
    gate, eidx = vals[..., :k], idx[..., :k]
    gate = gate / torch.clamp_min(gate.sum(-1, keepdim=True), 1e-9)
    # switch-style load-balance aux loss
    me = probs.mean(dim=tuple(range(probs.ndim - 1)))
    flat = eidx.reshape(-1)
    ce = torch.zeros_like(me).index_add_(
        0, flat, torch.full(flat.shape, 1.0 / flat.numel(),
                            dtype=me.dtype, device=me.device))
    if ax.batch is not None:
        me, ce = batch_mean(me, ax), batch_mean(ce, ax)
    aux = cfg.num_experts * torch.sum(me * ce)
    return gate, eidx, aux


def _gcd(a: int, b: int) -> int:
    while b:
        a, b = b, a % b
    return a


def _take_rows(src, idx):
    """src [G, M, d] gathered at idx [G, P] -> [G, P, d]."""
    return torch.gather(src, 1, idx[..., None].expand(*idx.shape,
                                                      src.shape[-1]))


def _sum_rows(src, pos, valid):
    """out[g, t] = sum over r of src[g, pos[g, t, r]] where valid[g, t, r],
    added one r after the other: src [G, P, d], pos/valid [G, n, k] ->
    [G, n, d] in src's dtype. No atomics, so the bits do not depend on
    the launch."""
    out = torch.zeros((*pos.shape[:2], src.shape[-1]), dtype=src.dtype,
                      device=src.device)
    for r in range(pos.shape[-1]):
        out = out + torch.where(valid[..., r, None],
                                _take_rows(src, pos[..., r]), 0.0)
    return out


class _Dispatch(torch.autograd.Function):
    """xb = ht gathered at the expert slots' tokens `tok_idx` [G, E*C].
    The backward sums each token's gradient over its valid slots in
    slot order (`_sum_rows`), not by an atomic scatter-add: the slots
    past an expert's capacity carry gate 0, so their gradient is zero and
    they are left out."""

    @staticmethod
    def forward(ctx, ht, tok_idx, pos, valid):
        ctx.save_for_backward(pos, valid)
        return _take_rows(ht, tok_idx)

    @staticmethod
    def backward(ctx, g):
        pos, valid = ctx.saved_tensors
        return _sum_rows(g, pos, valid), None, None, None


class _Combine(torch.autograd.Function):
    """out[g, t] = the sum of token t's gated expert outputs yb [G, E*C, d]
    over its valid slots `pos` [G, n, k], in slot order, that is in
    expert order after the stable sort: the order in which the
    reference's scatter-add applies its updates (its gate-0 slots add
    zeros). The backward hands each valid slot its token's gradient
    (`slot_valid` [G, E*C]), a gather: every valid slot has one token."""

    @staticmethod
    def forward(ctx, yb, tok_idx, slot_valid, pos, valid):
        ctx.save_for_backward(tok_idx, slot_valid)
        return _sum_rows(yb, pos, valid)

    @staticmethod
    def backward(ctx, g):
        tok_idx, slot_valid = ctx.saved_tensors
        return (torch.where(slot_valid[..., None], _take_rows(g, tok_idx),
                            0.0), None, None, None, None)


def moe_route(p, x, cfg: ModelConfig, groups: int = 16,
              ax: ModelAxis = LOCAL):
    """The router half of `moe_apply`: (h [B,T,d], gate [G,n,k],
    eidx [G,n,k], aux), with the tokens in G = gcd(B, groups) groups of
    n = B*T/G, as the reference groups them. Over a batch axis of D ranks
    (`ax.batch`, each rank B of the vehicle's B*D rows) a rank takes its
    G/D of the whole batch's G = gcd(B*D, groups) groups, where D divides
    G: the same groups, and capacities, as one process."""
    B, T, d = x.shape
    h = L.rmsnorm(p["ln"], x)
    if ax.batch is not None:
        D = ax.batch.size
        whole = _gcd(B * D, groups)
        groups = whole // D if whole % D == 0 else groups
    G = _gcd(B, groups)
    gate, eidx, aux = _router(p, h.reshape(G, (B * T) // G, d), cfg, ax)
    return h, gate, eidx, aux


def moe_plan(gate, eidx, cfg: ModelConfig):
    """The fixed-capacity dispatch of routing gate/eidx [G, n, k]. Per
    group the (token, choice) pairs are sorted stably by expert; expert e
    takes the first C = max(1, int(n * k * capacity_factor) // E) of its
    pairs into its C slots. The slots past its count carry gate 0 with
    their index clipped to n*k - 1, as the reference's (they gather a
    real token and multiply it by 0). Returns
      tok_idx [G, E*C]     each slot's token,
      slot_valid [G, E*C]  whether the slot holds one of its expert's pairs,
      gates_ec [G, E*C]    its gate (0 where not valid),
      pos, valid [G, n, k] each token's kept slots in ascending order,
                           which is expert order (the dropped ones last,
                           not valid)."""
    G, n, k = eidx.shape
    E = cfg.num_experts
    dev = eidx.device
    C = max(1, int(n * k * cfg.capacity_factor) // E)
    flat_e = eidx.reshape(G, n * k)
    flat_g = gate.reshape(G, n * k)
    flat_tok = torch.arange(n, device=dev).repeat_interleave(k) \
        .expand(G, n * k)
    order = torch.argsort(flat_e, dim=1, stable=True)  # per-group sort
    se = torch.gather(flat_e, 1, order)
    sg = torch.gather(flat_g, 1, order)
    stok = torch.gather(flat_tok, 1, order)
    experts = torch.arange(E, device=dev).expand(G, E).contiguous()
    first = torch.searchsorted(se, experts)
    counts = torch.searchsorted(se, experts, right=True) - first
    ar_c = torch.arange(C, device=dev)
    slots = first[:, :, None] + ar_c                            # [G,E,C]
    slot_valid = (ar_c < counts[:, :, None]).reshape(G, E * C)
    slots = torch.clamp(slots, 0, n * k - 1).reshape(G, E * C)
    tok_idx = torch.gather(stok, 1, slots)                      # [G,E*C]
    gates_ec = torch.where(slot_valid, torch.gather(sg, 1, slots), 0.0)
    # each pair's slot: its rank c within its expert, kept if c < C
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(n * k, device=dev).expand(G, n * k))
    c = rank - torch.gather(first, 1, flat_e)
    pos = torch.where(c < C, flat_e * C + c, E * C).reshape(G, n, k)
    pos = torch.sort(pos, dim=-1).values
    valid = pos < E * C
    return tok_idx, slot_valid, gates_ec, torch.clamp_max(pos, E * C - 1), \
        valid


def _local_slots(plan, E: int, ax: ModelAxis):
    """The global plan (`moe_plan`) cut to this rank's E/n experts: their
    slots' tokens, validity and gates, and each token's slots among them
    (positions local, the others not valid)."""
    tok_idx, slot_valid, gates_ec, pos, valid = plan
    C = tok_idx.shape[1] // E
    e0, el = ax.block(E)
    lo, hi = e0 * C, (e0 + el) * C
    return (tok_idx[:, lo:hi], slot_valid[:, lo:hi], gates_ec[:, lo:hi],
            torch.clamp(pos - lo, 0, hi - lo - 1),
            valid & (pos >= lo) & (pos < hi))


def moe_experts(p, x, h, gate, eidx, cfg: ModelConfig, mesh=None):
    """The dispatch half of `moe_apply`, given the routing (`moe_plan`):
    x + the experts' gated outputs (+ the shared expert). Each token's
    outputs are summed in expert order (`_Combine`). Over a model axis
    the plan is the global one (every rank keeps the same slots), this
    rank runs its block of the experts (`w_*` [E/n, ...]) and the
    partial combines are summed."""
    B, T, d = x.shape
    G, n, k = eidx.shape
    E = cfg.num_experts
    ax = model_axis(mesh)
    plan = moe_plan(copy_to(gate, ax), eidx, cfg)
    if ax.size > 1:
        plan = _local_slots(plan, E, ax)
    tok_idx, slot_valid, gates_ec, pos, valid = plan
    el = p["w_gate"].shape[0]
    C = tok_idx.shape[1] // el
    xb = _Dispatch.apply(copy_to(h, ax).reshape(G, n, d), tok_idx, pos,
                         valid).reshape(G, el, C, d)
    gh = F.silu(torch.einsum("gecd,edf->gecf", xb,
                             p["w_gate"].to(x.dtype)))
    uh = torch.einsum("gecd,edf->gecf", xb, p["w_up"].to(x.dtype))
    yb = torch.einsum("gecf,efd->gecd", gh * uh, p["w_down"].to(x.dtype))
    yb = yb * gates_ec.reshape(G, el, C, 1).to(yb.dtype)
    out = _Combine.apply(yb.reshape(G, el * C, d), tok_idx, slot_valid, pos,
                         valid).reshape(B, T, d)
    out = reduce_from(out, ax)
    if "shared" in p:
        out = out + L.mlp(p["shared"], h, act="silu", mesh=ax)
    return x + out


def moe_apply(p, x, cfg: ModelConfig, groups: int = 16, mesh=None, **_):
    """Group-local sort-based dispatch, per-group capacity dropping,
    standard token-choice top-k. Returns (x + MoE(x), aux)."""
    h, gate, eidx, aux = moe_route(p, x, cfg, groups, model_axis(mesh))
    return moe_experts(p, x, h, gate, eidx, cfg, mesh=mesh), aux


def moe_decode(p, x, cache, pos, cfg: ModelConfig, mesh, **_):
    """Decode: every expert applied densely to the (small) token batch x
    [B,d], each token's outputs weighted by its routing (no capacity, no
    dropped tokens), plus the shared expert. Over a model axis each rank
    applies its E/n experts and the outputs are summed, as the
    reference's docstring says of its GSPMD split."""
    ax = model_axis(mesh)
    h = L.rmsnorm(p["ln"], x)                        # [B,d]
    gate, eidx, _ = _router(p, h, cfg)               # [B,k]
    E = cfg.num_experts
    onehot = (eidx[..., None] == torch.arange(E, device=x.device)) \
        .to(x.dtype)                                 # [B,k,E]
    w_tok = torch.einsum("bk,bke->be", gate.to(x.dtype), onehot)
    if ax.size > 1:
        w_tok = w_tok.narrow(1, *ax.block(E))
    gh = F.silu(torch.einsum("bd,edf->ebf", h, p["w_gate"].to(x.dtype)))
    uh = torch.einsum("bd,edf->ebf", h, p["w_up"].to(x.dtype))
    ye = torch.einsum("ebf,efd->ebd", gh * uh, p["w_down"].to(x.dtype))
    y = reduce_from(torch.einsum("ebd,be->bd", ye, w_tok), ax)
    if "shared" in p:
        y = y + L.mlp(p["shared"], h, act="silu", mesh=ax)
    return x + y, cache


# ===========================================================================
# Mamba2 / SSD (scalar-per-head decay, shared B/C across heads, G=1)
# ===========================================================================

def mamba_decl(cfg: ModelConfig, tp: str):
    d, di, N = cfg.d_model, cfg.d_inner, cfg.ssm_state
    H = cfg.ssm_heads
    return {
        "ln": L.rmsnorm_decl(d),
        "w_x": declare((d, di), ("embed", "mlp")),
        "w_z": declare((d, di), ("embed", "mlp")),
        "w_bc": declare((d, 2 * N), ("embed", None)),
        "w_dt": declare((d, H), ("embed", "ssm_heads")),
        "conv_w": declare((cfg.ssm_conv_k, di), ("conv_k", "mlp"),
                          init="normal", scale=0.5),
        "A_log": declare((H,), ("ssm_heads",), init="zeros"),
        "dt_bias": declare((H,), ("ssm_heads",), init="zeros"),
        "D": declare((H,), ("ssm_heads",), init="ones"),
        "out_norm": {"scale": declare((di,), ("mlp",), init="ones")},
        "w_out": declare((di, d), ("mlp", "embed")),
    }


def _ssd_chunk_scan(xh, bmat, cmat, log_a, chunk: int, state0=None):
    """Chunked SSD. xh [B,T,H,P] (v), bmat/cmat [B,T,N], log_a [B,T,H]<=0.

    Returns y [B,T,H,P], final state [B,H,N,P]. Runs through
    `kernels/ssd_scan` (the CUDA kernel for CUDA tensors, its plain
    version on the CPU; the backward by autograd through the plain
    version), which reads the shared b and c of each batch row in
    place. The scan's chunk is min(chunk, T), as the reference's; the
    kernel runs a T below `chunk` as one padded chunk of `chunk`."""
    T = xh.shape[1]
    assert T % min(chunk, T) == 0, (T, chunk)
    return ssd_scan(xh.contiguous(), bmat.contiguous(), cmat.contiguous(),
                    log_a.contiguous(), chunk, state0)


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0), with no linear cut-off above a
    threshold (torch's softplus has one at 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _mamba_proj(p, x, cfg: ModelConfig, ax: ModelAxis = LOCAL):
    """(xi, z, bc, dt): over a model axis xi and z of this rank's d_inner
    block, dt of its heads (from `copy_to(h)`), and b/c whole (`w_bc` is
    replicated) passed through `copy_to`, since they enter the split
    scan: `w_bc`'s gradient is then summed over the ranks."""
    h = L.rmsnorm(p["ln"], x)
    hs = copy_to(h, ax)
    xi = torch.einsum("...d,di->...i", hs, p["w_x"].to(x.dtype))
    z = torch.einsum("...d,di->...i", hs, p["w_z"].to(x.dtype))
    bc = copy_to(torch.einsum("...d,dn->...n", h, p["w_bc"].to(x.dtype)),
                 ax)
    dt = _softplus(
        torch.einsum("...d,dh->...h", hs, p["w_dt"].to(x.dtype))
        + p["dt_bias"].to(x.dtype))
    return xi, z, bc, dt


def mamba_apply(p, x, cfg: ModelConfig, mesh=None, **_):
    """Over a model axis each rank runs its ssm_heads/n heads: its d_inner
    block of d_inner/n = (H/n) P channels is exactly those heads
    (d_inner is head-major), so the conv, the scan and D act on local
    tensors; `out_norm` normalises over the whole d_inner and `w_out`'s
    partial outputs are summed."""
    ax = model_axis(mesh)
    B, T, d = x.shape
    Pd, N = cfg.ssm_head_dim, cfg.ssm_state
    xi, z, bc, dt = _mamba_proj(p, x, cfg, ax)
    H = dt.shape[-1]                                      # this rank's
    # causal depthwise conv over x path: K shifted products summed in x's
    # dtype, in the reference's order
    K = cfg.ssm_conv_k
    xpad = F.pad(xi, (0, 0, K - 1, 0))
    xc = sum(xpad[:, i:i + T] * p["conv_w"][i].to(x.dtype)
             for i in range(K))
    xc = F.silu(xc)
    xh = xc.reshape(B, T, H, Pd)
    bmat, cmat = bc[..., :N], bc[..., N:]
    A = -torch.exp(p["A_log"].to(torch.float32))
    log_a = dt.to(torch.float32) * A                      # [B,T,H] <= 0
    v = xh * dt[..., None].to(x.dtype)
    y, _ = _ssd_chunk_scan(v, bmat, cmat, log_a, cfg.ssm_chunk)
    y = y + xh * p["D"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B, T, H * Pd)
    y = L.rmsnorm(p["out_norm"], y * F.silu(z), mesh=ax)
    y = torch.einsum("...i,id->...d", y, p["w_out"].to(x.dtype))
    return x + reduce_from(y, ax)


def mamba_cache_decl(cfg: ModelConfig, n_rep: int, batch: int, dtype):
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    K = cfg.ssm_conv_k
    return {
        "conv": declare((n_rep, batch, K - 1, cfg.d_inner),
                        ("layers", "batch", "conv_k", "mlp"),
                        init="zeros", dtype=dtype),
        "state": declare((n_rep, batch, H, N, Pd),
                         ("layers", "batch", "ssm_heads", "ssm_state", None),
                         init="zeros", dtype=torch.float32),
    }


def mamba_decode(p, x, cache, pos, cfg: ModelConfig, mesh, **_):
    """One step of the recurrence: the conv history [B,K-1,di] shifts by
    the new input, and the fp32 state [B,H,N,P] decays by
    a = exp(dt * -exp(A_log)) and takes b (dt * x). Over a model axis the
    history and the state are this rank's d_inner block and heads."""
    ax = model_axis(mesh)
    B, d = x.shape
    Pd, N = cfg.ssm_head_dim, cfg.ssm_state
    xi, z, bc, dt = _mamba_proj(p, x, cfg, ax)
    H = dt.shape[-1]
    conv, state = cache["conv"], cache["state"]
    hist = torch.cat([conv, xi[:, None]], dim=1)          # [B,K,di]
    xc = F.silu(torch.einsum("bki,ki->bi", hist, p["conv_w"].to(x.dtype)))
    conv_new = hist[:, 1:]
    xh = xc.reshape(B, H, Pd)
    bmat, cmat = bc[..., :N], bc[..., N:]
    A = -torch.exp(p["A_log"].to(torch.float32))
    a = torch.exp(dt.to(torch.float32) * A)               # [B,H]
    v = (xh * dt[..., None].to(x.dtype)).to(torch.float32)
    kv = torch.einsum("bn,bhp->bhnp", bmat.to(torch.float32), v)
    state_new = a[..., None, None] * state + kv
    y = torch.einsum("bn,bhnp->bhp", cmat.to(torch.float32), state_new)
    y = y.to(x.dtype) + xh * p["D"].to(x.dtype)[None, :, None]
    y = y.reshape(B, H * Pd)
    y = L.rmsnorm(p["out_norm"], y * F.silu(z), mesh=ax)
    out = x + reduce_from(torch.einsum("bi,id->bd", y,
                                       p["w_out"].to(x.dtype)), ax)
    return out, {"conv": conv_new, "state": state_new}


# ===========================================================================
# mLSTM (matrix memory; chunked like SSD but per-head q/k and normalizer)
# ===========================================================================

def mlstm_decl(cfg: ModelConfig, tp: str):
    d = cfg.d_model
    di = int(cfg.lstm_proj_factor * d)
    H = cfg.num_heads
    Pd = di // H
    return {
        "ln": L.rmsnorm_decl(d),
        "w_q": declare((d, H, Pd), ("embed", None, "row_head_dim")),
        "w_k": declare((d, H, Pd), ("embed", None, "row_head_dim")),
        "w_v": declare((d, H, Pd), ("embed", None, "row_head_dim")),
        "w_if": declare((d, 2 * H), ("embed", None)),
        "w_o": declare((d, di), ("embed", "mlp")),
        "w_out": declare((di, d), ("mlp", "embed")),
        "out_norm": {"scale": declare((di,), ("mlp",), init="ones")},
    }


def _mlstm_gates(p, h):
    """(log forget gate = log sigmoid(f) <= 0, log input gate), each
    [..., H], in float32 from float32 copies of h and w_if."""
    gif = torch.einsum("...d,dg->...g", h.to(torch.float32),
                       p["w_if"].to(torch.float32))
    H = gif.shape[-1] // 2
    return -_softplus(-gif[..., :H]), gif[..., H:]


def _one(like):
    return torch.ones((), dtype=like.dtype, device=like.device)


def _reduce_pair(a, b, ax: ModelAxis):
    """reduce_from of a [..., P] and b [...] in one all-reduce."""
    if ax.size == 1:
        return a, b
    ab = reduce_from(torch.cat([a, b[..., None]], dim=-1), ax)
    return ab[..., :-1], ab[..., -1]


def _mlstm_chunk(Cm, n, qc, kc, vc, lf, li, scale: float, dtype,
                 ax: ModelAxis = LOCAL):
    """One chunk of the mLSTM scan (the reference's scan step): the
    chunk's output [B, c, H, P] in `dtype`, and the carried matrix memory
    Cm [B, H, P, P] and normalizer n [B, H, P], all in float32; Cm and n
    None are the zero state (the first chunk: no inter-chunk term).

    Over a model axis q and k [B, c, H, P/n] and the state's rows (Cm's
    first P, n's P) are this rank's block of the head dim, v is whole:
    the q.k scores, the q.C readout and the q.n normalizer sum their
    partial sums over the ranks, so the output is whole on every rank.
    The gates (cum, li) and v are replicated; where they enter split
    work (q's and k's decay weights, the state update) they pass
    `copy_to`."""
    qc, kc, vc = (a.to(torch.float32) for a in (qc, kc, vc))
    cum = torch.cumsum(lf.to(torch.float32), dim=1)              # [B,c,H]
    # intra: w_ij = q_i k_j exp(cum_i - cum_j + li_j) (j <= i); above
    # the diagonal g grows with j - i, so it is clamped before the mask
    # multiplies (exp would overflow to inf, and inf * 0 is NaN)
    s = reduce_from(torch.einsum("bihp,bjhp->bhij", qc, kc), ax) * scale
    c = qc.shape[1]
    causal = torch.tril(torch.ones((c, c), dtype=torch.float32,
                                   device=qc.device))
    g = cum[:, :, None, :] - cum[:, None, :, :] + li[:, None, :, :]
    w = s * torch.exp(torch.clamp_max(g, 20.0)).permute(0, 3, 1, 2) \
        * causal
    y = torch.einsum("bhij,bjhp->bihp", w, vc)
    den = w.sum(-1).transpose(1, 2)[..., None]                   # [B,i,H,1]
    cum_s, li_s, vs = copy_to(cum, ax), copy_to(li, ax), copy_to(vc, ax)
    if Cm is not None:
        # inter, from the carried matrix memory
        qeff = qc * torch.exp(cum_s)[..., None] * scale
        yi, di = _reduce_pair(torch.einsum("bihp,bhpq->bihq", qeff, Cm),
                              torch.einsum("bihp,bhp->bih", qeff, n), ax)
        y = y + yi
        den = den + di[..., None]
    out = y / torch.maximum(torch.abs(den), _one(den))
    # state update; the tail exp(cum[-1] - cum + li) is not clamped, as
    # the reference's is not
    tail = torch.exp(cum_s[:, -1:, :] - cum_s + li_s)            # [B,j,H]
    keff = kc * tail[..., None]
    kv = torch.einsum("bjhp,bjhq->bhpq", keff, vs)
    if Cm is None:
        Cm, n = kv, keff.sum(dim=1)
    else:
        decay = torch.exp(cum_s[:, -1])[:, :, None, None]
        Cm = decay * Cm + kv
        n = decay[..., 0] * n + keff.sum(dim=1)
    return Cm, n, out.to(dtype)


def mlstm_apply(p, x, cfg: ModelConfig, mesh=None, **_):
    """Over a model axis q, k and v are this rank's block of the head dim
    P (`row_head_dim`), v all-gathered whole for the state update; the
    core's output is whole on every rank and is cut to this rank's
    d_inner block for `out_norm` (normalised over the whole d_inner),
    `o = sigmoid(h w_o)` and `w_out`, whose partial outputs are summed.
    The two cuts need not line up: a d_inner block is whole heads where
    n <= H and part of one head where n > H."""
    ax = model_axis(mesh)
    B, T, d = x.shape
    h = L.rmsnorm(p["ln"], x)
    hs = copy_to(h, ax)
    q = torch.einsum("btd,dhp->bthp", hs, p["w_q"].to(x.dtype))
    k = torch.einsum("btd,dhp->bthp", hs, p["w_k"].to(x.dtype))
    v = gather_from(torch.einsum("btd,dhp->bthp", hs, p["w_v"].to(x.dtype)),
                    ax, -1)
    log_f, log_i = _mlstm_gates(p, h)                            # [B,T,H]
    H, Pd = v.shape[2], v.shape[3]                               # whole
    chunk = min(cfg.ssm_chunk, T)
    if T % chunk:
        raise ValueError(f"mlstm_apply: the chunk {chunk} does not divide "
                         f"the sequence length {T}")
    Cm = n = None
    outs = []
    for c in loop("mlstm_chunks", T // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        Cm, n, out = _mlstm_chunk(Cm, n, q[:, sl], k[:, sl], v[:, sl],
                                  log_f[:, sl], log_i[:, sl], Pd ** -0.5,
                                  x.dtype, ax)
        outs.append(out)
    outs = fill(outs, T // chunk)
    y = scatter_to(torch.cat(outs, dim=1).reshape(B, T, H * Pd), ax, -1)
    o = torch.sigmoid(torch.einsum("btd,di->bti", hs, p["w_o"].to(x.dtype)))
    y = L.rmsnorm(p["out_norm"], y, mesh=ax) * o
    y = torch.einsum("bti,id->btd", y, p["w_out"].to(x.dtype))
    return x + reduce_from(y, ax)


def mlstm_cache_decl(cfg: ModelConfig, n_rep: int, batch: int, dtype):
    di = int(cfg.lstm_proj_factor * cfg.d_model)
    H = cfg.num_heads
    Pd = di // H
    return {
        "C": declare((n_rep, batch, H, Pd, Pd),
                     ("layers", "batch", None, "row_head_dim", None),
                     init="zeros", dtype=torch.float32),
        "n": declare((n_rep, batch, H, Pd),
                     ("layers", "batch", None, "row_head_dim"),
                     init="zeros", dtype=torch.float32),
    }


def mlstm_decode(p, x, cache, pos, cfg: ModelConfig, mesh, **_):
    """One step of the matrix memory: C = f C + i k v^T, n = f n + i k,
    with i = exp(min(log_i, 20)), read by q over max(|q.n|, 1). Over a
    model axis the cache holds this rank's rows of C and n (its block of
    the head dim), v is gathered whole, and the readout and the
    normalizer sum their partial sums over the ranks."""
    ax = model_axis(mesh)
    B, d = x.shape
    h = L.rmsnorm(p["ln"], x)
    q = torch.einsum("bd,dhp->bhp", h, p["w_q"].to(x.dtype))
    k = torch.einsum("bd,dhp->bhp", h, p["w_k"].to(x.dtype))
    v = gather_from(torch.einsum("bd,dhp->bhp", h, p["w_v"].to(x.dtype)),
                    ax, -1)
    log_f, log_i = _mlstm_gates(p, h)                           # [B,H]
    Pd = v.shape[-1]
    f = torch.exp(log_f)[..., None, None]
    i = torch.exp(torch.clamp_max(log_i, 20.0))[..., None, None]
    k32, v32 = k.to(torch.float32), v.to(torch.float32)
    Cm = f * cache["C"] + i * torch.einsum("bhp,bhq->bhpq", k32, v32)
    n = f[..., 0] * cache["n"] + i[..., 0] * k32
    qs = q.to(torch.float32) * (Pd ** -0.5)
    y, den = _reduce_pair(torch.einsum("bhp,bhpq->bhq", qs, Cm),
                          torch.einsum("bhp,bhp->bh", qs, n), ax)
    y = (y / torch.maximum(torch.abs(den[..., None]), _one(den))).to(
        x.dtype)
    y = scatter_to(y.reshape(B, -1), ax, -1)
    o = torch.sigmoid(torch.einsum("bd,di->bi", h, p["w_o"].to(x.dtype)))
    y = L.rmsnorm(p["out_norm"], y, mesh=ax) * o
    out = x + reduce_from(torch.einsum("bi,id->bd", y,
                                       p["w_out"].to(x.dtype)), ax)
    return out, {"C": Cm, "n": n}


# ===========================================================================
# sLSTM (scalar memory, a true recurrence over time)
# ===========================================================================

def slstm_decl(cfg: ModelConfig, tp: str):
    d = cfg.d_model
    H = cfg.num_heads
    Pd = d // H
    return {
        "ln": L.rmsnorm_decl(d),
        "w_in": declare((d, H, 4 * Pd), ("embed", None, None)),
        "r": declare((H, Pd, 4 * Pd), (None, None, None), scale=0.5),
        "b": declare((H, 4 * Pd), (None, None), init="zeros"),
        "w_out": declare((d, d), ("embed", "out")),
    }


def _slstm_cell(p, gx, state):
    """gx [B,H,4P] precomputed input gates; state (h,c,n,m) each [B,H,P]
    in float32."""
    h, c, n, m = state
    rec = torch.einsum("bhp,hpq->bhq", h, p["r"].to(torch.float32))
    g = gx.to(torch.float32) + rec + p["b"].to(torch.float32)
    Pd = g.shape[-1] // 4
    gi, gf, gz, go = (g[..., :Pd], g[..., Pd:2 * Pd],
                      g[..., 2 * Pd:3 * Pd], g[..., 3 * Pd:])
    log_f = -_softplus(-gf)
    m_new = torch.maximum(log_f + m, gi)
    i = torch.exp(gi - m_new)
    f = torch.exp(log_f + m - m_new)
    c_new = f * c + i * torch.tanh(gz)
    n_new = f * n + i
    h_new = torch.sigmoid(go) * c_new / torch.maximum(n_new, _one(n_new))
    return h_new, c_new, n_new, m_new


def slstm_apply(p, x, cfg: ModelConfig, mesh=None, **_):
    """The recurrence is a Python loop over the T steps, h kept in float32
    and cast to x's dtype after it, as the reference's scan emits it. The
    float32 copies of r and b are made once: the reference's cast in each
    step gives the same values. Over a model axis every parameter is
    replicated (no logical axis of its maps to the model axis) and every
    rank runs the whole block: no collective."""
    B, T, d = x.shape
    H = cfg.num_heads
    Pd = d // H
    hin = L.rmsnorm(p["ln"], x)
    gx = torch.einsum("btd,dhq->bthq", hin, p["w_in"].to(x.dtype))
    p32 = {"r": p["r"].to(torch.float32), "b": p["b"].to(torch.float32)}
    state = tuple(torch.zeros((B, H, Pd), dtype=torch.float32,
                              device=x.device) for _ in range(4))
    hs = []
    for t in loop("slstm_steps", T):
        state = _slstm_cell(p32, gx[:, t], state)
        hs.append(state[0])
    y = torch.stack(fill(hs, T), dim=1).reshape(B, T, d).to(x.dtype)
    return x + torch.einsum("btd,de->bte", y, p["w_out"].to(x.dtype))


def slstm_cache_decl(cfg: ModelConfig, n_rep: int, batch: int, dtype):
    H = cfg.num_heads
    Pd = cfg.d_model // H
    shp = (n_rep, batch, H, Pd)
    ax = ("layers", "batch", None, None)
    return {k: declare(shp, ax, init="zeros", dtype=torch.float32)
            for k in ("h", "c", "n", "m")}


def slstm_decode(p, x, cache, pos, cfg: ModelConfig, mesh, **_):
    """One step of `_slstm_cell` from the cached (h, c, n, m); from a zero
    cache m starts at 0, as in `slstm_apply`."""
    hin = L.rmsnorm(p["ln"], x)
    gx = torch.einsum("bd,dhq->bhq", hin, p["w_in"].to(x.dtype))
    state = (cache["h"], cache["c"], cache["n"], cache["m"])
    h, c, n, m = _slstm_cell(p, gx, state)
    B = x.shape[0]
    y = h.to(x.dtype).reshape(B, -1)
    out = x + torch.einsum("bd,de->be", y, p["w_out"].to(x.dtype))
    return out, {"h": h, "c": c, "n": n, "m": m}
