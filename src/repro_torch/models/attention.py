"""Attention cores.

Port of `repro/models/attention.py`, over the reference's GQA-grouped
layout, q [B, T, KV, G, D] and k, v [B, S, KV, D] (no materialized
KV-head repeat):

* `flash_attention`, the training/prefill core. It runs through
  `kernels/flash_attention`: for CUDA tensors the forward is the
  hand-written CUDA kernel, for CPU tensors its plain PyTorch version,
  and in both cases the backward is the chunked flash backward in
  PyTorch ops (the reference differentiates its jnp attention with
  autodiff; it has no backward kernel). The reference's
  `q_chunk`/`kv_chunk` are tile sizes of its jnp scans. Here the kernel
  picks its own tiles; `q_chunk` sets the backward's query-row chunk and
  `kv_chunk` is accepted for the same call signature.
* `seq_sharded_flash_attention`, the reference's sequence-parallel core
  (`attention.py:250`): over a model axis of n ranks each rank takes
  its T/n queries at their offset against the whole K and V through the
  same kernel, and the outputs are all-gathered on the sequence axis;
  otherwise (one rank, T not a multiple of n, T below 4 q_chunk, not
  causal, a window) `flash_attention` itself, as the reference falls
  back.
* Decode: one new token a row against a K/V cache, full (the new row
  written at `min(pos, S - 1)`) or a sliding-window ring of width S
  (written at `pos % S`). The reference computes it in jnp, outside any
  Pallas kernel, and so does the port, in PyTorch ops: every product
  accumulates in float32 (the reference's `preferred_element_type`).
  The new row is written into the cache in place, so a step moves one
  row, not the cache. `pos` is a 0-dim integer tensor on the cache's
  device, and nothing here reads it on the host.

A mesh is anything `sharding.model_axis.model_axis` reads. Without a
`model` axis, or with one of size 1, decode runs the local path, as the
reference's does. Over a model axis of n ranks the cache's sequence dim
is cut into n blocks of S/n slots (`cache_seq`): only the rank that
owns the new row's slot writes it, each rank's `_decode_core` gives a
partial (m, l, o) over its slots, and they are merged by an all-reduce
MAX of m and an all-reduce SUM of (o, l) times exp(m - max), the
reference's flash-decode (`attention.py:336`, `:390`).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention as _fa
from repro_torch.sharding.model_axis import (all_reduce_max, all_reduce_sum,
                                             copy_to, gather_from,
                                             model_axis, scatter_to)

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_chunk: int = 512, kv_chunk: int = 1024,
                    q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention. q [B,T,KV,G,D]; k,v [B,S,KV,D] ->
    [B,T,KV,G,D] in q's dtype."""
    B, T, KV, G, D = q.shape
    out = _fa(q.reshape(B, T, KV * G, D).contiguous(), k.contiguous(),
              v.contiguous(), causal=causal, window=window,
              q_offset=q_offset, bwd_chunk=min(q_chunk, T))
    return out.reshape(B, T, KV, G, D)


def seq_sharded_flash_attention(q, k, v, *, causal: bool = True,
                                window: Optional[int] = None,
                                q_chunk: int = 512, kv_chunk: int = 1024,
                                q_offset: int = 0, mesh=None) -> torch.Tensor:
    """The sequence-parallel core of the reference (`attention.py:250`):
    over a model axis of n ranks, rank i attends queries [i T/n,
    (i+1) T/n) at `q_offset + i T/n` to the whole (replicated) K and V,
    and the outputs are all-gathered on the sequence axis. The
    gradients follow the same split: each rank's query block takes its
    own rows' gradient, and K's and V's are summed over the ranks. Falls
    back to `flash_attention` where the reference does."""
    ax = model_axis(mesh)
    T = q.shape[1]
    n = ax.size
    if n <= 1 or T % n or T < 4 * q_chunk or not causal or window:
        return flash_attention(q, k, v, causal=causal, window=window,
                               q_chunk=q_chunk, kv_chunk=kv_chunk,
                               q_offset=q_offset)
    t_loc = T // n
    out = flash_attention(scatter_to(q, ax, 1), copy_to(k, ax),
                          copy_to(v, ax), causal=True, window=None,
                          q_chunk=min(q_chunk, t_loc), kv_chunk=kv_chunk,
                          q_offset=q_offset + ax.rank * t_loc)
    return gather_from(out, ax, 1)


# ---------------------------------------------------------------------------
# decode (single new token, KV cache)
# ---------------------------------------------------------------------------

def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a [N, M, K] @ b [N, K, P] -> [N, M, P] in float32, accumulated in
    float32 and never rounded to the inputs' dtype. b may be a strided
    view (a head's rows of a cache) and is read in place on CUDA; on the
    CPU low-precision operands are widened first, which gives the same
    exact products."""
    if a.dtype == b.dtype == torch.float32:
        return torch.bmm(a, b)
    if a.device.type == "cuda":
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), b.to(torch.float32))


def _decode_core(q, ck, cv, valid, over: Optional[str] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q [B,KV,G,D]; ck/cv [B,S,KV,D]; valid [B,S] -> partial (m, l, o):
    the row maxima and sums of the masked scores [B,KV,G] and the
    unnormalised output [B,KV,G,D], all float32.

    No [B, KV, G, S] score tensor and no copy of the cache is made: the
    scores are batched products against strided views of the cache, one
    KV head at a time over the rows (head k of ck is [B, S, D] with row
    stride KV*D), or one row at a time over the heads where the rows are
    fewer (row b of ck, [S, KV, D], read as [KV, D, S]): `over` "heads"
    or "rows", by default whichever loop is shorter (zamba2's step at 8
    rows and 32 KV heads is faster over the rows: PERF.md, measured by
    `tests/torch_chip_probes.py decode-loops`). The probabilities are
    cast to the cache's dtype before the PV product, as the reference's
    are."""
    B, KV, G, D = q.shape
    scale = 1.0 / (D ** 0.5)
    if over is None:
        over = "heads" if KV <= B else "rows"
    if over == "heads":     # batch over the rows
        parts = [(q[:, k], ck[:, :, k].transpose(1, 2), cv[:, :, k],
                  valid[:, None, :]) for k in range(KV)]
        dim = 1
    else:                   # batch over the heads
        parts = [(q[b], ck[b].permute(1, 2, 0), cv[b].transpose(0, 1),
                  valid[b][None, None, :]) for b in range(B)]
        dim = 0
    ms, ls, os_ = [], [], []
    for qx, kt, vx, ok in parts:
        s = _bmm_f32(qx, kt) * scale                  # [N, G, S]
        s.masked_fill_(~ok, NEG_INF)
        m = s.amax(dim=-1)
        p = s.sub_(m[..., None]).exp_()
        ms.append(m)
        ls.append(p.sum(dim=-1))
        os_.append(_bmm_f32(p.to(vx.dtype), vx))       # [N, G, D]
    return (torch.stack(ms, dim), torch.stack(ls, dim),
            torch.stack(os_, dim))


def _append(cache: torch.Tensor, new: torch.Tensor, idx: torch.Tensor,
            owner: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Write `new` [B,KV,D] at sequence index `idx` (a 0-dim integer
    tensor on the cache's device) of `cache` [B,S,KV,D], in place (one
    row moved, not the cache); returns `cache`. With `owner` (a 0-dim
    bool tensor) the row is written only where it is true, and the old
    row is written back elsewhere: the reference's masked append into
    a sequence-sharded cache, with no host sync."""
    idx = idx.reshape(1).long()        # pos may be int32, as the reference's
    new = new[:, None].to(cache.dtype)
    if owner is not None:
        new = torch.where(owner, new, cache.index_select(1, idx))
    return cache.index_copy_(1, idx, new)


def _valid_slots(pos: torch.Tensor, S: int, window: Optional[int],
                 off: int = 0, n: Optional[int] = None):
    """Validity of the cache's slots off .. off + n - 1 (all S by
    default) after the token at `pos` was written: the full cache holds
    positions 0..pos, the ring its last min(window, pos + 1) entries."""
    slots = off + torch.arange(S if n is None else n, device=pos.device)
    if window is None:
        return slots <= pos
    age = torch.remainder(pos - slots, S)
    return ((pos - age) >= 0) & (age < torch.clamp_max(pos + 1, window))


def _merge(m, l, o, ax, dtype) -> torch.Tensor:
    """The ranks' partial (m, l, o) merged: m by an all-reduce MAX, then
    l and o, each times exp(m - max), by one all-reduce SUM."""
    corr = torch.exp(m - all_reduce_max(m, ax))
    lo = all_reduce_sum(torch.cat([o * corr[..., None],
                                   (l * corr)[..., None]], dim=-1), ax)
    return (lo[..., :-1] / torch.clamp_min(lo[..., -1:], 1e-37)).to(dtype)


def decode_attention_local(q, cache_k, cache_v, k_new, v_new, pos, *,
                           window: Optional[int] = None):
    """Single-device decode attention. q [B,KV,G,D]; cache [B,S,KV,D];
    k_new/v_new [B,KV,D]; pos: the 0-dim integer tensor of tokens so far.
    Returns (out [B,KV,G,D] in q's dtype, cache_k, cache_v), the caches
    being the inputs with the new row written in place."""
    S = cache_k.shape[1]
    idx = torch.clamp_max(pos, S - 1) if window is None \
        else torch.remainder(pos, S)                # ring of width S
    ck = _append(cache_k, k_new, idx)
    cv = _append(cache_v, v_new, idx)
    valid = _valid_slots(pos, S, window)
    valid = valid[None].expand(q.shape[0], S)
    m, l, o = _decode_core(q, ck, cv, valid)
    out = o / torch.clamp_min(l[..., None], 1e-37)
    return out.to(q.dtype), ck, cv


def decode_attention(mesh, q, cache_k, cache_v, k_new, v_new, pos, *,
                     window: Optional[int] = None):
    """Flash-decode over a cache whose sequence dim is cut over the model
    axis (the reference's `attention.py:336`): q, k_new, v_new whole on
    every rank, cache_k/cache_v this rank's [B, S/n, KV, D] block of the
    S slots. The owner of the slot the new row goes to (`min(pos, S-1)`,
    or `pos % S` on the ring) writes it at its local index; the ranks'
    partial softmax statistics are merged (`_merge`). With no model
    axis larger than 1 it is `decode_attention_local`."""
    ax = model_axis(mesh)
    if ax.size == 1:
        return decode_attention_local(q, cache_k, cache_v, k_new, v_new,
                                      pos, window=window)
    s_loc = cache_k.shape[1]
    S, off = s_loc * ax.size, ax.rank * s_loc
    gidx = torch.clamp_max(pos, S - 1) if window is None \
        else torch.remainder(pos, S)
    owner = (gidx >= off) & (gidx < off + s_loc)
    lidx = torch.clamp(gidx - off, 0, s_loc - 1)
    ck = _append(cache_k, k_new, lidx, owner)
    cv = _append(cache_v, v_new, lidx, owner)
    valid = _valid_slots(pos, S, window, off, s_loc)
    valid = valid[None].expand(q.shape[0], s_loc)
    m, l, o = _decode_core(q, ck, cv, valid)
    return _merge(m, l, o, ax, q.dtype), ck, cv


def decode_cross_attention(mesh, q, cache_k, cache_v) -> torch.Tensor:
    """Cross-attention decode: q [B,KV,G,D] onto the static K/V
    [B,S_src,KV,D] of the source memory (no append, every slot valid);
    over a model axis each rank holds S_src/n of the slots and the
    partial statistics are merged (the reference's `attention.py:390`)."""
    ax = model_axis(mesh)
    valid = torch.ones((q.shape[0], cache_k.shape[1]), dtype=torch.bool,
                       device=q.device)
    m, l, o = _decode_core(q, cache_k, cache_v, valid)
    if ax.size == 1:
        return (o / torch.clamp_min(l[..., None], 1e-37)).to(q.dtype)
    return _merge(m, l, o, ax, q.dtype)
