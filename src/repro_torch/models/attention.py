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
* `seq_sharded_flash_attention`, the reference's one-device branch:
  `flash_attention` itself.
* Decode: one new token a row against a K/V cache, full (the new row
  written at `min(pos, S - 1)`) or a sliding-window ring of width S
  (written at `pos % S`). The reference computes it in jnp, outside any
  Pallas kernel, and so does the port, in PyTorch ops: every product
  accumulates in float32 (the reference's `preferred_element_type`).
  The new row is written into the cache in place, so a step moves one
  row, not the cache. `pos` is a 0-dim integer tensor on the cache's
  device, and nothing here reads it on the host.

A mesh is `None` or anything `sharding.rules.mesh_shape` reads. Without
a `model` axis, or with one of size 1, decode runs the local path, as
the reference's does; a `model` axis larger than 1 (flash-decode over
a sequence-sharded cache) raises (ROADMAP queue 1 item 9: the model
axis).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention as _fa
from repro_torch.sharding.rules import mesh_shape

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
                                q_offset: int = 0) -> torch.Tensor:
    """The sequence-parallel core of the reference (`attention.py:250`)
    on one device, where it has no `model` axis to shard the queries
    over and falls back to `flash_attention` with the same arguments."""
    return flash_attention(q, k, v, causal=causal, window=window,
                           q_chunk=q_chunk, kv_chunk=kv_chunk,
                           q_offset=q_offset)


# ---------------------------------------------------------------------------
# decode (single new token, KV cache)
# ---------------------------------------------------------------------------

def _model_axis(mesh) -> int:
    return 1 if mesh is None else mesh_shape(mesh).get("model", 1)


def _require_local(mesh, what: str) -> None:
    n = _model_axis(mesh)
    if n > 1:
        raise NotImplementedError(
            f"{what} over a model mesh axis of {n} (flash-decode over a "
            f"sequence-sharded cache) is not ported yet (ROADMAP queue 1 "
            f"item 9: the model axis)")


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


def _append(cache: torch.Tensor, new: torch.Tensor,
            idx: torch.Tensor) -> torch.Tensor:
    """Write `new` [B,KV,D] at sequence index `idx` (a 0-dim integer
    tensor on the cache's device) of `cache` [B,S,KV,D], in place (one
    row moved, not the cache); returns `cache`. The reference's `owner`
    mask serves its sequence-sharded cache, which the port does not
    have."""
    return cache.index_copy_(1, idx.reshape(1), new[:, None].to(cache.dtype))


def _valid_slots(pos: torch.Tensor, S: int, window: Optional[int]):
    """[S] validity of the cache's slots after the token at `pos` was
    written: the full cache holds positions 0..pos, the ring its last
    min(window, pos + 1) entries."""
    slots = torch.arange(S, device=pos.device)
    if window is None:
        return slots <= pos
    age = torch.remainder(pos - slots, S)
    return ((pos - age) >= 0) & (age < torch.clamp_max(pos + 1, window))


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
    """Decode attention over a cache whose sequence dim the reference
    shards over `model` (flash-decode). With no `model` axis larger than
    1 it is `decode_attention_local`, as in the reference."""
    _require_local(mesh, "decode_attention")
    return decode_attention_local(q, cache_k, cache_v, k_new, v_new, pos,
                                  window=window)


def decode_cross_attention(mesh, q, cache_k, cache_v) -> torch.Tensor:
    """Cross-attention decode: q [B,KV,G,D] onto the static K/V
    [B,S_src,KV,D] of the source memory (no append, every slot valid)."""
    _require_local(mesh, "decode_cross_attention")
    valid = torch.ones((q.shape[0], cache_k.shape[1]), dtype=torch.bool,
                       device=q.device)
    m, l, o = _decode_core(q, cache_k, cache_v, valid)
    return (o / torch.clamp_min(l[..., None], 1e-37)).to(q.dtype)
