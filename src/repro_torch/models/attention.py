"""Attention cores.

Port of the training/prefill path of `repro/models/attention.py`:
`flash_attention` over the reference's GQA-grouped layout,
q [B, T, KV, G, D] and k, v [B, S, KV, D] (no materialized KV-head
repeat). It runs through `kernels/flash_attention`: for CUDA tensors
the forward is the hand-written CUDA kernel, for CPU tensors its plain
PyTorch version, and in both cases the backward is the chunked flash
backward in PyTorch ops (the reference differentiates its jnp attention
with autodiff; it has no backward kernel).

The reference's `q_chunk`/`kv_chunk` are tile sizes of its jnp scans.
Here the kernel picks its own tiles; `q_chunk` sets the backward's
query-row chunk and `kv_chunk` is accepted for the same call signature.
Decode attention and the sequence-sharded core raise (ROADMAP queue 1
item 9: decode and caches, row-TP attention).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention as _fa


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


def seq_sharded_flash_attention(*args, **kwargs):
    raise NotImplementedError(
        "seq_sharded_flash_attention (row-TP sequence-parallel core) is "
        "not ported yet: it needs a model mesh axis (ROADMAP queue 1 "
        "item 9: row-TP attention)")


def decode_attention(*args, **kwargs):
    raise NotImplementedError(
        "decode attention is not ported yet (ROADMAP queue 1 item 9: "
        "decode and caches)")
