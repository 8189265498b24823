"""Sub-block implementations for the unified decoder engine.

Port of the attention and MLP parts of `repro/models/blocks.py`:
`<kind>_decl(cfg, tp)` gives the parameter declarations and
`<kind>_apply(p, x, ...)` the training/prefill forward (residual
included). On one device every sharding constraint is a no-op and the
TP mode is always "head" (`sharding/policy.py`); the "row" mode and the
sequence-sharded core need a model mesh axis and raise. MoE, Mamba,
mLSTM, sLSTM and every `*_decode` come with later slices.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as att
from repro_torch.models import layers as L
from repro_torch.models.module import declare


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


def _qkv(p, cfg: ModelConfig, x, src, positions, tp: str, cross: bool):
    """Project + norm + rope. Returns q [B,T,H,Dh], k/v [B,S,KV,Dh]."""
    kv_in = src if cross else x
    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", kv_in, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", kv_in, p["wv"].to(x.dtype))
    if "q_norm" in p:
        q = L.rmsnorm(p["q_norm"], q)
        k = L.rmsnorm(p["k_norm"], k)
    if not cross and positions is not None:
        q = L.rope(q, positions, cfg.rope_theta)
        k = L.rope(k, positions, cfg.rope_theta)
    return q, k, v


def attn_apply(p, x, cfg: ModelConfig, *, tp: str, kind: str = "attn",
               src=None, positions=None, causal: bool = True,
               seq_shard: bool = False):
    if tp != "head":
        raise NotImplementedError(
            f"attention tp mode {tp!r} needs a model mesh axis; on one "
            f"device the mode is 'head' (ROADMAP queue 1: row-TP attention)")
    if seq_shard:
        att.seq_sharded_flash_attention()      # raises: needs a mesh axis
    cross = kind == "cross"
    h = L.rmsnorm(p["ln"], x)
    hsrc = src if cross else None
    q, k, v = _qkv(p, cfg, h, hsrc, positions, tp, cross)
    B, T, H, Dh = q.shape
    KV = k.shape[2]
    window = cfg.window if kind == "attn_swa" else None
    # the reference repeats K and V to H heads (each shard then holds
    # its heads' copy); on one device the kernel reads KV head h // G in
    # place instead, which computes the same attention
    qg = q.reshape(B, T, KV, H // KV, Dh)
    out = att.flash_attention(qg, k, v, causal=causal and not cross,
                              window=window, q_chunk=cfg.attn_chunk)
    out = out.reshape(B, T, H, Dh)
    y = torch.einsum("bthk,hkd->btd", out, p["wo"].to(x.dtype))
    return x + y


# ===========================================================================
# MLP
# ===========================================================================

def mlp_decl(cfg: ModelConfig, tp: str):
    return {"ln": L.rmsnorm_decl(cfg.d_model),
            "mlp": L.mlp_decl(cfg.d_model, cfg.d_ff,
                              gated=cfg.act == "silu")}


def mlp_apply(p, x, cfg: ModelConfig, **_):
    return x + L.mlp(p["mlp"], L.rmsnorm(p["ln"], x), act=cfg.act)
