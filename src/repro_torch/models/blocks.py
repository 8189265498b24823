"""Sub-block implementations for the unified decoder engine.

Port of the attention, MLP and Mamba2 parts of `repro/models/blocks.py`:
`<kind>_decl(cfg, tp)` gives the parameter declarations and
`<kind>_apply(p, x, ...)` the training/prefill forward (residual
included). On one device every sharding constraint is a no-op and the
TP mode is always "head" (`sharding/policy.py`); the "row" mode and the
sequence-sharded core need a model mesh axis and raise. MoE, mLSTM,
sLSTM, the decode caches and every `*_decode` come with later slices.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssd_scan.ops import ssd_scan
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
    place."""
    T = xh.shape[1]
    chunk = min(chunk, T)
    assert T % chunk == 0, (T, chunk)
    return ssd_scan(xh.contiguous(), bmat.contiguous(), cmat.contiguous(),
                    log_a.contiguous(), chunk, state0)


def _softplus(x):
    """jax.nn.softplus: logaddexp(x, 0), with no linear cut-off above a
    threshold (torch's softplus has one at 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _mamba_proj(p, x, cfg: ModelConfig):
    h = L.rmsnorm(p["ln"], x)
    xi = torch.einsum("...d,di->...i", h, p["w_x"].to(x.dtype))
    z = torch.einsum("...d,di->...i", h, p["w_z"].to(x.dtype))
    bc = torch.einsum("...d,dn->...n", h, p["w_bc"].to(x.dtype))
    dt = _softplus(
        torch.einsum("...d,dh->...h", h, p["w_dt"].to(x.dtype))
        + p["dt_bias"].to(x.dtype))
    return xi, z, bc, dt


def mamba_apply(p, x, cfg: ModelConfig, **_):
    B, T, d = x.shape
    H, Pd, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    xi, z, bc, dt = _mamba_proj(p, x, cfg)
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
    y = y.reshape(B, T, cfg.d_inner)
    y = L.rmsnorm(p["out_norm"], y * F.silu(z))
    return x + torch.einsum("...i,id->...d", y, p["w_out"].to(x.dtype))


def mamba_cache_decl(*args, **kwargs):
    raise NotImplementedError(
        "mamba_cache_decl: Mamba decode caches are not ported yet (ROADMAP "
        "queue 1 item 9: decode and caches)")


def mamba_decode(*args, **kwargs):
    raise NotImplementedError(
        "mamba_decode: Mamba decode is not ported yet (ROADMAP queue 1 "
        "item 9: decode and caches)")
