"""Shared layer primitives: norms, RoPE, embeddings, MLPs, the loss.

Port of `repro/models/layers.py`. Every `*_decl` returns a tree of
`Declared` leaves in the reference's layout; every apply function is a
plain function over materialized params, with the reference's dtype
rules: norms and RoPE compute in float32 and return the input's dtype,
and logits come out in float32.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.module import declare


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_decl(dim: int, axis: str = "embed"):
    return {"scale": declare((dim,), (axis,), init="ones")}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + p["scale"].to(torch.float32))).to(dt)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x [B, T, H..., D] with T at axis 1; positions [T] (or a scalar)."""
    d = x.shape[-1]
    half = d // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    pos = torch.as_tensor(positions, device=x.device).to(torch.float32)
    ang = pos[..., None] * freq  # [T, half] or [half]
    cos, sin = torch.cos(ang), torch.sin(ang)
    # align: T (if present) sits at x axis 1; trailing dim is `half`;
    # every other axis broadcasts.
    shape = [1] * x.ndim
    shape[-1] = half
    if pos.ndim > 0:
        shape[1] = pos.shape[0]
    cos = cos.reshape(shape)
    sin = sin.reshape(shape)
    x1, x2 = x[..., :half], x[..., half: 2 * half]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    out = torch.cat([y1, y2, x[..., 2 * half:].to(y1.dtype)], dim=-1)
    return out.to(x.dtype)


def rope_positions(t: int, offset: int = 0, device=None) -> torch.Tensor:
    return offset + torch.arange(t, device=device)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed_decl(vocab: int, dim: int):
    return {"table": declare((vocab, dim), ("vocab", "embed"),
                             init="normal", scale=0.02)}


def embed(p, tokens: torch.Tensor) -> torch.Tensor:
    return F.embedding(tokens.long(), p["table"])


def unembed_decl(vocab: int, dim: int):
    return {"w": declare((dim, vocab), ("embed", "vocab"))}


class _MatmulF32(torch.autograd.Function):
    """x [N, d] @ w [d, V] with float32 output from low-precision inputs
    (the reference's `preferred_element_type=float32`): float32
    accumulation, and the logits are not rounded to the inputs' dtype.
    The backward is the reference's transpose: both products take the
    float32 gradient and the inputs widened to float32, and only their
    results are rounded to the inputs' dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cuda":
            return torch.mm(x, w, out_dtype=torch.float32)
        return torch.mm(x.to(torch.float32), w.to(torch.float32))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(torch.float32)
        return ((g @ w.to(torch.float32).T).to(x.dtype),
                (x.to(torch.float32).T @ g).to(w.dtype))


def matmul_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [..., d] @ w [d, V] -> [..., V] in float32."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    if x.dtype == torch.float32 and w.dtype == torch.float32:
        out = x2 @ w
    else:
        out = _MatmulF32.apply(x2, w)
    return out.reshape(*lead, w.shape[-1])


def unembed(p, x: torch.Tensor) -> torch.Tensor:
    return matmul_f32(x, p["w"])


def unembed_tied(embed_params, x: torch.Tensor) -> torch.Tensor:
    return matmul_f32(x, embed_params["table"].T)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_decl(dim: int, ff: int, gated: bool = True):
    d = {"w_up": declare((dim, ff), ("embed", "mlp")),
         "w_down": declare((ff, dim), ("mlp", "embed"))}
    if gated:
        d["w_gate"] = declare((dim, ff), ("embed", "mlp"))
    return d


def _act(name: str, x):
    if name == "silu":
        return F.silu(x)
    if name == "gelu":   # jax.nn.gelu's default: the tanh approximation
        return F.gelu(x, approximate="tanh")
    if name == "relu":
        return F.relu(x)
    raise ValueError(name)


def mlp(p, x: torch.Tensor, act: str = "silu") -> torch.Tensor:
    up = x @ p["w_up"]
    if "w_gate" in p:
        up = _act(act, x @ p["w_gate"]) * up
    else:
        up = _act(act, up)
    return up @ p["w_down"]


def linear_decl(d_in: int, d_out: int, axes=("embed", "out"), bias=False):
    d = {"w": declare((d_in, d_out), axes)}
    if bias:
        d["b"] = declare((d_out,), (axes[1],), init="zeros")
    return d


def linear(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """logits [..., V] (f32), labels int [...]. Mean over unmasked tokens."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
