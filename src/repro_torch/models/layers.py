"""Shared layer primitives: norms, RoPE, embeddings, MLPs, the loss.

Port of `repro/models/layers.py`. Every `*_decl` returns a tree of
`Declared` leaves in the reference's layout; every apply function is a
plain function over materialized params, with the reference's dtype
rules: norms and RoPE compute in float32 and return the input's dtype,
and logits come out in float32.

Over a model mesh axis (`mesh`: anything `sharding.model_axis.model_axis`
reads; None is one device) each rank holds its block of the parameters
(`model_axis.shard_params`): the embedding and the LM head by vocab
rows, the MLP's `w_gate`/`w_up` by columns and `w_down` by rows. The
embedding is a masked lookup of the local rows summed over the axis, the
LM head gives this rank's vocab logits (`gather_logits` joins them), the
loss runs vocab-parallel, the MLP sums its partial outputs, and
`rmsnorm(..., mesh=)` normalises a dim split over the ranks (Mamba2's
and the mLSTM's `out_norm` over d_inner).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.module import declare
from repro_torch.sharding.model_axis import (all_reduce_max, copy_to,
                                             gather_from, model_axis,
                                             reduce_from)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_decl(dim: int, axis: str = "embed"):
    return {"scale": declare((dim,), (axis,), init="ones")}


def rmsnorm(p, x: torch.Tensor, eps: float = 1e-6,
            mesh=None) -> torch.Tensor:
    """RMS norm over the last dim. Over a model axis (`mesh`) `x` and
    `p["scale"]` are this rank's block of a dim split over the ranks:
    each rank sums its block's squares in float32, the sums are reduced
    and divided by the whole width (n blocks). The reduced sum is
    replicated and then enters split work, so it passes `copy_to` as
    well: its gradient is summed over the ranks too."""
    ax = model_axis(mesh)
    dt = x.dtype
    x = x.to(torch.float32)
    if ax.size == 1:
        var = torch.mean(x * x, dim=-1, keepdim=True)
    else:
        ss = torch.sum(x * x, dim=-1, keepdim=True)
        var = copy_to(reduce_from(ss, ax), ax) / (x.shape[-1] * ax.size)
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


def embed(p, tokens: torch.Tensor, mesh=None) -> torch.Tensor:
    """The rows of `tokens`; over a model axis each rank looks up the
    tokens among its vocab rows (zeros for the others) and the ranks'
    rows are summed."""
    ax = model_axis(mesh)
    if ax.size == 1:
        return F.embedding(tokens.long(), p["table"])
    rows = p["table"].shape[0]
    t = tokens.long() - ax.rank * rows
    own = (t >= 0) & (t < rows)
    e = F.embedding(torch.where(own, t, 0), p["table"])
    return reduce_from(torch.where(own[..., None], e, 0), ax)


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


def unembed(p, x: torch.Tensor, mesh=None) -> torch.Tensor:
    """Logits of this rank's vocab columns (all of them on one device)."""
    return matmul_f32(copy_to(x, model_axis(mesh)), p["w"])


def unembed_tied(embed_params, x: torch.Tensor, mesh=None) -> torch.Tensor:
    return matmul_f32(copy_to(x, model_axis(mesh)),
                      embed_params["table"].T)


def gather_logits(logits: torch.Tensor, mesh=None) -> torch.Tensor:
    """The whole vocab's logits from each rank's columns."""
    return gather_from(logits, model_axis(mesh), -1)


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


def mlp(p, x: torch.Tensor, act: str = "silu", mesh=None) -> torch.Tensor:
    ax = model_axis(mesh)
    x = copy_to(x, ax)
    up = x @ p["w_up"]
    if "w_gate" in p:
        up = _act(act, x @ p["w_gate"]) * up
    else:
        up = _act(act, up)
    return reduce_from(up @ p["w_down"], ax)


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
                          mask: Optional[torch.Tensor] = None,
                          mesh=None) -> torch.Tensor:
    """logits [..., V] (f32), labels int [...]. Mean over unmasked tokens.
    Over a model axis `logits` are this rank's vocab columns: the
    maximum, the sum of exponentials and the target's logit are each
    reduced over the axis."""
    ax = model_axis(mesh)
    logits = logits.to(torch.float32)
    if ax.size == 1:
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    else:
        cols = logits.shape[-1]
        m = all_reduce_max(logits.amax(dim=-1), ax)
        lse = m + torch.log(reduce_from(
            torch.exp(logits - m[..., None]).sum(dim=-1), ax))
        t = labels.long() - ax.rank * cols
        own = (t >= 0) & (t < cols)
        ll = torch.gather(logits, -1, torch.where(own, t, 0)[..., None])
        ll = reduce_from(torch.where(own, ll[..., 0], 0.0), ax)
    nll = lse - ll
    if mask is not None:
        return (nll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return nll.mean()
