"""Unified decoder-LM engine.

Port of the training/prefill part of `repro/models/engine.py`. A model
is embedding -> [super-block `cfg.pattern`, n_rep times] -> norm ->
unembed. Params layout, as the reference's:

  {"embed": {"table"}, "blocks": [tree_0, ..., tree_{P-1}] (each leaf
   stacked [n_rep, ...]), "shared": {i: tree} (weight-tied positions),
   "final_norm": {"scale"}, "lm_head": {"w"}}

The reference scans the stacked blocks with `lax.scan`; here a Python
loop indexes repetition r of every leaf. `cfg.remat` wraps each
sub-block in `torch.utils.checkpoint` (non-reentrant), as the reference
wraps it in `jax.checkpoint`. `llm_params_from_jax` carries the
reference's parameters across. The weight-tied "shared" trees (zamba2)
are used by every repetition, so their gradients sum over the uses. The
encoder, the vlm projector, the MoE and xLSTM sub-blocks and decoding
come with later slices and raise.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.module import Declared, tree_map
from repro_torch.sharding.policy import pad_vocab

_DECLS = {
    "attn": lambda cfg, tp: B.attn_decl(cfg, tp),
    "attn_swa": lambda cfg, tp: B.attn_decl(cfg, tp),
    "cross": lambda cfg, tp: B.attn_decl(cfg, tp, cross=True),
    "mlp": B.mlp_decl,
    "mamba": B.mamba_decl,
}


def _ported(kind: str, table):
    if kind not in table:
        raise NotImplementedError(
            f"sub-block kind {kind!r} is not ported yet (ROADMAP queue 1 "
            f"item 9: moe, mlstm and slstm)")
    return table[kind]


def _stack_decl(tree, n: int):
    return tree_map(
        lambda d: Declared((n,) + d.shape, ("layers",) + d.axes, d.init,
                           d.scale, d.dtype), tree)


def effective_kind(kind: str, force_swa: bool) -> str:
    if force_swa and kind == "attn":
        return "attn_swa"
    return kind


# ---------------------------------------------------------------------------
# declarations
# ---------------------------------------------------------------------------

def model_decl(cfg: ModelConfig, tp: str) -> Dict[str, Any]:
    if cfg.family == "vlm" or cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: the vlm projector and the encoder are not ported "
            f"yet (ROADMAP queue 1 item 9)")
    V = pad_vocab(cfg.vocab_size)
    dt = cfg.pdtype
    blocks = []
    shared = {}
    for i, kind in enumerate(cfg.pattern):
        tree = _ported(kind, _DECLS)(cfg, tp)
        if cfg.shared_attn and kind in ("attn", "mlp") and \
                cfg.family == "hybrid":
            shared[str(i)] = tree              # declared once, weight-tied
            blocks.append({})
        else:
            blocks.append(_stack_decl(tree, cfg.n_rep))
    decl: Dict[str, Any] = {
        "embed": L.embed_decl(V, cfg.d_model),
        "blocks": list(blocks),
        "shared": shared,
        "final_norm": L.rmsnorm_decl(cfg.d_model),
    }
    if not cfg.tie_embeddings:
        decl["lm_head"] = L.unembed_decl(V, cfg.d_model)
    return tree_map(
        lambda d: Declared(d.shape, d.axes, d.init, d.scale, dt)
        if d.dtype == torch.float32 and d.init in ("scaled", "normal")
        else d, decl)


def llm_params_from_jax(tree, device=None):
    """The reference's parameter tree (`repro.models.engine`, as numpy
    arrays: dicts and lists) as the port's, on `device` (CUDA unless
    named), keeping every leaf's dtype. numpy has no bfloat16 of its
    own: a bfloat16 leaf is read through an exact float32 view and cast
    back."""
    device = resolve_device(device)

    def leaf(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)
    return tree_map(leaf, tree)


# ---------------------------------------------------------------------------
# source memory
# ---------------------------------------------------------------------------

def source_memory(params, cfg: ModelConfig, src: Optional[torch.Tensor],
                  tp: str) -> Optional[torch.Tensor]:
    if src is None:
        return None
    if cfg.family == "vlm" or cfg.encoder_layers:
        raise NotImplementedError(
            f"{cfg.name}: the vlm projector and the encoder are not ported "
            f"yet (ROADMAP queue 1 item 9)")
    return src.to(cfg.dtype)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

_APPLY = {
    "attn": functools.partial(B.attn_apply, kind="attn"),
    "attn_swa": functools.partial(B.attn_apply, kind="attn_swa"),
    "cross": functools.partial(B.attn_apply, kind="cross"),
    "mlp": B.mlp_apply,
    "mamba": B.mamba_apply,
}


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *, tp: str,
            src: Optional[torch.Tensor] = None,
            last_logit_only: bool = False,
            seq_shard: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,T] -> (logits [B,T,V] f32, aux scalar).

    last_logit_only: unembed just the final position (serving prefill)."""
    Bsz, T = tokens.shape
    x = L.embed(params["embed"], tokens).to(cfg.dtype)
    memory = source_memory(params, cfg, src, tp)
    positions = L.rope_positions(T, device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def apply_one(kind, p, x):
        fn = _ported(kind, _APPLY)
        kw = {}
        if kind in ("attn", "attn_swa", "cross"):
            kw = dict(tp=tp, positions=None if kind == "cross" else positions,
                      src=memory if kind == "cross" else None,
                      seq_shard=seq_shard and kind != "cross")

        def call(p, x):
            return fn(p, x, cfg, **kw)

        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(call, p, x, use_reentrant=False)
        return call(p, x)

    for r in range(cfg.n_rep):
        for i, kind in enumerate(cfg.pattern):
            p = params["shared"].get(str(i)) or tree_map(
                lambda a: a[r], params["blocks"][i])
            x = apply_one(kind, p, x)
    x = L.rmsnorm(params["final_norm"], x)
    if last_logit_only:
        x = x[:, -1:]
    if cfg.tie_embeddings:
        logits = L.unembed_tied(params["embed"], x)
    else:
        logits = L.unembed(params["lm_head"], x)
    return logits, aux
