"""Unified decoder-LM engine.

Port of the training/prefill part of `repro/models/engine.py`. A model
is embedding -> [super-block `cfg.pattern`, n_rep times] -> norm ->
unembed, optionally with an encoder (whisper) or a projector over
source embeddings (vlm) whose output feeds the `cross` sub-blocks.
Params layout, as the reference's:

  {"embed": {"table"}, "blocks": [tree_0, ..., tree_{P-1}] (each leaf
   stacked [n_rep, ...]), "shared": {i: tree} (weight-tied positions),
   "final_norm": {"scale"}, "lm_head": {"w"},
   "encoder": {"blocks", "pos", "final_norm"} | "projector": {"w"}}

The reference scans the stacked blocks with `lax.scan`; here a Python
loop indexes repetition r of every leaf. `cfg.remat` wraps each decoder
sub-block in `torch.utils.checkpoint` (non-reentrant), as the reference
wraps it in `jax.checkpoint`; the encoder is not checkpointed, as the
reference's encoder scan is not. `llm_params_from_jax` carries the
reference's parameters across. The weight-tied "shared" trees (zamba2)
are used by every repetition, so their gradients sum over the uses.
`forward`'s aux is the sum of every MoE sub-block's load-balance loss
over the positions and repetitions, in the reference's order.

Decode, as the reference's: `cache_decl` declares a cache that mirrors
"blocks" (a list with one tree a pattern position, each leaf stacked
[n_rep, ...], an empty dict for the stateless kinds), `zero_cache`
materialises it with zeros on a device, `build_cross_cache` fills the
cross-attention slots from the source memory, and `decode_step` takes
one token a row at position `pos`. The step updates the cache it is
given in place and returns it: the K/V rows are written into the
stacked leaves (no copy of the cache), the recurrent states copied over
their slots.

Over a model mesh axis (`mesh`: a ("data", "model") `DeviceMesh`, or
anything `sharding.model_axis.model_axis` reads) every function takes
this rank's block of the parameters (`model_axis.shard_params(mesh,
params, model_decl(cfg, tp))`) and, for decode, of the cache
(`zero_cache(..., mesh=mesh)`: S/n slots a rank, `cache_seq`). The
logits returned are the whole vocab's (all-gathered), except where
`forward(..., gather_logits=False)` leaves each rank its columns for the
vocab-parallel loss (`layers.softmax_cross_entropy(..., mesh=mesh)`).

Over an FSDP axis as well (`ModelAxis.fsdp`, `sharding/fsdp.py`: the
one-vehicle configs under the reference's `fsdp_rules`) each leaf's
`embed` dim is this rank's block too: a sub-block's weights are gathered
where it runs (inside its checkpointed call, so the backward gathers
them again), the leaves outside the blocks once a call.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.op_costs import loop
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models.module import Declared, declare, tree_map
from repro_torch.sharding import fsdp
from repro_torch.sharding.model_axis import all_reduce_sum, model_axis
from repro_torch.sharding.policy import pad_vocab
from repro_torch.sharding.rules import default_rules

_DECLS = {
    "attn": lambda cfg, tp: B.attn_decl(cfg, tp),
    "attn_swa": lambda cfg, tp: B.attn_decl(cfg, tp),
    "cross": lambda cfg, tp: B.attn_decl(cfg, tp, cross=True),
    "mlp": B.mlp_decl,
    "moe": B.moe_decl,
    "mamba": B.mamba_decl,
    "mlstm": B.mlstm_decl,
    "slstm": B.slstm_decl,
}


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
    V = pad_vocab(cfg.vocab_size)
    dt = cfg.pdtype
    blocks = []
    shared = {}
    for i, kind in enumerate(cfg.pattern):
        tree = _DECLS[kind](cfg, tp)
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
    if cfg.family == "vlm":
        decl["projector"] = L.linear_decl(cfg.src_dim, cfg.d_model,
                                          ("out", "embed"))
    if cfg.encoder_layers:
        enc_blk = {"attn": B.attn_decl(cfg, tp), "mlp": B.mlp_decl(cfg, tp)}
        decl["encoder"] = {
            "blocks": _stack_decl(enc_blk, cfg.encoder_layers),
            "pos": declare((cfg.num_src_tokens, cfg.d_model),
                           ("frames", "embed"), init="normal", scale=0.02),
            "final_norm": L.rmsnorm_decl(cfg.d_model),
        }
    return tree_map(
        lambda d: Declared(d.shape, d.axes, d.init, d.scale, dt)
        if d.dtype == torch.float32 and d.init in ("scaled", "normal")
        else d, decl)


def llm_params_from_jax(tree, device=None):
    """The reference's parameter tree (`repro.models.engine`, as numpy
    arrays: dicts and lists) as the port's, on `device` (CUDA unless
    named), keeping every leaf's dtype. It carries any such tree of
    arrays, the reference's decode caches (`cache_decl` materialised, a
    `decode_step`'s result) included. numpy has no bfloat16 of its own:
    a bfloat16 leaf is read through an exact float32 view and cast
    back."""
    device = resolve_device(device)

    def leaf(x):
        a = np.asarray(x)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(a.astype(np.float32)).to(
                device=device, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a)).to(device)
    return tree_map(leaf, tree)


@functools.lru_cache(maxsize=None)
def fsdp_dims(cfg: ModelConfig, tp: str):
    """`fsdp.embed_dims` of `model_decl(cfg, tp)`: the whole tree's (for
    the gradients), and each stacked block's and the encoder's per
    repetition (for the gathers)."""
    decl = model_decl(cfg, tp)
    whole = fsdp.embed_dims(decl)
    blocks = [fsdp.embed_dims(b, stacked=True) for b in decl["blocks"]]
    enc = fsdp.embed_dims(decl["encoder"]["blocks"], stacked=True) \
        if "encoder" in decl else None
    return whole, blocks, enc


def _top(params, cfg: ModelConfig, tp: str, ax):
    """`params` with its leaves outside the blocks (the embedding, the
    final norm, the LM head, the projector, the encoder's position table
    and norm) gathered over the FSDP axis, if there is one."""
    if ax.fsdp is None:
        return params
    whole = fsdp_dims(cfg, tp)[0]
    out = dict(params)
    for k in ("embed", "final_norm", "lm_head", "projector"):
        if k in params:
            out[k] = fsdp.gather(params[k], whole[k], ax)
    if "encoder" in params:
        enc = whole["encoder"]
        out["encoder"] = dict(
            params["encoder"],
            pos=fsdp.gather(params["encoder"]["pos"], enc["pos"], ax),
            final_norm=fsdp.gather(params["encoder"]["final_norm"],
                                   enc["final_norm"], ax))
    return out


def _block(params, i: int, r: int):
    """Pattern position i's parameters at repetition r (the weight-tied
    tree where it is shared), not yet gathered over an FSDP axis."""
    return params["shared"].get(str(i)) or tree_map(
        lambda a: a[r], params["blocks"][i])


def _gather_block(p, i: int, cfg: ModelConfig, tp: str, ax):
    """`_block`'s tree gathered over the FSDP axis, if there is one."""
    if ax.fsdp is None:
        return p
    whole, blocks, _ = fsdp_dims(cfg, tp)
    dims = whole["shared"][str(i)] if str(i) in whole["shared"] \
        else blocks[i]
    return fsdp.gather(p, dims, ax)


@functools.lru_cache(maxsize=None)
def check_model_axis(cfg: ModelConfig, tp: str, n: int) -> None:
    """Raise a ValueError if a model axis of `n` ranks does not divide a
    dim of `cfg`'s parameters that the default rules split over it
    (heads, mlp: d_ff and d_inner, ssm_heads, row_head_dim: the
    mLSTM's head dim, vocab, experts, row_in, ...), naming each such dim.
    The reference's GSPMD would pad it; the port refuses it, as
    `ModelAxis.block` and `zero_cache` do. The engine's entries, the VFL
    round and `launch/train.py` call it before any work."""
    if n <= 1:
        return
    rules = default_rules()
    bad = {}
    for path, d in _declared(model_decl(cfg, tp)):
        for size, a in zip(d.shape, d.axes):
            if rules.mesh_axis(a) == "model" and size % n:
                bad.setdefault((a, size), path)
    if bad:
        dims = ", ".join(f"{a} of {size} ({path})"
                         for (a, size), path in bad.items())
        raise ValueError(f"{cfg.name}: a model axis of {n} does not divide "
                         f"{dims}; run it over an axis that divides them")


def _declared(tree, prefix=""):
    """(path, Declared) of every leaf of a declaration tree."""
    if isinstance(tree, Declared):
        yield prefix, tree
        return
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        yield from _declared(v, f"{prefix}/{k}" if prefix else str(k))


# ---------------------------------------------------------------------------
# encoder / source memory
# ---------------------------------------------------------------------------

def _encode(params, cfg: ModelConfig, src: torch.Tensor,
            tp: str, mesh=None) -> torch.Tensor:
    """Whisper-style bidirectional encoder over stub frame embeddings:
    no rope, no causal mask, no remat."""
    enc = params["encoder"]
    ax = model_axis(mesh)
    x = src.to(cfg.dtype) + enc["pos"].to(cfg.dtype)[None]
    for r in loop("encoder_layers", cfg.encoder_layers):
        blk = tree_map(lambda a: a[r], enc["blocks"])
        if ax.fsdp is not None:
            blk = fsdp.gather(blk, fsdp_dims(cfg, tp)[2], ax)
        x = B.attn_apply(blk["attn"], x, cfg, tp=tp, kind="attn",
                         causal=False, positions=None, mesh=mesh)
        x = B.mlp_apply(blk["mlp"], x, cfg, mesh=mesh)
    return L.rmsnorm(enc["final_norm"], x)


def source_memory(params, cfg: ModelConfig, src: Optional[torch.Tensor],
                  tp: str, mesh=None) -> Optional[torch.Tensor]:
    """What the `cross` sub-blocks attend to: the projected patches
    (vlm), the encoded frames (audio), or `src` itself."""
    if src is None:
        return None
    if cfg.family == "vlm":
        return L.linear(params["projector"], src.to(cfg.dtype))
    if cfg.encoder_layers:
        return _encode(params, cfg, src, tp, mesh)
    return src.to(cfg.dtype)


def build_cross_cache(cfg: ModelConfig, params, cache, src, tp: str,
                      mesh=None):
    """Populate the cross-attention K/V cache slots from the source memory
    (VLM/audio decode: the encoder runs once, its K/V are static). Each
    repetition's wk/wv project the memory; the results take the cache's
    dtype. Over a model axis each rank projects its block of the source
    slots (row mode: from its d/n columns, the partial sums reduced).
    Returns a new list; the other positions keep their trees."""
    ax = model_axis(mesh)
    params = _top(params, cfg, tp, ax)
    mem = source_memory(params, cfg, src, tp, ax)
    row = ax.size > 1 and tp == "row"
    if ax.seq.size > 1:
        mem = mem.narrow(1, *ax.seq.block(mem.shape[1]))
        if row:
            mem = mem.narrow(2, *ax.block(mem.shape[2]))
    new_cache = list(cache)
    for i, kind in enumerate(cfg.pattern):
        if kind != "cross":
            continue
        bp = params["blocks"][i]
        if ax.fsdp is not None:
            dims = fsdp_dims(cfg, tp)[0]["blocks"][i]
            bp = fsdp.gather({k: bp[k] for k in ("wk", "wv")},
                             {k: dims[k] for k in ("wk", "wv")}, ax)
        ks = torch.einsum("bsd,rdhk->rbshk", mem, bp["wk"].to(mem.dtype))
        vs = torch.einsum("bsd,rdhk->rbshk", mem, bp["wv"].to(mem.dtype))
        if row:
            ks, vs = all_reduce_sum(ks, ax), all_reduce_sum(vs, ax)
        new_cache[i] = {"k": ks.to(cache[i]["k"].dtype),
                        "v": vs.to(cache[i]["v"].dtype)}
    return new_cache


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

_APPLY = {
    "attn": functools.partial(B.attn_apply, kind="attn"),
    "attn_swa": functools.partial(B.attn_apply, kind="attn_swa"),
    "cross": functools.partial(B.attn_apply, kind="cross"),
    "mlp": B.mlp_apply,
    "moe": B.moe_apply,         # returns (x, aux)
    "mamba": B.mamba_apply,
    "mlstm": B.mlstm_apply,
    "slstm": B.slstm_apply,
}


def forward(params, tokens: torch.Tensor, cfg: ModelConfig, *, tp: str,
            src: Optional[torch.Tensor] = None,
            last_logit_only: bool = False,
            seq_shard: bool = False, mesh=None,
            gather_logits: bool = True
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,T] -> (logits [B,T,V] f32, aux scalar).

    last_logit_only: unembed just the final position (serving prefill).
    Over a model axis (`mesh`) `params` are this rank's block; with
    `gather_logits=False` the logits are this rank's vocab columns."""
    ax = model_axis(mesh)
    check_model_axis(cfg, tp, ax.size)
    params = _top(params, cfg, tp, ax)
    Bsz, T = tokens.shape
    x = L.embed(params["embed"], tokens, mesh=ax).to(cfg.dtype)
    memory = source_memory(params, cfg, src, tp, ax)
    positions = L.rope_positions(T, device=tokens.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def apply_one(i, kind, p, x):
        fn = _APPLY[kind]
        kw = dict(mesh=ax)
        if kind in ("attn", "attn_swa", "cross"):
            kw.update(tp=tp,
                      positions=None if kind == "cross" else positions,
                      src=memory if kind == "cross" else None,
                      seq_shard=seq_shard and kind != "cross")

        def call(p, x):
            return fn(_gather_block(p, i, cfg, tp, ax), x, cfg, **kw)

        if cfg.remat and torch.is_grad_enabled():
            return checkpoint(call, p, x, use_reentrant=False)
        return call(p, x)

    for r in loop("layers", cfg.n_rep):
        for i, kind in enumerate(cfg.pattern):
            p = _block(params, i, r)
            if kind == "moe":
                x, a = apply_one(i, kind, p, x)
                aux = aux + a
            else:
                x = apply_one(i, kind, p, x)
    x = L.rmsnorm(params["final_norm"], x)
    if last_logit_only:
        x = x[:, -1:]
    logits = _logits(params, x, cfg, ax)
    if gather_logits:
        logits = L.gather_logits(logits, ax)
    return logits, aux


def _logits(params, x, cfg: ModelConfig, ax):
    """This rank's vocab columns of the LM head's logits."""
    if cfg.tie_embeddings:
        return L.unembed_tied(params["embed"], x, mesh=ax)
    return L.unembed(params["lm_head"], x, mesh=ax)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def cache_decl(cfg: ModelConfig, batch: int, seq_len: int, *,
               force_swa: bool = False):
    dt = cfg.dtype
    out = []
    for kind in cfg.pattern:
        kind = effective_kind(kind, force_swa)
        if kind in ("attn", "attn_swa", "cross"):
            out.append(B.attn_cache_decl(cfg, cfg.n_rep, batch, seq_len,
                                         kind, dt))
        elif kind == "mamba":
            out.append(B.mamba_cache_decl(cfg, cfg.n_rep, batch, dt))
        elif kind == "mlstm":
            out.append(B.mlstm_cache_decl(cfg, cfg.n_rep, batch, dt))
        elif kind == "slstm":
            out.append(B.slstm_cache_decl(cfg, cfg.n_rep, batch, dt))
        else:
            out.append({})
    return out


def zero_cache(decl, device=None, mesh=None):
    """The declared cache, every leaf zeros of its shape and dtype, on
    `device` (CUDA unless named); over a model axis (`mesh`) this rank's
    block of it: each dim whose logical axis maps to the model axis
    (`cache_seq` over `ModelAxis.seq`, the split heads' dims over the
    model axis) cut to 1/n; a dim that n does not divide raises."""
    device = resolve_device(device)
    ax = model_axis(mesh)
    rules = default_rules()

    def local(d):
        return tuple((ax.seq if a == "cache_seq" else ax).block(s)[1]
                     if rules.mesh_axis(a) == "model" else s
                     for s, a in zip(d.shape, d.axes))
    return tree_map(lambda d: torch.zeros(local(d), dtype=d.dtype,
                                          device=device), decl)


_DECODE = {
    "attn": functools.partial(B.attn_decode, kind="attn"),
    "attn_swa": functools.partial(B.attn_decode, kind="attn_swa"),
    "cross": functools.partial(B.attn_decode, kind="cross"),
    "mlp": B.mlp_decode,
    "moe": B.moe_decode,
    "mamba": B.mamba_decode,
    "mlstm": B.mlstm_decode,
    "slstm": B.slstm_decode,
}


def decode_step(params, cache, tokens: torch.Tensor, pos: torch.Tensor,
                cfg: ModelConfig, mesh, *, tp: str,
                force_swa: bool = False) -> Tuple[torch.Tensor, Any]:
    """tokens [B] -> (logits [B,V] f32, cache). pos: the 0-dim integer
    tensor of tokens so far, on the cache's device; it is never read on
    the host, so a step makes no host sync.

    The input cache is updated in place and returned: it holds the
    values of the reference's new cache. Attention writes its new K/V row
    into the stacked leaves; each recurrent state is copied over its
    repetition's slot. Over a model axis `params` and `cache` are this
    rank's blocks and the logits are the whole vocab's."""
    ax = model_axis(mesh)
    check_model_axis(cfg, tp, ax.size)
    params = _top(params, cfg, tp, ax)
    x = L.embed(params["embed"], tokens, mesh=ax).to(cfg.dtype)
    for r in loop("layers", cfg.n_rep):
        for i, kind in enumerate(cfg.pattern):
            ek = effective_kind(kind, force_swa)
            p = _gather_block(_block(params, i, r), i, cfg, tp, ax)
            slot = {k: v[r] for k, v in cache[i].items()}
            kw = dict(tp=tp) if ek in ("attn", "attn_swa", "cross") else {}
            x, new = _DECODE[ek](p, x, slot, pos, cfg, ax, **kw)
            for k, v in new.items():
                if v is not slot[k]:
                    slot[k].copy_(v)
    x = L.rmsnorm(params["final_norm"], x)
    return L.gather_logits(_logits(params, x, cfg, ax), ax), cache
