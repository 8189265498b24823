"""LaneGCN-lite: the trajectory-prediction model of the Argoverse-style task.

Port of `repro/models/lanegcn.py`. It mirrors the paper's LaneGCN
structure at reduced scale:
  * ActorNet: 1-D CNN with residuals over the 2 s history.
  * MapNet: graph convolution over the lane nodes (adjacency given).
  * FusionNet: actor -> map attention.
  * Header: regresses the 3 s future at 10 Hz (30 x 2 offsets).

Metric: ADE (average displacement error), as in the paper's Fig. 12.

Parameters are a flat dict of tensors keyed by the reference tree's path
("actor.c1.w", "map.g1.b", ...), the layout `run_fl`'s per-client
gradients and FedAvg take. Linear weights keep the reference's [in, out]
layout; convolution weights are [cout, cin, k], PyTorch's, from the
reference's [k, cin, cout] (WIO). Both sides compute a cross-correlation
with "SAME" padding (k = 3, one zero on each side).
"""
from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.module import declare, materialize

HIST, FUT = 20, 30  # 2 s history, 3 s future at 10 Hz
D = 64

Params = Dict[str, torch.Tensor]


def _lin(cin, cout):
    return {"w": declare((cin, cout), (None, None), init="scaled"),
            "b": declare((cout,), (None,), init="zeros")}


def _conv1d_decl(cin, cout, k=3):
    return {"w": declare((k, cin, cout), (None, None, None), init="scaled"),
            "b": declare((cout,), (None,), init="zeros")}


def lanegcn_decl(num_map_nodes: int = 64):
    """The parameter declarations, in the reference's layout."""
    return {
        "actor": {
            "c1": _conv1d_decl(2, D), "c2": _conv1d_decl(D, D),
            "c3": _conv1d_decl(D, D),
        },
        "map": {
            "in": _lin(4, D), "g1": _lin(D, D), "g2": _lin(D, D),
        },
        "fusion": {
            "q": _lin(D, D), "k": _lin(D, D), "v": _lin(D, D),
            "o": _lin(D, D),
        },
        "head": _lin(D, FUT * 2),
    }


def lanegcn_params_from_jax(tree) -> Params:
    """The reference's LaneGCN parameter tree (arrays or tensors) as the
    port's flat parameter dict: convolution weights [k, cin, cout] ->
    [cout, cin, k], everything else as it is."""
    def t(x):
        return torch.as_tensor(np.array(x) if not torch.is_tensor(x)
                               else x, dtype=torch.float32)

    out = {}
    for part in ("actor", "map", "fusion"):
        for name, p in tree[part].items():
            w = t(p["w"])
            if part == "actor":
                w = w.permute(2, 1, 0)
            out[f"{part}.{name}.w"] = w.contiguous()
            out[f"{part}.{name}.b"] = t(p["b"])
    out["head.w"] = t(tree["head"]["w"])
    out["head.b"] = t(tree["head"]["b"])
    return out


def init_lanegcn(gen: torch.Generator, num_map_nodes: int = 64) -> Params:
    """Parameters on `gen`'s device with the reference's initialisation
    (fan-in-scaled truncated normals, fan_in = shape[-2], zero biases)."""
    return lanegcn_params_from_jax(materialize(gen,
                                               lanegcn_decl(num_map_nodes)))


def _linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f"{name}.w"] + p[f"{name}.b"]


def _conv1d(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """x [B, T, C] -> [B, T, C'], a "SAME" cross-correlation."""
    y = F.conv1d(x.transpose(1, 2), p[f"{name}.w"], padding=1)
    return y.transpose(1, 2) + p[f"{name}.b"]


def lanegcn_apply(params: Params, batch) -> torch.Tensor:
    """batch: hist [B,HIST,2], map_feats [B,M,4], map_adj [B,M,M].

    Returns predicted future offsets [B,FUT,2].
    """
    hist, mfeat, adj = batch["hist"], batch["map_feats"], batch["map_adj"]
    x = F.relu(_conv1d(params, "actor.c1", hist))
    x = F.relu(_conv1d(params, "actor.c2", x)) + x
    x = F.relu(_conv1d(params, "actor.c3", x)) + x
    actor = x[:, -1]                                   # [B,D]

    h = F.relu(_linear(params, "map.in", mfeat))       # [B,M,D]
    deg = torch.clamp_min(adj.sum(-1, keepdim=True), 1.0)
    h = F.relu(_linear(params, "map.g1", (adj @ h) / deg)) + h
    h = F.relu(_linear(params, "map.g2", (adj @ h) / deg)) + h

    q = _linear(params, "fusion.q", actor)[:, None]    # [B,1,D]
    k = _linear(params, "fusion.k", h)
    v = _linear(params, "fusion.v", h)
    att = torch.softmax((q * k).sum(-1) / math.sqrt(D), dim=-1)  # [B,M]
    fused = torch.einsum("bm,bmd->bd", att, v)
    actor = actor + F.relu(_linear(params, "fusion.o", fused))

    out = _linear(params, "head", actor)
    return out.reshape(-1, FUT, 2)


def lanegcn_loss(params: Params, batch) -> torch.Tensor:
    pred = lanegcn_apply(params, batch)
    return torch.mean(torch.sum((pred - batch["fut"]) ** 2, dim=-1))


def lanegcn_ade(params: Params, batch) -> torch.Tensor:
    pred = lanegcn_apply(params, batch)
    return torch.mean(torch.linalg.vector_norm(pred - batch["fut"], dim=-1))
