"""Deterministic synthetic data (offline substitutes).

Port of `cifar_like_dataset`, `partition_labels`, `pad_client_shards_np`,
`pad_client_shards`, `make_trajectory_batch` and `lm_batch` of
`repro/data/synthetic.py`, and `src_lm_batch`, `lm_batch` with the
`src` entry that whisper's and llama-3.2-vision's cross-attention
reads. CIFAR-like: 10-class 32x32x3 images = class prototype plus
noise, so a small CNN genuinely learns. Trajectories: kinematic tracks
with random curvature and speed profile, with lane nodes scattered along the future path (the Argoverse-like task of LaneGCN). LM
batches: token streams that follow a noisy +step pattern, so next-token
prediction has signal. Draws come from `torch.Generator`s, so the data
differ from the reference's for the same seed; `make_trajectory_batch`
and `lm_batch` are split into a draws step and a deterministic step that
the tests feed with the reference's draws. The partition is numpy, the
same as the reference's.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.lanegcn import FUT, HIST


def cifar_like_dataset(gen: torch.Generator, n: int, noise: float = 0.6,
                       proto_seed: int = 42):
    """Returns images [n,32,32,3] (NHWC, float32) and labels [n] (int64)
    on `gen`'s device.

    Class prototypes are drawn from `proto_seed` (not `gen`) so that train
    and test splits share the same class structure.
    """
    device = gen.device
    g_proto = torch.Generator(device=device).manual_seed(proto_seed)
    protos = torch.randn((10, 32, 32, 3), generator=g_proto, device=device)
    labels = torch.randint(0, 10, (n,), generator=gen, device=device)
    imgs = protos[labels] + noise * torch.randn(
        (n, 32, 32, 3), generator=gen, device=device)
    return imgs, labels


def partition_labels(labels: np.ndarray, n_clients: int,
                     iid: bool, classes_per_client: int = 2,
                     seed: int = 0) -> list:
    """Index partition: iid shuffle-split or label-sharded non-iid (the
    paper's non-iid setting: each vehicle holds samples from 2 classes)."""
    rng = np.random.default_rng(seed)
    n = len(labels)
    if iid:
        idx = rng.permutation(n)
        return np.array_split(idx, n_clients)
    # strict label sharding: each client receives `classes_per_client`
    # single-class chunks from distinct classes (the paper's 2-class split)
    classes = np.unique(labels)
    k = len(classes)
    chunks_per_class = max(1, (n_clients * classes_per_client) // k)
    chunks = []  # (class_rank, indices)
    for rank, c in enumerate(classes):
        idx = rng.permutation(np.where(labels == c)[0])
        for part in np.array_split(idx, chunks_per_class):
            chunks.append((rank, part))
    parts = [[] for _ in range(n_clients)]
    # class-major order + a stride of n_clients gives each client chunks
    # from different classes
    for j, (rank, part) in enumerate(chunks):
        parts[j % n_clients].append(part)
    return [np.concatenate(p) if p else np.array([], np.int64)
            for p in parts]


def pad_client_shards_np(client_data) -> Tuple[Dict[str, np.ndarray],
                                               np.ndarray]:
    """Host-side padding: stack ragged per-client dicts of arrays into the
    padded layout as numpy arrays. Every leaf becomes `[C, n_max, ...]`
    and `n_samples [C]` holds the true per-client counts.

    Padding rows are zeros and are never sampled: minibatch indices are
    drawn against the true counts, and aggregation weights use them too,
    so a padded (or empty) client cannot move the global model. Clients
    share one set of keys; a client may be empty (0 samples, or `{}`).
    """
    counts = np.array(
        [int(next(iter(d.values())).shape[0]) if d else 0
         for d in client_data], np.int32)
    n_max = max(int(counts.max(initial=0)), 1)
    # schema from the first non-empty client
    keys = next((list(d.keys()) for d in client_data if d), [])
    data = {}
    for k in keys:
        ref = next(_np(d[k]) for d in client_data if d)
        out = np.zeros((len(client_data), n_max) + ref.shape[1:],
                       ref.dtype)
        for c, d in enumerate(client_data):
            if d:
                a = _np(d[k])
                out[c, :a.shape[0]] = a
        data[k] = out
    return data, counts


def pad_client_shards(client_data, device=None
                      ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """`pad_client_shards_np` as tensors on `device` (the fused engine's
    layout): CUDA unless the caller names another."""
    data, counts = pad_client_shards_np(client_data)
    device = resolve_device(device)
    return ({k: torch.as_tensor(v, device=device) for k, v in data.items()},
            torch.as_tensor(counts, device=device))


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# ---------------------------------------------------------------------------
# Argoverse-like trajectories
# ---------------------------------------------------------------------------

def trajectory_batch_draws(gen: torch.Generator, b: int,
                           num_map_nodes: int = 64
                           ) -> Dict[str, torch.Tensor]:
    """The random draws of `make_trajectory_batch`, on `gen`'s device:
    per track a speed in [3, 15) m/s, an initial heading in [0, 2 pi), a
    turn rate (0.05 N(0, 1) rad a step) and an acceleration (0.05 N(0, 1)),
    and per lane node a lateral offset (2 N(0, 1) m, [b, M, 2])."""
    device = gen.device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand((b, 1), generator=gen,
                                           device=device)

    return {
        "speed": uniform(3.0, 15.0),
        "heading0": uniform(0.0, 2 * math.pi),
        "curls": torch.randn((b, 1), generator=gen, device=device) * 0.05,
        "accel": torch.randn((b, 1), generator=gen, device=device) * 0.05,
        "off": torch.randn((b, num_map_nodes, 2), generator=gen,
                           device=device) * 2.0,
    }


def map_node_index(num_map_nodes: int, device=None) -> torch.Tensor:
    """The future steps the lane nodes are centred on: `num_map_nodes`
    evenly spaced points of [0, FUT - 1] in fp32, truncated (the
    reference's `linspace(...).astype(int32)`)."""
    return torch.linspace(0, FUT - 1, num_map_nodes,
                          device=device).to(torch.int64)


def trajectory_batch_from_draws(draws: Dict[str, torch.Tensor]
                                ) -> Dict[str, torch.Tensor]:
    """The deterministic step: hist [b, 20, 2], fut [b, 30, 2],
    map_feats [b, M, 4] (scaled node positions and directions) and
    map_adj [b, M, M] (1 where two nodes lie within 5 m)."""
    device = draws["speed"].device
    dt = 0.1
    t = torch.arange(HIST + FUT, dtype=torch.float32,
                     device=device)[None, :]
    heading = draws["heading0"] + draws["curls"] * t
    v = torch.clamp_min(draws["speed"] + draws["accel"] * t, 0.5)
    dx = torch.stack([v * torch.cos(heading), v * torch.sin(heading)],
                     -1) * dt
    pos = torch.cumsum(dx, dim=1)
    pos = pos - pos[:, HIST - 1:HIST]              # t = 0 at 0
    hist, fut = pos[:, :HIST], pos[:, HIST:]
    # map: lane nodes sampled along the future path + lateral offsets
    off = draws["off"]
    nodes = fut[:, map_node_index(off.shape[1], device)] + off
    dirs = torch.cat([nodes[:, 1:] - nodes[:, :-1],
                      nodes[:, -1:] - nodes[:, -2:-1]], dim=1)
    map_feats = torch.cat([nodes * 0.05, dirs], dim=-1)
    d2 = torch.sum((nodes[:, :, None] - nodes[:, None]) ** 2, -1)
    adj = (d2 < 25.0).to(torch.float32)
    return {"hist": hist, "fut": fut, "map_feats": map_feats,
            "map_adj": adj}


def make_trajectory_batch(gen: torch.Generator, b: int,
                          num_map_nodes: int = 64
                          ) -> Dict[str, torch.Tensor]:
    """Kinematic trajectories with random curvature and speed profile,
    on `gen`'s device."""
    return trajectory_batch_from_draws(
        trajectory_batch_draws(gen, b, num_map_nodes))


# ---------------------------------------------------------------------------
# LM token streams
# ---------------------------------------------------------------------------

def lm_batch_draws(gen: torch.Generator, b: int, t: int,
                   vocab: int) -> Dict[str, torch.Tensor]:
    """The random draws of `lm_batch`, on `gen`'s device: start token and
    step per row, and per position a 10% Bernoulli `noise` flag with the
    uniform token `rand` that replaces it."""
    device = gen.device
    return {
        "start": torch.randint(0, vocab, (b, 1), generator=gen,
                               device=device),
        "step": torch.randint(1, 7, (b, 1), generator=gen, device=device),
        "noise": torch.rand((b, t + 1), generator=gen, device=device) < 0.1,
        "rand": torch.randint(0, vocab, (b, t + 1), generator=gen,
                              device=device),
    }


def lm_batch_from_draws(draws: Dict[str, torch.Tensor], t: int,
                        vocab: int) -> Dict[str, torch.Tensor]:
    """The deterministic step: tokens [b, t] and next-token labels
    [b, t] (int64)."""
    ar = torch.arange(t + 1, device=draws["start"].device)[None, :]
    toks = (draws["start"] + draws["step"] * ar) % vocab
    toks = torch.where(draws["noise"], draws["rand"], toks)
    return {"tokens": toks[:, :t].long(), "labels": toks[:, 1:t + 1].long()}


def lm_batch(gen: torch.Generator, b: int, t: int,
             vocab: int) -> Dict[str, torch.Tensor]:
    """Structured token stream: tokens follow a noisy +step pattern so the
    next-token task has learnable signal."""
    return lm_batch_from_draws(lm_batch_draws(gen, b, t, vocab), t, vocab)


def src_lm_batch(cfg):
    """The batch maker of a model whose cross-attention reads `src`
    (whisper's frames, llama-3.2-vision's patches): `lm_batch` with
    src = 0.1 * N(0, 1) [b, num_src_tokens, src_dim] in the compute dtype,
    drawn from the same generator (the shape and scale of the reference's
    tests/test_arch_smoke.py); None for the other families, which take
    `lm_batch` as it is. It has `lm_batch`'s signature, as `train`'s
    `batch_fn` takes it."""
    if cfg.family not in ("vlm", "audio"):
        return None

    def make(gen: torch.Generator, b: int, t: int,
             vocab: int) -> Dict[str, torch.Tensor]:
        out = lm_batch(gen, b, t, vocab)
        out["src"] = 0.1 * torch.randn(
            (b, cfg.num_src_tokens, cfg.src_dim), generator=gen,
            device=gen.device).to(cfg.dtype)
        return out
    return make
