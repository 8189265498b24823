"""Deterministic synthetic CIFAR-like data (offline substitute).

Port of `cifar_like_dataset` and `partition_labels` of
`repro/data/synthetic.py`: 10-class 32x32x3 images = class prototype plus
noise, so a small CNN genuinely learns. Draws come from `torch.Generator`s,
so the images differ from the reference's for the same seed; the
partition is numpy, the same as the reference's.
"""
from __future__ import annotations

import numpy as np
import torch


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
