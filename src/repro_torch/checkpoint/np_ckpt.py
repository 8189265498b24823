"""Checkpointing: a tree of tensors <-> `.npz` with path-flattened keys
and a JSON meta file.

Port of `repro/checkpoint/np_ckpt.py`, in its file layout: the keys are
the leaves' paths joined by "/" (dict keys sorted, list indices), in the
reference's flatten order; the arrays go to `<path>.npz` and the meta,
with `step`, to `<path>.meta.json`.

numpy has no bfloat16, so a bf16 leaf is written as the reference
writes it: its 2-byte payload under the raw dtype `|V2`, the same
bytes. It is read back through the template leaf's dtype, the payload
reinterpreted as `torch.bfloat16` (with no `ml_dtypes`). So the port
reads the bf16 files the reference writes (which the reference's own
`load_checkpoint` refuses: its cast of `|V2` to bf16 raises) and writes
files whose keys, dtypes and bytes are the reference's.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.models.module import tree_map

_BF16 = np.dtype("V2")


def _flat(tree, prefix=()):
    """(path, leaf) pairs in the reference's order: dict keys sorted,
    sequences by index, None an empty subtree."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _flat(t, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if not torch.is_tensor(leaf):
        return np.asarray(leaf)
    x = leaf.detach().cpu().contiguous()
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy().view(_BF16)
    return x.numpy()


def _from_numpy(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16 and arr.dtype.itemsize == 2 \
            and arr.dtype.kind in "Viu":
        x = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)) \
            .view(torch.bfloat16)
    else:
        x = torch.from_numpy(np.ascontiguousarray(arr)).to(like.dtype)
    return x.to(like.device)


def save_checkpoint(path: str, params, meta: Optional[Dict[str, Any]] = None,
                    step: Optional[int] = None) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _flat(params)}
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)
    meta = dict(meta or {})
    if step is not None:
        meta["step"] = step
    with open(path.replace(".npz", "") + ".meta.json", "w") as f:
        json.dump(meta, f)
    return path


def load_checkpoint(path: str, like):
    """Restore into the structure of `like` (a template tree of tensors),
    each leaf in the template leaf's dtype and on its device."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as data:
        it = iter([_from_numpy(data[k], v) for k, v in _flat(like)])
    return tree_map(lambda x: None if x is None else next(it), like)
