"""Per-architecture tensor-parallel policy.

Port of `repro/sharding/policy.py` (plain Python, copied). Head-sharded
TP needs the query-head count to divide the model-axis size; when it
does not, projections fall back to row-parallel. On one device the mode
is always "head".
"""
from __future__ import annotations


def attention_tp_mode(num_heads: int, model_parallel: int) -> str:
    if model_parallel <= 1:
        return "head"
    return "head" if num_heads % model_parallel == 0 else "row"


def kv_shardable(num_kv_heads: int, model_parallel: int) -> bool:
    return model_parallel > 1 and num_kv_heads % model_parallel == 0


def pad_vocab(vocab_size: int, multiple: int = 128) -> int:
    r = vocab_size % multiple
    return vocab_size if r == 0 else vocab_size + (multiple - r)
