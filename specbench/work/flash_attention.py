"""Work of one ``flash_attention`` forward call (prefill): causal,
optionally windowed, grouped-query attention of a sequence with itself."""
from __future__ import annotations


def visible_pairs(length: int, window: int | None) -> int:
    """(query, key) pairs a causal mask of ``window`` keys lets through."""
    if window is None or window >= length:
        return length * (length + 1) // 2
    return window * (window + 1) // 2 + (length - window) * window


def call(batch: int, length: int, n_heads: int, n_kv_heads: int,
         head_dim: int, window: int | None, elem_bytes: int = 2) -> tuple:
    """q, o (B, L, Hq, d); k, v (B, L, Hkv, d).  QK^T and PV over the
    visible pairs: 4 d operations a pair and head."""
    flops = 4 * batch * n_heads * head_dim * visible_pairs(length, window)
    io = batch * length * head_dim * (2 * n_heads + 2 * n_kv_heads)
    return flops, io * elem_bytes
