"""Work of one ``wkv6`` call, the RWKV-6 recurrence per head of size hd::

    y_t = r_t^T (S + diag(u) k_t v_t^T);   S <- diag(w_t) S + k_t v_t^T
"""
from __future__ import annotations


def call(batch: int, heads: int, steps: int, head_size: int,
         stack: bool) -> tuple:
    """r/k/v/w (B, H, S, hd) f32 in, u (H, hd), s0 (B, H, hd, hd) f32 in;
    y (B, H, S, hd) f32 out and the final state, or with ``stack`` every
    state (S + 1 of them) out.  Per step and head: k v^T (hd^2), u * kv
    and its sum with S (2 hd^2), r^T (.) (2 hd^2), w * S + kv (2 hd^2)."""
    hd2 = head_size * head_size
    flops = 7 * batch * heads * steps * hd2
    seq = batch * heads * steps * head_size * 4
    state = batch * heads * hd2 * 4
    states_out = (steps + 1) * state if stack else state
    return flops, 4 * seq + heads * head_size * 4 + state + seq + states_out
