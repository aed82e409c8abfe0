"""Work of one ``moe_ffn`` call: the gated expert FFN
``(act(x @ w_gate) * (x @ w_up)) @ w_down`` over the routed rows."""
from __future__ import annotations


def call(n_tokens: int, top_k: int, d_model: int, d_ff: int,
         experts_touched: int, elem_bytes: int = 2) -> tuple:
    """``n_tokens`` tokens each routed to ``top_k`` experts (a row each),
    ``experts_touched`` experts whose three matrices are read."""
    rows = n_tokens * top_k
    flops = 2 * 3 * rows * d_model * d_ff
    weights = experts_touched * 3 * d_model * d_ff * elem_bytes
    acts = 2 * rows * d_model * elem_bytes          # rows in, rows out
    return flops, weights + acts


def experts_touched(n_tokens: int, top_k: int, n_experts: int) -> float:
    """Experts a call is expected to read under a router whose choices
    are spread evenly: each goes unused with probability
    ((E - k) / E) ** n_tokens (Mixtral at 40 tokens: 1e-5)."""
    return n_experts * (1.0 - ((n_experts - top_k) / n_experts) ** n_tokens)
