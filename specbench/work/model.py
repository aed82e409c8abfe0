"""Work of a whole serving step, from a model configuration (the
``target`` / ``draft`` dicts of a configuration file) and the shapes the
step runs at: the fused speculative round and a B=1 prefill."""
from __future__ import annotations

import numpy as np

from . import flash_attention, moe_ffn, wkv6


def _kind(cfg: dict, layer: int) -> str:
    pat = cfg["layer_pattern"]
    return pat[layer % len(pat)]


def _is_moe(cfg: dict, layer: int) -> bool:
    pat = cfg["layer_pattern"]
    moe_pat = cfg.get("moe_pattern") or [k in ("attn", "swa") for k in pat]
    return cfg.get("n_experts", 0) > 0 and bool(moe_pat[layer % len(pat)])


def _elem(cfg: dict) -> int:
    return 2 if cfg.get("dtype", "bfloat16") in ("bfloat16", "float16") else 4


def _window(cfg: dict, layer: int):
    return cfg["sliding_window"] if _kind(cfg, layer) == "swa" else None


def _attn_proj(cfg: dict) -> int:
    d, hd = cfg["d_model"], cfg["head_dim"]
    return 2 * d * hd * (cfg["n_heads"] + cfg["n_kv_heads"])


def _kv_elems(cfg: dict) -> int:
    """K and V elements a token adds to one attention layer's cache."""
    return 2 * cfg["n_kv_heads"] * cfg["head_dim"]


def _rwkv_mats(cfg: dict) -> int:
    d, f = cfg["d_model"], cfg["d_ff"]
    return 6 * d * d + 2 * d * f


def forward(cfg: dict, batch: int, steps: int, contexts, *,
            stack: bool) -> tuple:
    """(flops, bytes) of one decode call of ``steps`` tokens for each of
    ``batch`` sequences, whose caches hold ``contexts`` tokens (a list,
    one per sequence, or one number for all) before it: every layer,
    the final norm's head for every token; weights read once, each
    sequence's cache read once and the new rows written."""
    ctx = np.broadcast_to(np.asarray(contexts, np.int64), (batch,))
    d, v, e = cfg["d_model"], cfg["vocab_size"], _elem(cfg)
    toks = batch * steps
    flops = 2 * toks * d * v
    nbytes = d * v * e
    for layer in range(cfg["n_layers"]):
        kind = _kind(cfg, layer)
        if kind == "rwkv":
            mats = _rwkv_mats(cfg)
            flops += 2 * toks * mats
            nbytes += mats * e
            hs = cfg["rwkv_head_size"]
            f, b = wkv6.call(batch, d // hs, steps, hs, stack)
            flops, nbytes = flops + f, nbytes + b
            continue
        proj = _attn_proj(cfg)
        flops += 2 * toks * proj
        nbytes += proj * e
        win = _window(cfg, layer)
        hq, hd = cfg["n_heads"], cfg["head_dim"]
        seen = ctx[:, None] + np.arange(1, steps + 1)[None, :]
        if win:
            seen = np.minimum(seen, win)
        flops += 4 * hq * hd * int(seen.sum())
        held = np.minimum(ctx, win) if win else ctx
        nbytes += int(held.sum()) * _kv_elems(cfg) * e
        nbytes += toks * _kv_elems(cfg) * e
        f3 = 3 * d * cfg["d_ff"]
        if _is_moe(cfg, layer):
            k, ne = cfg["top_k"], cfg["n_experts"]
            fm, bm = moe_ffn.call(toks, k, d, cfg["d_ff"],
                                  moe_ffn.experts_touched(toks, k, ne), e)
            flops += fm + 2 * toks * d * ne
            nbytes += bm + d * ne * 4
        else:
            flops += 2 * toks * f3
            nbytes += f3 * e
    return flops, nbytes


def spec_round(target: dict, draft: dict, batch: int, n_cand: int,
               contexts) -> tuple:
    """The fused chain round: the target verifies ``n_cand`` drafts and
    the root of ``batch`` sequences (one call of n_cand + 1 tokens), the
    draft feeds n_cand + 1 single tokens to the other ``batch`` (one call
    each).  ``contexts``: the committed lengths (see :func:`forward`)."""
    flops, nbytes = forward(target, batch, n_cand + 1, contexts, stack=True)
    ctx = np.broadcast_to(np.asarray(contexts, np.int64), (batch,))
    for j in range(n_cand + 1):
        f, b = forward(draft, batch, 1, ctx + j, stack=True)
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes


def prefill(cfg: dict, length: int) -> tuple:
    """(flops, bytes) of a B=1 prefill of ``length`` tokens: every layer
    over every token, the head for the last one; weights read once, the
    cache or state written once."""
    d, v, e = cfg["d_model"], cfg["vocab_size"], _elem(cfg)
    flops, nbytes = 2 * d * v, d * v * e
    for layer in range(cfg["n_layers"]):
        kind = _kind(cfg, layer)
        if kind == "rwkv":
            mats = _rwkv_mats(cfg)
            hs = cfg["rwkv_head_size"]
            f, b = wkv6.call(1, d // hs, length, hs, False)
            flops += 2 * length * mats + f
            nbytes += mats * e + b
            continue
        proj = _attn_proj(cfg)
        fa, _ = flash_attention.call(1, length, cfg["n_heads"],
                                     cfg["n_kv_heads"], cfg["head_dim"],
                                     _window(cfg, layer), e)
        flops += 2 * length * proj + fa
        nbytes += proj * e + length * _kv_elems(cfg) * e
        f3 = 3 * d * cfg["d_ff"]
        if _is_moe(cfg, layer):
            k, ne = cfg["top_k"], cfg["n_experts"]
            fm, bm = moe_ffn.call(length, k, d, cfg["d_ff"],
                                  moe_ffn.experts_touched(length, k, ne), e)
            flops += fm + 2 * length * d * ne
            nbytes += bm
        else:
            flops += 2 * length * f3
            nbytes += f3 * e
    return flops, nbytes


def attention_layers(cfg: dict) -> list:
    """Indices of the layers that run ``flash_attention`` in prefill."""
    return [l for l in range(cfg["n_layers"])
            if _kind(cfg, l) in ("attn", "swa")]


def flash_prefill(cfg: dict, length: int) -> tuple:
    """(flops, bytes) of the ``flash_attention`` calls of one prefill."""
    flops = nbytes = 0
    for layer in attention_layers(cfg):
        f, b = flash_attention.call(1, length, cfg["n_heads"],
                                    cfg["n_kv_heads"], cfg["head_dim"],
                                    _window(cfg, layer), _elem(cfg))
        flops, nbytes = flops + f, nbytes + b
    return flops, nbytes
