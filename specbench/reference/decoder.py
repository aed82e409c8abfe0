"""Decoder-only transformers with full or sliding-window grouped-query
attention (RoPE, rotating the two halves of each head) and a SwiGLU
FFN, dense or a top-k mixture of experts without capacity limits:
Mixtral-8x7B (arXiv:2401.04088) and Mistral-7B (arXiv:2310.06825).  A
sequence is plain (causal) or a tree of branches off a main branch, each
token at its own position (see :func:`_visible`)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import head_logits, linear, rms_norm


def _rope(x: torch.Tensor, theta: float, pos: torch.Tensor) -> torch.Tensor:
    """x (L, H, d) at positions ``pos`` (L,)."""
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float64,
                                    device=x.device) / half)
    ang = (pos.to(torch.float64)[:, None] * freqs).float()
    s, c = torch.sin(ang)[:, None], torch.cos(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _layout(length: int, layout, device) -> tuple:
    """(pos, lim, branch) of a sequence: a plain one, or the tree given."""
    if layout is not None:
        return layout
    i = torch.arange(length, device=device)
    return i, i, torch.full_like(i, -1)


def _visible(layout, window) -> torch.Tensor:
    """(L, L): token i sees token j.  A main token (branch -1) at a
    position <= i's ``lim``, or a token of i's own branch at a position
    <= i's; within ``window`` positions where the layer has one."""
    pos, lim, br = layout
    main = br[None, :] < 0
    ok = ((main & (pos[None, :] <= lim[:, None]))
          | (~main & (br[None, :] == br[:, None])
             & (pos[None, :] <= pos[:, None])))
    if window is not None:
        ok &= pos[None, :] > pos[:, None] - window
    return ok


def _attention(p: dict, x: torch.Tensor, cfg: dict, pos, ok, quant):
    """One sequence x (L, D) f32 at positions ``pos``, mask ``ok``."""
    length = x.shape[0]
    hq, hkv, hd = cfg["n_heads"], cfg["n_kv_heads"], cfg["head_dim"]
    q = _rope(linear(x, p["wq"], quant).view(length, hq, hd),
              cfg["rope_theta"], pos)
    k = _rope(linear(x, p["wk"], quant).view(length, hkv, hd),
              cfg["rope_theta"], pos)
    v = linear(x, p["wv"], quant).view(length, hkv, hd)
    rep = hq // hkv
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    out = torch.empty_like(q)
    for h0 in range(0, hq, 8):                  # a few heads at a time
        s = torch.einsum("qhd,khd->hqk", q[:, h0:h0 + 8], k[:, h0:h0 + 8])
        s = (s * hd ** -0.5).masked_fill(~ok, float("-inf"))
        out[:, h0:h0 + 8] = torch.einsum("hqk,khd->qhd", s.softmax(-1),
                                         v[:, h0:h0 + 8])
    return linear(out.reshape(length, hq * hd), p["wo"], quant)


def _swiglu(x, w_gate, w_up, w_down, quant):
    return linear(F.silu(linear(x, w_gate, quant)) * linear(x, w_up, quant),
                  w_down, quant)


def _moe(p: dict, x: torch.Tensor, cfg: dict, quant):
    """x (N, D): softmax router over every expert, the top k renormalised,
    each token's output the gated sum of its experts' FFNs."""
    probs = torch.softmax(x @ p["router"].float(), dim=-1)
    gate, idx = torch.topk(probs, cfg["top_k"], dim=-1)
    gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(x)
    for e in range(cfg["n_experts"]):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = _swiglu(x[tok], p["w_gate"][e], p["w_up"][e], p["w_down"][e],
                    quant)
        out.index_add_(0, tok, y * gate[tok, slot][:, None])
    return out


def logits_at(params: dict, cfg: dict, seqs: list, positions: list,
              quant: str | None, layouts: list) -> list:
    pat = cfg["layer_pattern"]
    moe_pat = cfg.get("moe_pattern") or [k in ("attn", "swa") for k in pat]
    xs = [params["embed"]["tok"][s].float() for s in seqs]
    lens = [len(s) for s in seqs]
    lays = [_layout(n, lay, x.device) for n, lay, x in zip(lens, layouts, xs)]
    masks = {}
    for layer, p in enumerate(params["layers"]):
        kind = pat[layer % len(pat)]
        window = cfg["sliding_window"] if kind == "swa" else None
        if window not in masks:
            masks[window] = [_visible(lay, window) for lay in lays]
        xs = [x + _attention(p["attn"], rms_norm(x, p["ln1"]["scale"]), cfg,
                             lay[0], ok, quant)
              for x, lay, ok in zip(xs, lays, masks[window])]
        h = rms_norm(torch.cat(xs), p["ln2"]["scale"])
        if cfg.get("n_experts", 0) and moe_pat[layer % len(pat)]:
            f = _moe(p["ffn"], h, cfg, quant)
        else:
            f = _swiglu(h, p["ffn"]["w_gate"], p["ffn"]["w_up"],
                        p["ffn"]["w_down"], quant)
        xs = [x + y for x, y in zip(xs, torch.split(f, lens))]
    return [head_logits(params, x[pos], quant) for x, pos in zip(xs, positions)]
