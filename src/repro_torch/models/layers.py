"""Basic building blocks: norms, RoPE, MLPs, embeddings, sinusoids.

Counterpart of ``repro/models/layers.py`` without the sharding hints.
Weight matrices are stored ``(in_features, out_features)`` so the
forward is ``x @ w``; norms and RoPE compute in f32 and return the
input's dtype.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ref import ffn_act


def apply_norm(params: dict, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        var = xf.square().mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + eps) * params["scale"].float()
    elif kind == "layernorm":
        mean = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mean) * torch.rsqrt(var + eps)
        out = out * params["scale"].float() + params["bias"].float()
    else:
        raise ValueError(kind)
    return out.to(x.dtype)


def rope_table(positions: torch.Tensor, head_dim: int, theta: float):
    """sin/cos tables for integer ``positions`` (any shape), each of shape
    ``positions.shape + (head_dim // 2,)`` in f32."""
    half = head_dim // 2
    exps = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=positions.device), exps)
    angles = positions.float()[..., None] * freqs
    return torch.sin(angles), torch.cos(angles)


def apply_rope(x: torch.Tensor, sin: torch.Tensor,
               cos: torch.Tensor) -> torch.Tensor:
    """Rotate ``x`` (..., S, n_heads, head_dim) by per-position tables of
    shape (..., S, head_dim // 2), broadcast over the heads axis."""
    half = x.shape[-1] // 2
    s, c = sin[..., None, :], cos[..., None, :]
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([xf1 * c - xf2 * s, xf2 * c + xf1 * s], dim=-1)
    return out.to(x.dtype)


def apply_mlp(params: dict, x: torch.Tensor, activation: str) -> torch.Tensor:
    if "w_gate" in params:
        h = ffn_act(x @ params["w_gate"], activation) * (x @ params["w_up"])
    else:
        h = ffn_act(x @ params["w_up"], activation)
    return h @ params["w_down"]


def embed_tokens(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["tok"][tokens]


def unembed(params: dict, x: torch.Tensor) -> torch.Tensor:
    w = params.get("head")
    if w is None:
        w = params["tok"].T
    return (x @ w).float()


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """Classic sinusoid table (the Whisper encoder's positions), (n, d)
    f32: sin of the ``d // 2`` angles, then their cos."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10_000.0, device=device),
                            2 * dim / d)
    return torch.cat([torch.sin(angle), torch.cos(angle)], dim=-1)
