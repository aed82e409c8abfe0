"""Whisper-style encoder stack (arXiv:2212.04356).

Counterpart of ``repro/models/encdec.py::apply_encoder``.  The modality
frontend (mel spectrogram + conv feature extractor) is a stub: the
caller hands over frame embeddings (B, T, D).  This is the transformer
that consumes them: sinusoidal positions, then per layer a LayerNorm,
bidirectional self-attention and a GELU MLP, each as a residual, and a
final norm.  The JAX package stacks the layers for a ``lax.scan``; here
``params["layers"]`` is a list, one dict a layer (``ln1``, ``attn``,
``ln2``, ``mlp``).  On CUDA tensors the attention is the flash kernel
with ``causal=False`` (T 1500, head dim 64 at Whisper-base), and in
training its backward kernel through ``FlashAttentionFn`` (the plain
versions on CPU tensors); on CPU tensors without a gradient the plain
``attention_chunked``.  Over a mesh the encoder runs on its blocks at
rest (:func:`encoder_specs`), as the decoder's prefill does
(:mod:`repro_torch.models.layers`): q/k/v and the MLP's first matrix
are column products, ``wo`` and its second row products, each with its
``"data"`` blocks gathered for the call and its ``"model"`` block kept;
each rank attends over its own heads where the heads split over
``"model"``, else over every head gathered (the decoder's gathered
route); the rank encodes its rows of the batch.
"""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.attention import (_heads_in, _heads_out,
                                          attention_chunked,
                                          attention_specs, flash_bshd,
                                          heads_split, needs_grad, on_card)
from repro_torch.models.layers import (apply_mlp, apply_norm, mlp_specs,
                                       model_input, norm_specs,
                                       sinusoidal_positions)


def encoder_specs(cfg: ModelConfig) -> dict:
    """At rest over a mesh (``repro/models/encdec.py:41``, its layer axis
    dropped: one entry a layer)."""
    one = lambda: {"ln1": norm_specs(cfg.norm),  # noqa: E731
                   "attn": attention_specs(), "ln2": norm_specs(cfg.norm),
                   "mlp": mlp_specs(cfg.activation)}
    return {"layers": [one() for _ in range(cfg.n_encoder_layers)],
            "final_norm": norm_specs(cfg.norm)}


def apply_encoder(params: dict, cfg: ModelConfig, frames,
                  mesh=None) -> torch.Tensor:
    """frames (B, T, D) stub embeddings -> encoder states (B, T, D); over
    a ``mesh`` the frames and states are the rank's rows and ``params``
    its blocks at rest."""
    b, t, d = frames.shape
    x = frames + sinusoidal_positions(t, d, frames.device).to(frames.dtype)
    scale = cfg.head_dim ** -0.5
    positions = torch.arange(t, device=frames.device)
    gather = not heads_split(cfg.n_heads, cfg.n_kv_heads, mesh)
    for layer in params["layers"]:
        h = apply_norm(layer["ln1"], x, cfg.norm)
        attn = layer["attn"]
        q, k, v = _heads_in(model_input(h, mesh, False),
                            (attn["wq"], attn["wk"], attn["wv"]), mesh, False,
                            gather, cfg.head_dim)
        if on_card(x) or needs_grad(q, k, v):
            out = flash_bshd(q, k, v, scale, causal=False)
        else:
            out = attention_chunked(q, k, v, positions, positions, scale,
                                    causal=False)
        x = x + _heads_out(out, attn["wo"], mesh, False, gather)
        x = x + apply_mlp(layer["mlp"], apply_norm(layer["ln2"], x, cfg.norm),
                          cfg.activation, mesh)
    return apply_norm(params["final_norm"], x, cfg.norm)
