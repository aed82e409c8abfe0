"""Top-level model API for serving: prefill / decode / commit / decode_step.

Counterpart of ``repro/models/model.py`` (``:120-168``).  ``decode`` and
``decode_step`` of an encoder-decoder config read the cross K/V that
``prefill`` stored in the cache.  Caches are updated in place (see
:mod:`repro_torch.models.transformer`).
"""
from __future__ import annotations

import torch

from repro_torch.configs import ModelConfig
from repro_torch.models.encdec import apply_encoder
from repro_torch.models.layers import embed_tokens
from repro_torch.models.transformer import (commit_cache, forward_decoder,
                                            init_cache, logits_from_hidden)

__all__ = ["prefill", "decode", "commit", "decode_step", "init_cache"]


def _embed(params, cfg, tokens):
    return embed_tokens(params["embed"], tokens).to(cfg.torch_dtype)


def prefill(params: dict, cfg: ModelConfig, tokens, cache: dict,
            encoder_frames=None):
    """Process the prompt (B, L); fill the cache in place.  An
    encoder-decoder config first runs the encoder over
    ``encoder_frames`` (B, T, D) and stores each layer's cross K/V in the
    cache.

    Returns (last-position logits (B, V) f32, cache with pos=L).
    """
    b, length = tokens.shape
    x = _embed(params, cfg, tokens)
    enc_out = None
    if cfg.encoder_decoder:
        enc_out = apply_encoder(params["encoder"], cfg, encoder_frames)
    h, cache, _ = forward_decoder(params, cfg, x, phase="prefill",
                                  cache=cache, enc_out=enc_out)
    logits = logits_from_hidden(params, cfg, h[:, -1:])[:, 0]
    cache["pos"] = torch.full((b,), length, dtype=torch.int64,
                              device=tokens.device)
    return logits, cache


def decode(params: dict, cfg: ModelConfig, cache: dict, tokens,
           spec_tree: dict | None = None):
    """Decode/verify ``m`` new tokens (B, m) at positions cache['pos'].

    Writes the cache in place and returns (logits (B, m, V), cache,
    pendings); call :func:`commit` with the accepted counts to finalize.
    ``spec_tree`` marks ``tokens`` as speculation-tree nodes (depth-based
    positions and ancestor masking; see
    :func:`repro_torch.core.spec_decode.tree_spec`).
    """
    x = _embed(params, cfg, tokens)
    h, cache, pendings = forward_decoder(params, cfg, x, phase="decode",
                                         cache=cache, spec_tree=spec_tree)
    return logits_from_hidden(params, cfg, h), cache, pendings


def commit(cfg: ModelConfig, cache: dict, pendings, n_commit,
           sq: int) -> dict:
    """Accept the first ``n_commit`` (B,) of the ``sq`` decoded tokens."""
    return commit_cache(cfg, cache, pendings, n_commit, sq)


def decode_step(params: dict, cfg: ModelConfig, cache: dict, tokens):
    """One committed autoregressive step (B, 1) -> (logits (B, V), cache)."""
    logits, cache, pendings = decode(params, cfg, cache, tokens)
    b = tokens.shape[0]
    ones = torch.ones((b,), dtype=torch.int64, device=tokens.device)
    cache = commit(cfg, cache, pendings, ones, 1)
    return logits[:, 0], cache
