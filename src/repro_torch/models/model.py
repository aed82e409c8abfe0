"""Top-level model API: train / prefill / decode / commit / decode_step.

Counterpart of ``repro/models/model.py`` (``:66-168``).  ``decode`` and
``decode_step`` of an encoder-decoder config read the cross K/V that
``prefill`` stored in the cache.  Caches are updated in place (see
:mod:`repro_torch.models.transformer`).  A batch is a dict of tensors
on the parameters' device: ``tokens`` (B, S) integer and, for an
encoder-decoder config, ``encoder_frames`` (B, T, D).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.models.encdec import apply_encoder
from repro_torch.models.layers import apply_norm, embed_tokens, unembed
from repro_torch.models.transformer import (commit_cache, forward_decoder,
                                            init_cache, logits_from_hidden)

__all__ = ["forward_train", "loss_fn", "prefill", "decode", "commit",
           "decode_step", "init_cache"]


def _embed(params, cfg, tokens):
    return embed_tokens(params["embed"], tokens).to(cfg.torch_dtype)


def _train_hidden(params: dict, cfg: ModelConfig, batch: dict):
    x = _embed(params, cfg, batch["tokens"])
    enc_out = (apply_encoder(params["encoder"], cfg, batch["encoder_frames"])
               if cfg.encoder_decoder else None)
    h, _, _ = forward_decoder(params, cfg, x, phase="train", enc_out=enc_out)
    return h


def forward_train(params: dict, cfg: ModelConfig, batch: dict):
    """Next-token logits (B, S, V) f32 of the training forward."""
    return logits_from_hidden(params, cfg, _train_hidden(params, cfg, batch))


def loss_fn(params: dict, cfg: ModelConfig, batch: dict,
            logits_chunk: int = 256):
    """Causal LM cross-entropy (next token), ignoring the last position.

    The (B, S - 1, V) logits are never materialised: the unembedding and
    the log-softmax run over chunks of the sequence of ``c`` positions,
    ``c`` the largest divisor of S - 1 up to ``logits_chunk`` (195 at S
    4096), each chunk a checkpoint that keeps only its hidden rows and
    recomputes its logits in the backward, the counterpart of the JAX
    package's ``jax.checkpoint(chunk_nll)`` (at a 262144-token vocabulary,
    B 2 and S 4096 every chunk's f32 logits and log-softmax kept at once
    would be ~17 GB).  Returns the mean over B * (S - 1) tokens, f32."""
    h = apply_norm(params["final_norm"], _train_hidden(params, cfg, batch),
                   cfg.norm)
    h = h[:, :-1]
    targets = batch["tokens"][:, 1:].long()
    b, s, _ = h.shape
    c = min(logits_chunk, s)
    while s % c:
        c -= 1

    def chunk_nll(h_i, t_i):
        logp = F.log_softmax(unembed(params["embed"], h_i), dim=-1)
        return -torch.gather(logp, -1, t_i[..., None]).sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, c):
        total = total + checkpoint(chunk_nll, h[:, i:i + c],
                                   targets[:, i:i + c], use_reentrant=False,
                                   preserve_rng_state=False)
    return total / (b * s)


def prefill(params: dict, cfg: ModelConfig, tokens, cache: dict,
            mesh=None, encoder_frames=None):
    """Process the prompt (B, L); fill the cache in place.  An
    encoder-decoder config first runs the encoder over
    ``encoder_frames`` (B, T, D) and stores each layer's cross K/V in the
    cache.  With a ``mesh`` (:mod:`repro_torch.launch.mesh`) the MoE
    layers run distributed (``params`` then holds this rank's
    :func:`repro_torch.models.moe.shard_moe_layers` shards); every rank
    gets the whole result.

    Returns (last-position logits (B, V) f32, cache with pos=L).
    """
    b, length = tokens.shape
    x = _embed(params, cfg, tokens)
    enc_out = None
    if cfg.encoder_decoder:
        enc_out = apply_encoder(params["encoder"], cfg, encoder_frames)
    h, cache, _ = forward_decoder(params, cfg, x, phase="prefill",
                                  cache=cache, mesh=mesh, enc_out=enc_out)
    logits = logits_from_hidden(params, cfg, h[:, -1:])[:, 0]
    cache["pos"] = torch.full((b,), length, dtype=torch.int64,
                              device=tokens.device)
    return logits, cache


def decode(params: dict, cfg: ModelConfig, cache: dict, tokens,
           mesh=None, spec_tree: dict | None = None):
    """Decode/verify ``m`` new tokens (B, m) at positions cache['pos'].

    Writes the cache in place and returns (logits (B, m, V), cache,
    pendings); call :func:`commit` with the accepted counts to finalize.
    ``spec_tree`` marks ``tokens`` as speculation-tree nodes (depth-based
    positions and ancestor masking; see
    :func:`repro_torch.core.spec_decode.tree_spec`).  ``mesh`` as in
    :func:`prefill`.
    """
    x = _embed(params, cfg, tokens)
    h, cache, pendings = forward_decoder(params, cfg, x, phase="decode",
                                         cache=cache, mesh=mesh,
                                         spec_tree=spec_tree)
    return logits_from_hidden(params, cfg, h), cache, pendings


def commit(cfg: ModelConfig, cache: dict, pendings, n_commit,
           sq: int) -> dict:
    """Accept the first ``n_commit`` (B,) of the ``sq`` decoded tokens."""
    return commit_cache(cfg, cache, pendings, n_commit, sq)


def decode_step(params: dict, cfg: ModelConfig, cache: dict, tokens,
                mesh=None):
    """One committed autoregressive step (B, 1) -> (logits (B, V), cache)."""
    logits, cache, pendings = decode(params, cfg, cache, tokens, mesh)
    b = tokens.shape[0]
    ones = torch.ones((b,), dtype=torch.int64, device=tokens.device)
    cache = commit(cfg, cache, pendings, ones, 1)
    return logits[:, 0], cache
