"""Top-level model API: specs / train / prefill / decode / commit /
decode_step.

Counterpart of ``repro/models/model.py`` (``:43-168``).  ``decode`` and
``decode_step`` of an encoder-decoder config read the cross K/V that
``prefill`` stored in the cache.  Caches are updated in place (see
:mod:`repro_torch.models.transformer`).  A batch is a dict of tensors
on the parameters' device: ``tokens`` (B, S) integer and, for an
encoder-decoder config, ``encoder_frames`` (B, T, D).

Over a ``mesh`` (:mod:`repro_torch.launch.mesh`) the parameters are the
rank's blocks (:func:`shard_model`, laid out by :func:`param_specs`);
every entry point takes the whole inputs and returns the whole outputs,
the same on every rank.  Prefill and training give each rank its rows
of the batch over ``"data"`` (as the JAX package's ``_embed`` hint
does; a prefill whose batch does not split runs it whole on every
rank); decode steps run the whole token block on every rank.  The
training loss is the global mean: each rank's sum over its rows, summed
over ``"data"``.

Prefill and training run under the sequence-parallel profile in force
when they are called (:class:`repro_torch.models.layers.
sequence_sharding`, ``"model"`` by default, as the JAX package's
``launch/specs.build_step`` wraps them): the training carry between
layer groups is the rank's block of the sequence and attention is
context-parallel where the heads do not split
(:mod:`repro_torch.models.transformer`).  The decoder's output is
gathered whole before the loss, so the loss is the unsharded one; a
training sequence that does not split over ``"model"`` raises.  Decode
ignores the profile.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import ModelConfig
from repro_torch.launch.mesh import (all_gather, all_reduce, axis_size, block,
                                     shard_params)
from repro_torch.models.encdec import apply_encoder, encoder_specs
from repro_torch.models.layers import apply_norm, embed_tokens, unembed
from repro_torch.models.transformer import (commit_cache, decoder_param_specs,
                                            embed_specs, forward_decoder,
                                            init_cache, logits_from_hidden)

__all__ = ["param_specs", "shard_model", "forward_train", "loss_fn",
           "prefill", "decode", "commit", "decode_step", "init_cache"]


def param_specs(cfg: ModelConfig, model_size: int = 16,
                data_size: int = 16) -> dict:
    """The specs of :func:`repro_torch.params.init_params`'s tree: a tuple
    of mesh axes (or None) a dim, one entry a layer (the JAX package's
    ``param_specs`` with its group axis dropped; ``data_size`` as in
    :func:`repro_torch.models.transformer.decoder_param_specs`)."""
    specs = decoder_param_specs(cfg, model_size, data_size)
    if cfg.encoder_decoder:
        specs["encoder"] = encoder_specs(cfg)
    return specs


def mesh_specs(cfg: ModelConfig, mesh) -> dict:
    """:func:`param_specs` at ``mesh``'s axis sizes."""
    return param_specs(cfg, axis_size(mesh, "model"), axis_size(mesh, "data"))


def shard_model(params: dict, cfg: ModelConfig, mesh) -> dict:
    """This rank's at-rest blocks of whole parameters
    (:func:`repro_torch.launch.mesh.shard_params` over
    :func:`mesh_specs`)."""
    return shard_params(params, mesh_specs(cfg, mesh), mesh)


def _splits(mesh, b: int) -> bool:
    """Whether a batch of ``b`` rows splits over ``"data"``."""
    d = axis_size(mesh, "data") if mesh is not None else 1
    return d > 1 and b % d == 0


def _embed(params, cfg, tokens, mesh=None, stationary=False):
    return embed_tokens(params["embed"], tokens, mesh, embed_specs(cfg, mesh),
                        stationary).to(cfg.torch_dtype)


def _train_hidden(params: dict, cfg: ModelConfig, batch: dict, mesh=None):
    """The decoder's output over the rank's rows of the batch."""
    if mesh is not None:          # a batch that does not split raises
        batch = {k: block(v, mesh, "data", 0) for k, v in batch.items()}
    x = _embed(params, cfg, batch["tokens"], mesh)
    enc_out = (apply_encoder(params["encoder"], cfg, batch["encoder_frames"],
                             mesh)
               if cfg.encoder_decoder else None)
    h, _, _ = forward_decoder(params, cfg, x, phase="train", enc_out=enc_out,
                              mesh=mesh)
    return h


def forward_train(params: dict, cfg: ModelConfig, batch: dict, mesh=None):
    """Next-token logits (B, S, V) f32 of the training forward."""
    logits = logits_from_hidden(params, cfg,
                                _train_hidden(params, cfg, batch, mesh), mesh)
    return logits if mesh is None else all_gather(logits, mesh, "data", 0)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, mesh=None,
            logits_chunk: int = 256):
    """Causal LM cross-entropy (next token), ignoring the last position.

    The (B, S - 1, V) logits are never materialised: the unembedding and
    the log-softmax run over chunks of the sequence of ``c`` positions,
    ``c`` the largest divisor of S - 1 up to ``logits_chunk`` (195 at S
    4096), each chunk a checkpoint that keeps only its hidden rows and
    recomputes its logits in the backward, the counterpart of the JAX
    package's ``jax.checkpoint(chunk_nll)`` (at a 262144-token vocabulary,
    B 2 and S 4096 every chunk's f32 logits and log-softmax kept at once
    would be ~17 GB).  Returns the mean over B * (S - 1) tokens, f32.

    Over a ``mesh`` each rank sums its rows' negative log-likelihoods; a
    sum over ``"data"`` (identity backward: each rank's gradient is its
    rows' part) gives every rank the global mean."""
    h = apply_norm(params["final_norm"],
                   _train_hidden(params, cfg, batch, mesh), cfg.norm)
    h = h[:, :-1]
    targets = batch["tokens"][:, 1:].long()
    if mesh is not None:
        targets = block(targets, mesh, "data", 0)
    b = batch["tokens"].shape[0]
    s = h.shape[1]
    c = min(logits_chunk, s)
    while s % c:
        c -= 1

    def chunk_nll(h_i, t_i):
        logp = F.log_softmax(unembed(params["embed"], h_i, mesh,
                                     embed_specs(cfg, mesh)), dim=-1)
        return -torch.gather(logp, -1, t_i[..., None]).sum()

    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(0, s, c):
        total = total + checkpoint(chunk_nll, h[:, i:i + c],
                                   targets[:, i:i + c], use_reentrant=False,
                                   preserve_rng_state=False)
    if mesh is not None:
        total = all_reduce(total, mesh, "data")
    return total / (b * s)


def prefill(params: dict, cfg: ModelConfig, tokens, cache: dict,
            mesh=None, encoder_frames=None):
    """Process the prompt (B, L); fill the cache in place.  An
    encoder-decoder config first runs the encoder over
    ``encoder_frames`` (B, T, D) and stores each layer's cross K/V in the
    cache.  With a ``mesh`` (:mod:`repro_torch.launch.mesh`) ``params``
    holds this rank's :func:`shard_model` blocks and ``cache`` comes from
    :func:`init_cache` with the mesh; each rank prefills its rows of the
    batch, fills its cache (every row, or in the production layout its
    rows and slots), and gets the whole result.

    Returns (last-position logits (B, V) f32, cache with pos=L).
    """
    b, length = tokens.shape
    split = _splits(mesh, b)
    if split:
        tokens = block(tokens, mesh, "data", 0)
        if encoder_frames is not None:
            encoder_frames = block(encoder_frames, mesh, "data", 0)
    x = _embed(params, cfg, tokens, mesh)
    enc_out = None
    if cfg.encoder_decoder:
        enc_out = apply_encoder(params["encoder"], cfg, encoder_frames, mesh)
    h, cache, _ = forward_decoder(params, cfg, x, phase="prefill",
                                  cache=cache, mesh=mesh, enc_out=enc_out,
                                  batch_split=split)
    logits = logits_from_hidden(params, cfg, h[:, -1:], mesh)[:, 0]
    if split:
        logits = all_gather(logits, mesh, "data", 0)
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
    :func:`prefill`, the token block whole on every rank:
    weight-stationary, no attention, MLP or MoE weight moves.
    """
    x = _embed(params, cfg, tokens, mesh, stationary=True)
    h, cache, pendings = forward_decoder(params, cfg, x, phase="decode",
                                         cache=cache, mesh=mesh,
                                         spec_tree=spec_tree)
    return (logits_from_hidden(params, cfg, h, mesh, stationary=True), cache,
            pendings)


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
