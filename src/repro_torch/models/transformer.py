"""Decoder stack: per-layer apply, cache plumbing, phase dispatch.

Counterpart of ``repro/models/transformer.py`` for ATTN, SWA, RG-LRU and
RWKV-6 layers, MoE layers at any ``moe_pattern`` position, and the
cross attention of encoder-decoder configs.  The JAX package stacks
parameters and caches over layer groups for a ``lax.scan``; here both
are plain lists with one entry per layer (layer ``l`` has kind
``cfg.layer_kind(l)``), and the forward pass is a Python loop.

Caches are dicts ``{"layers": [per-layer dict], "pos": (B,) int64}``
(plus ``"block_tables"`` (B, MBS) int32 for a paged serving cache), and
are updated **in place**: KV rows are written into the cache tensors,
and a recurrent layer's new state is copied into its state tensors.

Phases: ``prefill`` (the whole prompt, fills the cache), ``decode``
(Sq new tokens per sequence at positions ``cache["pos"]``; writes are
eager and the returned pendings carry what :func:`commit_cache` needs to
undo the writes of rejected tokens: saved ring rows, recurrent state
stacks) and ``train`` (no cache; the layers run in groups of the
pattern, each group under ``torch.utils.checkpoint`` when ``cfg.remat``,
as the JAX package's scan body runs under ``jax.checkpoint``).
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs import (ATTN, RGLRU, RWKV, SWA, ModelConfig,
                                 resolve_device)
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import rwkv as rwkv_lib
from repro_torch.models.attention import (apply_attention,
                                          apply_cross_attention,
                                          init_kv_cache, init_paged_kv_pool,
                                          paged_row_indices,
                                          precompute_cross_kv, quantize_rows,
                                          restore_rejected_rows)
from repro_torch.models.layers import (apply_mlp, apply_norm,
                                       unembed)


def _set_state(cache: dict | None, new_state: dict) -> None:
    """In place: copy a recurrent layer's new state into its cache."""
    if cache is not None:
        for key, val in new_state.items():
            cache[key].copy_(val)


def apply_layer(params: dict, cfg: ModelConfig, kind: str, x, cache,
                pos, phase: str, use_moe: bool = False,
                block_tables=None, spec_tree: dict | None = None,
                enc_out=None, mesh=None):
    """Returns (x, cache, pending).  ``spec_tree`` reaches the attention
    layers only (see :func:`apply_attention`); ``mesh`` the MoE FFN only
    (:func:`repro_torch.models.moe.apply_moe`: the layer's ``ffn`` is
    then this rank's shard, every other layer runs whole on each rank).  An encoder-decoder
    attention layer (``xattn`` in ``params``) attends over the encoder
    after its self-attention: prefill computes the cross K/V from
    ``enc_out`` and stores them in the cache's ``ck`` / ``cv`` (in
    place), decode reads them from there."""
    norm = lambda p, z: apply_norm(p, z, cfg.norm)
    if kind == RGLRU:
        state = (cache if cache is not None else
                 rglru_lib.init_rglru_state(x.shape[0], cfg.rnn_width,
                                            cfg.conv_width, x.dtype,
                                            x.device))
        out, new_state, stack = rglru_lib.apply_rglru_block(
            params["rec"], norm(params["ln1"], x), state)
        x = x + out
        x = x + apply_mlp(params["ffn"], norm(params["ln2"], x),
                          cfg.activation)
        _set_state(cache, new_state)
        return x, cache, ({"stack": stack} if phase == "decode" else {})
    if kind == RWKV:
        state = (cache if cache is not None else
                 rwkv_lib.init_rwkv_state(x.shape[0], cfg.d_model,
                                          cfg.rwkv_head_size, x.dtype,
                                          x.device))
        x, new_state, stack = rwkv_lib.apply_rwkv_block(
            params["tmix"], params["cmix"], params["ln1"], params["ln2"], x,
            state, cfg.rwkv_head_size, norm)
        _set_state(cache, new_state)
        return x, cache, ({"stack": stack} if phase == "decode" else {})
    if kind not in (ATTN, SWA):
        raise ValueError(kind)
    window = cfg.sliding_window if kind == SWA else None
    out, cache, saved = apply_attention(
        params["attn"], apply_norm(params["ln1"], x, cfg.norm),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope, window=window, cache=cache, pos=pos,
        phase=phase, block_tables=block_tables if kind == ATTN else None,
        spec_tree=spec_tree)
    x = x + out
    if "xattn" in params:
        if phase == "prefill" or cache is None or "ck" not in cache:
            cross = precompute_cross_kv(params["xattn"], enc_out,
                                        n_kv_heads=cfg.n_kv_heads,
                                        head_dim=cfg.head_dim)
            if cache is not None and "ck" in cache:
                cache["ck"].copy_(cross["ck"])
                cache["cv"].copy_(cross["cv"])
        else:
            cross = {"ck": cache["ck"], "cv": cache["cv"]}
        x = x + apply_cross_attention(params["xattn"],
                                      norm(params["ln_x"], x), cross,
                                      n_heads=cfg.n_heads,
                                      head_dim=cfg.head_dim)
    h = apply_norm(params["ln2"], x, cfg.norm)
    if use_moe:
        # decode steps are few-token: dropless dispatch keeps speculative
        # verification exact (no batch-dependent drops)
        cf = (float("inf") if (cfg.moe_dropless or phase == "decode")
              else cfg.capacity_factor)
        f = moe_lib.apply_moe(params["ffn"], h, n_experts=cfg.n_experts,
                              top_k=cfg.top_k, activation=cfg.activation,
                              mesh=mesh, capacity_factor=cf)
    else:
        f = apply_mlp(params["ffn"], h, cfg.activation)
    x = x + f
    pending = {"saved": saved} if phase == "decode" else {}
    return x, cache, pending


# ---------------------------------------------------------------------------
# caches


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device) -> dict:
    """One layer's cache; an encoder-decoder ATTN layer also holds the
    cross K/V ``ck`` / ``cv`` (B, encoder_len, Hkv, d)."""
    if kind == ATTN:
        c = init_kv_cache(batch, max_len, cfg.n_kv_heads, cfg.head_dim,
                          cfg.torch_dtype, device,
                          quant=cfg.kv_cache_dtype == "int8")
        if cfg.encoder_decoder:
            shape = (batch, cfg.encoder_len, cfg.n_kv_heads, cfg.head_dim)
            c["ck"] = torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
            c["cv"] = torch.zeros_like(c["ck"])
        return c
    if kind == SWA:
        return init_kv_cache(batch, min(cfg.sliding_window, max_len),
                             cfg.n_kv_heads, cfg.head_dim, cfg.torch_dtype,
                             device)
    if kind == RGLRU:
        return rglru_lib.init_rglru_state(batch, cfg.rnn_width,
                                          cfg.conv_width, cfg.torch_dtype,
                                          device)
    if kind == RWKV:
        return rwkv_lib.init_rwkv_state(batch, cfg.d_model,
                                        cfg.rwkv_head_size, cfg.torch_dtype,
                                        device)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    device = resolve_device(device)
    return {"layers": [init_layer_cache(cfg, cfg.layer_kind(l), batch,
                                        max_len, device)
                       for l in range(cfg.n_layers)],
            "pos": torch.zeros((batch,), dtype=torch.int64, device=device)}


def init_paged_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                     block_size: int, max_blocks_per_seq: int,
                     kv_quant: bool | None = None, device="cuda") -> dict:
    """Serving cache with paged full-attention KV: each ATTN layer has one
    ``(num_blocks, block_size, Hkv, d)`` pool addressed through the
    ``block_tables`` rows (0 = the reserved scratch block); SWA layers
    keep per-slot rings.  ``kv_quant`` overrides ``cfg.kv_cache_dtype``
    for the pools.  Encoder-decoder configs raise, as in the JAX
    package."""
    if cfg.encoder_decoder:
        raise ValueError("paged KV serving supports decoder-only models")
    device = resolve_device(device)
    quant = (cfg.kv_cache_dtype == "int8") if kv_quant is None else kv_quant
    layers = []
    for l in range(cfg.n_layers):
        kind = cfg.layer_kind(l)
        if kind == ATTN:
            layers.append(init_paged_kv_pool(num_blocks, block_size,
                                             cfg.n_kv_heads, cfg.head_dim,
                                             cfg.torch_dtype, device,
                                             quant=quant))
        else:
            layers.append(init_layer_cache(cfg, kind, batch,
                                           max_blocks_per_seq * block_size,
                                           device))
    return {"layers": layers,
            "pos": torch.zeros((batch,), dtype=torch.int64, device=device),
            "block_tables": torch.zeros((batch, max_blocks_per_seq),
                                        dtype=torch.int32, device=device)}


def admit_sequence_paged(cfg: ModelConfig, cache: dict, prefill: dict,
                         slot: int, table_row, length: int,
                         n_shared: int) -> dict:
    """In place: graft a (B=1) contiguous prefill cache into batch slot
    ``slot`` of a paged serving cache.  ATTN layers scatter prefill rows
    [``n_shared * block_size``, ``length``) into the blocks of
    ``table_row`` (rows of prefix-shared blocks are already in the pool);
    other layers copy their per-slot state.  Rows are quantized on insert
    when the pool is int8 and the prefill cache is not."""
    row = torch.as_tensor(table_row, dtype=torch.int32,
                          device=cache["block_tables"].device)
    start = n_shared * _paged_block_size(cache, cfg)
    for l in range(cfg.n_layers):
        big, small = cache["layers"][l], prefill["layers"][l]
        if cfg.layer_kind(l) == ATTN:
            _paged_insert_layer(big, small, row, start, length)
        else:
            for key in big:
                big[key][slot] = small[key][0].to(big[key].dtype)
    cache["pos"][slot] = length
    cache["block_tables"][slot] = row
    return cache


def _paged_block_size(cache: dict, cfg: ModelConfig) -> int:
    for l in range(cfg.n_layers):
        if cfg.layer_kind(l) == ATTN:
            return cache["layers"][l]["k"].shape[1]
    raise ValueError("paged cache has no full-attention layer")


def _paged_insert_layer(pool: dict, prefill: dict, table_row, start: int,
                        length: int) -> None:
    """In place: scatter one layer's prefill rows [start, length) into its
    block pool (``pool`` leaves (NB, BS, H, d), ``prefill`` (1, L, H, d))."""
    nb, bs = pool["k"].shape[:2]
    i = torch.arange(start, length, device=table_row.device)
    idx = paged_row_indices(table_row[None, :], i[None, :], bs)[0]

    def scat(p, rows):
        p.view((nb * bs,) + p.shape[2:])[idx] = rows.to(p.dtype)

    src = {k: v[0, start:length] for k, v in prefill.items()}
    if "k_scale" in pool and "k_scale" not in prefill:
        kq, ks = quantize_rows(src["k"])
        vq, vs = quantize_rows(src["v"])
        src = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    for key in pool:
        scat(pool[key], src[key])


def release_slot_paged(cache: dict, slot: int) -> dict:
    """In place: point a retired slot's table row at the scratch block and
    rewind its ``pos``, so the still-running fused round can never write
    into blocks that were freed (and possibly re-granted)."""
    cache["block_tables"][slot] = 0
    cache["pos"][slot] = 0
    return cache


# ---------------------------------------------------------------------------
# forward

def _sqrt_factor(n: int, threshold: int = 8) -> int:
    """Outer superblock count for sqrt-remat (1 = disabled): the largest
    divisor of ``n`` up to its square root, as the JAX package picks it."""
    if n < threshold:
        return 1
    return next(k for k in range(math.isqrt(n), 0, -1) if n % k == 0)


def _train_group(params: dict, cfg: ModelConfig, group: int, x, enc_out):
    """The layers of pattern group ``group`` over x, phase ``train``."""
    p = len(cfg.layer_pattern)
    for l in range(group * p, (group + 1) * p):
        x, _, _ = apply_layer(params["layers"][l], cfg, cfg.layer_kind(l), x,
                              None, None, "train",
                              use_moe=cfg.layer_is_moe(l), enc_out=enc_out)
    return x


def _forward_train(params: dict, cfg: ModelConfig, x, enc_out):
    """The cache-less training forward (``repro/models/transformer.py:
    520-560``): one group of the pattern at a time.  With ``cfg.remat``
    each group is a checkpoint (only its input is kept; the backward
    recomputes it); with ``cfg.offload_carries`` too, those inputs (the
    group carries) are kept in page-locked host memory
    (``save_on_cpu``), the counterpart of the JAX policy that offloads
    ``group_carry`` to ``pinned_host``; otherwise past 8 groups
    sqrt-remat checkpoints superblocks of ``n_groups / n_outer`` groups
    around the group checkpoints, so n_outer + n_inner carries live at
    once instead of n_groups."""
    ckpt = lambda fn, z: checkpoint(fn, z, use_reentrant=False,
                                    preserve_rng_state=False)
    group = lambda g: (lambda z: _train_group(params, cfg, g, z, enc_out))
    n = cfg.n_groups
    if not cfg.remat:
        for g in range(n):
            x = group(g)(x)
        return x
    if cfg.offload_carries:
        with torch.autograd.graph.save_on_cpu(pin_memory=x.is_cuda):
            for g in range(n):
                x = ckpt(group(g), x)
        return x
    n_outer = _sqrt_factor(n)
    n_inner = n // n_outer

    def superblock(o):
        def run(z):
            for g in range(o * n_inner, (o + 1) * n_inner):
                z = ckpt(group(g), z)
            return z
        return run

    if n_outer == 1:
        return superblock(0)(x)
    for o in range(n_outer):
        x = ckpt(superblock(o), x)
    return x


def forward_decoder(params: dict, cfg: ModelConfig, x, *, phase: str,
                    cache: dict | None = None, mesh=None,
                    spec_tree: dict | None = None, enc_out=None):
    """Run the decoder over embedded inputs x (B, S, D): a loop over
    layers.  ``spec_tree`` (decode only) marks x as a speculation-tree
    buffer; ``enc_out`` is the encoder output of an encoder-decoder
    config (read in prefill and training); ``mesh`` (prefill and decode)
    distributes the MoE layers (:func:`apply_layer`).  Returns (hidden, cache,
    pendings); phase ``train`` takes no cache and returns (hidden, None,
    [])."""
    if phase == "train":
        assert cache is None, "the training forward takes no cache"
        return _forward_train(params, cfg, x, enc_out), None, []
    pos = cache["pos"] if (cache is not None and phase == "decode") else None
    block_tables = (cache.get("block_tables")
                    if (cache is not None and phase == "decode") else None)
    pendings = []
    for l in range(cfg.n_layers):
        layer_cache = cache["layers"][l] if cache is not None else None
        x, _, pend = apply_layer(params["layers"][l], cfg, cfg.layer_kind(l),
                                 x, layer_cache, pos, phase,
                                 use_moe=cfg.layer_is_moe(l),
                                 block_tables=block_tables,
                                 spec_tree=spec_tree, enc_out=enc_out,
                                 mesh=mesh)
        pendings.append(pend)
    return x, cache, pendings


def logits_from_hidden(params: dict, cfg: ModelConfig, x):
    h = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed(params["embed"], h)


def commit_cache(cfg: ModelConfig, cache: dict, pendings, n_commit,
                 sq: int) -> dict:
    """Finalize a verify step: keep ``n_commit`` (B,) of the ``sq`` written
    tokens, restore the ring rows of the rest (in place), set each
    recurrent layer to its state after ``n_commit`` steps (in place), and
    advance ``pos``.  Full-attention rows past ``pos`` are invisible, so
    they need no undo."""
    nc = n_commit.long()
    for l in range(cfg.n_layers):
        kind = cfg.layer_kind(l)
        if kind == SWA and pendings[l].get("saved"):
            restore_rejected_rows(cache["layers"][l], pendings[l]["saved"],
                                  cache["pos"], nc)
        elif kind in (RGLRU, RWKV):
            sel = (rglru_lib.select_rglru_state if kind == RGLRU
                   else rwkv_lib.select_rwkv_state)
            _set_state(cache["layers"][l],
                       sel(pendings[l]["stack"], torch.clamp(nc, 0, sq)))
    out = {"layers": cache["layers"], "pos": cache["pos"] + nc}
    if "block_tables" in cache:
        out["block_tables"] = cache["block_tables"]
    return out
