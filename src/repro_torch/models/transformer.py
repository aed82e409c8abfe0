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

Over a mesh (``mesh``, :mod:`repro_torch.launch.mesh`) every layer's
parameters are the rank's blocks under :func:`decoder_param_specs`
(one spec a layer: the JAX package's group axis dropped).  Decode steps
take the whole token block on every rank and move no weight; prefill
and training take the rank's rows of the batch (``batch_split``) and
gather each weight's ``"data"`` blocks for the layer's call.  The norms
are replicated.  The recurrent mixers run channel-parallel in every
phase (``repro/models/rglru.py:95-129``, ``repro/models/rwkv.py:
113-130``): the RG-LRU on the rank's W/m channels, RWKV on its H/m heads
(an RWKV layer whose heads do not split over ``"model"`` is gathered
whole for each call).  The recurrent states hold the rank's channels
(the state specs ``rglru_state_specs`` / ``rwkv_state_specs``).  A
cache takes one of two layouts (:func:`init_cache`): the earlier one
holds the whole batch on every rank, with the rank's kv heads where the
heads split over ``"model"`` (the engine's); the production one, which
the cache records, holds the rank's block of the JAX package's
``cache_specs(cfg, cache_batch_spec, kv_seq_spec)``: its rows, its
slice of the slots, every kv head (:mod:`.attention`), and a layer
converts a state between the rows x holds and the rows its cache
holds.

Under the sequence-parallel profile (``seq``, read once a call by
:func:`forward_decoder`) the training carry between layer groups is
the rank's block of the sequence over ``"model"``
(``repro/models/transformer.py:526-531``): each group gathers it at its
start (``:130-136``) and keeps its block at its end, so remat keeps
1/m of each group's input; attention is context-parallel in prefill and
training where the heads do not split (:mod:`.attention`).
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
from repro_torch.launch.mesh import all_gather, axis_size, gather_tree
from repro_torch.models.attention import (CacheLayout, apply_attention,
                                          apply_cross_attention,
                                          attention_specs, cache_rows,
                                          heads_split, init_kv_cache,
                                          init_paged_kv_pool, input_rows,
                                          kv_cache_specs, local_kv_heads,
                                          paged_row_indices,
                                          precompute_cross_kv, quantize_rows,
                                          restore_rejected_rows, row_block)
from repro_torch.models.layers import (active_seq_axis, apply_mlp,
                                       apply_norm, embedding_specs, mlp_specs,
                                       norm_specs, seq_gather, seq_split,
                                       unembed)


# ---------------------------------------------------------------------------
# specs (the JAX package's PartitionSpecs as tuples, one entry a layer)


def layer_specs(cfg: ModelConfig, kind: str, model_size: int,
                use_moe: bool = False) -> dict:
    p = {"ln1": norm_specs(cfg.norm), "ln2": norm_specs(cfg.norm)}
    if kind in (ATTN, SWA):
        p["attn"] = attention_specs()
        if cfg.encoder_decoder:
            p["xattn"] = attention_specs()
            p["ln_x"] = norm_specs(cfg.norm)
        p["ffn"] = (moe_lib.moe_storage_specs(cfg.activation, cfg.n_experts,
                                              model_size) if use_moe
                    else mlp_specs(cfg.activation))
    elif kind == RGLRU:
        p["rec"] = rglru_lib.rglru_specs()
        p["ffn"] = mlp_specs(cfg.activation)
    elif kind == RWKV:
        p["tmix"] = rwkv_lib.tmix_specs()
        p["cmix"] = rwkv_lib.cmix_specs()
    return p


def decoder_param_specs(cfg: ModelConfig, model_size: int = 16,
                        data_size: int = 16) -> dict:
    """The decoder's specs (``data_size`` decides the embedding's D,
    the JAX package's default 16 unless a mesh says otherwise)."""
    return {"embed": embedding_specs(cfg.tie_embeddings, cfg.vocab_size,
                                     cfg.d_model, model_size, data_size),
            "layers": [layer_specs(cfg, cfg.layer_kind(l), model_size,
                                   cfg.layer_is_moe(l))
                       for l in range(cfg.n_layers)],
            "final_norm": norm_specs(cfg.norm)}


def cache_specs(cfg: ModelConfig, batch_spec, seq_spec) -> dict:
    """Specs matching :func:`init_cache`'s layout, one entry a layer."""
    layers = []
    for l in range(cfg.n_layers):
        kind = cfg.layer_kind(l)
        if kind in (ATTN, SWA):
            one = kv_cache_specs(batch_spec, seq_spec,
                                 quant=(kind == ATTN
                                        and cfg.kv_cache_dtype == "int8"))
            if cfg.encoder_decoder and kind == ATTN:
                one["ck"] = (batch_spec, None, None, None)
                one["cv"] = (batch_spec, None, None, None)
        elif kind == RGLRU:
            one = rglru_lib.rglru_state_specs(batch_spec)
        else:
            one = rwkv_lib.rwkv_state_specs(batch_spec)
        layers.append(one)
    return {"layers": layers, "pos": (None,)}


def _set_state(cache: dict | None, new_state: dict) -> None:
    """In place: copy a recurrent layer's new state into its cache."""
    if cache is not None:
        for key, val in new_state.items():
            cache[key].copy_(val)


# the state whose recurrence a mixer runs on the rank's rows of a cache
# in the production layout, in a decode step (x whole: the stationary
# products need every row); the layer gathers its other states' rows
_ROW_STATE = {RGLRU: "h", RWKV: "S"}


def _rows(state: dict, mesh, batch_split: bool, rows=None,
          keep=None) -> dict:
    """A cache's state (its rows: the rank's block over ``rows``, or
    every row) as the layer reads it: the rows x holds
    (:func:`repro_torch.models.attention.input_rows`), ``keep`` (a key)
    as the cache holds it."""
    return {k: v if k == keep else input_rows(v, mesh, batch_split, rows)
            for k, v in state.items()}


def _whole(state: dict, mesh, batch_split: bool, rows=None,
           keep=None) -> dict:
    """The inverse of :func:`_rows`: a state of x's rows as the cache
    holds it."""
    return {k: v if k == keep else cache_rows(v, mesh, batch_split, rows)
            for k, v in state.items()}


def _stack_pending(stack: dict, mesh, rows, keep, b: int) -> dict:
    """A decode's rollback stack (``keep`` the rank's rows, the rest all
    ``b``: x is whole) as the pending of a cache whose rows split over
    ``rows``: the rank's rows, and which they are (``commit_cache``
    reads them)."""
    if rows is None:
        return {"stack": stack}
    rs = row_block(mesh, rows, b)
    return {"stack": {k: v if k == keep else v[rs]
                      for k, v in stack.items()}, "rows": rs}


def _state_shards(cfg: ModelConfig, kind: str, mesh) -> int:
    """Over how many ranks a recurrent layer's channels split: the
    RG-LRU's over ``"model"``, RWKV's where its heads split over it (1:
    the layer is gathered whole)."""
    m = axis_size(mesh, "model") if mesh is not None else 1
    if kind == RWKV and (cfg.d_model // cfg.rwkv_head_size) % m:
        return 1
    return m


def apply_layer(params: dict, cfg: ModelConfig, kind: str, x, cache,
                pos, phase: str, use_moe: bool = False,
                block_tables=None, spec_tree: dict | None = None,
                enc_out=None, mesh=None, batch_split: bool = False,
                seq=None, layout: CacheLayout | None = None):
    """Returns (x, cache, pending).  ``spec_tree`` reaches the attention
    layers only (see :func:`apply_attention`).  With a ``mesh`` the
    layer's parameters are the rank's blocks (see the module's
    docstring) and ``batch_split`` says that x holds the rank's rows of
    the batch (prefill, training), while the cache holds them all.  An
    encoder-decoder attention layer (``xattn`` in ``params``) attends
    over the encoder after its self-attention: prefill computes the
    cross K/V from ``enc_out`` and stores them in the cache's ``ck`` /
    ``cv`` (in place), decode reads them from there.  ``seq``: the
    sequence-parallel axis of a prefill or training call (context
    parallelism, see :func:`repro_torch.models.attention.apply_attention`).
    ``layout``: the cache's production layout (:func:`init_cache`), whose
    rows a layer converts to and from the rows x holds."""
    norm = lambda p, z: apply_norm(p, z, cfg.norm)
    rows = layout.rows if layout is not None else None
    stationary = phase == "decode"
    shards = _state_shards(cfg, kind, mesh)
    rec_mesh = mesh if shards > 1 else None      # channel-parallel mixers
    # a decode step on a production cache runs the recurrence on its rows
    # (a mixer gathered whole gathers its state's rows instead)
    mixer_rows = (rows if cache is not None and not batch_split
                  and rec_mesh is not None else None)
    keep = _ROW_STATE.get(kind) if mixer_rows is not None else None
    if mesh is not None and kind == RWKV and rec_mesh is None:
        params = dict(params,
                      tmix=gather_tree(params["tmix"], rwkv_lib.tmix_specs(),
                                       mesh),
                      cmix=gather_tree(params["cmix"], rwkv_lib.cmix_specs(),
                                       mesh))
    if kind == RGLRU:
        state = (_rows(cache, mesh, batch_split, rows, keep)
                 if cache is not None
                 else rglru_lib.init_rglru_state(x.shape[0],
                                            cfg.rnn_width // shards,
                                            cfg.conv_width, x.dtype,
                                            x.device))
        out, new_state, stack = rglru_lib.apply_rglru_block(
            params["rec"], norm(params["ln1"], x), state, rec_mesh,
            stationary, mixer_rows)
        x = x + out
        x = x + apply_mlp(params["ffn"], norm(params["ln2"], x),
                          cfg.activation, mesh, stationary)
        _set_state(cache, _whole(new_state, mesh, batch_split, rows, keep))
        return x, cache, (_stack_pending(stack, mesh, rows, keep, x.shape[0])
                          if phase == "decode" else {})
    if kind == RWKV:
        state = (_rows(cache, mesh, batch_split, rows, keep)
                 if cache is not None
                 else rwkv_lib.init_rwkv_state(x.shape[0], cfg.d_model,
                                          cfg.rwkv_head_size, x.dtype,
                                          x.device, shards))
        x, new_state, stack = rwkv_lib.apply_rwkv_block(
            params["tmix"], params["cmix"], params["ln1"], params["ln2"], x,
            state, cfg.rwkv_head_size, norm, rec_mesh, stationary,
            mixer_rows)
        _set_state(cache, _whole(new_state, mesh, batch_split, rows, keep))
        return x, cache, (_stack_pending(stack, mesh, rows, keep, x.shape[0])
                          if phase == "decode" else {})
    if kind not in (ATTN, SWA):
        raise ValueError(kind)
    window = cfg.sliding_window if kind == SWA else None
    out, cache, saved = apply_attention(
        params["attn"], apply_norm(params["ln1"], x, cfg.norm),
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope, window=window, cache=cache, pos=pos,
        phase=phase, block_tables=block_tables if kind == ATTN else None,
        spec_tree=spec_tree, mesh=mesh, batch_split=batch_split, seq=seq,
        layout=layout)
    x = x + out
    if "xattn" in params:
        heads = dict(n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim)
        cached = phase != "prefill" and cache is not None and "ck" in cache
        if cached:
            cross = {"ck": cache["ck"], "cv": cache["cv"]}
        else:
            cross = precompute_cross_kv(params["xattn"], enc_out,
                                        n_heads=cfg.n_heads, mesh=mesh,
                                        **heads)
            if cache is not None and "ck" in cache:
                keep = cross
                if layout is not None and heads_split(cfg.n_heads,
                                                      cfg.n_kv_heads, mesh):
                    # the production layout holds every head
                    keep = {k: all_gather(v, mesh, "model", 2)
                            for k, v in cross.items()}
                whole = _whole(keep, mesh, batch_split, rows)
                cache["ck"].copy_(whole["ck"])
                cache["cv"].copy_(whole["cv"])
        x = x + apply_cross_attention(params["xattn"],
                                      norm(params["ln_x"], x), cross,
                                      n_heads=cfg.n_heads, mesh=mesh,
                                      stationary=stationary,
                                      layout=layout if cached else None,
                                      **heads)
    h = apply_norm(params["ln2"], x, cfg.norm)
    if use_moe:
        # decode steps are few-token: dropless dispatch keeps speculative
        # verification exact (no batch-dependent drops)
        cf = (float("inf") if (cfg.moe_dropless or phase == "decode")
              else cfg.capacity_factor)
        f = moe_lib.apply_moe(params["ffn"], h, n_experts=cfg.n_experts,
                              top_k=cfg.top_k, activation=cfg.activation,
                              mesh=mesh, capacity_factor=cf,
                              stationary=stationary,
                              x_spec=("data" if batch_split else None,
                                      None, None))
    else:
        f = apply_mlp(params["ffn"], h, cfg.activation, mesh, stationary)
    x = x + f
    pending = {"saved": saved} if phase == "decode" else {}
    return x, cache, pending


# ---------------------------------------------------------------------------
# caches


def _block_size(n: int, mesh, axis, what: str) -> int:
    """The rank's share of ``n`` split over ``axis`` (None: all of it);
    a count that does not split raises."""
    if axis is None:
        return n
    size = axis_size(mesh, axis)
    if n % size:
        raise ValueError(f"{n} {what} do not split over the {size} ranks of "
                         f"axis {axis!r}")
    return n // size


def init_layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     device, mesh=None,
                     layout: CacheLayout | None = None) -> dict:
    """One layer's cache; an encoder-decoder ATTN layer also holds the
    cross K/V ``ck`` / ``cv`` (B, encoder_len, Hkv, d).  Over a ``mesh``
    the recurrent states hold the rank's channels; the attention caches
    hold the rank's kv heads (:func:`repro_torch.models.attention.
    local_kv_heads`) and every row, or, with a ``layout``, every kv head
    of the rank's block of the rows and of the slots (the cross K/V: of
    the rows), the recurrent states the rank's rows."""
    shards = _state_shards(cfg, kind, mesh)
    hkv = (local_kv_heads(cfg.n_heads, cfg.n_kv_heads, mesh)
           if layout is None else cfg.n_kv_heads)
    layout = layout or CacheLayout()
    batch = _block_size(batch, mesh, layout.rows, "batch rows")
    slots = lambda n: _block_size(n, mesh, layout.slots,  # noqa: E731
                                  "cache slots")
    if kind == ATTN:
        c = init_kv_cache(batch, slots(max_len), hkv, cfg.head_dim,
                          cfg.torch_dtype, device,
                          quant=cfg.kv_cache_dtype == "int8")
        if cfg.encoder_decoder:
            shape = (batch, cfg.encoder_len, hkv, cfg.head_dim)
            c["ck"] = torch.zeros(shape, dtype=cfg.torch_dtype, device=device)
            c["cv"] = torch.zeros_like(c["ck"])
        return c
    if kind == SWA:
        return init_kv_cache(batch, slots(min(cfg.sliding_window, max_len)),
                             hkv, cfg.head_dim, cfg.torch_dtype, device)
    if kind == RGLRU:
        return rglru_lib.init_rglru_state(batch, cfg.rnn_width // shards,
                                          cfg.conv_width, cfg.torch_dtype,
                                          device)
    if kind == RWKV:
        return rwkv_lib.init_rwkv_state(batch, cfg.d_model,
                                        cfg.rwkv_head_size, cfg.torch_dtype,
                                        device, shards)
    raise ValueError(kind)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda", mesh=None, layout=None) -> dict:
    """The decode cache: one dict a layer (:func:`init_layer_cache`) and
    ``pos`` (B,).  Over a ``mesh``, without ``layout``, the earlier
    layout (every row, the rank's kv heads where they split); with
    ``layout`` (a :class:`CacheLayout`, or the JAX package's
    ``(cache_batch_spec, kv_seq_spec)`` pair) the rank's block of JAX's
    ``cache_specs(cfg, batch_spec, seq_spec)``, recorded under
    ``"layout"``, which ``prefill``, ``decode`` and ``commit_cache``
    read.  ``pos`` stays whole."""
    device = resolve_device(device)
    if layout is not None:
        if mesh is None:
            raise ValueError("a cache layout needs a mesh")
        if not isinstance(layout, CacheLayout):
            layout = CacheLayout(*layout)
        names = tuple(getattr(mesh, "mesh_dim_names", None) or ())
        if "pod" in names and layout.rows == "data":
            # "data" names ("pod", "data") here (launch/mesh.py)
            raise ValueError("rows split over 'data' alone on a mesh with "
                             "'pod' have no name in the port")
    cache = {"layers": [init_layer_cache(cfg, cfg.layer_kind(l), batch,
                                         max_len, device, mesh, layout)
                        for l in range(cfg.n_layers)],
             "pos": torch.zeros((batch,), dtype=torch.int64, device=device)}
    if layout is not None:
        cache["layout"] = layout
    return cache


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


def _train_group(params: dict, cfg: ModelConfig, group: int, x, enc_out,
                 mesh, seq=None):
    """The layers of pattern group ``group`` over x, phase ``train``
    (over a ``mesh``, x the rank's rows of the batch; with ``seq``, its
    block of the sequence, gathered here and split again at the end)."""
    p = len(cfg.layer_pattern)
    x = seq_gather(x, mesh, seq)
    for l in range(group * p, (group + 1) * p):
        x, _, _ = apply_layer(params["layers"][l], cfg, cfg.layer_kind(l), x,
                              None, None, "train",
                              use_moe=cfg.layer_is_moe(l), enc_out=enc_out,
                              mesh=mesh, batch_split=mesh is not None,
                              seq=seq)
    return seq_split(x, mesh, seq)


def _forward_train(params: dict, cfg: ModelConfig, x, enc_out, mesh=None,
                   seq=None):
    """The cache-less training forward (``repro/models/transformer.py:
    520-560``): one group of the pattern at a time.  With ``cfg.remat``
    each group is a checkpoint (only its input is kept; the backward
    recomputes it); with ``cfg.offload_carries`` too, those inputs (the
    group carries) are kept in page-locked host memory
    (``save_on_cpu``), the counterpart of the JAX policy that offloads
    ``group_carry`` to ``pinned_host``; otherwise past 8 groups
    sqrt-remat checkpoints superblocks of ``n_groups / n_outer`` groups
    around the group checkpoints, so n_outer + n_inner carries live at
    once instead of n_groups.  With ``seq`` the carries are the rank's
    blocks of the sequence; the result is gathered whole."""
    x = seq_split(x, mesh, seq)
    return seq_gather(_train_groups(params, cfg, x, enc_out, mesh, seq),
                      mesh, seq)


def _offloaded(x):
    """``save_on_cpu`` for the saved group carries; on meta tensors (the
    dry run, which has no data to copy) saved tensors that keep only
    their shapes, as the host copy frees the card's."""
    if not x.is_meta:
        return torch.autograd.graph.save_on_cpu(pin_memory=x.is_cuda)
    return torch.autograd.graph.saved_tensors_hooks(
        lambda t: (t.shape, t.dtype),
        lambda s: torch.empty(s[0], dtype=s[1], device="meta"))


def _train_groups(params: dict, cfg: ModelConfig, x, enc_out, mesh, seq):
    ckpt = lambda fn, z: checkpoint(fn, z, use_reentrant=False,
                                    preserve_rng_state=False)
    group = lambda g: (lambda z: _train_group(params, cfg, g, z, enc_out,
                                              mesh, seq))
    n = cfg.n_groups
    if not cfg.remat:
        for g in range(n):
            x = group(g)(x)
        return x
    if cfg.offload_carries:
        with _offloaded(x):
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
                    spec_tree: dict | None = None, enc_out=None,
                    batch_split: bool = False):
    """Run the decoder over embedded inputs x (B, S, D): a loop over
    layers.  ``spec_tree`` (decode only) marks x as a speculation-tree
    buffer; ``enc_out`` is the encoder output of an encoder-decoder
    config (read in prefill and training); ``mesh`` distributes every
    layer, and ``batch_split`` (prefill) says x holds the rank's rows
    of the batch (:func:`apply_layer`; training always splits it).
    Prefill and training read the sequence-parallel profile here, once
    (:func:`repro_torch.models.layers.sequence_sharding`); decode never
    does.  Returns (hidden, cache, pendings); phase ``train`` takes no
    cache and returns (hidden, None, [])."""
    seq = active_seq_axis(mesh) if phase != "decode" else None
    if phase == "train":
        assert cache is None, "the training forward takes no cache"
        return _forward_train(params, cfg, x, enc_out, mesh, seq), None, []
    pos = cache["pos"] if (cache is not None and phase == "decode") else None
    layout = cache.get("layout") if cache is not None else None
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
                                 mesh=mesh, batch_split=batch_split, seq=seq,
                                 layout=layout)
        pendings.append(pend)
    return x, cache, pendings


def logits_from_hidden(params: dict, cfg: ModelConfig, x, mesh=None,
                       stationary: bool = False):
    h = apply_norm(params["final_norm"], x, cfg.norm)
    return unembed(params["embed"], h, mesh, embed_specs(cfg, mesh),
                   stationary)


def embed_specs(cfg: ModelConfig, mesh) -> dict | None:
    """The embedding's specs at ``mesh``'s sizes (None off a mesh)."""
    if mesh is None:
        return None
    return embedding_specs(cfg.tie_embeddings, cfg.vocab_size, cfg.d_model,
                           axis_size(mesh, "model"), axis_size(mesh, "data"))


def commit_cache(cfg: ModelConfig, cache: dict, pendings, n_commit,
                 sq: int) -> dict:
    """Finalize a verify step: keep ``n_commit`` (B,) of the ``sq`` written
    tokens, restore the ring rows of the rest (in place), set each
    recurrent layer to its state after ``n_commit`` steps (in place), and
    advance ``pos``.  Full-attention rows past ``pos`` are invisible, so
    they need no undo.  In the production layout the pendings name the
    rank's rows (and the ring's slots) they hold."""
    nc = n_commit.long()
    for l in range(cfg.n_layers):
        kind = cfg.layer_kind(l)
        if kind == SWA and pendings[l].get("saved"):
            restore_rejected_rows(cache["layers"][l], pendings[l]["saved"],
                                  cache["pos"], nc)
        elif kind in (RGLRU, RWKV):
            sel = (rglru_lib.select_rglru_state if kind == RGLRU
                   else rwkv_lib.select_rwkv_state)
            mine = nc[pendings[l].get("rows", slice(None))]
            _set_state(cache["layers"][l],
                       sel(pendings[l]["stack"], torch.clamp(mine, 0, sq)))
    out = {"layers": cache["layers"], "pos": cache["pos"] + nc}
    for key in ("block_tables", "layout"):
        if key in cache:
            out[key] = cache[key]
    return out
