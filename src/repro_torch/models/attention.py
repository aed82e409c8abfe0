"""Attention: GQA with RoPE, full/sliding-window variants, KV caches.

Counterpart of ``repro/models/attention.py`` (the prefill phase, the
chain and tree decode phases, and the Whisper decoder's cross
attention).  Layouts are the JAX package's: activations
``(B, S, H, d)``, contiguous caches ``(B, n_slots, Hkv, d)``, the paged
pool ``(NB, BS, Hkv, d)``.

KV caches are updated **in place**: every write helper mutates the
cache tensors it is given and returns the same dict.

On CUDA tensors prefill and cross attention run the flash-attention
kernel, paged verify the paged-decode kernel, and verify over a
contiguous, non-ring cache and a one-token decode over a sliding-window
ring the decode-attention kernel; on CPU tensors they run the plain
paths the JAX package runs off the TPU (``attention_chunked``;
``attention_direct``; ``paged_gather`` + ``attention_direct``;
``attention_direct``).  A CUDA tensor never
reaches a plain version of a kernel.  A speculation tree's full buffer
(``spec_tree`` with ``prev == 0``) goes to the verify kernels with its
ancestor bitmasks; a tree level fed after ``prev > 0`` buffer rows takes
the plain masked path on both devices, as in the JAX package (the
kernels mask only the last m rows and cannot see a partial buffer).
A multi-token verify over a sliding-window ring has no kernel and stays
plain PyTorch on both devices.

Over a mesh (``mesh``; the weights the rank's blocks at rest,
:func:`attention_specs`) q/k/v are column products and ``wo`` a row
product (:mod:`repro_torch.models.layers`: weight-stationary in decode,
the ``"data"`` blocks gathered for a prefill or training call).  Where
``n_heads`` and ``n_kv_heads`` both split over ``"model"``
(:func:`heads_split`) each rank attends over its own heads and its
caches hold its kv heads; otherwise the rank gathers the q/k/v
activations over ``"model"``, attends over every head and keeps every
kv head.  The same kernels run either way, on fewer heads when split.

Two cache layouts over a mesh.  The earlier one (a cache from
``init_cache(..., mesh=)``, what ``SpecOffloadEngine`` on a mesh reads):
every rank holds every batch row, and the rank's kv heads where the
heads split; a prefill whose batch splits over ``"data"`` gathers the
rows it writes.  The production one (``init_cache(..., layout=)``, the
JAX package's ``cache_specs(cfg, cache_batch_spec, kv_seq_spec)``; the
cache records it as a :class:`CacheLayout`): the rank holds its block of
the rows over the batch axes and its contiguous block of the slots over
the sequence axes (``"model"``, or every axis at ``long_500k``), with
every kv head.  A prefill writes the rank's rows and slots of the K/V it
holds (its rows already; the heads gathered where they split).  A decode
step attends the rank's rows over its slots, at their global positions
(``decode_attention`` with ``kv_offset`` and ``return_lse`` on a
contiguous cache, the plain ring attention of a sliding-window layer),
and the partials merge over the sequence axes by their log-sum-exp (the
exact softmax: :func:`merge_partials`); the output rows are gathered
over the batch axes before ``wo``, so every rank returns the whole
output.  A write of positions that straddle two ranks' slots goes to
both owners; the in-flight rows of a ring's multi-token verify are
counted by the first rank of the sequence axes alone.

Context parallelism (``repro/models/attention.py:587-598``): in prefill
and training under the sequence-parallel profile (``seq``, see
:func:`repro_torch.models.layers.sequence_sharding`), where the heads do
not split, each rank attends its own block of the queries, at their
positions, over the whole K/V, instead of every rank attending every
query.  The rank's column block of q for the whole sequence is
exchanged (``all_to_all``) into its sequence block of every head, k and
v are gathered over ``"model"`` as on the gathered route, and the flash
kernel runs with ``q_offset`` at the block's first position.  After it
the output is exchanged back into the rank's column block of the whole
sequence for the ``wo`` row product.  Only activations move; each
rank's queries give a partial dK / dV, which the gather's backward sums
over ``"model"``.  A prefill whose length does not split over the axis
takes the gathered route; a training sequence that does not raises.

Training (``phase="train"``, no cache) and any attention call whose
inputs need a gradient go through :class:`FlashAttentionFn`: the
forward kernel with its log-sum-exp, then the backward kernel
(``flash_attention_bwd``), the counterpart of the JAX package's custom
VJP (``_attention_flash``); on CPU tensors the same Function runs the
two plain versions.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fb
from repro_torch.kernels import paged_decode_attention as _pd
from repro_torch.kernels.ref import NEG_INF, gather_paged_kv_ref
from repro_torch.launch.mesh import (all_gather, all_reduce, all_to_all,
                                     axis_index, axis_size, block)
from repro_torch.models.layers import (COL, ROW, apply_rope, col_product,
                                       model_input, rope_table, row_product)


@dataclasses.dataclass(frozen=True)
class CacheLayout:
    """The production layout a cache records (under ``"layout"``): its
    rows split over ``rows`` (the batch axes, or None: every row), its
    slots over ``slots`` (an axis or a tuple of axes, or None), every kv
    head whole."""
    rows: object = None
    slots: object = None


def slot_geometry(n_local: int, mesh, slots) -> tuple:
    """(offset, global slots) of a rank's ``n_local`` contiguous slots:
    its block along ``slots``."""
    if slots is None or mesh is None:
        return 0, n_local
    return axis_index(mesh, slots) * n_local, n_local * axis_size(mesh,
                                                                 slots)


def row_block(mesh, rows, b: int) -> slice:
    """The rank's rows of a batch of ``b`` split over ``rows``."""
    if rows is None:
        return slice(0, b)
    n = b // axis_size(mesh, rows)
    r0 = axis_index(mesh, rows) * n
    return slice(r0, r0 + n)


def attention_specs() -> dict:
    return {"wq": COL, "wk": COL, "wv": COL, "wo": ROW}


def kv_cache_specs(batch_spec, seq_spec, quant: bool = False) -> dict:
    spec = (batch_spec, seq_spec, None, None)
    out = {"k": spec, "v": spec}
    if quant:
        out["k_scale"] = spec
        out["v_scale"] = spec
    return out


def heads_split(n_heads: int, n_kv_heads: int, mesh) -> bool:
    """Whether each rank of ``mesh`` attends over its own block of the
    heads (both counts split over ``"model"``), rather than over all."""
    if mesh is None:
        return True
    m = axis_size(mesh, "model")
    return n_heads % m == 0 and n_kv_heads % m == 0


def local_kv_heads(n_heads: int, n_kv_heads: int, mesh) -> int:
    """The kv heads a rank's caches hold."""
    if mesh is None or not heads_split(n_heads, n_kv_heads, mesh):
        return n_kv_heads
    return n_kv_heads // axis_size(mesh, "model")


def _heads_in(xin, ws, mesh, stationary, gather, head_dim):
    """Column products of ``xin`` by each of ``ws``, as (B, S, heads,
    d): the rank's heads, or, with ``gather``, every head (the flat
    outputs gathered over ``"model"``; backward a reduce-scatter)."""
    out = []
    for w in ws:
        y = col_product(xin, w, mesh, stationary)
        if gather:
            y = all_gather(y, mesh, "model", -1, grad="sum")
        out.append(y.reshape(*y.shape[:2], -1, head_dim))
    return out


def _seq_blocks(y, mesh, axis):
    """(B, S, n) the rank's column block over the whole sequence ->
    (B, S/m, m n): its sequence block of every column (``all_to_all``)."""
    m = axis_size(mesh, axis)
    b, s, n = y.shape
    y = all_to_all(y.reshape(b, m, s // m, n).transpose(0, 1), mesh, axis)
    return y.permute(1, 2, 0, 3).reshape(b, s // m, m * n)


def _col_blocks(o, mesh, axis):
    """The inverse of :func:`_seq_blocks`: (B, S/m, N) -> (B, S, N/m)."""
    m = axis_size(mesh, axis)
    b, sl, n = o.shape
    o = all_to_all(o.reshape(b, sl, m, n // m).permute(2, 0, 1, 3), mesh,
                   axis)
    return o.transpose(0, 1).reshape(b, m * sl, n // m)


def _heads_out(out, wo, mesh, stationary, gather):
    """The attention output (B, S, heads*d) times ``wo``: with
    ``gather`` the rank keeps its ``"model"`` block of the flat heads
    first."""
    if gather:
        out = block(out, mesh, "model", -1)
    return row_product(out, wo, mesh, stationary)


# ---------------------------------------------------------------------------
# masking helpers


def ring_slot_positions(n_slots: int, length, window: int) -> torch.Tensor:
    """Logical position held by each ring-buffer slot given cache length
    (``length``: (B,) tokens written so far).  Slots not yet written get a
    negative position.  Output (B, n_slots)."""
    j = torch.arange(n_slots, dtype=torch.int64, device=length.device)
    last = length.long()[:, None] - 1
    return last - torch.remainder(last - j, window)


def attention_mask(q_positions, kv_positions, window: int | None,
                   causal: bool = True) -> torch.Tensor:
    """Additive f32 mask, 0 allowed / NEG_INF disallowed.  ``q_positions``
    (Sq,) or (B, Sq); ``kv_positions`` (Skv,) or (B, Skv); the result
    broadcasts to (..., Sq, Skv)."""
    qp = q_positions[..., :, None]
    kp = kv_positions[..., None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    return torch.where(ok, 0.0, NEG_INF).float()


def _tree_decode_mask(base, tree_mask, n_kv: int) -> torch.Tensor:
    """Additive (B, Sq, n_kv) mask for one tree-speculation decode step.

    ``base`` (B,) is where the speculation buffer starts in the cache;
    ``tree_mask`` (Sq, W) bool is the ancestor-or-self visibility of the
    Sq fed nodes over the W buffer rows written so far.  Committed rows
    (< base) stay fully visible, buffer rows [base, base+W) follow the
    tree mask, and stale rows past the buffer are hidden.
    """
    w = tree_mask.shape[1]
    kv_idx = torch.arange(n_kv, device=base.device)[None, :]
    col = kv_idx - base.long()[:, None]                      # (B, n_kv)
    allowed = tree_mask[:, col.clamp(0, w - 1)].permute(1, 0, 2)
    ok = (col < 0)[:, None, :] | (((col >= 0) & (col < w))[:, None, :]
                                  & allowed)
    return torch.where(ok, 0.0, NEG_INF).float()


#: profiler range around a tree feed's plain masked attention (on the
#: card only the draft's level feeds take it); ``launch/profile_serve.py``
#: reads it
TREE_PLAIN_RANGE = "tree feed attention (plain)"


def _tree_attention_plain(q, k, v, base, tree_mask, scale):
    """Attention of tree nodes over the whole cache under
    :func:`_tree_decode_mask`, inside the :data:`TREE_PLAIN_RANGE`
    profiler range."""
    with torch.profiler.record_function(TREE_PLAIN_RANGE):
        mask = _tree_decode_mask(base, tree_mask, k.shape[1])
        return attention_direct(q, k, v, mask, scale)


# ---------------------------------------------------------------------------
# attention cores (GQA-aware)


def attention_direct(q, k, v, mask, scale: float) -> torch.Tensor:
    """Masked softmax attention; q (B,Sq,Hq,d), k/v (B,Skv,Hkv,d);
    ``mask`` (Sq, Skv) or (B, Sq, Skv).  Returns (B, Sq, Hq*d)."""
    b, sq, hq, d = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, sq, n_kv, hq // n_kv, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if mask.dim() == 2:
        mask = mask[None]
    s = s + mask[:, None, None]
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    return out.reshape(b, sq, -1).to(q.dtype)


def attention_direct_lse(q, k, v, mask, scale: float) -> tuple:
    """:func:`attention_direct` with each row's log-sum-exp: (out (B, Sq,
    Hq*d) in q's dtype, lse (B, Sq, Hq) f32).  A row with no visible key
    gives 0 and -inf (a rank's slice of a split cache may hold none)."""
    b, sq, hq, d = q.shape
    n_kv = k.shape[2]
    qg = q.reshape(b, sq, n_kv, hq // n_kv, d).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if mask.dim() == 2:
        mask = mask[None]
    s = s + mask[:, None, None]
    seen = (mask > NEG_INF / 2).any(-1)[:, None, None]          # (B,1,1,Sq)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p.to(v.dtype).float(), v.float())
    out = torch.where(seen.permute(0, 3, 1, 2)[..., None], out, 0.0)
    lse = torch.where(seen, torch.logsumexp(s, -1), -math.inf)
    return (out.reshape(b, sq, -1).to(q.dtype),
            lse.permute(0, 3, 1, 2).reshape(b, sq, hq))


def lse_weights(every):
    """The weight of each slice's normalised partial in the softmax over
    all of them, from their log-sum-exps ``every`` (n, ...): exp(lse -
    max) over the sum of those, 0 for a slice with no visible key (-inf),
    never NaN (0 everywhere where no slice holds one)."""
    top = every.amax(0)
    top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
    w = torch.exp(every - top)
    return w / w.sum(0).clamp_min(1e-30)


def merge_partials(out, lse, mesh, axis):
    """The attention over slots split over ``axis`` from each rank's
    normalised partial ``out`` (B, Sq, Hq*d) and its log-sum-exp ``lse``
    (B, Sq, Hq): every rank's lse gathered, the rank's partial weighted
    by :func:`lse_weights` and the weighted partials summed over
    ``axis``.  The result is in ``out``'s dtype."""
    if mesh is None or axis is None or axis_size(mesh, axis) == 1:
        return out
    every = all_gather(lse[None], mesh, axis, 0)              # (n, B, Sq, Hq)
    w = lse_weights(every)[axis_index(mesh, axis)]
    b, sq, hq = lse.shape
    o = out.float().reshape(b, sq, hq, -1) * w[..., None]
    return all_reduce(o.reshape(b, sq, -1), mesh, axis).to(out.dtype)


def attention_chunked(q, k, v, q_positions, kv_positions, scale: float,
                      window: int | None = None, causal: bool = True,
                      kv_chunk: int = 512) -> torch.Tensor:
    """Online-softmax attention over KV chunks (the forward of the JAX
    package's flash-style ``attention_chunked``): the plain prefill.
    q (B,Sq,Hq,d), k/v (B,Skv,Hkv,d) -> (B, Sq, Hq*d)."""
    b, sq, hq, d = q.shape
    skv, n_kv = k.shape[1], k.shape[2]
    g = hq // n_kv
    qg = q.reshape(b, sq, n_kv, g, d)
    kv_chunk = min(kv_chunk, skv)
    n_chunks = math.ceil(skv / kv_chunk)
    pad = n_chunks * kv_chunk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad),
                                               value=-1)
    m = torch.full((b, n_kv, g, sq), NEG_INF, device=q.device)
    l = torch.zeros((b, n_kv, g, sq), device=q.device)
    acc = torch.zeros((b, n_kv, g, sq, d), device=q.device)
    for i in range(n_chunks):
        sl = slice(i * kv_chunk, (i + 1) * kv_chunk)
        k_i, v_i = k[:, sl], v[:, sl]
        mask_i = attention_mask(q_positions, kv_positions[sl], window, causal)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_i.float()) * scale
        s = s + mask_i[None, None, None]
        m_new = torch.maximum(m, s.amax(-1))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(v_i.dtype).float(),
                          v_i.float())
        acc = acc * corr[..., None] + pv
        m = m_new
    out = acc / torch.clamp_min(l, 1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq * d).to(q.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a hand-written backward: the counterpart of
    the JAX package's ``_attention_flash`` custom VJP
    (``repro/models/attention.py:206-272``).  Takes and returns (B, H, S,
    d) tensors (the model's (B, S, H, d) ones as transposed views).  The
    forward runs ``flash_attention`` with ``return_lse`` and saves q, k,
    v, the output and the log-sum-exp; the backward runs
    ``flash_attention_bwd`` on them.  On CUDA tensors both are kernels,
    on CPU tensors both wrappers return their plain versions.
    ``q_offset`` places query row i at position ``q_offset + i``
    (context parallelism)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal, window, q_offset=0):
        out, lse = _fa.flash_attention(q, k, v, scale=scale, causal=causal,
                                       window=window, return_lse=True,
                                       q_offset=q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.mask = (scale, causal, window, q_offset)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        scale, causal, window, q_offset = ctx.mask
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        dq, dk, dv = _fb.flash_attention_bwd(q, k, v, out, lse, dout,
                                             scale=scale, causal=causal,
                                             window=window, q_offset=q_offset)
        return dq, dk, dv, None, None, None, None


def on_card(x) -> bool:
    """Whether a call takes the kernels' route: CUDA tensors, or meta ones
    (``launch/dryrun.py``, where each kernel wrapper stands for its
    kernel); CPU tensors take the plain paths."""
    return x.is_cuda or x.is_meta


def needs_grad(*tensors) -> bool:
    """Whether autograd records a call on these tensors."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_bshd(q, k, v, scale: float, causal: bool,
               window: int | None = None, q_offset: int = 0) -> torch.Tensor:
    """The ``flash_attention`` kernel over the model's (B, S, H, d) q and
    k/v, handed over as transposed views (the kernel reads them, and
    writes the output, through their strides), through
    :class:`FlashAttentionFn` when a gradient is needed; query row i at
    position ``q_offset + i``.  Returns (B, Sq, Hq*d)."""
    b, sq, hq, d = q.shape
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if needs_grad(q, k, v):
        out = FlashAttentionFn.apply(qt, kt, vt, scale, causal, window,
                                     q_offset)
    else:
        out = _fa.flash_attention(qt, kt, vt, scale=scale, causal=causal,
                                  window=window, q_offset=q_offset)
    return out.transpose(1, 2).reshape(b, sq, hq * d)


# ---------------------------------------------------------------------------
# KV cache (optionally int8: per-row-per-head absmax scales)


def init_kv_cache(batch: int, n_slots: int, n_kv_heads: int, head_dim: int,
                  dtype, device, quant: bool = False) -> dict:
    shape = (batch, n_slots, n_kv_heads, head_dim)
    if quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:3] + (1,), device=device),
                "v_scale": torch.zeros(shape[:3] + (1,), device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def quantize_rows(x: torch.Tensor):
    """(..., d) -> (int8 values, f32 absmax/127 scale with kept dim);
    rounds half to even, like ``jnp.round``."""
    xf = x.float()
    scale = xf.abs().amax(-1, keepdim=True) / 127.0
    q = torch.round(xf / torch.clamp_min(scale, 1e-9))
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


# ---------------------------------------------------------------------------
# paged KV pool (block-table indexed; shared across the batch)


def init_paged_kv_pool(num_blocks: int, block_size: int, n_kv_heads: int,
                       head_dim: int, dtype, device,
                       quant: bool = False) -> dict:
    """Block pool ``(NB, BS, Hkv, d)`` shared by every sequence of a
    half-batch; ``quant`` stores int8 values + f32 per-row scales."""
    return init_kv_cache(num_blocks, block_size, n_kv_heads, head_dim, dtype,
                         device, quant=quant)


def paged_row_indices(block_tables, positions, block_size: int):
    """Flat pool-row index for each logical ``positions`` (B, N) entry.
    Out-of-table positions clamp to the last table entry and null (<= 0)
    entries resolve to the scratch block 0."""
    bt = block_tables.long()
    mbs = bt.shape[1]
    blk = torch.clamp(positions // block_size, 0, mbs - 1)
    bids = torch.gather(bt, 1, blk).clamp_min(0)
    return bids * block_size + positions % block_size


def _pool_scatter(pool, flat_idx, rows) -> None:
    """In place: rows (..., H, d) at flat row indices of a (NB, BS, H, d)
    pool.  Duplicate indices only come from dead slots aimed at the
    scratch block, where any write order is acceptable."""
    nb, bs = pool.shape[:2]
    pool.view((nb * bs,) + pool.shape[2:])[flat_idx] = (
        rows.reshape((-1,) + pool.shape[2:]).to(pool.dtype))


def paged_write(cache: dict, k_new, v_new, block_tables, pos) -> dict:
    """In place: scatter Sq new K/V rows per sequence into the pool at
    logical positions [pos, pos+Sq) via the block table, quantizing on
    write when the pool is int8."""
    bs = cache["k"].shape[1]
    b, sq = k_new.shape[:2]
    positions = pos.long()[:, None] + torch.arange(sq, device=pos.device)
    idx = paged_row_indices(block_tables, positions, bs).reshape(-1)
    if "k_scale" in cache:
        kq, ks = quantize_rows(k_new)
        vq, vs = quantize_rows(v_new)
        for key, rows in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            _pool_scatter(cache[key], idx, rows)
    else:
        _pool_scatter(cache["k"], idx, k_new)
        _pool_scatter(cache["v"], idx, v_new)
    return cache


def paged_gather(cache: dict, block_tables, dtype):
    """Per-sequence contiguous (B, MBS*BS, H, d) K/V view of the pool
    (dequantized when int8): the CPU read path."""
    return gather_paged_kv_ref(cache["k"], cache["v"], block_tables,
                               k_scale=cache.get("k_scale"),
                               v_scale=cache.get("v_scale"), dtype=dtype)


def _slots(pos, sq: int, n_slots: int, ring: bool):
    """(B, Sq) cache slots of logical positions [pos, pos+Sq): modulo the
    ring, else clamped to the last slot (the JAX package's
    ``dynamic_update_slice`` clamps its start index the same way)."""
    slot = pos.long()[:, None] + torch.arange(sq, device=pos.device)
    return torch.remainder(slot, n_slots) if ring else slot.clamp(0, n_slots - 1)


def _write_cache(cache: dict, k_new, v_new, pos, window: int | None) -> dict:
    """In place: write Sq new K/V rows per sequence starting at logical
    ``pos`` (B,) — at ``pos % n_slots`` when ``window`` (a ring)."""
    b, sq = k_new.shape[:2]
    n_slots = cache["k"].shape[1]
    slots = _slots(pos, sq, n_slots, window is not None)
    rows = torch.arange(b, device=pos.device)[:, None]
    cache["k"][rows, slots] = k_new.to(cache["k"].dtype)
    cache["v"][rows, slots] = v_new.to(cache["v"].dtype)
    return cache


def _gather_rows(cache: dict, pos, sq: int) -> dict:
    """Copies of the Sq ring rows a write at ``pos`` would clobber."""
    b, n_slots = cache["k"].shape[:2]
    slots = _slots(pos, sq, n_slots, True)
    rows = torch.arange(b, device=pos.device)[:, None]
    return {"k": cache["k"][rows, slots], "v": cache["v"][rows, slots]}


def _local_slots(pos, sq: int, n_local: int, off: int, n_glob: int,
                 ring: bool) -> tuple:
    """(slot, owned), each (B, Sq): the rank's slot (clamped into its
    block) of each of the global slots of [pos, pos+Sq) (:func:`_slots`
    over ``n_glob``), and whether the rank's block [off, off + n_local)
    holds it."""
    loc = _slots(pos, sq, n_glob, ring) - off
    owned = (loc >= 0) & (loc < n_local)
    return loc.clamp(0, n_local - 1), owned


def _write_owned(t, new, loc, owned) -> None:
    """In place: ``new`` (B, Sq, ...) into ``t`` (B, slots, ...) at the
    owned ``loc``, one token column at a time (the clamped slots of the
    rows not owned write back what they read: no two writes of one
    assignment meet)."""
    rows = torch.arange(t.shape[0], device=t.device)
    for i in range(loc.shape[1]):
        li, own = loc[:, i], owned[:, i].reshape((-1,) + (1,) * (t.dim() - 2))
        t[rows, li] = torch.where(own, new[:, i].to(t.dtype), t[rows, li])


def restore_rejected_rows(cache: dict, saved: dict, pos, n_commit) -> dict:
    """In place: undo ring writes of rejected speculative tokens — row i of
    ``saved`` goes back where ``i >= n_commit`` (per sequence).  A
    ``saved`` of a rank's block of a split ring (its ``"rows"`` slice,
    ``"slot"`` / ``"owned"``) restores the rank's rows and slots only."""
    if "slot" in saved:
        rows = saved["rows"]
        reject = (torch.arange(saved["slot"].shape[1], device=pos.device)
                  [None, :] >= n_commit.long()[rows, None])
        for key in ("k", "v"):
            _write_owned(cache[key], saved[key], saved["slot"],
                         saved["owned"] & reject)
        return cache
    b, n_slots = cache["k"].shape[:2]
    sq = saved["k"].shape[1]
    slots = _slots(pos, sq, n_slots, True)
    rows = torch.arange(b, device=pos.device)[:, None]
    keep = (torch.arange(sq, device=pos.device)[None, :]
            < n_commit.long()[:, None])[..., None, None]
    for key in ("k", "v"):
        cur = cache[key][rows, slots]
        cache[key][rows, slots] = torch.where(keep, cur, saved[key])
    return cache


def _prefill_write(cache: dict, k, v, window: int | None, off: int,
                   n_glob: int) -> None:
    """In place: a prefill's K/V (the cache's rows and heads, positions
    [0, S)) into a cache that holds slots [off, off + n_local) of
    ``n_glob`` (the whole cache: 0 and its own size): where a ring is
    shorter than S, its slots' positions among the last ``window``,
    else the positions the slots hold."""
    s = k.shape[1]
    n_loc = cache["k"].shape[1]
    if window is not None and n_glob < s:
        length = torch.full((1,), s, device=k.device)
        idx = ring_slot_positions(n_glob, length, window)[0].clamp(0, s - 1)
        idx = idx[off:off + n_loc]
        cache["k"].copy_(k[:, idx].to(cache["k"].dtype))
        cache["v"].copy_(v[:, idx].to(cache["v"].dtype))
        return
    if s > n_glob:
        raise ValueError(f"a {s}-token prompt does not fit {n_glob} slots")
    n = min(off + n_loc, s) - off            # positions the block holds
    if n <= 0:
        return
    kw, vw = k[:, off:off + n], v[:, off:off + n]
    if "k_scale" in cache:
        kw, ks = quantize_rows(kw)
        vw, vs = quantize_rows(vw)
        cache["k_scale"][:, :n] = ks
        cache["v_scale"][:, :n] = vs
    cache["k"][:, :n] = kw.to(cache["k"].dtype)
    cache["v"][:, :n] = vw.to(cache["v"].dtype)


def _decode_split(q, k, v, cache: dict, pos, q_positions, window, scale,
                  anc_bits, mesh, layout: CacheLayout) -> tuple:
    """A decode step over the rank's block of a cache in the production
    layout: q/k/v (B, Sq, heads, d) whole, every head.  The rank writes
    the new rows it owns (its rows, its slots), attends its rows over its
    slots at their global positions, and the partials merge over the
    slots' axes; returns (out (B, Sq, Hq*d) whole, saved)."""
    rs = row_block(mesh, layout.rows, q.shape[0])
    q, k, v, pos, q_positions = (t[rs] for t in (q, k, v, pos, q_positions))
    b, sq = q.shape[:2]
    n_loc = cache["k"].shape[1]
    off, n_glob = slot_geometry(n_loc, mesh, layout.slots)
    ring = window is not None and n_glob <= window
    quant = "k_scale" in cache
    saved = {}
    if ring:
        assert not quant, "int8 cache unsupported on ring buffers"
        loc, owned = _local_slots(pos, sq, n_loc, off, n_glob, True)
        rows = torch.arange(b, device=pos.device)[:, None]
        saved = {"k": cache["k"][rows, loc], "v": cache["v"][rows, loc],
                 "slot": loc, "owned": owned, "rows": rs}
        if sq > 1:
            # as the whole ring: attend over [slots ++ new], then write;
            # the new rows counted by the sequence axes' first rank alone
            k_all, v_all = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
            kv_pos = ring_slot_positions(n_glob, pos, n_glob)[:,
                                                             off:off + n_loc]
            if layout.slots is None or axis_index(mesh, layout.slots) == 0:
                k_all = torch.cat([k_all, k], dim=1)
                v_all = torch.cat([v_all, v], dim=1)
                kv_pos = torch.cat([kv_pos, q_positions], dim=1)
            out, lse = attention_direct_lse(
                q, k_all, v_all, attention_mask(q_positions, kv_pos, window),
                scale)
            _write_owned(cache["k"], k, loc, owned)
            _write_owned(cache["v"], v, loc, owned)
        else:
            _write_owned(cache["k"], k, loc, owned)
            _write_owned(cache["v"], v, loc, owned)
            kv_pos = ring_slot_positions(n_glob, pos + sq, n_glob)[
                :, off:off + n_loc]
            out, lse = attention_direct_lse(
                q, cache["k"].to(q.dtype), cache["v"].to(q.dtype),
                attention_mask(q_positions, kv_pos, window), scale)
    else:
        loc, owned = _local_slots(pos, sq, n_loc, off, n_glob, False)
        if quant:
            kq, ks = quantize_rows(k)
            vq, vs = quantize_rows(v)
            for key, new in (("k", kq), ("v", vq), ("k_scale", ks),
                             ("v_scale", vs)):
                _write_owned(cache[key], new, loc, owned)
            k_read = dequantize(cache["k"], cache["k_scale"], q.dtype)
            v_read = dequantize(cache["v"], cache["v_scale"], q.dtype)
        else:
            _write_owned(cache["k"], k, loc, owned)
            _write_owned(cache["v"], v, loc, owned)
            k_read, v_read = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
        # the kernel on CUDA tensors, its plain version on CPU tensors
        o, lse = _da.decode_attention(
            q.transpose(1, 2), k_read.transpose(1, 2), v_read.transpose(1, 2),
            (pos + sq).to(torch.int32), scale=scale, window=window,
            anc_bits=anc_bits, kv_offset=off, return_lse=True)
        out, lse = o.transpose(1, 2).reshape(b, sq, -1), lse.transpose(1, 2)
    out = merge_partials(out, lse, mesh, layout.slots)
    if layout.rows is not None:
        out = all_gather(out, mesh, layout.rows, 0)
    return out, saved


def cache_rows(t, mesh, batch_split: bool, rows):
    """``t`` (the rows x holds: the rank's ``"data"`` block with
    ``batch_split``, else every row) as a cache whose rows split over
    ``rows`` (None: every row) holds them."""
    if batch_split == (rows is not None):
        return t
    if batch_split:
        return all_gather(t, mesh, "data", 0)
    return block(t, mesh, rows, 0)


def input_rows(t, mesh, batch_split: bool, rows):
    """The inverse of :func:`cache_rows`: a cache's rows as x holds
    them."""
    if batch_split == (rows is not None):
        return t
    if batch_split:
        return block(t, mesh, "data", 0)
    return all_gather(t, mesh, rows, 0)


# ---------------------------------------------------------------------------
# attention layer


def apply_attention(params: dict, x, *, n_heads: int, n_kv_heads: int,
                    head_dim: int, rope_theta: float, use_rope: bool = True,
                    window: int | None = None, cache: dict | None = None,
                    pos=None, phase: str = "prefill",
                    block_tables=None, spec_tree: dict | None = None,
                    mesh=None, batch_split: bool = False,
                    seq=None, layout: CacheLayout | None = None) -> tuple:
    """One attention layer; returns (out, cache, saved).

    phase="prefill": x is the whole prompt at positions [0, S); a given
    ``cache`` is filled in place.  phase="train": the same attention
    with no cache, through :class:`FlashAttentionFn` on both devices.
    phase="decode": x holds Sq new tokens
    at logical positions [pos, pos+Sq) (``pos`` (B,)); the cache is
    written in place and attended.  With ``block_tables`` the cache is a
    shared block pool (paged KV, full attention only).  ``saved`` holds
    the ring rows a decode overwrote, for :func:`restore_rejected_rows`.

    ``spec_tree`` (decode only) marks x as speculation-tree nodes
    (:func:`repro_torch.core.spec_decode.tree_spec`): cache slots stay
    ``[pos, pos + Sq)`` but each node's RoPE position is ``pos - prev +
    depth``, and visibility inside the buffer follows the ancestor mask.
    It needs full attention (``window`` None).

    ``mesh``: see the module's docstring; ``batch_split`` says that x
    holds the rank's ``"data"`` block of the batch (a prefill), whose
    cache rows are then gathered before they are written; ``seq`` is the
    sequence-parallel axis of a prefill or training call (context
    parallelism where the heads do not split; None: none).  ``layout``:
    the production layout of ``cache`` (:class:`CacheLayout`), whose
    decode computes every head of the rank's rows over its slots.
    """
    b, sq, _ = x.shape
    scale = head_dim ** -0.5
    stationary = phase == "decode"
    gather = not heads_split(n_heads, n_kv_heads, mesh)
    split = layout is not None and cache is not None
    if split and phase == "decode":
        gather = True                # every head of the rank's rows
    if mesh is not None and block_tables is not None:
        raise ValueError("the paged pool serves off the mesh")
    cp = (gather and seq is not None and phase in ("prefill", "train")
          and (phase == "train" or sq % axis_size(mesh, seq) == 0))
    xin = model_input(x, mesh, stationary)
    if cp:
        q = _seq_blocks(col_product(xin, params["wq"], mesh, False), mesh,
                        seq)
        q = q.reshape(*q.shape[:2], -1, head_dim)
        k, v = _heads_in(xin, (params["wk"], params["wv"]), mesh, False,
                         True, head_dim)
    else:
        q, k, v = _heads_in(xin, (params["wq"], params["wk"], params["wv"]),
                            mesh, stationary, gather, head_dim)
    if pos is None:
        pos = torch.zeros((b,), dtype=torch.int64, device=x.device)
    q_positions = pos.long()[:, None] + torch.arange(sq, device=x.device)
    tree = spec_tree is not None and phase == "decode"
    if tree:
        if window is not None:
            raise ValueError("tree speculation needs full attention: a "
                             "sliding-window ring cannot hold a branched "
                             "buffer")
        t_prev = int(spec_tree["prev"])
        # device constants of the descriptor (spec_decode.tree_spec)
        t_depths, t_mask, t_anc = spec_tree["tensors"]
        t_base = pos.long() - t_prev
        # logical position = committed length + depth; the cache slot
        # stays the sequential [pos, pos+Sq) buffer order
        q_positions = t_base[:, None] + t_depths[None, :]
    # the verify kernels take a whole tree buffer (with its ancestor
    # bitmasks), never a level fed after part of the buffer
    kernel_ok = on_card(x) and (not tree or t_prev == 0)
    anc_bits = t_anc if tree else None
    kv_positions = q_positions
    q_off = 0
    if cp:                           # the rank's block of the queries
        q_off = axis_index(mesh, seq) * q.shape[1]
        q_positions = q_positions[:, q_off:q_off + q.shape[1]]
    if use_rope:
        sin, cos = rope_table(q_positions, head_dim, rope_theta)
        q = apply_rope(q, sin, cos)
        if cp:
            sin, cos = rope_table(kv_positions, head_dim, rope_theta)
        k = apply_rope(k, sin, cos)

    saved = {}
    if phase == "train":
        out = flash_bshd(q, k, v, scale, causal=True, window=window,
                         q_offset=q_off)
    elif phase == "prefill":
        if on_card(x):
            out = flash_bshd(q, k, v, scale, causal=True, window=window,
                             q_offset=q_off)
        else:
            out = attention_chunked(q, k, v, q_positions[0],
                                    kv_positions[0], scale, window=window)
        if cache is not None:
            rows = slots = None          # the earlier layout: every row
            if split:
                rows, slots = layout.rows, layout.slots
                if not gather:           # the heads split: gather them
                    k = all_gather(k, mesh, "model", 2)
                    v = all_gather(v, mesh, "model", 2)
            _prefill_write(cache, cache_rows(k, mesh, batch_split, rows),
                           cache_rows(v, mesh, batch_split, rows), window,
                           *slot_geometry(cache["k"].shape[1], mesh, slots))
    elif phase == "decode" and split:
        if tree and t_prev:
            raise ValueError("a tree level fed after part of its buffer "
                             "needs a cache in the earlier layout")
        out, saved = _decode_split(q, k, v, cache, pos, q_positions, window,
                                   scale, anc_bits, mesh, layout)
    elif phase == "decode" and block_tables is not None:
        assert cache is not None and window is None
        paged_write(cache, k, v, block_tables, pos)
        if kernel_ok:
            lengths = (pos + sq).to(torch.int32)
            # (B, S, H, d) q read and the output written through strides
            out = _pd.paged_decode_attention(
                q.transpose(1, 2), cache["k"], cache["v"],
                block_tables.to(torch.int32), lengths,
                k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
                scale=scale, anc_bits=anc_bits)
            out = out.transpose(1, 2).reshape(b, sq, -1)
        else:
            k_read, v_read = paged_gather(cache, block_tables, q.dtype)
            if tree:
                out = _tree_attention_plain(q, k_read, v_read, t_base, t_mask,
                                            scale)
            else:
                kv_positions = torch.arange(k_read.shape[1], device=x.device)
                mask = attention_mask(q_positions, kv_positions, None)
                out = attention_direct(q, k_read, v_read, mask, scale)
    elif phase == "decode":
        assert cache is not None
        n_slots = cache["k"].shape[1]
        ring = window is not None and n_slots <= window
        quant = "k_scale" in cache
        assert not (ring and quant), "int8 cache unsupported on ring buffers"
        if ring and sq > 1:
            # Multi-token verify on a ring: writing first would clobber rows
            # still visible to the earlier in-flight tokens, so attend over
            # a [cache ++ new] view, then write.
            saved = _gather_rows(cache, pos, sq)
            old_positions = ring_slot_positions(n_slots, pos, n_slots)
            k_all = torch.cat([cache["k"].to(q.dtype), k], dim=1)
            v_all = torch.cat([cache["v"].to(q.dtype), v], dim=1)
            kv_positions = torch.cat([old_positions, q_positions], dim=1)
            mask = attention_mask(q_positions, kv_positions, window)
            out = attention_direct(q, k_all, v_all, mask, scale)
            _write_cache(cache, k, v, pos, window)
        else:
            if ring:
                saved = _gather_rows(cache, pos, sq)
            if quant:
                kq, ks = quantize_rows(k)
                vq, vs = quantize_rows(v)
                _write_cache({"k": cache["k"], "v": cache["v"]}, kq, vq, pos,
                             None)
                _write_cache({"k": cache["k_scale"], "v": cache["v_scale"]},
                             ks, vs, pos, None)
                k_read = dequantize(cache["k"], cache["k_scale"], q.dtype)
                v_read = dequantize(cache["v"], cache["v_scale"], q.dtype)
            else:
                _write_cache(cache, k, v, pos, window if ring else None)
                k_read = cache["k"].to(q.dtype)
                v_read = cache["v"].to(q.dtype)
            if kernel_ok:
                # slot index = logical position: the kernel reads the
                # (B, S, Hkv, d) cache and the (B, S, H, d) q, and writes
                # the output, through transposed views.  A ring reaches
                # here with one token: the written slots hold the last
                # min(pos + 1, n_slots) positions, all inside the window,
                # and before the ring wraps slot j holds position j, so
                # the visible keys are the slots [0, that count), in any
                # order
                lengths = pos + sq
                if ring:
                    lengths = lengths.clamp(max=n_slots)
                out = _da.decode_attention(
                    q.transpose(1, 2), k_read.transpose(1, 2),
                    v_read.transpose(1, 2), lengths.to(torch.int32),
                    scale=scale, window=None if ring else window,
                    anc_bits=anc_bits)
                out = out.transpose(1, 2).reshape(b, sq, -1)
            elif tree:
                out = _tree_attention_plain(q, k_read, v_read, t_base, t_mask,
                                            scale)
            else:
                if ring:
                    kv_positions = ring_slot_positions(n_slots, pos + sq,
                                                       n_slots)
                else:
                    kv_positions = torch.arange(n_slots, device=x.device)
                mask = attention_mask(q_positions, kv_positions, window)
                out = attention_direct(q, k_read, v_read, mask, scale)
    else:
        raise ValueError(phase)
    if cp:
        out = row_product(_col_blocks(out, mesh, seq), params["wo"], mesh,
                          False)
    else:
        out = _heads_out(out, params["wo"], mesh, stationary, gather)
    return out, cache, saved


# ---------------------------------------------------------------------------
# cross attention (the Whisper decoder)


def precompute_cross_kv(params: dict, enc_out, *, n_kv_heads: int,
                        head_dim: int, n_heads: int = 0,
                        mesh=None) -> dict:
    """K/V of the encoder states (B, T, D): ``{"ck", "cv"}`` (B, T, Hkv, d),
    over a ``mesh`` the rank's kv heads where the heads split (see
    :func:`apply_attention`; ``n_heads`` decides)."""
    gather = not heads_split(n_heads or n_kv_heads, n_kv_heads, mesh)
    k, v = _heads_in(model_input(enc_out, mesh, False),
                     (params["wk"], params["wv"]), mesh, False, gather,
                     head_dim)
    return {"ck": k, "cv": v}


def apply_cross_attention(params: dict, x, cross_kv: dict, *, n_heads: int,
                          head_dim: int, n_kv_heads: int = 0, mesh=None,
                          stationary: bool = False,
                          layout: CacheLayout | None = None) -> torch.Tensor:
    """x (B, Sq, D) attends, unmasked, over every encoder row of
    ``cross_kv``: on CUDA tensors, and wherever a gradient is needed,
    through the flash kernel with ``causal=False`` (Sq = the prompt in
    prefill or training, the m new tokens in decode, over Skv = T), on
    CPU tensors without a gradient through ``attention_direct`` with a
    zero mask, as the JAX package computes it.  ``layout``: the cross K/V
    are a production-layout cache's, every head of the rank's rows (a
    decode step attends the rank's rows over them on every head and
    gathers the output rows)."""
    sq = x.shape[1]
    scale = head_dim ** -0.5
    gather = not heads_split(n_heads, n_kv_heads or n_heads, mesh)
    rows = None if layout is None else layout.rows
    if layout is not None:
        gather = True
    q, = _heads_in(model_input(x, mesh, stationary), (params["wq"],), mesh,
                   stationary, gather, head_dim)
    if rows is not None:
        q = q[row_block(mesh, rows, q.shape[0])]
    k, v = cross_kv["ck"].to(q.dtype), cross_kv["cv"].to(q.dtype)
    if on_card(x) or needs_grad(q, k, v):
        out = flash_bshd(q, k, v, scale, causal=False)
    else:
        mask = torch.zeros((sq, k.shape[1]), device=x.device)
        out = attention_direct(q, k, v, mask, scale)
    if rows is not None:
        out = all_gather(out, mesh, rows, 0)
    return _heads_out(out, params["wo"], mesh, stationary, gather)
