"""Attention: GQA with RoPE, full/sliding-window variants, KV caches.

Counterpart of ``repro/models/attention.py`` (the prefill and chain
decode phases).  Layouts are the JAX package's: activations
``(B, S, H, d)``, contiguous caches ``(B, n_slots, Hkv, d)``, the paged
pool ``(NB, BS, Hkv, d)``.

KV caches are updated **in place**: every write helper mutates the
cache tensors it is given and returns the same dict.

On CUDA tensors prefill runs the flash-attention kernel, paged verify the
paged-decode kernel and verify over a contiguous, non-ring cache the
decode-attention kernel; on CPU tensors they run the plain paths the JAX
package runs off the TPU (``attention_chunked``; ``paged_gather`` +
``attention_direct``; ``attention_direct``).  A CUDA tensor never
reaches a plain version of a kernel.  The ring-buffer decode of
sliding-window layers has no TPU kernel and stays plain PyTorch on both
devices.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import decode_attention as _da
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_decode_attention as _pd
from repro_torch.kernels.ref import NEG_INF, gather_paged_kv_ref
from repro_torch.models.layers import apply_rope, rope_table


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


def restore_rejected_rows(cache: dict, saved: dict, pos, n_commit) -> dict:
    """In place: undo ring writes of rejected speculative tokens — row i of
    ``saved`` goes back where ``i >= n_commit`` (per sequence)."""
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


def _prefill_ring(cache: dict, k_new, v_new, window: int) -> dict:
    """In place: bulk-write the last ``window`` of a prefilled sequence into
    the ring."""
    s = k_new.shape[1]
    n_slots = cache["k"].shape[1]
    length = torch.full((1,), s, device=k_new.device)
    idx = ring_slot_positions(n_slots, length, window)[0].clamp(0, s - 1)
    cache["k"].copy_(k_new[:, idx].to(cache["k"].dtype))
    cache["v"].copy_(v_new[:, idx].to(cache["v"].dtype))
    return cache


# ---------------------------------------------------------------------------
# attention layer


def apply_attention(params: dict, x, *, n_heads: int, n_kv_heads: int,
                    head_dim: int, rope_theta: float, use_rope: bool = True,
                    window: int | None = None, cache: dict | None = None,
                    pos=None, phase: str = "prefill",
                    block_tables=None) -> tuple:
    """One attention layer; returns (out, cache, saved).

    phase="prefill": x is the whole prompt at positions [0, S); a given
    ``cache`` is filled in place.  phase="decode": x holds Sq new tokens
    at logical positions [pos, pos+Sq) (``pos`` (B,)); the cache is
    written in place and attended.  With ``block_tables`` the cache is a
    shared block pool (paged KV, full attention only).  ``saved`` holds
    the ring rows a decode overwrote, for :func:`restore_rejected_rows`.
    """
    b, sq, _ = x.shape
    scale = head_dim ** -0.5
    q = (x @ params["wq"]).reshape(b, sq, n_heads, head_dim)
    k = (x @ params["wk"]).reshape(b, sq, n_kv_heads, head_dim)
    v = (x @ params["wv"]).reshape(b, sq, n_kv_heads, head_dim)
    if pos is None:
        pos = torch.zeros((b,), dtype=torch.int64, device=x.device)
    q_positions = pos.long()[:, None] + torch.arange(sq, device=x.device)
    if use_rope:
        sin, cos = rope_table(q_positions, head_dim, rope_theta)
        q = apply_rope(q, sin, cos)
        k = apply_rope(k, sin, cos)

    saved = {}
    if phase == "prefill":
        if x.is_cuda:                    # (B, S, H, d) read through strides
            out = _fa.flash_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                scale=scale, causal=True, window=window)
            out = out.transpose(1, 2).reshape(b, sq, n_heads * head_dim)
        else:
            qp = q_positions[0]
            out = attention_chunked(q, k, v, qp, qp, scale, window=window)
        if cache is not None:
            if window is not None and cache["k"].shape[1] < sq:
                _prefill_ring(cache, k, v, window)
            else:                        # bulk write of the prefix at 0
                kw, vw = k, v
                if "k_scale" in cache:
                    kw, ks = quantize_rows(k)
                    vw, vs = quantize_rows(v)
                    cache["k_scale"][:, :sq] = ks
                    cache["v_scale"][:, :sq] = vs
                cache["k"][:, :sq] = kw.to(cache["k"].dtype)
                cache["v"][:, :sq] = vw.to(cache["v"].dtype)
    elif phase == "decode" and block_tables is not None:
        assert cache is not None and window is None
        paged_write(cache, k, v, block_tables, pos)
        if x.is_cuda:
            lengths = (pos + sq).to(torch.int32)
            out = _pd.paged_decode_attention(
                q.transpose(1, 2).contiguous(), cache["k"], cache["v"],
                block_tables.to(torch.int32), lengths,
                k_scale=cache.get("k_scale"), v_scale=cache.get("v_scale"),
                scale=scale)
            out = out.transpose(1, 2).reshape(b, sq, -1)
        else:
            k_read, v_read = paged_gather(cache, block_tables, q.dtype)
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
            if x.is_cuda and not ring:
                # slot index = logical position: the kernel reads the
                # (B, S, Hkv, d) cache through a transposed view
                out = _da.decode_attention(
                    q.transpose(1, 2).contiguous(), k_read.transpose(1, 2),
                    v_read.transpose(1, 2), (pos + sq).to(torch.int32),
                    scale=scale, window=window)
                out = out.transpose(1, 2).reshape(b, sq, -1)
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
    return out @ params["wo"], cache, saved
