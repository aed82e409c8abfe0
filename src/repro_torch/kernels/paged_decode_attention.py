"""Paged verify attention: wrapper of ``csrc/paged_decode_attention.cu``.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::
paged_decode_attention``.  On CPU tensors it returns the plain version
(:func:`repro_torch.kernels.ref.paged_decode_attention_ref`); on CUDA
tensors it launches the kernel or raises.  ``launches`` counts kernel
launches and ``route_launches`` those of each mask: ``causal`` (a chain's
verify) and ``tree`` (a speculation tree's ``anc_bits``).  The kernel is
bound by bytes (see the source's note).  The grid, its split count,
its row groups and the merge workspace are those of
:mod:`repro_torch.kernels.decode_attention`, whose kernel shares the
body; q and the output go through their strides in the same way.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.decode_attention import (HEAD_DIMS, n_split,
                                                  row_groups,
                                                  split_workspace,
                                                  token_strides)

_ARGS = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 10 + [ctypes.c_float]
         + [ctypes.c_int] * 2 + [ctypes.c_void_p])


def paged_decode_attention(q, k_pool, v_pool, block_tables, lengths, *,
                           k_scale=None, v_scale=None, scale=None,
                           anc_bits=None):
    """Verify attention against a paged (block-pool) cache.

    q (B, Hq, m, d) — the m new tokens, already written into the pool at
    logical positions [len-m, len), possibly a strided view such as the
    model's (B, m, Hq, d) tensor transposed; k_pool/v_pool (NB, BS, Hkv, d) f32 or
    bf16, or int8 with ``k_scale``/``v_scale`` (NB, BS, Hkv, 1) f32;
    block_tables (B, MBS) int32 (entries <= 0 read block 0); lengths (B,)
    int32 valid tokens (= pos + m).  Causal over the m tokens, or, with
    ``anc_bits`` (m,) int32, ancestor-bitmask masking of a speculation
    tree buffer.  Returns (B, Hq, m, d) in q's dtype, laid out like q
    where q is dense (``torch.empty_like``).
    """
    b, hq, m, d = q.shape
    nb, bs, hkv, d_k = k_pool.shape
    _build.require(d_k == d and v_pool.shape == k_pool.shape,
                   "k_pool/v_pool must be (NB, BS, Hkv, d) with q's d")
    _build.require(hq % hkv == 0, "Hq must be a multiple of Hkv")
    _build.require(block_tables.dim() == 2 and block_tables.shape[0] == b,
                   "block_tables must be (B, MBS)")
    _build.require(lengths.shape == (b,), "lengths must be (B,)")
    quant = k_scale is not None
    _build.require(quant == (k_pool.dtype == torch.int8)
                   and (v_scale is not None) == quant,
                   "int8 pools need k_scale and v_scale; float pools none")
    if quant:
        _build.require(k_scale.shape == (nb, bs, hkv, 1)
                       and v_scale.shape == (nb, bs, hkv, 1)
                       and k_scale.dtype == torch.float32
                       and v_scale.dtype == torch.float32,
                       "scales must be (NB, BS, Hkv, 1) float32")
    else:
        _build.require(k_pool.dtype == q.dtype and v_pool.dtype == q.dtype,
                       "float pools must have q's dtype")
    _build.require(q.dtype in (torch.float32, torch.bfloat16),
                   "q must be float32 or bfloat16")
    if anc_bits is not None:
        _build.require(anc_bits.shape == (m,), "anc_bits must be (m,)")
    if not _build.use_kernel(q, k_pool, v_pool, block_tables, lengths,
                             k_scale, v_scale, anc_bits):
        return ref.paged_decode_attention_ref(
            q, k_pool, v_pool, block_tables, lengths, k_scale=k_scale,
            v_scale=v_scale, scale=scale, anc_bits=anc_bits)

    _build.require(d in HEAD_DIMS, f"head dim must be one of {HEAD_DIMS}")
    _build.require(block_tables.dtype == torch.int32
                   and lengths.dtype == torch.int32,
                   "block_tables and lengths must be int32")
    if anc_bits is not None:
        _build.require(anc_bits.dtype == torch.int32, "anc_bits must be int32")
    _build.check_contiguous(k_pool=k_pool, v_pool=v_pool,
                            block_tables=block_tables, lengths=lengths,
                            k_scale=k_scale, v_scale=v_scale,
                            anc_bits=anc_bits)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        _build.require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte "
                       "aligned")
    out = torch.empty_like(q)
    strides = (ctypes.c_int64 * 6)(*(token_strides(q, "q")
                                     + token_strides(out, "out")))
    mbs = block_tables.shape[1]
    groups, per = row_groups((hq // hkv) * m, d)
    splits = n_split(b, hkv * groups, mbs * bs)
    fn = _build.bind("paged_decode_attention", "paged_decode_attention",
                     _ARGS)
    stream = _build.stream_ptr(q)
    part_acc, part_ml, cnt = split_workspace(b, hkv * groups, splits, per, d,
                                             q.device, stream)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            _build.ptr(k_scale), _build.ptr(v_scale),
            block_tables.data_ptr(), lengths.data_ptr(),
            _build.ptr(anc_bits), out.data_ptr(), _build.ptr(part_acc),
            _build.ptr(part_ml), _build.ptr(cnt), ctypes.addressof(strides),
            b, hq, hkv, m, d, bs, mbs, splits, groups, per,
            float(d ** -0.5 if scale is None else scale),
            _build.DTYPE_CODE[q.dtype], _build.DTYPE_CODE[k_pool.dtype],
            stream)
    _build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    paged_decode_attention.route_launches[
        "causal" if anc_bits is None else "tree"] += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.route_launches = {"causal": 0, "tree": 0}
