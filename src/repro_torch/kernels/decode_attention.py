"""Contiguous-cache verify attention: wrapper of
``csrc/decode_attention.cu``.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::
decode_attention``.  On CPU tensors it returns the plain version
(:func:`repro_torch.kernels.ref.decode_attention_ref`); on CUDA tensors
it launches the kernel or raises.  ``launches`` counts kernel launches.
The kernel is bound by bytes (see the source's note).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
         + [ctypes.c_longlong] * 3 + [ctypes.c_float] + [ctypes.c_int] * 2
         + [ctypes.c_void_p])
HEAD_DIMS = (64, 128, 256)
_SMEM_FLOATS = 232_448 // 4          # a CTA's shared memory on Hopper
_TILE = 32                           # kDecodeTile in common.cuh


def max_rows(d: int) -> int:
    """The most query rows (g * m) one CTA of the verify-attention body
    holds at head dim ``d`` (``decode_smem_floats`` in common.cuh), at
    most 128."""
    return min(128, (_SMEM_FLOATS - _TILE * (2 * d + 1)) // (2 * d + _TILE + 3))


def decode_attention(q, k, v, lengths, *, scale=None, window=None,
                     anc_bits=None):
    """Verify attention against a contiguous cache.

    q (B, Hq, m, d) — the m new tokens, already written into the cache at
    positions [len-m, len); k/v (B, Hkv, S, d) f32 or bf16 in q's dtype,
    possibly a strided view (k and v sharing strides, last dim
    contiguous); lengths (B,) int32 valid cache length (= pos + m).
    Causal over the m tokens, within ``window`` (slot index = logical
    position) if given, or, with ``anc_bits`` (m,) int32, ancestor-bitmask
    masking of a speculation-tree buffer.  Returns (B, Hq, m, d).
    """
    b, hq, m, d = q.shape
    _build.require(k.dim() == 4 and k.shape[0] == b and k.shape[3] == d
                   and v.shape == k.shape,
                   "k/v must be (B, Hkv, S, d) with q's B and d")
    hkv = k.shape[1]
    _build.require(hq % hkv == 0, "Hq must be a multiple of Hkv")
    _build.require(lengths.shape == (b,), "lengths must be (B,)")
    _build.require(q.dtype in (torch.float32, torch.bfloat16)
                   and k.dtype == q.dtype and v.dtype == q.dtype,
                   "q/k/v must share a float32 or bfloat16 dtype")
    _build.require(window is None or window > 0, "window must be positive")
    if anc_bits is not None:
        _build.require(anc_bits.shape == (m,) and window is None,
                       "anc_bits must be (m,), with no window")
    if not _build.use_kernel(q, k, v, lengths, anc_bits):
        anc = (None if anc_bits is None
               else ref.anc_mask_from_bits(anc_bits, m))
        return ref.decode_attention_ref(q, k, v, lengths, scale=scale,
                                        window=window, anc_mask=anc)

    _build.require(d in HEAD_DIMS, f"head dim must be one of {HEAD_DIMS}")
    _build.require((hq // hkv) * m <= max_rows(d),
                   f"g * m must be <= {max_rows(d)} at head dim {d}")
    _build.require(lengths.dtype == torch.int32, "lengths must be int32")
    if anc_bits is not None:
        _build.require(anc_bits.dtype == torch.int32, "anc_bits must be int32")
    _build.require(v.stride() == k.stride() and k.stride(3) == 1
                   and all(s % 8 == 0 for s in k.stride()[:3]),
                   "k/v must share strides that are multiples of 8, with a "
                   "contiguous last dim")
    _build.check_contiguous(q=q, lengths=lengths, anc_bits=anc_bits)
    for name, t in (("k", k), ("v", v)):
        _build.require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte "
                       "aligned")
    fn = _build.bind("decode_attention", "decode_attention", _ARGS)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            _build.ptr(anc_bits), out.data_ptr(), b, hq, hkv, m, d,
            k.shape[2], k.stride(0), k.stride(1), k.stride(2),
            float(d ** -0.5 if scale is None else scale),
            0 if window is None else int(window), _build.DTYPE_CODE[q.dtype],
            _build.stream_ptr(q))
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
