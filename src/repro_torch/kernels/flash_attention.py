"""Prefill flash attention: wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``.  On CPU tensors it returns the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`); on CUDA tensors
it launches the kernel or raises.  ``launches`` counts kernel launches.
The kernel is bound by operations (see the source's note).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
         + [ctypes.c_int] * 3 + [ctypes.c_void_p])
HEAD_DIMS = (64, 128, 256)


def flash_attention(q, k, v, *, scale=None, causal=True, window=None):
    """q (B, Hq, Sq, d); k/v (B, Hkv, Skv, d) -> (B, Hq, Sq, d).

    Query and key positions both start at 0; ``causal`` masks keys after
    the query, ``window`` keys at or before ``q_pos - window``.
    """
    b, hq, sq, d = q.shape
    _build.require(k.dim() == 4 and k.shape[0] == b and k.shape[3] == d
                   and v.shape == k.shape,
                   "k/v must be (B, Hkv, Skv, d) with q's B and d")
    hkv, skv = k.shape[1], k.shape[2]
    _build.require(hq % hkv == 0, "Hq must be a multiple of Hkv")
    _build.require(q.dtype in (torch.float32, torch.bfloat16)
                   and k.dtype == q.dtype and v.dtype == q.dtype,
                   "q/k/v must share a float32 or bfloat16 dtype")
    _build.require(window is None or window > 0, "window must be positive")
    if not _build.use_kernel(q, k, v):
        return ref.flash_attention_ref(q, k, v, scale=scale, causal=causal,
                                       window=window)

    _build.require(d in HEAD_DIMS, f"head dim must be one of {HEAD_DIMS}")
    _build.check_contiguous(q=q, k=k, v=v)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte "
                       "aligned")
    fn = _build.bind("flash_attention", "flash_attention", _ARGS)
    out = torch.empty_like(q)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, hq, hkv, sq, skv, d,
            float(d ** -0.5 if scale is None else scale), int(causal),
            0 if window is None else int(window),
            _build.DTYPE_CODE[q.dtype], _build.stream_ptr(q))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
