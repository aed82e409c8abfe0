"""Prefill flash attention: wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::
flash_attention``.  On CPU tensors it returns the plain version
(:func:`repro_torch.kernels.ref.flash_attention_ref`); on CUDA tensors
it launches the kernel or raises.  ``launches`` counts kernel launches.
The kernel is bound by operations (see the source's note).  With
``return_lse`` the kernel also writes each query row's log-sum-exp,
which the backward kernel (:mod:`repro_torch.kernels.flash_attention_bwd`)
reads.

bf16 runs the tensor-core kernel, which reads q/k/v and writes the
output through their strides: any layout with a contiguous last dim
whose other strides are multiples of 8 elements, so the model hands over
its (B, S, H, d) tensors as ``transpose(1, 2)`` views and gets the output
back in the same layout.  f32 runs the exact CUDA-core kernel, which
takes contiguous (B, H, S, d) tensors (copied here when they are not).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGS = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float]
         + [ctypes.c_int] * 3 + [ctypes.c_void_p])
# 240 and 32: the 256- and 64-wide tiles, zero-filled past d
HEAD_DIMS = (32, 64, 128, 240, 256)
# the exact f32 kernel also takes head dim 16 (a reduced Mistral's)
F32_HEAD_DIMS = (16,) + HEAD_DIMS


def _strides(t) -> list:
    """(b, h, s) element strides of a (B, H, S, d) tensor for a tensor
    map, which needs multiples of 8 (16 bytes in bf16)."""
    _build.require(t.stride(3) == 1, "the last dim must be contiguous")
    out = [t.stride(i) for i in range(3)]
    _build.require(all(st % 8 == 0 for st in out), "strides must be "
                   "multiples of 8 elements (16 bytes)")
    return out


def flash_attention(q, k, v, *, scale=None, causal=True, window=None,
                    return_lse=False):
    """q (B, Hq, Sq, d); k/v (B, Hkv, Skv, d) -> (B, Hq, Sq, d), and with
    ``return_lse`` also the log-sum-exp (B, Hq, Sq) f32.

    Query and key positions both start at 0; ``causal`` masks keys after
    the query, ``window`` keys at or before ``q_pos - window``.  The
    output has q's strides where q is dense (``torch.empty_like``).
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
                                       window=window, return_lse=return_lse)

    dims = F32_HEAD_DIMS if q.dtype == torch.float32 else HEAD_DIMS
    _build.require(d in dims, f"head dim must be one of {dims} in {q.dtype}")
    if q.dtype == torch.float32:
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out)):
        _build.require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte "
                       "aligned")
    strides = (ctypes.c_int64 * 12)(*(_strides(q) + _strides(k) + _strides(v)
                                      + _strides(out)))
    fn = _build.bind("flash_attention", "flash_attention", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _build.ptr(lse), ctypes.addressof(strides), b, hq, hkv, sq, skv, d,
            float(d ** -0.5 if scale is None else scale), int(causal),
            0 if window is None else int(window),
            _build.DTYPE_CODE[q.dtype], _build.stream_ptr(q))
    _build.check(rc, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0
