"""RG-LRU time recurrence: wrapper of ``csrc/rglru_scan.cu``.

Replaces the TPU kernel ``repro/kernels/rglru_scan.py::rglru_scan``.  On
CPU tensors it returns the plain version
(:func:`repro_torch.kernels.ref.rglru_scan_ref`); on CUDA tensors it
launches the kernel or raises.  ``launches`` counts kernel launches.
The kernel is bound by bytes (see the source's note).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def rglru_scan(a, gated, h0):
    """a/gated (B, S, W) f32 (decay and gated input); h0 (B, W) f32.

    Returns h_all (B, S, W) f32: the state after every step of
    ``h_t = a_t * h_{t-1} + g_t``.
    """
    _build.require(a.dim() == 3 and gated.shape == a.shape,
                   "a/gated must be (B, S, W)")
    b, s, w = a.shape
    _build.require(h0.shape == (b, w), "h0 must be (B, W)")
    _build.require(all(t.dtype == torch.float32 for t in (a, gated, h0)),
                   "a, gated and h0 must be float32")
    if not _build.use_kernel(a, gated, h0):
        return ref.rglru_scan_ref(a, gated, h0)

    _build.check_contiguous(a=a, gated=gated, h0=h0)
    fn = _build.bind("rglru_scan", "rglru_scan", _ARGS)
    out = torch.empty_like(a)
    rc = fn(a.data_ptr(), gated.data_ptr(), h0.data_ptr(), out.data_ptr(),
            b, s, w, _build.stream_ptr(a))
    _build.check(rc, "rglru_scan")
    rglru_scan.launches += 1
    return out


rglru_scan.launches = 0
