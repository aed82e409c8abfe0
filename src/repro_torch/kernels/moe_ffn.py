"""Grouped expert FFN: wrapper of ``csrc/moe_ffn.cu``.

Replaces the TPU kernel ``repro/kernels/moe_ffn.py::moe_ffn``.  On CPU
tensors it returns the plain version
(:func:`repro_torch.kernels.ref.moe_ffn_ref`); on CUDA tensors it
launches the kernel pair or raises.  ``launches`` counts calls that
launched the kernels.  The kernels are bound by bytes at decode (see the
source's note).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ACT = {"swiglu": 1, "gelu": 2, "geglu": 2}


def moe_ffn(buf, w_gate, w_up, w_down, *, activation="swiglu"):
    """buf (E, C, D); w_gate/w_up (E, D, F); w_down (E, F, D) -> (E, C, D).

    ``act(buf @ w_gate) * (buf @ w_up) @ w_down`` per expert, computed in
    f32 and returned in buf's dtype.  On the card the (E, C, F) hidden
    tensor lives in an f32 workspace allocated here.
    """
    e, c, d = buf.shape
    f = w_gate.shape[2]
    _build.require(w_gate.shape == (e, d, f) and w_up.shape == (e, d, f)
                   and w_down.shape == (e, f, d),
                   "weights must be w_gate/w_up (E, D, F), w_down (E, F, D)")
    _build.require(buf.dtype in (torch.float32, torch.bfloat16)
                   and all(w.dtype == buf.dtype
                           for w in (w_gate, w_up, w_down)),
                   "buf and weights must share a float32 or bfloat16 dtype")
    _build.require(activation in _ACT, f"activation must be one of "
                   f"{sorted(_ACT)}")
    if not _build.use_kernel(buf, w_gate, w_up, w_down):
        return ref.moe_ffn_ref(buf, w_gate, w_up, w_down,
                               activation=activation)

    _build.check_contiguous(buf=buf, w_gate=w_gate, w_up=w_up, w_down=w_down)
    fn = _build.bind("moe_ffn", "moe_ffn", _ARGS)
    hidden = torch.empty((e, c, f), dtype=torch.float32, device=buf.device)
    out = torch.empty_like(buf)
    rc = fn(buf.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), hidden.data_ptr(), out.data_ptr(),
            e, c, d, f, _ACT[activation], _build.DTYPE_CODE[buf.dtype],
            _build.stream_ptr(buf))
    _build.check(rc, "moe_ffn")
    moe_ffn.launches += 1
    return out


moe_ffn.launches = 0
