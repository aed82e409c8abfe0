"""Grouped expert FFN: wrapper of ``csrc/moe_ffn.cu``.

Replaces the TPU kernel ``repro/kernels/moe_ffn.py::moe_ffn``.  On CPU
tensors it returns the plain version
(:func:`repro_torch.kernels.ref.moe_ffn_ref`); on CUDA tensors it
launches the kernel pair or raises.  ``launches`` counts calls that
launched the kernels.  The kernels are bound by bytes at verify (see the
source's note).

:func:`moe_ffn_bwd` is the backward (``csrc/moe_ffn_bwd.cu``), which
training runs through ``models.moe.MoEFFNFn``; no TPU kernel has it.

bf16 runs the tensor-core kernels: TMA reads every operand, so D and
every base must be 16-byte aligned; an F that is not a multiple of 8
(none of the served models; the small test shapes) is padded with zero
columns of w_gate/w_up and zero rows of w_down, which changes nothing in
the result.  f32 runs the exact CUDA-core kernels.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, ref

_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_ACT = {"swiglu": 1, "gelu": 2, "geglu": 2}


def _check_dtypes(*tensors) -> None:
    dt = tensors[0].dtype
    _build.require(all(t.dtype == dt for t in tensors) and (
        dt in (torch.float32, torch.bfloat16)
        or (dt == torch.float64 and tensors[0].device.type == "cpu")),
        "buf and weights must share a float32 or bfloat16 dtype (float64 "
        "on the CPU)")


def _pad_f(w_gate, w_up, w_down):
    """bf16's F padded to a multiple of 8 with zero columns of w_gate /
    w_up and zero rows of w_down: ((w_gate, w_up, w_down), padded F)."""
    f = w_gate.shape[2]
    if f % 8:
        pad = 8 - f % 8
        w_gate, w_up = F.pad(w_gate, (0, pad)), F.pad(w_up, (0, pad))
        w_down = F.pad(w_down, (0, 0, 0, pad))
        f += pad
    return (w_gate, w_up, w_down), f


def _check_tma(**tensors) -> None:
    """bf16: TMA's 16-byte strides (D a multiple of 8) and bases."""
    _build.require(tensors["buf"].shape[2] % 8 == 0, "bf16 needs D a "
                   "multiple of 8 (TMA's 16-byte strides)")
    for name, t in tensors.items():
        _build.require(t.data_ptr() % 16 == 0,
                       f"{name} must be 16-byte aligned")


def moe_ffn(buf, w_gate, w_up, w_down, *, activation="swiglu"):
    """buf (E, C, D); w_gate/w_up (E, D, F); w_down (E, F, D) -> (E, C, D).

    ``act(buf @ w_gate) * (buf @ w_up) @ w_down`` per expert with f32
    accumulation, returned in buf's dtype.  On the card the (E, C, F)
    hidden tensor lives in a workspace allocated here: f32 for f32, and
    bf16 for bf16 (act(g) * u is rounded to bf16 before the down
    product).
    """
    e, c, d = buf.shape
    f = w_gate.shape[2]
    _build.require(w_gate.shape == (e, d, f) and w_up.shape == (e, d, f)
                   and w_down.shape == (e, f, d),
                   "weights must be w_gate/w_up (E, D, F), w_down (E, F, D)")
    _check_dtypes(buf, w_gate, w_up, w_down)
    _build.require(activation in _ACT, f"activation must be one of "
                   f"{sorted(_ACT)}")
    if _build.on_meta(buf, w_gate, w_up, w_down):
        _build.count_meta("moe_ffn", 2 * e * c * d * f * 3)
        return torch.empty_like(buf)
    if not _build.use_kernel(buf, w_gate, w_up, w_down):
        return ref.moe_ffn_ref(buf, w_gate, w_up, w_down,
                               activation=activation)

    _build.check_contiguous(buf=buf, w_gate=w_gate, w_up=w_up, w_down=w_down)
    if buf.dtype == torch.bfloat16:
        (w_gate, w_up, w_down), f = _pad_f(w_gate, w_up, w_down)
        _check_tma(buf=buf, w_gate=w_gate, w_up=w_up, w_down=w_down)
    fn = _build.bind("moe_ffn", "moe_ffn", _ARGS)
    hidden = torch.empty((e, c, f), dtype=buf.dtype, device=buf.device)
    out = torch.empty_like(buf)
    rc = fn(buf.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), hidden.data_ptr(), out.data_ptr(),
            e, c, d, f, _ACT[activation], _build.DTYPE_CODE[buf.dtype],
            _build.stream_ptr(buf))
    _build.check(rc, "moe_ffn")
    moe_ffn.launches += 1
    return out


moe_ffn.launches = 0


_BWD_ARGS = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def moe_ffn_bwd(buf, w_gate, w_up, w_down, dy, *, activation="swiglu"):
    """The backward of :func:`moe_ffn`: from the gradient dy (E, C, D) of
    its output, returns (dbuf (E, C, D), dw_gate, dw_up (E, D, F),
    dw_down (E, F, D)) in buf's dtype.  On CPU tensors the plain version
    (:func:`repro_torch.kernels.ref.moe_ffn_bwd_ref`); on CUDA tensors the
    kernels of ``csrc/moe_ffn_bwd.cu`` or an error.  The forward's
    products are recomputed on the card into (E, C, F) workspaces
    allocated here (three, in buf's dtype)."""
    e, c, d = buf.shape
    f = w_gate.shape[2]
    _build.require(w_gate.shape == (e, d, f) and w_up.shape == (e, d, f)
                   and w_down.shape == (e, f, d) and dy.shape == buf.shape,
                   "weights must be w_gate/w_up (E, D, F), w_down (E, F, "
                   "D), dy (E, C, D)")
    _check_dtypes(buf, w_gate, w_up, w_down, dy)
    _build.require(activation in _ACT, f"activation must be one of "
                   f"{sorted(_ACT)}")
    if _build.on_meta(buf, w_gate, w_up, w_down, dy):   # 2 recomputed + 4
        _build.count_meta("moe_ffn_bwd", 2 * buf.shape[0] * buf.shape[1]
                          * buf.shape[2] * w_gate.shape[2] * 6)
        return tuple(torch.empty_like(t) for t in (buf, w_gate, w_up, w_down))
    if not _build.use_kernel(buf, w_gate, w_up, w_down, dy):
        return ref.moe_ffn_bwd_ref(buf, w_gate, w_up, w_down, dy,
                                   activation=activation)

    _build.check_contiguous(buf=buf, w_gate=w_gate, w_up=w_up, w_down=w_down,
                            dy=dy)
    f_in = f
    if buf.dtype == torch.bfloat16:
        (w_gate, w_up, w_down), f = _pad_f(w_gate, w_up, w_down)
        _check_tma(buf=buf, w_gate=w_gate, w_up=w_up, w_down=w_down, dy=dy)
    g, u, dh = (torch.empty((e, c, f), dtype=buf.dtype, device=buf.device)
                for _ in range(3))
    dbuf = torch.empty_like(buf)
    dwg, dwu, dwd = (torch.empty_like(w) for w in (w_gate, w_up, w_down))
    fn = _build.bind("moe_ffn_bwd", "moe_ffn_bwd", _BWD_ARGS)
    rc = fn(buf.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr(), dy.data_ptr(), g.data_ptr(), u.data_ptr(),
            dh.data_ptr(), dbuf.data_ptr(), dwg.data_ptr(), dwu.data_ptr(),
            dwd.data_ptr(), e, c, d, f, _ACT[activation],
            _build.DTYPE_CODE[buf.dtype], _build.stream_ptr(buf))
    _build.check(rc, "moe_ffn_bwd")
    moe_ffn_bwd.launches += 1
    if f != f_in:
        dwg, dwu, dwd = dwg[..., :f_in], dwu[..., :f_in], dwd[:, :f_in]
    return dbuf, dwg, dwu, dwd


moe_ffn_bwd.launches = 0
