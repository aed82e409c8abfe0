"""RWKV-6 WKV recurrence: wrapper of ``csrc/wkv6.cu``.

Replaces the TPU kernel ``repro/kernels/wkv6.py::wkv6``.  On CPU tensors
it returns the plain version (:func:`repro_torch.kernels.ref.wkv6_ref`);
on CUDA tensors it launches one of two kernels or raises: the serial one
for verify and decode (at most ``CHUNKED_MIN_STEPS`` steps, or with the
state stack), the chunked one for prefill (:func:`route` decides from
shapes and ``stack`` alone).  ``launches`` counts the launches of both,
``route_launches`` each route's.
The kernels are bound by bytes (see the source's note).

:func:`wkv6_bwd` is the backward (``csrc/wkv6_bwd.cu``), which training
runs through ``models.rwkv.WKV6Fn``; no TPU kernel has it.  Head sizes
64 and 128 take its chunked kernel (16-step chunks, the products on the
tensor cores, :func:`bwd_slab` columns of the state a CTA), head size 32
its serial one.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGS = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
         + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
_CHUNKED_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                 + [ctypes.c_longlong] * 3 + [ctypes.c_void_p])
HEAD_DIMS = (32, 64, 128)   # 32: the training launcher's reduced config
CHUNKED_HEAD_DIMS = (64, 128)
CHUNK, SUB = 16, 4          # steps a chunk and a sub-chunk (chunked kernel)
CHUNKED_MIN_STEPS = 17      # fewer steps, or a stack: the serial kernel
WHOLE_HEAD_FROM = 2 * 132   # (batch x heads) from which a CTA owns a head


def route(seq: int, stack: bool, hd: int = 64) -> str:
    """"serial" or "chunked": the kernel a call of ``seq`` steps takes
    (head size 32 has the serial kernel only)."""
    return ("serial" if stack or seq < CHUNKED_MIN_STEPS
            or hd not in CHUNKED_HEAD_DIMS else "chunked")


def slab(batch: int, n_heads: int, hd: int) -> int:
    """Columns of the state one CTA of the chunked kernel owns: 32, which
    spreads a batch-1 prefill over 2 (hd 64) or 4 (hd 128) CTAs a head,
    or at head size 64 the whole head once the call has two CTAs an SM's
    worth of heads (a whole head forms its decay products once, not once
    per slab)."""
    return 64 if hd == 64 and batch * n_heads >= WHOLE_HEAD_FROM else 32


def _strides(t) -> tuple:
    """Strides of the axes that are longer than 1 (the only ones that
    address anything)."""
    return tuple(st for st, n in zip(t.stride(), t.shape) if n > 1)


def _check_inputs(r, k, v, w, u, s0, *extra) -> None:
    _build.require(r.dim() == 4 and all(t.shape == r.shape
                                        for t in (k, v, w)),
                   "r/k/v/w must be (B, H, S, hd) of one shape")
    b, h, s, hd = r.shape
    _build.require(u.shape == (h, hd) and s0.shape == (b, h, hd, hd),
                   "u must be (H, hd) and s0 (B, H, hd, hd)")
    ts = (r, k, v, w, u, s0, *[t for t in extra if t is not None])
    _build.require(all(t.dtype == torch.float32 for t in ts)
                   or (all(t.dtype == torch.float64 for t in ts)
                       and r.device.type == "cpu"),
                   "wkv6 takes float32 tensors (float64 on the CPU)")


def wkv6(r, k, v, w, u, s0, *, stack: bool = False):
    """r/k/v/w (B, H, S, hd) f32; u (H, hd) f32; s0 (B, H, hd, hd) f32.

    Returns (y (B, H, S, hd), s_final (B, H, hd, hd)); with ``stack`` also
    every state (B, S+1, H, hd, hd), index t the state after t steps (the
    rollback stack of speculative verify).  r/k/v/w may be strided views
    (a transposed (B, S, H, hd) tensor) as long as they share their
    strides and their last dimension is contiguous.
    """
    _check_inputs(r, k, v, w, u, s0)
    b, h, s, hd = r.shape
    if _build.on_meta(r, k, v, w, u, s0):     # the state's update and read
        _build.count_meta("wkv6", 6 * b * h * s * hd * hd)
        y = torch.empty((b, h, s, hd), dtype=torch.float32, device="meta")
        if stack:
            states = torch.empty((b, s + 1, h, hd, hd), dtype=torch.float32,
                                 device="meta")
            return y, states[:, -1], states
        return y, torch.empty_like(s0)
    if not _build.use_kernel(r, k, v, w, u, s0):
        return ref.wkv6_ref(r, k, v, w, u, s0, stack=stack)

    _build.require(hd in HEAD_DIMS, f"head size must be one of {HEAD_DIMS}")
    _build.require(all(_strides(t) == _strides(r) for t in (k, v, w))
                   and r.stride(3) == 1,
                   "r/k/v/w must share strides with a contiguous last dim")
    _build.check_contiguous(u=u, s0=s0)
    y = torch.empty((b, h, s, hd), dtype=torch.float32, device=r.device)
    if route(s, stack, hd) == "chunked":
        _build.require(all(t.data_ptr() % 16 == 0 for t in (r, k, v, w))
                       and all(st % 4 == 0 for st in _strides(r)[:-1]),
                       "the chunked wkv6 needs 16-byte aligned rows")
        s_fin = torch.empty((b, h, hd, hd), dtype=torch.float32,
                            device=r.device)
        fn = _build.bind("wkv6", "wkv6_chunked", _CHUNKED_ARGS)
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_fin.data_ptr(),
                b, h, s, hd, slab(b, h, hd), r.stride(0), r.stride(1),
                r.stride(2), _build.stream_ptr(r))
        _build.check(rc, "wkv6_chunked")
        wkv6.launches += 1
        wkv6.route_launches["chunked"] += 1
        return y, s_fin
    fn = _build.bind("wkv6", "wkv6", _ARGS)
    states = (torch.empty((b, s + 1, h, hd, hd), dtype=torch.float32,
                          device=r.device) if stack else None)
    s_fin = (None if stack else
             torch.empty((b, h, hd, hd), dtype=torch.float32,
                         device=r.device))
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), y.data_ptr(), _build.ptr(s_fin),
            _build.ptr(states), b, h, s, hd, r.stride(0), r.stride(1),
            r.stride(2), _build.stream_ptr(r))
    _build.check(rc, "wkv6")
    wkv6.launches += 1
    wkv6.route_launches["serial"] += 1
    if stack:
        return y, states[:, -1], states
    return y, s_fin


wkv6.launches = 0
wkv6.route_launches = {"serial": 0, "chunked": 0}


_BWD_ARGS = ([ctypes.c_void_p] * 17 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 6 + [ctypes.c_void_p])
N_SMS = 132                 # the H100's SMs: one chunked CTA an SM


def bwd_slab(batch: int, n_heads: int, hd: int) -> int:
    """Columns of the state one CTA of ``wkv6_bwd`` owns: the whole head
    at head size 32 (the serial kernel); at head size 64 two 32-column
    slabs a head while they fit in one wave of the card's SMs, else the
    whole head (a second wave costs more than a slab saves); head size
    128 always 32 (4 CTAs a head)."""
    if hd == 32 or (hd == 64 and 2 * batch * n_heads > N_SMS):
        return hd
    return 32


def wkv6_bwd(r, k, v, w, u, s0, dy, ds_fin=None):
    """The backward of :func:`wkv6` without the stack: from the gradient
    dy (B, H, S, hd) of y and ``ds_fin`` (B, H, hd, hd) of the final
    state (None: zero), returns (dr, dk, dv, dw, du, ds0).  r/k/v/w as
    :func:`wkv6` takes them (dr/dk/dv/dw come back with r's strides, so
    the model's transposed views stay views); dy may have strides of its
    own with a contiguous last dimension.  On CPU tensors the plain
    version (:func:`repro_torch.kernels.ref.wkv6_bwd_ref`); on CUDA
    tensors the kernels of ``csrc/wkv6_bwd.cu`` (chunked at head sizes 64
    and 128, serial at 32) or an error."""
    _check_inputs(r, k, v, w, u, s0, dy, ds_fin)
    b, h, s, hd = r.shape
    _build.require(dy.shape == r.shape and (
        ds_fin is None or ds_fin.shape == s0.shape),
        "dy must be (B, H, S, hd) and ds_fin (B, H, hd, hd)")
    if _build.on_meta(r, k, v, w, u, s0, dy, ds_fin):
        _build.count_meta("wkv6_bwd", 18 * b * h * s * hd * hd)
        return (*(torch.empty_like(t) for t in (r, k, v, w)),
                torch.empty((h, hd), dtype=torch.float32, device="meta"),
                torch.empty_like(s0))
    if not _build.use_kernel(r, k, v, w, u, s0, dy, ds_fin):
        return ref.wkv6_bwd_ref(r, k, v, w, u, s0, dy, ds_fin)

    _build.require(hd in HEAD_DIMS, f"head size must be one of {HEAD_DIMS}")
    _build.require(all(_strides(t) == _strides(r) for t in (k, v, w))
                   and r.stride(3) == 1 and dy.stride(3) == 1,
                   "r/k/v/w must share strides; every last dim contiguous")
    _build.check_contiguous(u=u, s0=s0, ds_fin=ds_fin)
    if hd in CHUNKED_HEAD_DIMS:
        _build.require(all(t.data_ptr() % 16 == 0 for t in (r, k, v, w))
                       and all(st % 4 == 0 for st in _strides(r)[:-1]),
                       "the chunked wkv6_bwd needs 16-byte aligned rows")
        if dy.data_ptr() % 16 or any(st % 4 for st in _strides(dy)[:-1]):
            dy = dy.contiguous()
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    _build.require(_strides(dr) == _strides(r),
                   "r must be dense to lay out its gradient alike")
    seg = _build.bind("wkv6_bwd", "wkv6_bwd_seg", [ctypes.c_int])(hd)
    n_seg = -(-s // seg)      # the checkpoints, seg steps apart
    slab = bwd_slab(b, h, hd)
    dev = r.device
    du = torch.empty((h, hd), dtype=torch.float32, device=dev)
    ds0 = torch.empty_like(s0)
    ckpt = torch.empty((b, h, n_seg, hd, hd), dtype=torch.float32,
                       device=dev)
    du_part = torch.empty((b, h, hd // slab, hd), dtype=torch.float32,
                          device=dev)
    part = (torch.empty((hd // slab, 3, b, h, s, hd), dtype=torch.float32,
                        device=dev) if slab < hd else None)
    fn = _build.bind("wkv6_bwd", "wkv6_bwd", _BWD_ARGS)
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr(), dy.data_ptr(), _build.ptr(ds_fin),
            dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
            du.data_ptr(), ds0.data_ptr(), ckpt.data_ptr(),
            du_part.data_ptr(), _build.ptr(part), b, h, s, hd, slab, n_seg,
            r.stride(0), r.stride(1), r.stride(2), dy.stride(0),
            dy.stride(1), dy.stride(2), _build.stream_ptr(r))
    _build.check(rc, "wkv6_bwd")
    wkv6_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


wkv6_bwd.launches = 0
