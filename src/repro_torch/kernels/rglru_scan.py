"""RG-LRU time recurrence: wrappers of ``csrc/rglru_scan.cu``.

Two entries share one scan body:

- :func:`rglru_scan` ``(a, g, h0)`` replaces the TPU kernel
  ``repro/kernels/rglru_scan.py::rglru_scan``;
- :func:`rglru_gated_scan` also forms the gates from the two products,
  the conv output and the parameters (what the model calls).

On CPU tensors each returns its plain version
(:func:`repro_torch.kernels.ref.rglru_scan_ref`,
:func:`repro_torch.kernels.ref.rglru_gated_scan_ref`); on CUDA tensors
it launches the kernel or raises.  :func:`route` picks the serial kernel
(verify, decode) or the time-parallel one (prefill) from the step count
alone.  Each function counts its launches in ``launches``, and each
route's in ``route_launches``.  The kernels
are bound by bytes (see the source's note).

:func:`rglru_gated_scan_bwd` is the fused entry's backward
(``csrc/rglru_scan_bwd.cu``), which training runs through
``models.rglru.RGLRUScanFn``; no TPU kernel has it.  :func:`bwd_route`
picks its kernel from the shape: time chunks across CTAs joined by an
ordered carry, with tiles staged by TMA (``chunked``), or, where TMA
cannot take the rows, the time-parallel layout over a whole sequence
(``sequence``).
"""
from __future__ import annotations

import ctypes
import types

import torch

from repro_torch.kernels import _build, ref

_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
_GATED_ARGS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
PARALLEL_MIN_STEPS = 17     # fewer steps: the serial kernel
# the time-parallel kernel's layout (csrc/rglru_scan.cu's kSegSteps,
# kSegsPerWarp, kSegs): (steps a segment, segments one warp's shuffles
# compose, segments a tile of eight warps); tiles are walked in order
LAYOUT = (4, 16, 128)


def route(seq: int) -> str:
    """"serial" or "parallel": the kernel a call of ``seq`` steps takes."""
    return "serial" if seq < PARALLEL_MIN_STEPS else "parallel"


def _launch_shape(seq: int, width: int, *tensors) -> tuple:
    """(parallel, vec): the kernel and the channels a thread of the
    time-parallel kernel owns (4 for 16-byte loads along W where the
    width and every tensor's alignment allow it)."""
    parallel = route(seq) == "parallel"
    aligned = width % 4 == 0 and all(
        t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)
    return int(parallel), 4 if parallel and aligned else 1


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
    if _build.on_meta(a, gated, h0):
        _build.count_meta("rglru_scan", 2 * a.numel())
        return torch.empty_like(a)
    if not _build.use_kernel(a, gated, h0):
        return ref.rglru_scan_ref(a, gated, h0)

    _build.check_contiguous(a=a, gated=gated, h0=h0)
    fn = _build.bind("rglru_scan", "rglru_scan", _ARGS)
    out = torch.empty_like(a)
    parallel, vec = _launch_shape(s, w, a, gated, out)
    rc = fn(a.data_ptr(), gated.data_ptr(), h0.data_ptr(), out.data_ptr(),
            b, s, w, parallel, vec, _build.stream_ptr(a))
    _build.check(rc, "rglru_scan")
    rglru_scan.launches += 1
    rglru_scan.route_launches[route(s)] += 1
    return out


rglru_scan.launches = 0
rglru_scan.route_launches = {"serial": 0, "parallel": 0}


def _check_gate_dtypes(xa, xi, x, b_a, b_i, a_param, *state) -> None:
    ts = (xa, xi, b_a, b_i, a_param, *state)
    _build.require((all(t.dtype == torch.float32 for t in ts)
                    and x.dtype in (torch.float32, torch.bfloat16))
                   or (all(t.dtype == torch.float64 for t in (*ts, x))
                       and xa.device.type == "cpu"),
                   "the gates take float32 (x float32 or bfloat16; "
                   "float64 on the CPU)")


def rglru_gated_scan(xa, xi, x, b_a, b_i, a_param, h0):
    """The RG-LRU with its gates (``repro/models/rglru.py:97-108``).

    xa = x @ w_a and xi = x @ w_i (B, S, W) f32; x, the conv output,
    (B, S, W) f32 or bf16; b_a, b_i, a_param (W,) f32; h0 (B, W) f32.
    Returns h_all (B, S, W) f32.
    """
    _build.require(xa.dim() == 3 and xi.shape == xa.shape
                   and x.shape == xa.shape, "xa/xi/x must be (B, S, W)")
    b, s, w = xa.shape
    _build.require(h0.shape == (b, w) and all(
        p.shape == (w,) for p in (b_a, b_i, a_param)),
        "h0 must be (B, W) and b_a/b_i/a_param (W,)")
    _check_gate_dtypes(xa, xi, x, b_a, b_i, a_param, h0)
    if _build.on_meta(xa, xi, x, b_a, b_i, a_param, h0):   # ~12 an element
        _build.count_meta("rglru_gated_scan", 12 * x.numel())
        return torch.empty(x.shape, dtype=torch.float32, device="meta")
    if not _build.use_kernel(xa, xi, x, b_a, b_i, a_param, h0):
        return ref.rglru_gated_scan_ref(xa, xi, x, b_a, b_i, a_param, h0)

    _build.check_contiguous(xa=xa, xi=xi, x=x, b_a=b_a, b_i=b_i,
                            a_param=a_param, h0=h0)
    fn = _build.bind("rglru_scan", "rglru_gated_scan", _GATED_ARGS)
    out = torch.empty_like(xa)
    parallel, vec = _launch_shape(s, w, xa, xi, x, out)
    rc = fn(xa.data_ptr(), xi.data_ptr(), x.data_ptr(), b_a.data_ptr(),
            b_i.data_ptr(), a_param.data_ptr(), h0.data_ptr(),
            out.data_ptr(), b, s, w, _build.DTYPE_CODE[x.dtype], parallel,
            vec, _build.stream_ptr(xa))
    _build.check(rc, "rglru_gated_scan")
    rglru_gated_scan.launches += 1
    rglru_gated_scan.route_launches[route(s)] += 1
    return out


rglru_gated_scan.launches = 0
rglru_gated_scan.route_launches = {"serial": 0, "parallel": 0}


_BWD_ARGS = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
# csrc/rglru_scan_bwd.cu's chunked route, which the scratch is sized
# from (keep in step): the steps of a chunk by x's dtype (kChunkSteps)
# and the channels of a slab (kSlab, one 128-byte row of f32)
BWD_CHUNK = types.MappingProxyType({torch.bfloat16: 88, torch.float32: 64})
BWD_SLAB = 32


_SYNC: dict = {}     # (device, stream) -> the chunked route's sync words


def _sync_words(n: int, device, stream: int) -> torch.Tensor:
    """At least ``n`` zeroed int64 words for the chunked route's ticket,
    slab counts and carries on ``stream``: the kernel leaves them zero, so
    one buffer a stream is zeroed once, when it is made or grown (the
    stream orders the calls that share it;
    :func:`repro_torch.kernels._build.workspace`)."""
    return _build.workspace(_SYNC, n, torch.int64, device, stream)


def bwd_route(w: int, x_dtype, *tensors) -> str:
    """"chunked" where TMA can load every (B, S, W) operand (rows of a
    multiple of 16 bytes in f32 and in x's dtype, each tensor 16-byte
    aligned), else "sequence"."""
    rows = all(w * torch.finfo(dt).bits // 8 % 16 == 0
               for dt in (torch.float32, x_dtype))
    aligned = all(t.data_ptr() % 16 == 0 for t in tensors)
    return "chunked" if rows and aligned else "sequence"


def rglru_gated_scan_bwd(xa, xi, x, b_a, b_i, a_param, h0, h_all, dh):
    """The backward of :func:`rglru_gated_scan` from its output h_all and
    the output's gradient dh (B, S, W) f32.  Returns (dxa, dxi, dx in x's
    dtype, db_a, db_i, da_param, dh0).  On CPU tensors the plain version
    (:func:`repro_torch.kernels.ref.rglru_gated_scan_bwd_ref`); on CUDA
    tensors the kernel of ``csrc/rglru_scan_bwd.cu`` or an error."""
    _build.require(xa.dim() == 3 and all(
        t.shape == xa.shape for t in (xi, x, h_all, dh)),
        "xa/xi/x/h_all/dh must be (B, S, W)")
    b, s, w = xa.shape
    _build.require(h0.shape == (b, w) and all(
        p.shape == (w,) for p in (b_a, b_i, a_param)),
        "h0 must be (B, W) and b_a/b_i/a_param (W,)")
    _check_gate_dtypes(xa, xi, x, b_a, b_i, a_param, h0, h_all, dh)
    args = (xa, xi, x, b_a, b_i, a_param, h0, h_all, dh)
    if _build.on_meta(*args):
        _build.count_meta("rglru_gated_scan_bwd", 30 * x.numel())
        return tuple(torch.empty_like(t) for t in args[:7])
    if not _build.use_kernel(*args):
        return ref.rglru_gated_scan_bwd_ref(*args)

    _build.check_contiguous(xa=xa, xi=xi, x=x, b_a=b_a, b_i=b_i,
                            a_param=a_param, h0=h0, h_all=h_all, dh=dh)
    dxa, dxi, dx = (torch.empty_like(t) for t in (xa, xi, x))
    dh0 = torch.empty_like(h0)
    db_a, db_i, da_param = (torch.empty_like(p) for p in (b_a, b_i, a_param))
    _, vec = _launch_shape(PARALLEL_MIN_STEPS, w, xa, xi, x, h0, h_all, dh,
                           dxa, dxi, dx, dh0)
    chunked = bwd_route(w, x.dtype, xa, xi, x, h_all, dh) == "chunked"
    rows, sync = b, None
    fn = _build.bind("rglru_scan_bwd", "rglru_gated_scan_bwd", _BWD_ARGS)
    stream = _build.stream_ptr(xa)
    if chunked:
        rows = b * -(-s // BWD_CHUNK[x.dtype])
        n_slabs = -(-w // BWD_SLAB)
        sync = _sync_words(1 + n_slabs * (1 + rows * BWD_SLAB), xa.device,
                           stream)
    part = torch.empty((rows, 3, w), dtype=torch.float32, device=xa.device)
    rc = fn(*(t.data_ptr() for t in (*args, dxa, dxi, dx, dh0, db_a, db_i,
                                     da_param, part)), _build.ptr(sync),
            b, s, w, _build.DTYPE_CODE[x.dtype], vec, int(chunked), stream)
    _build.check(rc, "rglru_gated_scan_bwd")
    rglru_gated_scan_bwd.launches += 1
    return dxa, dxi, dx, db_a, db_i, da_param, dh0


rglru_gated_scan_bwd.launches = 0
