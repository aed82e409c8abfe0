"""Contiguous-cache verify attention: wrapper of
``csrc/decode_attention.cu``.

Replaces the TPU kernel ``repro/kernels/decode_attention.py::
decode_attention``.  On CPU tensors it returns the plain version
(:func:`repro_torch.kernels.ref.decode_attention_ref`); on CUDA tensors
it launches the kernel or raises.  ``launches`` counts kernel launches and
``route_launches`` those of each mask: ``causal``, ``window`` and
``tree`` (a speculation tree's ``anc_bits``), and, beside them, the
``partial`` launches (``return_lse``: a rank's slice of a cache split
over the sequence, whose partial the ranks merge by log-sum-exp).
The kernel is bound by bytes (see the source's note).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

_ARGS = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float]
         + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2)
HEAD_DIMS = (64, 128, 240, 256)     # both bodies
# the exact CUDA-core body (f32 here, f32 and int8 pools in the paged
# kernel) also takes the reduced configs' head dim 32
CORE_HEAD_DIMS = (32,) + HEAD_DIMS
# and here 16 (the serving example's draft, whose sliding-window ring
# decodes one token a step on this kernel)
F32_HEAD_DIMS = (16,) + CORE_HEAD_DIMS
_SMEM_FLOATS = 232_448 // 4          # a CTA's shared memory on Hopper
_TILE = 32                           # kDecodeTile in common.cuh
KEY_TILE = 64                        # kKeyTile in common.cuh: split unit
N_SMS = 132                          # streaming multiprocessors of an H100
CTAS_PER_SM = 2                      # the tensor-core body's occupancy

_COUNTERS: dict = {}                 # (device, stream) -> int32 zeros


def n_split(batch: int, n_kv_heads: int, capacity: int) -> int:
    """Key splits per (sequence, KV head) of the verify kernels' grid
    (the wrappers count each row group of a head as a head here).

    A function of shapes only: ``capacity`` is the most keys a sequence
    can hold (``max_blocks * block_size`` paged, ``n_slots`` contiguous).
    About two CTAs per SM in one wave (CTAS_PER_SM * N_SMS // (B * Hkv)
    splits), never more splits than the capacity has KEY_TILE-key tiles,
    so every split the capacity can fill holds at least one whole tile.
    """
    tiles = max(1, -(-int(capacity) // KEY_TILE))
    want = max(1, (CTAS_PER_SM * N_SMS) // max(1, batch * n_kv_heads))
    return min(want, tiles)


def split_workspace(b: int, hkv: int, splits: int, rows: int, d: int,
                    device, stream: int = 0) -> tuple:
    """(part_acc, part_ml, counters) for a call with ``splits`` > 1: f32
    partials (B, Hkv, n_split, rows, d) and their (m, l) pairs from
    ``torch.empty``, and int32 counters, one per (sequence, KV head),
    allocated zeroed once per device and stream (calls on one stream run
    in order, so they may share them) and kept at zero by the kernel
    (:func:`repro_torch.kernels._build.workspace`);
    (None, None, None) for one split.  The wrappers count each row group
    of a head as a head of its own, with ``rows`` the group's."""
    if splits == 1:
        return None, None, None
    part_acc = torch.empty((b, hkv, splits, rows, d), dtype=torch.float32,
                           device=device)
    part_ml = torch.empty((b, hkv, splits, rows, 2), dtype=torch.float32,
                          device=device)
    cnt = _build.workspace(_COUNTERS, max(1024, b * hkv), torch.int32,
                           device, stream)
    return part_acc, part_ml, cnt


def token_strides(t, name: str) -> list:
    """(batch, head, token) element strides of a (B, H, m, d) q or
    output: the last dim contiguous, the others multiples of 8 elements
    (16-byte vector loads), 16-byte aligned.  The stride of an axis of
    size 1 is never used and counts as 0."""
    _build.require(t.stride(3) == 1, f"{name} must have a contiguous last "
                   "dim")
    out = [t.stride(i) if t.shape[i] > 1 else 0 for i in range(3)]
    _build.require(all(st % 8 == 0 for st in out), f"{name} strides must be "
                   "multiples of 8 elements")
    _build.require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    return out


def max_rows(d: int) -> int:
    """The most query rows one CTA of the verify-attention body holds at
    head dim ``d`` (``max_group_rows`` in common.cuh): what the CUDA-core
    body's shared memory fits (``decode_smem_floats``), and at most 16
    n-tiles of 8 rows in the tensor-core body (10 at d > 128).  128 at d
    64 and 128, 80 at d 240 (the memory would fit 82), 76 at d 256."""
    return min(128 if d <= 128 else 80,
               (_SMEM_FLOATS - _TILE * (2 * d + 1)) // (2 * d + _TILE + 3))


def row_groups(rows: int, d: int) -> tuple:
    """(n_groups, group_rows): the g * m query rows of a KV head dealt out
    to as few CTAs as ``max_rows(d)`` allows, in groups of equal size
    (the last one shorter): group i holds rows [i * group_rows,
    min((i + 1) * group_rows, rows)).  Every CTA of a group reads the
    same KV tiles; one group is the path of every served shape but a
    large tree on many query heads (Llama-3-405B under tree (3, 2):
    16 x 10 = 160 rows, 2 groups of 80)."""
    n = -(-rows // max_rows(d))
    per = -(-rows // n)
    return -(-rows // per), per


def decode_attention(q, k, v, lengths, *, scale=None, window=None,
                     anc_bits=None, kv_offset: int = 0,
                     return_lse: bool = False):
    """Verify attention against a contiguous cache.

    q (B, Hq, m, d) — the m new tokens, already written into the cache at
    positions [len-m, len), possibly a strided view such as the model's
    (B, m, Hq, d) tensor transposed; k/v (B, Hkv, S, d) f32 or bf16 in q's dtype,
    possibly a strided view (k and v sharing strides, last dim
    contiguous); lengths (B,) int32 valid cache length (= pos + m).
    Causal over the m tokens, within ``window`` (slot index = logical
    position) if given, or, with ``anc_bits`` (m,) int32, ancestor-bitmask
    masking of a speculation-tree buffer.  Returns (B, Hq, m, d), laid
    out like q where q is dense (``torch.empty_like``).

    ``kv_offset``: k/v hold slots [kv_offset, kv_offset + S) of the
    sequence (a rank's slice of a cache split over it); ``lengths`` and
    every mask stay global, the tree's buffer may lie partly or wholly
    outside the slice.  ``return_lse``: also return each row's
    log-sum-exp (B, Hq, m) f32 over the slice's visible keys; a row with
    none writes 0 and reports -inf.  Returns (out, lse) then.
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
    _build.require(int(kv_offset) >= 0, "kv_offset must be >= 0")
    if anc_bits is not None:
        _build.require(anc_bits.shape == (m,) and window is None,
                       "anc_bits must be (m,), with no window")
    if _build.on_meta(q, k, v, lengths, anc_bits):   # every slot counted
        _build.count_meta("decode_attention", 4 * b * hq * m * k.shape[2] * d)
        out = torch.empty_like(q)
        return ((out, torch.empty((b, hq, m), device="meta"))
                if return_lse else out)
    if not _build.use_kernel(q, k, v, lengths, anc_bits):
        anc = (None if anc_bits is None
               else ref.anc_mask_from_bits(anc_bits, m))
        return ref.decode_attention_ref(q, k, v, lengths, scale=scale,
                                        window=window, anc_mask=anc,
                                        kv_offset=int(kv_offset),
                                        return_lse=return_lse)

    dims = F32_HEAD_DIMS if q.dtype == torch.float32 else HEAD_DIMS
    _build.require(d in dims, f"head dim must be one of {dims} in {q.dtype}")
    _build.require(lengths.dtype == torch.int32, "lengths must be int32")
    if anc_bits is not None:
        _build.require(anc_bits.dtype == torch.int32, "anc_bits must be int32")
    _build.require(v.stride() == k.stride() and k.stride(3) == 1
                   and all(s % 8 == 0 for s in k.stride()[:3]),
                   "k/v must share strides that are multiples of 8, with a "
                   "contiguous last dim")
    _build.check_contiguous(lengths=lengths, anc_bits=anc_bits)
    for name, t in (("k", k), ("v", v)):
        _build.require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte "
                       "aligned")
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, m), dtype=torch.float32, device=q.device)
           if return_lse else None)
    strides = (ctypes.c_int64 * 9)(*(token_strides(q, "q")
                                     + token_strides(out, "out")
                                     + list(k.stride()[:3])))
    groups, per = row_groups((hq // hkv) * m, d)
    splits = n_split(b, hkv * groups, k.shape[2])
    fn = _build.bind("decode_attention", "decode_attention", _ARGS)
    stream = _build.stream_ptr(q)
    part_acc, part_ml, cnt = split_workspace(b, hkv * groups, splits, per, d,
                                             q.device, stream)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            _build.ptr(anc_bits), out.data_ptr(), _build.ptr(part_acc),
            _build.ptr(part_ml), _build.ptr(cnt), ctypes.addressof(strides),
            b, hq, hkv, m, d, k.shape[2], splits, groups, per,
            float(d ** -0.5 if scale is None else scale),
            0 if window is None else int(window), _build.DTYPE_CODE[q.dtype],
            int(kv_offset), _build.ptr(lse), stream)
    _build.check(rc, "decode_attention")
    decode_attention.launches += 1
    decode_attention.route_launches[
        "tree" if anc_bits is not None
        else "causal" if window is None else "window"] += 1
    if return_lse:
        decode_attention.route_launches["partial"] += 1
        return out, lse
    return out


decode_attention.launches = 0
decode_attention.route_launches = {"causal": 0, "window": 0, "tree": 0,
                                   "partial": 0}
