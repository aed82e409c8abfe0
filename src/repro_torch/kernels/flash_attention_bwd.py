"""Flash attention backward: wrapper of ``csrc/flash_attention_bwd.cu``.

Replaces the JAX package's custom VJP of its flash attention,
``repro/models/attention.py::_flash_bwd_rule`` (plain jnp on the TPU, no
``pallas_call``).  On CPU tensors it returns the plain version
(:func:`repro_torch.kernels.ref.flash_attention_bwd_ref`); on CUDA
tensors it launches the kernel (three launches on the current stream:
the row sums D, then dK/dV, then dQ; in bf16 on ``wgmma`` fed by TMA)
or raises.  ``launches`` counts the calls that launched it.  The kernel
is bound by operations (see the source's note).

Every tensor is read or written through its (b, h, s) strides with a
contiguous last dim, so the model hands over its (B, S, H, d) tensors
as ``transpose(1, 2)`` views and gets dq/dk/dv back in the layouts of
q/k/v (``torch.empty_like``).  bf16 needs strides that are multiples of
8 elements and 16-byte-aligned bases.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.flash_attention import HEAD_DIMS

_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 6 + [ctypes.c_float]
         + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _strides(t, name: str, bf16: bool) -> list:
    """(b, h, s) element strides; the bf16 kernels' 16-byte copies need
    multiples of 8 and an aligned base (the f32 kernels read floats)."""
    _build.require(t.stride(3) == 1, f"{name}: the last dim must be "
                   "contiguous")
    out = [t.stride(i) for i in range(3)]
    if bf16:
        _build.require(all(st % 8 == 0 for st in out), f"{name}: strides "
                       "must be multiples of 8 elements (16 bytes)")
        _build.require(t.data_ptr() % 16 == 0,
                       f"{name} must be 16-byte aligned")
    return out


def flash_attention_bwd(q, k, v, out, lse, dout, *, scale=None, causal=True,
                        window=None, q_offset=0):
    """Gradients (dq, dk, dv) of ``flash_attention(q, k, v)`` given its
    output ``out``, its log-sum-exp ``lse`` (B, Hq, Sq) f32 and the
    output's gradient ``dout``.  q/out/dout (B, Hq, Sq, d), k/v (B, Hkv,
    Skv, d) in one dtype (f32 or bf16); masks and ``q_offset`` as the
    forward's."""
    b, hq, sq, d = q.shape
    _build.require(k.dim() == 4 and k.shape[0] == b and k.shape[3] == d
                   and v.shape == k.shape,
                   "k/v must be (B, Hkv, Skv, d) with q's B and d")
    _build.require(out.shape == q.shape and dout.shape == q.shape,
                   "out/dout must have q's shape")
    hkv = k.shape[1]
    _build.require(hq % hkv == 0, "Hq must be a multiple of Hkv")
    _build.require(q.dtype in (torch.float32, torch.bfloat16)
                   and all(t.dtype == q.dtype for t in (k, v, out, dout)),
                   "q/k/v/out/dout must share a float32 or bfloat16 dtype")
    _build.require(lse.shape == (b, hq, sq) and lse.dtype == torch.float32,
                   "lse must be (B, Hq, Sq) float32")
    _build.require(window is None or window > 0, "window must be positive")
    _build.require(q_offset >= 0, "q_offset must be >= 0")
    scale = d ** -0.5 if scale is None else scale
    if _build.on_meta(q, k, v, out, lse, dout):     # five products a pair
        _build.count_meta("flash_attention_bwd", 10 * b * hq * d *
                          ref.visible_pairs(sq, k.shape[2], causal, window,
                                            q_offset))
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if not _build.use_kernel(q, k, v, out, lse, dout):
        return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                           scale=scale, causal=causal,
                                           window=window, q_offset=q_offset)

    _build.require(d in HEAD_DIMS, f"head dim must be one of {HEAD_DIMS}")
    lse = lse.contiguous()
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the row sums D (f32: (B, Hq, Sq); bf16: packed beside lse * log2 e
    # in 64-row chunks, Sq rounded up to 128)
    delta = torch.empty(b * hq * 256 * ((sq + 127) // 128),
                        dtype=torch.float32, device=q.device)
    st = []
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out),
                    ("dout", dout), ("dq", dq), ("dk", dk), ("dv", dv)):
        st += _strides(t, name, q.dtype == torch.bfloat16)
    strides = (ctypes.c_int64 * 24)(*st)
    fn = _build.bind("flash_attention_bwd", "flash_attention_bwd", _ARGS)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), ctypes.addressof(strides), b, hq,
            hkv, sq, k.shape[2], d, float(scale), int(causal),
            0 if window is None else int(window), int(q_offset),
            _build.DTYPE_CODE[q.dtype], _build.stream_ptr(q))
    _build.check(rc, "flash_attention_bwd")
    flash_attention_bwd.launches += 1
    flash_attention_bwd.offset_launches += q_offset > 0
    return dq, dk, dv


flash_attention_bwd.launches = 0
flash_attention_bwd.offset_launches = 0   # those with a nonzero q_offset
