#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``; imports nothing of JAX.  Phases, each printed
on its own lines with its wall seconds:

1. environment: the card's name and power limit, torch/CUDA versions,
   the kernels' build time (every ``csrc/*.cu``, one nvcc each, in
   parallel), and what ``-Xptxas -v`` said of the two tensor-core
   kernels (registers, static shared memory, spills per instantiation);
2. every kernel against its plain PyTorch version on the card at the
   cases of tests/test_kernels.py, the serving paths' shapes and a
   stress shape each, plus the edges of the tensor-core kernels (flash
   at 100 tokens, windowed and bidirectional at head dims 64/128/256 and
   fed (B, S, H, d) views; ``moe_ffn`` at C 1, 7, 33 and 300 at Mixtral
   widths), each ``flash_attention`` and ``moe_ffn`` line naming the
   path that ran (tensor-core bf16 or exact f32): max error against the
   tolerance (attention and
   the FFN f32 2e-5 with TF32 off, bf16 2e-2; ``rglru_scan`` 1e-5;
   ``wkv6`` 2e-4), kernel time (CUDA events, L2 flushed before each
   launch), its bound on this card and what sets it, the plain
   version's time and one library call's time as a yardstick where one
   PyTorch call computes the same function;
3. serve, bf16, weights from a seed, ``max_batch=4``, ``n_cand=4``,
   Poisson requests (prompt 512, gen 32-64), every kernel's launch count
   read around each run: (a) paged, Mixtral-8x7B / Mistral-7B widths, 4
   layers each, 12 requests; (b) contiguous (``paged=False``),
   RWKV-6-7B at full width and depth (32 layers) with a 2-layer
   Mistral-7B-width draft, 8 requests; (c) contiguous,
   RecurrentGemma-2B at full width and depth (27 layers), the same kind
   of draft, 8 requests; (d) contiguous, the widths of (a), 8 requests;
4. lossless, f32, ``max_batch=2``, 6 requests with mid-flight
   admission, every stream equal to the port's own target-only greedy
   decode: Mixtral / Mistral widths (2 layers) paged and contiguous,
   RWKV-6 widths (2 layers), RecurrentGemma widths (3 layers, one
   group);
5. the kernels as one JSON object; 6. the device as one JSON object.

Any failure raises and exits non-zero; so does a machine with no card.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12                   # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no TF32
TOL = {"float32": 2e-5, "bfloat16": 2e-2}
TOL_RGLRU, TOL_WKV6 = 1e-5, 2e-4      # tests/test_kernels.py:153,169-171
REPLACES = {
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:297",
    "flash_attention": "src/repro/kernels/flash_attention.py:111",
    "moe_ffn": "src/repro/kernels/moe_ffn.py:68",
    "decode_attention": "src/repro/kernels/decode_attention.py:129",
    "rglru_scan": "src/repro/kernels/rglru_scan.py:49",
    "wkv6": "src/repro/kernels/wkv6.py:57",
}
# the serving run whose launches each kernel reports (its path)
PATH_RUN = {"paged_decode_attention": "3a", "flash_attention": "3a",
            "moe_ffn": "3a", "decode_attention": "3d", "rglru_scan": "3c",
            "wkv6": "3b"}


def _bound(n_bytes: float, n_ops: float, dtype: str):
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / PEAK_OPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Bench:
    """Per-launch CUDA-event timing with the 50 MB L2 flushed before each
    launch (the serving path finds its KV and weights cold).  The card is
    first held busy while the host queues every launch, so the events
    time the device's work, not the host's dispatch."""

    HOLD_CYCLES = 40_000_000       # ~20 ms at the H100's ~2 GHz SM clock

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.int8, device="cuda")

    def ms(self, fn, budget_ms: float = 150.0, max_iters: int = 30) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        est = 1e3 * (time.perf_counter() - t0)
        iters = int(max(1, min(max_iters, budget_ms / max(est, 1e-3))))
        ev = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
        torch.cuda._sleep(self.HOLD_CYCLES)
        for s, e in ev:
            self.flush.zero_()
            s.record()
            fn()
            e.record()
        torch.cuda.synchronize()
        return float(np.median([s.elapsed_time(e) for s, e in ev]))


def _check(name, case, got, want, dtype, tol=None):
    import torch
    tol = TOL[dtype] if tol is None else tol
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol + tol * want.float().abs()).all())
    bad = int(torch.isnan(got.float()).sum())
    max_err = float(err.max())
    if not ok or bad:
        raise AssertionError(f"{name} {case}: kernel disagrees with its plain "
                             f"version (max abs err {max_err:.3e}, tol {tol}, "
                             f"{bad} NaN)")
    return max_err


def _report(name, case, dtype, max_err, ms, bound, plain_ms, lib_ms,
            path=""):
    bound_ms, bound_by = bound
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
    path = f" [{path}]" if path else ""
    print(f"  {name:<23} {case:<34} {dtype:<8} err={max_err:.2e} "
          f"kernel={ms:.4f}ms bound={bound_ms:.4f}ms({bound_by}) "
          f"plain={plain_ms:.4f}ms library={lib}ms{path}", flush=True)


def _tc_path(dt) -> str:
    """Which kernel of flash_attention / moe_ffn a dtype runs."""
    return "tensor-core bf16" if str(dt).endswith("bfloat16") else "exact f32"


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def kernel_cases(bench) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_ffn as mf
    from repro_torch.kernels import paged_decode_attention as pd
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rg
    from repro_torch.kernels import wkv6 as wk

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s, dt=torch.float32: torch.randn(
        s, generator=gen, device=dev).to(dt)
    main = {}

    # -- flash attention ---------------------------------------------------
    def flash_case(label, b, hq, hkv, sq, d, causal, window, dt,
                   model_layout=False):
        """With ``model_layout`` q/k/v are made (B, S, H, d), as the model
        keeps them, and handed over as transposed views."""
        dname = str(dt).split(".")[1]
        if model_layout:
            q, k, v = (rn(b, sq, h, d, dt=dt).transpose(1, 2)
                       for h in (hq, hkv, hkv))
        else:
            q, k, v = rn(b, hq, sq, d, dt=dt), rn(b, hkv, sq, d, dt=dt), \
                rn(b, hkv, sq, d, dt=dt)
        kw = dict(causal=causal, window=window)
        got = fa.flash_attention(q, k, v, **kw)
        want = ref.flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        err = _check("flash_attention", label, got, want, dname)
        qp = np.arange(sq)[:, None]
        kp = np.arange(sq)[None, :]
        okm = np.ones((sq, sq), bool)
        if causal:
            okm &= kp <= qp
        if window is not None:
            okm &= kp > qp - window
        pairs = int(okm.sum())
        bound = _bound(_nbytes(q, k, v, got), 4.0 * b * hq * d * pairs, dname)
        ke = k.repeat_interleave(hq // hkv, 1)
        ve = v.repeat_interleave(hq // hkv, 1)
        mask = (None if (causal and window is None) or not (causal or window)
                else torch.as_tensor(okm, device=dev))
        lib = lambda: F.scaled_dot_product_attention(
            q, ke, ve, attn_mask=mask,
            is_causal=bool(causal and window is None))
        r = (err, bench.ms(lambda: fa.flash_attention(q, k, v, **kw)), bound,
             bench.ms(lambda: ref.flash_attention_ref(q, k, v, **kw)),
             bench.ms(lib))
        _report("flash_attention", label, dname, *r, path=_tc_path(dt))
        return r

    for dt in (torch.float32, torch.bfloat16):
        for b, hq, hkv, s, d, causal, window in [
                (1, 4, 2, 128, 64, True, None), (2, 2, 1, 256, 128, True, None),
                (1, 4, 4, 128, 64, True, 40), (1, 2, 2, 100, 64, True, None),
                (2, 8, 2, 128, 64, False, None)]:
            flash_case(f"b{b} hq{hq} hkv{hkv} s{s} d{d} c{int(causal)} "
                       f"w{window}", b, hq, hkv, s, d, causal, window, dt)
    flash_case("prefill s512 f32 (lossless phase)", 1, 32, 8, 512, 128, True,
               None, torch.float32)
    main["flash_attention"] = flash_case("prefill s512 (serve path)", 1, 32, 8,
                                         512, 128, True, None, torch.bfloat16)
    flash_case("prefill s512 (B,S,H,d) views", 1, 32, 8, 512, 128, True, None,
               torch.bfloat16, model_layout=True)
    flash_case("stress s4096", 1, 32, 8, 4096, 128, True, None, torch.bfloat16)
    for dt in (torch.float32, torch.bfloat16):    # RecurrentGemma SWA prefill
        flash_case("d256 mqa s512 w2048 (rg prefill)", 1, 10, 1, 512, 256,
                   True, 2048, dt)
    flash_case("d256 mqa s512 w2048 (B,S,H,d) views", 1, 10, 1, 512, 256,
               True, 2048, torch.bfloat16, model_layout=True)
    for d in (64, 128, 256):          # the tensor-core kernel's edges
        for causal, window in ((True, None), (True, 40), (False, None)):
            flash_case(f"edge s100 d{d} c{int(causal)} w{window}", 1, 4, 2,
                       100, d, causal, window, torch.bfloat16,
                       model_layout=window is not None)

    # -- paged decode attention --------------------------------------------
    def paged_case(label, b, hq, hkv, m, bs, d, lengths, dt, quant=False,
                   anc=None):
        dname = str(dt).split(".")[1]
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        mbs = -(-int(lengths.max()) // bs)
        nb = b * mbs + 1
        perm = (torch.randperm(nb - 1, generator=gen, device=dev) + 1)
        bt = perm.reshape(b, mbs).to(torch.int32)
        q = rn(b, hq, m, d, dt=dt)
        if quant:
            kp = torch.randint(-127, 128, (nb, bs, hkv, d), generator=gen,
                               device=dev, dtype=torch.int8)
            vp = torch.randint(-127, 128, (nb, bs, hkv, d), generator=gen,
                               device=dev, dtype=torch.int8)
            sc = dict(k_scale=rn(nb, bs, hkv, 1).abs() * 0.01,
                      v_scale=rn(nb, bs, hkv, 1).abs() * 0.01)
        else:
            kp, vp = rn(nb, bs, hkv, d, dt=dt), rn(nb, bs, hkv, d, dt=dt)
            sc = {}
        ab = None if anc is None else torch.as_tensor(anc, dtype=torch.int32,
                                                      device=dev)
        call = lambda: pd.paged_decode_attention(q, kp, vp, bt, lengths,
                                                 anc_bits=ab, **sc)
        plain = lambda: ref.paged_decode_attention_ref(q, kp, vp, bt, lengths,
                                                       anc_bits=ab, **sc)
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = _check("paged_decode_attention", label, got, want, dname)
        lens = lengths.long().cpu().numpy()
        row_b = kp.element_size() * d + (4 if quant else 0)   # one head's row
        kv_bytes = float(2 * hkv * row_b * lens.sum())
        keys = float(sum(max(0, int(n) - m + i + 1)
                         for n in lens for i in range(m)))
        bound = _bound(kv_bytes + _nbytes(q, got, bt, lengths),
                       4.0 * hq * d * keys, dname)
        kg, vg = ref.gather_paged_kv_ref(kp, vp, bt, dtype=dt, **sc)
        kg = kg.transpose(1, 2).repeat_interleave(hq // hkv, 1).contiguous()
        vg = vg.transpose(1, 2).repeat_interleave(hq // hkv, 1).contiguous()
        s_all = kg.shape[2]
        kpos = torch.arange(s_all, device=dev)[None, None, :]
        qpos = (lengths.long()[:, None, None] - m
                + torch.arange(m, device=dev)[None, :, None])
        vis = ((kpos <= qpos) & (kpos < lengths.long()[:, None, None]))
        if ab is not None:
            col = kpos - (lengths.long()[:, None, None] - m)
            bit = (ab.long()[None, :, None] >> col.clamp(0, 31)) & 1
            vis = (col < 0) | ((col >= 0) & (kpos < lengths.long()[:, None,
                                                                   None])
                               & (bit > 0))
        mask = vis[:, None]
        lib = lambda: F.scaled_dot_product_attention(q, kg, vg,
                                                     attn_mask=mask)
        r = (err, bench.ms(call), bound, bench.ms(plain), bench.ms(lib))
        _report("paged_decode_attention", label, dname, *r)
        return r

    rng = np.random.default_rng(0)
    for dt in (torch.float32, torch.bfloat16):
        for b, hq, hkv, m, mbs, bs, d, quant in [
                (2, 4, 2, 1, 4, 16, 64, False), (2, 4, 2, 5, 4, 16, 64, False),
                (1, 8, 1, 4, 8, 8, 128, False), (2, 2, 2, 3, 3, 32, 64, True),
                (1, 4, 2, 4, 5, 16, 64, True)]:
            lens = rng.integers(m + 1, mbs * bs + 1, b)
            paged_case(f"b{b} hq{hq} hkv{hkv} m{m} bs{bs} d{d}"
                       + (" int8" if quant else ""), b, hq, hkv, m, bs, d,
                       lens, dt, quant)
        paged_case("tree anc_bits m4", 2, 4, 2, 4, 16, 64, [37, 50], dt,
                   anc=[1, 3, 5, 11])
    main_lens = rng.integers(512, 608, 4)
    paged_case("verify f32 (lossless phase)", 2, 32, 8, 5, 16, 128,
               main_lens[:2], torch.float32)
    main["paged_decode_attention"] = paged_case(
        "verify b4 m5 ~560 tokens (serve path)", 4, 32, 8, 5, 16, 128,
        main_lens, torch.bfloat16)
    paged_case("stress b8 L32768 m5", 8, 32, 8, 5, 16, 128, [32768] * 8,
               torch.bfloat16)

    # -- MoE FFN -------------------------------------------------------------
    def moe_weights(e, d, f, dt):
        return ((rn(e, d, f) * d ** -0.5).to(dt),
                (rn(e, d, f) * d ** -0.5).to(dt),
                (rn(e, f, d) * f ** -0.5).to(dt))

    def moe_case(label, e, c, d, f, dt, activation="swiglu", weights=None):
        dname = str(dt).split(".")[1]
        buf = rn(e, c, d, dt=dt)
        wg, wu, wd = weights or moe_weights(e, d, f, dt)
        call = lambda: mf.moe_ffn(buf, wg, wu, wd, activation=activation)
        plain = lambda: ref.moe_ffn_ref(buf, wg, wu, wd, activation=activation)
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = _check("moe_ffn", label, got, want, dname)
        bound = _bound(_nbytes(buf, wg, wu, wd, got), 6.0 * e * c * d * f,
                       dname)

        def lib():                    # the einsum path as three bmm calls
            h = ref.ffn_act(torch.bmm(buf, wg), activation)
            return torch.bmm(h * torch.bmm(buf, wu), wd)
        r = (err, bench.ms(call), bound, bench.ms(plain), bench.ms(lib))
        _report("moe_ffn", label, dname, *r, path=_tc_path(dt))
        return r

    for dt in (torch.float32, torch.bfloat16):
        for e, c, d, f in [(4, 128, 64, 256), (2, 100, 128, 300),
                           (8, 64, 32, 128)]:
            moe_case(f"e{e} c{c} d{d} f{f}", e, c, d, f, dt)
        moe_case("gelu e4 c20 d64 f192", 4, 20, 64, 192, dt, "gelu")
    moe_case("verify c10 f32 (lossless phase)", 8, 10, 4096, 14336,
             torch.float32)
    mix_w = moe_weights(8, 4096, 14336, torch.bfloat16)
    main["moe_ffn"] = moe_case("verify c20 (serve path)", 8, 20, 4096, 14336,
                               torch.bfloat16, weights=mix_w)
    moe_case("prefill c257 (serve path)", 8, 257, 4096, 14336, torch.bfloat16,
             weights=mix_w)
    for c in (1, 7, 33, 300):         # token tiles of 8, 8, 40, 2 x 152
        moe_case(f"edge c{c} d4096 f14336", 8, c, 4096, 14336,
                 torch.bfloat16, weights=mix_w)
    del mix_w
    torch.cuda.empty_cache()

    # -- contiguous decode attention ----------------------------------------
    def decode_case(label, b, hq, hkv, m, s, d, lengths, dt, window=None,
                    anc=None):
        """The cache is made (B, S, Hkv, d), as the model keeps it, and
        handed over as a transposed view."""
        dname = str(dt).split(".")[1]
        lengths = torch.as_tensor(lengths, dtype=torch.int32, device=dev)
        q = rn(b, hq, m, d, dt=dt)
        k = rn(b, s, hkv, d, dt=dt).transpose(1, 2)
        v = rn(b, s, hkv, d, dt=dt).transpose(1, 2)
        ab = None if anc is None else torch.as_tensor(anc, dtype=torch.int32,
                                                      device=dev)
        amask = None if ab is None else ref.anc_mask_from_bits(ab, m)
        call = lambda: da.decode_attention(q, k, v, lengths, window=window,
                                           anc_bits=ab)
        plain = lambda: ref.decode_attention_ref(q, k, v, lengths,
                                                 window=window,
                                                 anc_mask=amask)
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = _check("decode_attention", label, got, want, dname)
        kpos = torch.arange(s, device=dev)[None, None, :]
        qpos = (lengths.long()[:, None, None] - m
                + torch.arange(m, device=dev)[None, :, None])
        vis = (kpos <= qpos) & (kpos < lengths.long()[:, None, None])
        if window is not None:
            vis &= kpos > qpos - window
        if ab is not None:
            col = kpos - (lengths.long()[:, None, None] - m)
            bit = (ab.long()[None, :, None] >> col.clamp(0, 31)) & 1
            vis = (col < 0) | ((col >= 0)
                               & (kpos < lengths.long()[:, None, None])
                               & (bit > 0))
        rows_read = float(lengths.clamp(max=s).sum())
        bound = _bound(2.0 * hkv * d * k.element_size() * rows_read
                       + _nbytes(q, got, lengths),
                       4.0 * hq * d * float(vis.sum()), dname)
        ke = k.repeat_interleave(hq // hkv, 1).contiguous()
        ve = v.repeat_interleave(hq // hkv, 1).contiguous()
        lib = lambda: F.scaled_dot_product_attention(q, ke, ve,
                                                     attn_mask=vis[:, None])
        r = (err, bench.ms(call), bound, bench.ms(plain), bench.ms(lib))
        _report("decode_attention", label, dname, *r)
        return r

    for dt in (torch.float32, torch.bfloat16):
        for b, hq, hkv, m, s, d, window in [
                (2, 4, 2, 1, 256, 64, None), (2, 4, 2, 5, 256, 64, None),
                (1, 8, 1, 4, 512, 128, None), (2, 2, 2, 3, 300, 64, None),
                (1, 4, 2, 4, 256, 64, 64)]:
            lens = rng.integers(m + 8, s + 1, b)
            decode_case(f"b{b} hq{hq} hkv{hkv} m{m} s{s} d{d} w{window}", b,
                        hq, hkv, m, s, d, lens, dt, window=window)
        decode_case("tree anc_bits m4", 2, 4, 2, 4, 128, 64, [37, 50], dt,
                    anc=[1, 3, 5, 11])
        decode_case("d256 mqa m5", 2, 10, 1, 5, 640, 256, [300, 640], dt)
    decode_case("verify f32 (lossless phase)", 2, 32, 8, 5, 640, 128,
                main_lens[:2], torch.float32)
    main["decode_attention"] = decode_case(
        "verify b4 m5 s640 (serve path)", 4, 32, 8, 5, 640, 128, main_lens,
        torch.bfloat16)
    decode_case("stress b8 S32768 m5", 8, 32, 8, 5, 32768, 128, [32768] * 8,
                torch.bfloat16)
    torch.cuda.empty_cache()

    # -- RG-LRU scan ----------------------------------------------------------
    def rglru_case(label, b, s, w):
        a = torch.sigmoid(rn(b, s, w))
        g, h0 = rn(b, s, w), rn(b, w)
        call = lambda: rg.rglru_scan(a, g, h0)
        plain = lambda: ref.rglru_scan_ref(a, g, h0)
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = _check("rglru_scan", label, got, want, "float32", TOL_RGLRU)
        bound = _bound(_nbytes(a, g, h0, got), 2.0 * b * s * w, "float32")
        r = (err, bench.ms(call), bound, bench.ms(plain), None)
        _report("rglru_scan", label, "float32", *r)
        return r

    for b, s, w in [(2, 64, 256), (1, 128, 100), (4, 32, 512)]:
        rglru_case(f"b{b} s{s} w{w}", b, s, w)
    main["rglru_scan"] = rglru_case("verify b4 s5 w2560 (serve path)", 4, 5,
                                    2560)
    rglru_case("prefill b1 s512 w2560 (serve path)", 1, 512, 2560)
    rglru_case("stress b8 s4096 w2560", 8, 4096, 2560)

    # -- WKV-6 ----------------------------------------------------------------
    def wkv6_case(label, b, h, s, hd, stack):
        """r/k/v/w as the model hands them over: (B, S, H, hd) transposed."""
        r, k, v = (rn(b, s, h, hd).transpose(1, 2) for _ in range(3))
        w = torch.sigmoid(rn(b, s, h, hd)).transpose(1, 2)
        u, s0 = rn(h, hd) * 0.1, rn(b, h, hd, hd) * 0.1
        call = lambda: wk.wkv6(r, k, v, w, u, s0, stack=stack)
        plain = lambda: ref.wkv6_ref(r, k, v, w, u, s0, stack=stack)
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = max(_check("wkv6", label + f" out{i}", x, y, "float32",
                         TOL_WKV6) for i, (x, y) in enumerate(zip(got, want)))
        bound = _bound(_nbytes(r, k, v, w, u, s0, *got[:1], *got[2:])
                       + (0 if stack else _nbytes(got[1])),
                       6.0 * b * h * s * hd * hd, "float32")
        r_ = (err, bench.ms(call), bound, bench.ms(plain), None)
        _report("wkv6", label, "float32", *r_)
        return r_

    for b, h, s, hd in [(1, 2, 32, 64), (2, 4, 16, 64), (1, 1, 64, 128)]:
        wkv6_case(f"b{b} h{h} s{s} hd{hd}", b, h, s, hd, False)
    main["wkv6"] = wkv6_case("verify+stack b4 h64 s5 (serve path)", 4, 64, 5,
                             64, True)
    wkv6_case("prefill b1 h64 s512 (serve path)", 1, 64, 512, 64, False)
    wkv6_case("stress b8 h64 s2048", 8, 64, 2048, 64, False)
    torch.cuda.empty_cache()
    return main


# ---------------------------------------------------------------------------
# phase 3 / 4: serving


def _engine(tcfg, dcfg, config, seed):
    import torch

    from repro_torch.params import init_params
    from repro_torch.serving.engine import ServingEngine
    eng = ServingEngine(tcfg, dcfg, config=config, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    eng.load(init_params(tcfg, g, "cuda"), init_params(dcfg, g, "cuda"))
    return eng


def _free() -> None:
    """Give the memory of a run's dropped engine and weights back to the
    card before the next run allocates."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def serve_run(label, tcfg, dcfg, paged, n_requests, must_launch,
              must_not_launch=()) -> dict:
    """Serve ``n_requests`` Poisson requests (prompt 512, gen 32-64) with
    ``max_batch=4``, ``n_cand=4``; every kernel's launches are counted
    from 0 over the run.  Returns {kernel: launches}."""
    import torch

    from repro_torch.kernels import reset_launches, wrappers
    from repro_torch.serving.engine import SchedulerConfig, latency_percentiles
    from repro_torch.serving.trace import poisson_requests

    t_run = time.perf_counter()
    eng = _engine(tcfg, dcfg, SchedulerConfig(max_batch=4, n_cand=4,
                                              paged=paged), seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, 512).astype(np.int32)
               for _ in range(n_requests)]
    gens = rng.integers(32, 65, n_requests).tolist()
    reqs = poisson_requests(prompts, gens, rate_rps=4.0, seed=0)
    for r in reqs:
        assert eng.submit(r), f"request {r.rid} rejected"
    torch.cuda.synchronize()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in wrappers()}
    st = eng.stats()
    fused = eng.engine.pipeline(4).trace_counts["fused"]
    ttft = latency_percentiles(done, "ttft_s")
    print(f"  [{label}] {tcfg.name} {tcfg.n_layers} layers / draft "
          f"{dcfg.n_layers} layers, {'paged' if paged else 'contiguous'}: "
          f"served {len(done)} requests, {st['tokens_out']} tokens in "
          f"{wall:.3f}s wall: {st['tok_per_s']:.2f} tok/s over "
          f"{st['rounds']} rounds, occupancy {st['mean_occupancy']:.3f}")
    print(f"  [{label}] round p50={1e3 * st['round_s_p50']:.2f}ms "
          f"p95={1e3 * st['round_s_p95']:.2f}ms  ttft p50={ttft['p50']:.3f}s "
          f"p95={ttft['p95']:.3f}s (virtual clock)  acceptance="
          f"{st['acceptance']:.4f}")
    print(f"  [{label}] peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB  fused shape "
          f"signatures={fused}  launches={launches}")
    assert len(done) == len(reqs), "not every request finished"
    for r in reqs:
        assert r.result is not None and len(r.result) == r.max_new_tokens
        assert ((r.result >= 0) & (r.result < tcfg.vocab_size)).all()
    assert fused == 1, f"fused round ran at {fused} shape signatures"
    for name in must_launch:
        assert launches[name] > 0, f"{name} was never launched in run {label}"
    for name in must_not_launch:
        assert launches[name] == 0, f"{name} was launched in run {label}"
    n_prefills = len(reqs) + (0 if paged else 2)    # + the parked dummies
    print(f"  [{label}] {n_prefills} prefills, {st['rounds']} rounds; "
          f"run wall {time.perf_counter() - t_run:.1f}s", flush=True)
    del eng, done
    _free()
    return launches


def serve_phase() -> dict:
    """Runs 3a-3d; returns {run label: launches}."""
    from repro_torch.configs import (MIXTRAL_8X7B, RECURRENTGEMMA_2B,
                                     RWKV6_7B, SWA, draft_for)

    mix = dataclasses.replace(MIXTRAL_8X7B, n_layers=4)
    mis = draft_for(mix, 4)
    runs = {"3a": serve_run("3a", mix, mis, True, 12,
                            ("paged_decode_attention", "flash_attention",
                             "moe_ffn"))}
    rw_draft = draft_for(RWKV6_7B, 2)
    runs["3b"] = serve_run("3b", RWKV6_7B, rw_draft, False, 8,
                           ("wkv6", "flash_attention"))
    # RWKV has no attention: every flash launch is the draft's prefill
    assert runs["3b"]["flash_attention"] == 2 * (8 + 2)
    rg_draft = draft_for(RECURRENTGEMMA_2B, 2)
    runs["3c"] = serve_run("3c", RECURRENTGEMMA_2B, rg_draft, False, 8,
                           ("rglru_scan", "flash_attention"))
    # one flash launch per attention layer per prefill (8 requests + the 2
    # parked dummies): the target's SWA layers run it at head dim 256
    n_swa = sum(RECURRENTGEMMA_2B.layer_kind(l) == SWA
                for l in range(RECURRENTGEMMA_2B.n_layers))
    assert runs["3c"]["flash_attention"] == (n_swa + 2) * (8 + 2)
    print(f"  [3c] flash launches at head dim 256 (target SWA prefill): "
          f"{n_swa * (8 + 2)} of {runs['3c']['flash_attention']}")
    runs["3d"] = serve_run("3d", mix, mis, False, 8,
                           ("decode_attention", "flash_attention", "moe_ffn"),
                           ("paged_decode_attention",))
    return runs


def _greedy_check(label, tp, tcfg, reqs) -> None:
    """Every served stream equals the port's own target-only greedy
    decode; on a mismatch name the first divergent position and the
    top-2 logit gap there."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_cache
    for r in reqs:
        steps = r.max_new_tokens
        cache = init_cache(tcfg, 1, len(r.prompt) + steps + 1, "cuda")
        lg, cache = M.prefill(tp, tcfg, torch.as_tensor(
            r.prompt[None], device="cuda").long(), cache)
        ref_toks, gaps = [], []
        for _ in range(steps):
            top2 = torch.topk(lg[0], 2).values
            gaps.append(float(top2[0] - top2[1]))
            tok = torch.argmax(lg, -1)
            ref_toks.append(int(tok[0]))
            lg, cache = M.decode_step(tp, tcfg, cache, tok[:, None])
        ref_toks = np.asarray(ref_toks)
        if not np.array_equal(ref_toks, r.result):
            i = int(np.nonzero(ref_toks != r.result)[0][0])
            raise AssertionError(
                f"[{label}] request {r.rid}: served stream diverges from "
                f"greedy decode at position {i} (served {r.result[i]}, "
                f"greedy {ref_toks[i]}, top-2 logit gap there {gaps[i]:.3e})")
        print(f"  [{label}] request {r.rid}: prompt {len(r.prompt)}, {steps} "
              f"tokens identical to greedy decode (min top-2 gap "
              f"{min(gaps):.3e})")


def lossless_run(label, tcfg, dcfg, paged, must_launch) -> None:
    import torch

    from repro_torch.kernels import reset_launches, wrappers
    from repro_torch.serving.engine import SchedulerConfig
    from repro_torch.serving.trace import poisson_requests

    t_run = time.perf_counter()
    eng = _engine(tcfg, dcfg, SchedulerConfig(max_batch=2, n_cand=4,
                                              paged=paged), seed=1)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, tcfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(40, 130, 6)]
    gens = rng.integers(16, 33, 6).tolist()
    reqs = poisson_requests(prompts, gens, rate_rps=20.0, seed=1)
    for r in reqs:
        assert eng.submit(r)
    done = eng.run()
    assert len(done) == len(reqs)
    assert any(r.queue_s > 0 for r in reqs), "no mid-flight admission"
    fused = eng.engine.pipeline(4).trace_counts["fused"]
    assert fused == 1, f"fused round ran at {fused} shape signatures"
    reset_launches()
    _greedy_check(label, eng.engine.tp, tcfg, reqs)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in wrappers()}
    for name in must_launch:           # the greedy decode ran the kernels
        assert launches[name] > 0, f"[{label}] greedy decode skipped {name}"
    print(f"  [{label}] {tcfg.name} {tcfg.n_layers} layers, "
          f"{'paged' if paged else 'contiguous'}: fused shape "
          f"signatures={fused}; greedy decode launches={launches}; run wall "
          f"{time.perf_counter() - t_run:.1f}s", flush=True)
    del eng, done
    _free()


def lossless_phase() -> None:
    from repro_torch.configs import (MIXTRAL_8X7B, RECURRENTGEMMA_2B,
                                     RWKV6_7B, draft_for)
    f32 = lambda c, n: dataclasses.replace(c, n_layers=n, dtype="float32")
    mix = f32(MIXTRAL_8X7B, 2)
    mis = draft_for(mix, 2)
    lossless_run("4a", mix, mis, True, ("flash_attention", "decode_attention",
                                        "moe_ffn"))
    lossless_run("4b", mix, mis, False, ("flash_attention",
                                         "decode_attention", "moe_ffn"))
    rw = f32(RWKV6_7B, 2)
    lossless_run("4c", rw, draft_for(rw, 2), False, ("wkv6",))
    rgc = f32(RECURRENTGEMMA_2B, 3)
    lossless_run("4d", rgc, draft_for(rgc, 2), False,
                 ("rglru_scan", "flash_attention"))


# ---------------------------------------------------------------------------


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    t_all = time.perf_counter()
    print("== 1. environment")
    print(smi)
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    per_source = _build.build_all()
    print(f"  kernels built in {time.perf_counter() - t0:.2f}s wall "
          f"(nvcc seconds per source: "
          + ", ".join(f"{k}={v:.2f}" for k, v in per_source.items()) + ")",
          flush=True)
    for src, kern in (("moe_ffn", "moe_wgmma_kernel"),
                      ("flash_attention", "flash_fwd_wgmma_kernel")):
        print(f"  ptxas -v {kern} (<template args>: registers, static smem "
              "B, spill stores/loads B): " + "; ".join(
                  f"<{a}>: {r}, {sm}, {ss}/{sl}"
                  for a, r, sm, ss, sl in _build.ptxas_usage(src, kern)))

    phases = {}
    t0 = time.perf_counter()
    print("== 2. kernels against their plain versions")
    main_cases = kernel_cases(Bench(torch))
    phases["2"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print("== 3. serve (bf16, weights from a seed)", flush=True)
    runs = serve_phase()
    phases["3"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    print("== 4. lossless (f32)", flush=True)
    lossless_phase()
    phases["4"] = time.perf_counter() - t0
    print("  phase wall seconds: " + ", ".join(
        f"{k}={v:.1f}" for k, v in phases.items())
        + f", total {time.perf_counter() - t_all:.1f}")

    kernels = []
    for name, run in PATH_RUN.items():
        err, ms, (bound_ms, bound_by), plain_ms, lib_ms = main_cases[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{name}.cu",
                        "replaces": REPLACES[name],
                        "launches": runs[run][name], "max_abs_err": err,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": lib_ms})
    print("== 5. kernels")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
