#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100: the kernels are built for sm_90a) and the
CUDA toolkit's ``nvcc``; imports nothing of JAX.  Phases, each printed
on its own lines:

1. environment: the card's name and power limit, torch/CUDA versions,
   the kernels' build time (every ``csrc/*.cu``, one nvcc each, in
   parallel);
2. every kernel against its plain PyTorch version on the card at the
   cases of tests/test_kernels.py, the serving path's shapes and a
   stress shape each: max error against the tolerance (f32 2e-5 with
   TF32 off, bf16 2e-2), kernel time (CUDA events, L2 flushed before
   each launch), its bound on this card and what sets it, the plain
   version's time and one library call's time as a yardstick;
3. serve: Mixtral-8x7B / Mistral-7B widths, 4 layers each, bf16,
   weights from a seed; ``ServingEngine(max_batch=4, n_cand=4)`` over 12
   Poisson requests (prompt 512, gen 32-64), with every kernel's launch
   count read around the run;
4. lossless: the same widths, 2 layers each, f32, ``max_batch=2``, 6
   requests with mid-flight admission; every stream must equal the
   port's own target-only greedy decode;
5. the kernels as one JSON object; 6. the device as one JSON object.

Any failure raises and exits non-zero; so does a machine with no card.
"""
from __future__ import annotations

import dataclasses
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
REPLACES = {
    "paged_decode_attention": "src/repro/kernels/decode_attention.py:297",
    "flash_attention": "src/repro/kernels/flash_attention.py:111",
    "moe_ffn": "src/repro/kernels/moe_ffn.py:68",
}


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


def _check(name, case, got, want, dtype):
    import torch
    tol = TOL[dtype]
    err = (got.float() - want.float()).abs()
    ok = bool((err <= tol + tol * want.float().abs()).all())
    bad = int(torch.isnan(got.float()).sum())
    max_err = float(err.max())
    if not ok or bad:
        raise AssertionError(f"{name} {case}: kernel disagrees with its plain "
                             f"version (max abs err {max_err:.3e}, tol {tol}, "
                             f"{bad} NaN)")
    return max_err


def _report(name, case, dtype, max_err, ms, bound, plain_ms, lib_ms):
    bound_ms, bound_by = bound
    lib = "n/a" if lib_ms is None else f"{lib_ms:.4f}"
    print(f"  {name:<23} {case:<34} {dtype:<8} err={max_err:.2e} "
          f"kernel={ms:.4f}ms bound={bound_ms:.4f}ms({bound_by}) "
          f"plain={plain_ms:.4f}ms library={lib}ms", flush=True)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions


def kernel_cases(bench) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import moe_ffn as mf
    from repro_torch.kernels import paged_decode_attention as pd
    from repro_torch.kernels import ref

    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(0)
    rn = lambda *s, dt=torch.float32: torch.randn(
        s, generator=gen, device=dev).to(dt)
    main = {}

    # -- flash attention ---------------------------------------------------
    def flash_case(label, b, hq, hkv, sq, d, causal, window, dt):
        dname = str(dt).split(".")[1]
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
        _report("flash_attention", label, dname, *r)
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
    flash_case("stress s4096", 1, 32, 8, 4096, 128, True, None, torch.bfloat16)

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
    def moe_case(label, e, c, d, f, dt, activation="swiglu"):
        dname = str(dt).split(".")[1]
        buf = rn(e, c, d, dt=dt)
        wg = (rn(e, d, f) * d ** -0.5).to(dt)
        wu = (rn(e, d, f) * d ** -0.5).to(dt)
        wd = (rn(e, f, d) * f ** -0.5).to(dt)
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
        _report("moe_ffn", label, dname, *r)
        return r

    for dt in (torch.float32, torch.bfloat16):
        for e, c, d, f in [(4, 128, 64, 256), (2, 100, 128, 300),
                           (8, 64, 32, 128)]:
            moe_case(f"e{e} c{c} d{d} f{f}", e, c, d, f, dt)
        moe_case("gelu e4 c20 d64 f192", 4, 20, 64, 192, dt, "gelu")
    moe_case("verify c10 f32 (lossless phase)", 8, 10, 4096, 14336,
             torch.float32)
    main["moe_ffn"] = moe_case("verify c20 (serve path)", 8, 20, 4096, 14336,
                               torch.bfloat16)
    moe_case("prefill c257 (serve path)", 8, 257, 4096, 14336, torch.bfloat16)
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


def serve_phase() -> dict:
    import torch

    from repro_torch.configs import MISTRAL_7B, MIXTRAL_8X7B
    from repro_torch.kernels import reset_launches, wrappers
    from repro_torch.serving.engine import SchedulerConfig, latency_percentiles
    from repro_torch.serving.trace import poisson_requests

    tcfg = dataclasses.replace(MIXTRAL_8X7B, n_layers=4)
    dcfg = dataclasses.replace(MISTRAL_7B, n_layers=4)
    eng = _engine(tcfg, dcfg, SchedulerConfig(max_batch=4, n_cand=4), seed=0)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, 512).astype(np.int32)
               for _ in range(12)]
    gens = rng.integers(32, 65, 12).tolist()
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
    print(f"  served {len(done)} requests, {st['tokens_out']} tokens in "
          f"{wall:.3f}s wall: {st['tok_per_s']:.2f} tok/s over "
          f"{st['rounds']} rounds, occupancy {st['mean_occupancy']:.3f}")
    print(f"  round p50={1e3 * st['round_s_p50']:.2f}ms "
          f"p95={1e3 * st['round_s_p95']:.2f}ms  ttft p50={ttft['p50']:.3f}s "
          f"p95={ttft['p95']:.3f}s (virtual clock)  acceptance="
          f"{st['acceptance']:.4f}")
    print(f"  peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"
          f"  fused shape signatures={fused}  launches={launches}")
    assert len(done) == len(reqs), "not every request finished"
    for r in reqs:
        assert r.result is not None and len(r.result) == r.max_new_tokens
        assert ((r.result >= 0) & (r.result < tcfg.vocab_size)).all()
    assert fused == 1, f"fused round ran at {fused} shape signatures"
    for name, n in launches.items():
        assert n > 0, f"{name} was never launched on the serving path"
    del eng
    torch.cuda.empty_cache()
    return launches


def lossless_phase() -> None:
    import torch

    from repro_torch.configs import MISTRAL_7B, MIXTRAL_8X7B
    from repro_torch.models import model as M
    from repro_torch.models.transformer import init_cache
    from repro_torch.serving.engine import SchedulerConfig
    from repro_torch.serving.trace import poisson_requests

    tcfg = dataclasses.replace(MIXTRAL_8X7B, n_layers=2, dtype="float32")
    dcfg = dataclasses.replace(MISTRAL_7B, n_layers=2, dtype="float32")
    eng = _engine(tcfg, dcfg, SchedulerConfig(max_batch=2, n_cand=4), seed=1)
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
    tp = eng.engine.tp
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
                f"request {r.rid}: served stream diverges from greedy decode "
                f"at position {i} (served {r.result[i]}, greedy "
                f"{ref_toks[i]}, top-2 logit gap there {gaps[i]:.3e})")
        print(f"  request {r.rid}: prompt {len(r.prompt)}, {steps} tokens "
              f"identical to greedy decode (min top-2 gap "
              f"{min(gaps):.3e})")
    print(f"  fused shape signatures="
          f"{eng.engine.pipeline(4).trace_counts['fused']}")
    del eng, tp
    torch.cuda.empty_cache()


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

    print("== 2. kernels against their plain versions")
    main_cases = kernel_cases(Bench(torch))
    print("== 3. serve (full widths, 4 layers each, bf16)", flush=True)
    launches = serve_phase()
    print("== 4. lossless (full widths, 2 layers each, f32)", flush=True)
    lossless_phase()

    kernels = []
    for name in ("paged_decode_attention", "flash_attention", "moe_ffn"):
        err, ms, (bound_ms, bound_by), plain_ms, lib_ms = main_cases[name]
        kernels.append({"name": name, "route": "cuda",
                        "source": f"src/repro_torch/csrc/{name}.cu",
                        "replaces": REPLACES[name],
                        "launches": launches[name], "max_abs_err": err,
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
