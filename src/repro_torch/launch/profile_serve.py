"""Where a serving round spends its time on the card.

    python -m repro_torch.launch.profile_serve [--arch mixtral-8x7b]
        [--layers 4] [--contiguous] [--rounds 20]

Builds a serving configuration of ``chip_smoke.py``'s serve phase
(``--arch`` target — Mixtral-8x7B by default, or RWKV-6-7B or
RecurrentGemma-2B — with ``--layers`` layers, 0 for the full depth, and
its Mistral-7B-width draft (``configs.draft_for``) of as many layers, 2
at full depth; bf16, weights from a seed, ``max_batch=4``, ``n_cand=4``,
paged KV unless ``--contiguous``, which the recurrent targets need),
fills every slot with 512-token prompts, runs ``--warmup`` scheduler
steps, then traces ``--rounds`` steady-state steps (no admissions) with
``torch.profiler``.  The wall time per round is taken over ``--rounds``
untraced steps first (the profiler slows the host); then it prints the
device time per round over the traced steps, the device's idle share
(one minus device time over untraced wall time), and the device time by
kernel and by group (the port's six kernels, cuBLAS products, the
rest).  ``--trace PATH`` also writes the Chrome trace.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import re
import time

import numpy as np
import torch

from repro_torch.configs import draft_for, get_config
from repro_torch.params import init_params
from repro_torch.serving.engine import SchedulerConfig, ServingEngine
from repro_torch.serving.trace import poisson_requests

GROUPS = (("moe_ffn kernels", r"moe_wgmma_kernel|grouped_gemm_kernel"),
          ("paged_decode_attention kernel", r"paged_decode_kernel"),
          ("decode_attention kernel", r"decode_kernel"),
          ("rglru_scan kernel", r"rglru_scan_kernel"),
          ("wkv6 kernel", r"wkv6_kernel"),
          ("flash_attention kernel", r"flash_fwd_(wgmma_)?kernel"),
          ("cuBLAS products", r"gemm|gemv|cutlass|xmma|cublas|nvjet|sm90_"),
          ("everything else", r""))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--layers", type=int, default=4,
                    help="target layers (0: the configuration's depth)")
    ap.add_argument("--contiguous", action="store_true",
                    help="contiguous KV (paged=False) instead of paged")
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--trace", default=None,
                    help="write the Chrome trace of the traced steps here")
    args = ap.parse_args(argv)

    tcfg = get_config(args.arch)
    if args.layers:
        tcfg = dataclasses.replace(tcfg, n_layers=args.layers)
    dcfg = draft_for(tcfg, args.layers or 2)
    eng = ServingEngine(tcfg, dcfg, device="cuda",
                        config=SchedulerConfig(max_batch=4, n_cand=4,
                                               paged=not args.contiguous))
    g = torch.Generator(device="cuda").manual_seed(0)
    eng.load(init_params(tcfg, g, "cuda"), init_params(dcfg, g, "cuda"))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tcfg.vocab_size, 512).astype(np.int32)
               for _ in range(8)]
    gen = args.warmup + 2 * args.rounds + 8      # nobody retires in the window
    for r in poisson_requests(prompts, gen, rate_rps=1e6, seed=0):
        eng.submit(r)
    for _ in range(args.warmup):
        eng.run_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.rounds):
        eng.run_step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / args.rounds
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.rounds):
            eng.run_step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_ms = {e.key: _device_us(e) / 1e3 / args.rounds for e in kernels}
    busy = sum(dev_ms.values())
    print(f"{torch.cuda.get_device_name(0)}: {tcfg.name} {tcfg.n_layers} "
          f"layers, draft {dcfg.n_layers} layers, "
          f"{'contiguous' if args.contiguous else 'paged'}, {args.rounds} "
          f"steady-state rounds")
    print(f"wall {wall_ms:.3f} ms/round, device {busy:.3f} ms/round, "
          f"device idle share {1 - busy / wall_ms:.3f}")
    left = dict(dev_ms)
    for label, pat in GROUPS:
        hit = {k: v for k, v in left.items() if re.search(pat, k)}
        for k in hit:
            del left[k]
        print(f"  {label:<32} {sum(hit.values()):9.3f} ms/round "
              f"({sum(hit.values()) / max(busy, 1e-9):.1%} of device time)")
    print("top kernels by device time:")
    for k, v in sorted(dev_ms.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {v:9.4f} ms/round  {k[:110]}")
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
