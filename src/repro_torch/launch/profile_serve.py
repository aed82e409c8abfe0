"""Where a serving round spends its time on the card.

    python -m repro_torch.launch.profile_serve [--arch mixtral-8x7b]
        [--layers 4] [--contiguous] [--tree 3,2] [--rounds 20] [--ttft 8]
        [--eager]

Builds a serving configuration of ``chip_smoke.py``'s serve phase
(``--arch`` target — Mixtral-8x7B by default, or RWKV-6-7B or
RecurrentGemma-2B — with ``--layers`` layers, 0 for the full depth, and
its Mistral-7B-width draft (``configs.draft_for``) of as many layers, 2
at full depth; bf16, weights from a seed, ``max_batch=4``, ``n_cand=4``,
paged KV unless ``--contiguous``, which the recurrent targets need;
``--tree`` serves tree speculation of that branching with the draft made
all-attention, as the JAX serving bench does),
fills every slot with 512-token prompts, runs ``--warmup`` scheduler
steps, then traces ``--rounds`` steady-state steps (no admissions) with
``torch.profiler``.  The wall time per round is taken over ``--rounds``
untraced steps first (the profiler slows the host); then it prints the
device time per round over the traced steps, the device's idle share
(one minus device time over untraced wall time), and the device time
and launches per round by kernel and by group (the port's kernels,
cuBLAS products, the rest).  The rounds run as the pipeline's CUDA
graphs (captured during the warmup steps), or eagerly with
``--eager``; in tree mode the eager route also prints the device time
of the plain masked attention that the draft's level feeds run (the
``models.attention.TREE_PLAIN_RANGE`` ranges: a tree round enters one
per level feed and layer), which a graph's replay does not enter.
``--ttft N`` first serves N Poisson requests on the same engine as
``chip_smoke.py``'s serve runs do (prompt 512, generation 32-64, 4
requests/s, seed 0) and prints their time to first token on the
virtual clock.  ``--trace PATH`` also writes
the Chrome trace.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import re
import time

import numpy as np
import torch

from repro_torch.configs import ATTN, draft_for, get_config
from repro_torch.models.attention import TREE_PLAIN_RANGE
from repro_torch.params import init_params
from repro_torch.serving.engine import (SchedulerConfig, ServingEngine,
                                        latency_percentiles)
from repro_torch.serving.trace import poisson_requests

# Each kernel lands in the first group whose pattern it matches: the paged
# pattern comes first, since the contiguous one also matches its names.
# The recurrences' patterns match both their earlier single kernels and
# the serial / chunked (wkv6) and serial / time-parallel (RG-LRU) pairs;
# their backward kernels (training) have groups of their own, as do the
# span tracer's marks (a traced run's one-thread stamp kernels).
GROUPS = (("moe_ffn_bwd kernels", r"moe_bwd_(act|wgmma|f32)_kernel"),
          ("moe_ffn kernels", r"moe_wgmma_kernel|grouped_gemm_kernel"),
          ("paged_decode_attention kernel", r"paged_decode_(mma_)?kernel"),
          ("decode_attention kernel", r"decode_(mma_)?kernel"),
          ("rglru_scan kernels", r"rglru_(scan|serial|parallel)_kernel"),
          ("rglru_scan_bwd kernels", r"rglru_bwd_(chunked_|sum_)?kernel"),
          ("wkv6_bwd kernels", r"wkv6_bwd_(chunked_|slab_sum_|du_)?kernel"),
          ("wkv6 kernels", r"wkv6_(chunked_)?kernel"),
          ("flash_attention kernel", r"flash_fwd_(wgmma_)?kernel"),
          ("flash_attention_bwd kernels",
           r"bwd_(delta|dkdv_wgmma|dq_wgmma|dkdv_f32|dq_f32)_kernel"),
          ("tracer marks", r"obs_mark_"),
          ("cuBLAS products", r"gemm|gemv|cutlass|xmma|cublas|nvjet|sm90_"),
          ("everything else", r""))


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _level_feed_ms(prof, rounds: int) -> tuple:
    """(device ms, ranges) a round of the level-feed ranges: the kernels
    launched inside them (the profiler's device-side copy of the range,
    which spans the idle gaps too, left out)."""
    total_us, n = 0.0, 0

    def walk(evt):
        nonlocal total_us
        total_us += sum(k.duration for k in evt.kernels
                        if k.name != TREE_PLAIN_RANGE)
        for child in evt.cpu_children:
            walk(child)
    for evt in prof.events():
        if (evt.name == TREE_PLAIN_RANGE
                and evt.device_type == torch.autograd.DeviceType.CPU):
            n += 1
            walk(evt)
    return total_us / 1e3 / rounds, n / rounds


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--layers", type=int, default=4,
                    help="target layers (0: the configuration's depth)")
    ap.add_argument("--contiguous", action="store_true",
                    help="contiguous KV (paged=False) instead of paged")
    ap.add_argument("--tree", default=None,
                    help="speculation-tree branching, e.g. 3,2 (the draft "
                    "is made all-attention)")
    ap.add_argument("--warmup", type=int, default=10)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--ttft", type=int, default=0,
                    help="first serve this many requests and print TTFT")
    ap.add_argument("--trace", default=None,
                    help="write the Chrome trace of the traced steps here")
    ap.add_argument("--eager", action="store_true",
                    help="run the rounds eagerly instead of as CUDA graphs")
    args = ap.parse_args(argv)

    tcfg = get_config(args.arch)
    if args.layers:
        tcfg = dataclasses.replace(tcfg, n_layers=args.layers)
    dcfg = draft_for(tcfg, args.layers or 2)
    tree = None
    if args.tree:
        tree = tuple(int(k) for k in args.tree.split(","))
        dcfg = dataclasses.replace(dcfg, layer_pattern=(ATTN,) * dcfg.n_layers)
    eng = ServingEngine(tcfg, dcfg, device="cuda",
                        config=SchedulerConfig(max_batch=4, n_cand=4,
                                               paged=not args.contiguous,
                                               spec_tree=tree,
                                               graphs=not args.eager))
    g = torch.Generator(device="cuda").manual_seed(0)
    eng.load(init_params(tcfg, g, "cuda"), init_params(dcfg, g, "cuda"))
    if args.ttft:
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, tcfg.vocab_size, 512).astype(np.int32)
                   for _ in range(args.ttft)]
        gens = rng.integers(32, 65, args.ttft).tolist()
        for r in poisson_requests(prompts, gens, rate_rps=4.0, seed=0):
            eng.submit(r)
        done = eng.run()
        t = latency_percentiles(done, "ttft_s")
        print(f"ttft over {len(done)} requests (virtual clock): "
              f"p50={t['p50']:.4f}s p95={t['p95']:.4f}s")
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
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key != TREE_PLAIN_RANGE]
    dev_ms = {e.key: _device_us(e) / 1e3 / args.rounds for e in kernels}
    calls = {e.key: e.count / args.rounds for e in kernels}
    busy = sum(dev_ms.values())
    print(f"{torch.cuda.get_device_name(0)}: {tcfg.name} {tcfg.n_layers} "
          f"layers, draft {dcfg.n_layers} layers, "
          f"{'contiguous' if args.contiguous else 'paged'}, "
          + (f"tree {tree}" if tree else "chain n_cand 4")
          + f", {'eager' if args.eager else 'CUDA graphs'}, "
          f"{args.rounds} steady-state rounds; graph captures "
          f"{eng.stats()['graph_captures']}")
    print(f"wall {wall_ms:.3f} ms/round, device {busy:.3f} ms/round, "
          f"device idle share {1 - busy / wall_ms:.3f}")
    left = dict(dev_ms)
    for label, pat in GROUPS:
        hit = {k: v for k, v in left.items() if re.search(pat, k)}
        for k in hit:
            del left[k]
        print(f"  {label:<32} {sum(hit.values()):9.3f} ms/round "
              f"({sum(hit.values()) / max(busy, 1e-9):.1%} of device time, "
              f"{sum(calls[k] for k in hit):.1f} launches/round)")
    if tree and args.eager:
        ms, n = _level_feed_ms(prof, args.rounds)
        print(f"  {TREE_PLAIN_RANGE:<32} {ms:9.3f} ms/round ({n:.1f} "
              "ranges/round; its kernels are inside the groups above)")
    elif tree:
        print(f"  {TREE_PLAIN_RANGE}: with --eager only (a graph's replay "
              "enters no range)")
    print("top kernels by device time:")
    for k, v in sorted(dev_ms.items(), key=lambda kv: -kv[1])[:15]:
        print(f"  {v:9.4f} ms/round  {k[:110]}")
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)


if __name__ == "__main__":
    main()
