"""The device trace of a traced run: ``torch.profiler`` over a slice of
the window, read back as kernel intervals.

Groups (copied from the program's ``launch/profile_serve.py``): each
kernel lands in the first group whose pattern it matches.
"""
from __future__ import annotations

import json
import os
import re
import tempfile

import torch

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
          ("cuBLAS products", r"gemm|gemv|cutlass|xmma|cublas|nvjet|sm90_"),
          ("everything else", r""))

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime", "cuda_driver")


def group_of(name: str) -> str:
    for label, pat in GROUPS:
        if re.search(pat, name):
            return label
    return GROUPS[-1][0]


def start():
    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    return prof


def stop(prof) -> dict:
    """Stop and read: ``{"device": [(name, t0_us, t1_us)], "host":
    [(cat, name, t0_us, t1_us)]}``.  The trace passes through a temporary
    file under ``TMPDIR``, deleted at once."""
    prof.stop()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    if isinstance(events, dict):
        events = events.get("traceEvents", [])
    dev, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t0 = float(e["ts"])
        t1 = t0 + float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            dev.append((e.get("name", ""), t0, t1))
        elif cat in HOST_CATS:
            host.append((cat, e.get("name", ""), t0, t1))
    dev.sort(key=lambda x: x[1])
    return {"device": dev, "host": host}


def union_us(intervals) -> float:
    total, hi = 0.0, None
    for _, a, b in intervals:
        if hi is None or a > hi:
            total += b - a
            hi = b
        elif b > hi:
            total += b - hi
            hi = b
    return total


def idle_gaps(dev: list, host: list, top: int = 10) -> list:
    """The longest gaps between device operations, each named by what
    the host ran at its middle (the innermost annotation and op)."""
    gaps, hi = [], None
    for _, a, b in dev:
        if hi is not None and a > hi:
            gaps.append((a - hi, hi, a))
        hi = b if hi is None else max(hi, b)
    gaps.sort(reverse=True)
    out = []
    for length, a, b in gaps[:top]:
        mid = 0.5 * (a + b)
        inner = {}
        for cat, name, t0, t1 in host:
            if t0 <= mid <= t1:
                kind = "annotation" if cat == "user_annotation" else "op"
                if kind not in inner or t1 - t0 < inner[kind][0]:
                    inner[kind] = (t1 - t0, name)
        label = " / ".join(inner[k][1] for k in ("annotation", "op")
                           if k in inner) or "host (no op recorded)"
        out.append([label, length / 1e6])
    return out


def by_group(dev: list) -> dict:
    """Device seconds and launches by group."""
    out = {}
    for name, a, b in dev:
        g = group_of(name)
        s, n = out.get(g, (0.0, 0))
        out[g] = (s + (b - a) / 1e6, n + 1)
    return out


def top_ops(dev: list, top: int = 10) -> list:
    tot = {}
    for name, a, b in dev:
        tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:top]]
