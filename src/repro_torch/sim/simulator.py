"""Discrete-event simulator of the SpecOffload pipeline + baselines.

Used to reproduce the paper's measured results (Figs 1/2/5/6/8, Tables 3/4)
on hardware we don't have.  The SpecOffload model reuses the ParaSpec
planner's latency equations (which were calibrated against Table 3);
ablations modify the pipeline structure, not the constants:

* ``serial_sd``  — speculative decoding *outside* the pipeline: draft runs
  serially between target rounds (no overlap) and its weights/KV must be
  streamed in and out each round (the paper's "loosely coupled" mode).
* ``no_sd``      — the pipeline without a draft model (FlexGen-like
  schedule but with our prefill/batching).
* ``no_policy``  — a deliberately bad policy (the paper uses a random one).

It also emits a decode-phase **timeline** of GPU-busy intervals so the
Fig 6/7 utilization/periodicity plots can be reproduced.  A copy of
``repro/sim/simulator.py``: the same floats.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

from repro_torch.configs import ModelConfig
from repro_torch.core.planner import (ParaSpecPlanner, Policy, Workload,
                                      attn_flops_per_token,
                                      dense_flops_per_token,
                                      kv_bytes_per_token, layer_ffn_bytes)
from repro_torch.sim.baselines import BASELINES, SystemResult, nvsmi_util
from repro_torch.sim.hardware import HardwareSpec


@dataclass
class Timeline:
    """GPU-busy intervals (start, end, kind) during one decode window."""
    events: list = field(default_factory=list)
    horizon: float = 0.0

    def busy_fraction(self) -> float:
        busy = sum(e - s for s, e, _ in self.events)
        return busy / max(self.horizon, 1e-9)


def simulate_specoffload(target: ModelConfig, draft: ModelConfig,
                         hw: HardwareSpec, wl: Workload, pol: Policy,
                         mode: str = "full") -> SystemResult:
    """mode: full | serial_sd | no_sd | no_policy."""
    planner = ParaSpecPlanner(target, draft, hw)
    rep = planner.evaluate(pol, wl)
    m = pol.n_cand
    e_n = rep.expected_tokens
    bs = pol.bs_decode * 2

    if mode == "no_sd":
        # no draft: one token per round.  The CPU attention still reads the
        # whole KV working set per round and the FFN stream is unchanged,
        # so the round costs nearly as much as a verify round but yields 1
        # token instead of E[n] — that is the paper's whole point.
        ctx = wl.prompt_len + wl.gen_len / 2
        kv_read = pol.bs_decode * ctx * kv_bytes_per_token(target)
        t_attn = max(pol.bs_decode * attn_flops_per_token(target, int(ctx))
                     / hw.host_flops,
                     kv_read / (hw.host_mem_bw * hw.host_attn_eff))
        t_stream = target.n_layers * layer_ffn_bytes(target) / hw.h2d_bw
        t_gpu = pol.bs_decode * dense_flops_per_token(target) \
            / hw.accel_flops
        t_round = max(t_attn, t_stream) + t_gpu
        t_dec = 2 * wl.gen_len * t_round
        thr = bs * wl.gen_len / (rep.t_prefill + t_dec)
        util = nvsmi_util(t_gpu / t_round, min(t_stream, t_round) / t_round)
        return SystemResult("specoffload[no_sd]", thr, util,
                            {"t_round": t_round})

    if mode == "serial_sd":
        # draft runs between target rounds; its weights+KV stream in/out
        draft_io = 2 * draft.param_bytes() / hw.h2d_bw
        t_round = rep.t_target + rep.t_draft + draft_io
        n_iter = math.ceil(wl.gen_len / e_n)
        t_dec = 2 * n_iter * t_round
        thr = bs * wl.gen_len / (rep.t_prefill + t_dec)
        util = nvsmi_util((rep.detail["t_ffn_gpu"] + rep.t_draft) / t_round,
                          rep.detail["t_ffn_stream"] / t_round)
        return SystemResult("specoffload[serial_sd]", thr, util,
                            {"t_round": t_round, "draft_io": draft_io})

    thr = rep.throughput
    util = _gpu_util_full(rep)
    name = "specoffload" if mode == "full" else f"specoffload[{mode}]"
    return SystemResult(name, thr, util,
                        {"t_round": rep.detail["t_round"],
                         "t_draft": rep.t_draft,
                         "t_target": rep.t_target,
                         "E[n]": e_n,
                         "t_prefill": rep.t_prefill,
                         "t_decode": rep.t_decode})


def _gpu_util_full(rep) -> float:
    """Draft compute + target FFN/verify compute over the round, mapped to
    the nvidia-smi-style metric (see sim.baselines.nvsmi_util)."""
    t_round = rep.detail["t_round"]
    busy = min(rep.t_draft + rep.detail["t_ffn_gpu"], t_round)
    io = min(rep.detail["t_ffn_stream"], t_round)
    return nvsmi_util(busy / t_round, io / t_round * (1 - busy / t_round))


# ---------------------------------------------------------------------------
# paper-table drivers


def end_to_end(target: ModelConfig, draft: ModelConfig, hw: HardwareSpec,
               wl: Workload, pol: Policy) -> dict:
    """Fig 5: SpecOffload vs the four baselines."""
    out = {}
    spec = simulate_specoffload(target, draft, hw, wl, pol)
    out["specoffload"] = spec
    for name, fn in BASELINES.items():
        out[name] = fn(target, hw, wl.prompt_len, wl.gen_len)
    return out


def ablation(target: ModelConfig, draft: ModelConfig, hw: HardwareSpec,
             wl: Workload, pol: Policy, bad_pol: Policy) -> dict:
    """Table 4: all-opt vs no-policy vs serial-SD vs no-SD."""
    return {
        "all": simulate_specoffload(target, draft, hw, wl, pol),
        "no_policy": simulate_specoffload(target, draft, hw, wl, bad_pol,
                                          mode="no_policy"),
        "serial_sd": simulate_specoffload(target, draft, hw, wl, pol,
                                          mode="serial_sd"),
        "no_sd": simulate_specoffload(target, draft, hw, wl, pol,
                                      mode="no_sd"),
    }


def memory_sweep(target: ModelConfig, hw: HardwareSpec, wl: Workload,
                 fractions) -> list:
    """Fig 2: throughput (FlexGen-style decode) vs pinned-weight fraction.

    The total stream volume per step is (1 - pinned) of the FFN bytes;
    because the model is far larger than HBM, even a 5x memory reduction
    barely moves (1 - pinned) — the paper's "marginal utility" effect.
    """
    rows = []
    full = target.n_layers * layer_ffn_bytes(target)
    for frac in fractions:
        pinned_bytes = frac * hw.accel_mem_bytes
        pinned = min(pinned_bytes / full, 1.0)
        t_stream = full * (1 - pinned) / hw.h2d_bw
        ctx = wl.prompt_len + wl.gen_len / 2
        bs = 64
        kv_read = bs * ctx * kv_bytes_per_token(target)
        t_cpu = kv_read / (hw.host_mem_bw * hw.host_attn_eff)
        thr = bs / max(t_stream, t_cpu)
        rows.append({"mem_gib": pinned_bytes / 2 ** 30,
                     "pinned_frac": pinned, "throughput": thr})
    return rows


def disk_mode(target: ModelConfig, draft: ModelConfig, hw: HardwareSpec,
              wl: Workload, pol: Policy,
              os_reserve: float = 24 * 2 ** 30,
              disk_eff: float = 0.25) -> dict:
    """Fig 8: throughput when host memory can't hold the weights.

    Model assumptions: everything that does
    not fit in (host - KV cache - OS reserve) streams from disk each round,
    at ``disk_eff * disk_read_bw`` effective throughput (layer-granular
    reads don't reach sequential-read bandwidth), serialized with the
    host->device stream since both cross the host memory bus.
    """
    spec = simulate_specoffload(target, draft, hw, wl, pol)
    ctx = wl.prompt_len + wl.gen_len
    kv_host = 2 * pol.bs_decode * ctx * kv_bytes_per_token(target)
    w = target.param_bytes()
    host_avail = hw.host_mem_bytes - kv_host - os_reserve
    disk_bytes = max(0.0, w - host_avail)
    t_round = spec.detail["t_round"]
    t_disk = disk_bytes / (hw.disk_read_bw * disk_eff)
    t_round_disk = max(t_round, t_round - spec.detail.get("t_target", 0)
                       + t_disk) + t_disk * 0.2   # eviction writes
    thr = spec.throughput * t_round / max(t_round_disk, 1e-9)
    return {"no_disk": spec.throughput, "disk": thr,
            "ratio": thr / spec.throughput,
            "disk_bytes_gib": disk_bytes / 2 ** 30}


def decode_timeline(target: ModelConfig, draft: ModelConfig,
                    hw: HardwareSpec, wl: Workload, pol: Policy,
                    n_rounds: int = 8) -> Timeline:
    """Fig 6/7: GPU-busy intervals across decode rounds (the ~26 s draft
    burst + ~2 s idle gap periodicity)."""
    planner = ParaSpecPlanner(target, draft, hw)
    rep = planner.evaluate(pol, wl)
    t_round = rep.detail["t_round"]
    tl = Timeline(horizon=n_rounds * t_round)
    t = 0.0
    for _ in range(n_rounds):
        busy_draft = min(rep.t_draft, t_round)
        tl.events.append((t, t + busy_draft, "draft"))
        t_ffn = rep.detail["t_ffn_gpu"]
        tl.events.append((t + t_round - t_ffn, t + t_round, "target_ffn"))
        t += t_round
    return tl
