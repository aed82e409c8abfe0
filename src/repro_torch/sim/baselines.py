"""Analytic performance models of the paper's four baselines (§5.1).

All models share the hardware constants of ``repro_torch.sim.hardware``
and the byte/FLOP accounting of ``repro_torch.core.planner`` so the
*ratios* between systems follow from structure, not per-system fudge
factors (a copy of ``repro/sim/baselines.py``):

* **Accelerate** — device-map offloading: every decode step streams all
  non-resident weights host->GPU; attention + FFN on GPU; batch limited by
  the KV cache that must stay in GPU memory alongside the streamed layer.
* **DeepSpeed (ZeRO-Inference)** — full-weight streaming with a pinned
  buffer and slightly better overlap; same structure as Accelerate with a
  bigger feasible batch (its KV can spill to host between steps).
* **FlexGen** — zig-zag column schedule: weights streamed once per batch
  *block* (large effective batch) and decode-phase attention on the CPU
  against host KV; throughput = min(stream-bound, CPU-attention-bound).
* **Fiddler** — MoE-aware CPU/GPU orchestration: attention/shared layers on
  GPU (resident), expert FFNs computed *on the CPU* (no expert streaming);
  bound by host expert GEMM throughput.

Each returns (throughput tok/s, gpu_core_utilization in [0,1], detail).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs import ModelConfig
from repro_torch.core.planner import (attn_flops_per_token,
                                      dense_flops_per_token,
                                      kv_bytes_per_token, layer_ffn_bytes)
from repro_torch.sim.hardware import HardwareSpec


@dataclass
class SystemResult:
    name: str
    throughput: float
    gpu_util: float
    detail: dict


# nvidia-smi-style utilization model (calibrated once against Fig 6 / Fig 1):
# SM-active fraction = 0.63 during compute bursts (decode GEMM occupancy),
# 0.12 while the GPU is an I/O endpoint (PCIe copies keep copy+scheduler SMs
# ticking), 0.07 while waiting on CPU compute.
UTIL_COMPUTE, UTIL_IO, UTIL_WAIT = 0.63, 0.12, 0.07


def nvsmi_util(compute_frac: float, io_frac: float = 0.0,
               wait_frac: float = 0.0) -> float:
    return min(1.0, UTIL_COMPUTE * compute_frac + UTIL_IO * io_frac
               + UTIL_WAIT * wait_frac)


def _resident_bytes(hw: HardwareSpec, frac: float = 0.7) -> float:
    """Weights that fit permanently in accelerator memory."""
    return hw.accel_mem_bytes * frac


def accelerate(cfg: ModelConfig, hw: HardwareSpec, prompt_len: int,
               gen_len: int, batch: int = 32) -> SystemResult:
    w = cfg.param_bytes()
    resident = min(w, _resident_bytes(hw, 0.5))     # rest of HBM: KV + act
    stream = max(w - resident, 0.0)
    ctx = prompt_len + gen_len / 2
    t_stream = stream / hw.h2d_bw
    t_gpu = batch * (dense_flops_per_token(cfg)
                     + attn_flops_per_token(cfg, int(ctx))) / hw.accel_flops
    t_tok = t_stream + t_gpu                        # no overlap (HF loop)
    thr = batch / t_tok
    util = nvsmi_util(t_gpu / t_tok, t_stream / t_tok)
    return SystemResult("accelerate", thr, util,
                        {"t_stream": t_stream, "t_gpu": t_gpu,
                         "batch": batch})


def deepspeed(cfg: ModelConfig, hw: HardwareSpec, prompt_len: int,
              gen_len: int, batch: int = 40) -> SystemResult:
    w = cfg.param_bytes()
    resident = min(w, _resident_bytes(hw, 0.4))
    stream = max(w - resident, 0.0)
    ctx = prompt_len + gen_len / 2
    t_stream = stream / hw.h2d_bw
    t_gpu = batch * (dense_flops_per_token(cfg)
                     + attn_flops_per_token(cfg, int(ctx))) / hw.accel_flops
    t_tok = max(t_stream, t_gpu) + 0.15 * t_stream  # partial overlap
    thr = batch / t_tok
    util = nvsmi_util(t_gpu / t_tok, t_stream / t_tok)
    return SystemResult("deepspeed", thr, util,
                        {"t_stream": t_stream, "t_gpu": t_gpu,
                         "batch": batch})


def flexgen(cfg: ModelConfig, hw: HardwareSpec, prompt_len: int,
            gen_len: int, batch: int = 64) -> SystemResult:
    """Zig-zag schedule + CPU attention (the paper's strongest baseline)."""
    ctx = prompt_len + gen_len / 2
    # per decode step: stream all FFN layers once for the whole batch
    t_stream = cfg.n_layers * layer_ffn_bytes(cfg) / hw.h2d_bw
    kv_read = batch * ctx * kv_bytes_per_token(cfg)
    t_cpu_attn = max(batch * attn_flops_per_token(cfg, int(ctx))
                     / hw.host_flops,
                     kv_read / (hw.host_mem_bw * hw.host_attn_eff))
    t_gpu = batch * dense_flops_per_token(cfg) / hw.accel_flops
    t_tok = max(t_stream, t_cpu_attn) + t_gpu       # overlapped pipeline
    thr = batch / t_tok
    util = nvsmi_util(t_gpu / t_tok, min(t_stream, t_tok) / t_tok)
    return SystemResult("flexgen", thr, util,
                        {"t_stream": t_stream, "t_cpu_attn": t_cpu_attn,
                         "t_gpu": t_gpu, "batch": batch})


def fiddler(cfg: ModelConfig, hw: HardwareSpec, prompt_len: int,
            gen_len: int, batch: int = 16) -> SystemResult:
    """CPU expert compute for MoE models (no expert streaming)."""
    ctx = prompt_len + gen_len / 2
    if cfg.is_moe:
        d, f = cfg.d_model, cfg.d_ff
        expert_flops = 2 * 3 * d * f * cfg.top_k * cfg.n_layers
        # CPU GEMM on scattered per-expert token groups reaches only a
        # fraction of peak (small tiles, bf16->f32 conversion)
        t_cpu = batch * expert_flops / (hw.host_flops * 0.3)
        t_gpu = batch * (attn_flops_per_token(cfg, int(ctx))
                         + 2 * cfg.n_layers * 4 * d * d) / hw.accel_flops
    else:  # degenerate: behaves like accelerate
        return accelerate(cfg, hw, prompt_len, gen_len, batch)
    t_tok = max(t_cpu, t_gpu) + 0.1 * t_cpu
    thr = batch / t_tok
    util = nvsmi_util(t_gpu / t_tok, 0.0, 1.0 - t_gpu / t_tok)
    return SystemResult("fiddler", thr, util,
                        {"t_cpu_experts": t_cpu, "t_gpu": t_gpu,
                         "batch": batch})


BASELINES = {
    "accelerate": accelerate,
    "deepspeed": deepspeed,
    "flexgen": flexgen,
    "fiddler": fiddler,
}
