"""Hardware specifications.

``ENV1`` / ``ENV2`` replicate the paper's Table 1 (RTX 4090 + PCIe 3/4)
so the simulator and the ParaSpec planner can be validated against the
paper's measured numbers (a copy of ``repro/sim/hardware.py:17-70``).
``H100`` is the port's own card: data-sheet peaks for the accelerator,
and the host link, host memory and host GEMM rate as ``chip_smoke.py``
phase 1 measured them on the machine that holds the card.
"""
from __future__ import annotations

from dataclasses import dataclass

GB = 1024 ** 3
TFLOPS = 1e12


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    # accelerator
    accel_flops: float            # effective matmul FLOP/s (decode-size GEMMs)
    accel_mem_bytes: float
    accel_mem_bw: float           # HBM bytes/s
    # host
    host_flops: float             # effective CPU GEMM FLOP/s
    host_mem_bytes: float
    host_mem_bw: float = 60 * GB  # effective DRAM bandwidth (CPU attention
                                  # is memory-bound: ~1 FLOP/byte)
    # Effective fraction of host_mem_bw that framework-level CPU attention
    # achieves (HF/torch bf16: repeat_kv copies, dtype conversions, NUMA).
    # Calibrated against the paper's Table 3 Compute(C) column.
    host_attn_eff: float = 0.012
    # interconnect host<->accelerator
    h2d_bw: float = 12.5 * GB     # bytes/s host -> accelerator
    d2h_bw: float = 12.5 * GB
    # disk tier
    disk_read_bw: float = 3.5 * GB
    disk_write_bw: float = 1.7 * GB
    # large-GEMM (prefill) effective FLOP/s; 0 -> 1.33 * accel_flops
    accel_flops_prefill: float = 0.0
    # multi-chip links
    ici_bw: float = 0.0


# Paper Table 1.  PCIe 3.0 x16 ~ 12.5 GB/s effective; PCIe 4.0 x16 ~ 25 GB/s.
# CPU effective GEMM throughput estimated from the paper's runtime breakdown
# (Table 3): decode-phase CPU attention dominates at ~0.1-0.2 TFLOP/s.
ENV1 = HardwareSpec(
    name="Env#1 RTX4090 PCIe3 i9-10980XE 256G",
    accel_flops=82.6 * TFLOPS * 0.6,   # fp16 w/ realistic efficiency
    accel_mem_bytes=24 * GB,
    accel_mem_bw=1008 * GB,
    host_flops=0.45 * TFLOPS,          # 18-core AVX-512 GEMM
    host_mem_bytes=256 * GB,
    host_mem_bw=55 * GB,               # quad-channel DDR4-2933 effective
    h2d_bw=12.5 * GB, d2h_bw=12.5 * GB,
)

ENV2 = HardwareSpec(
    name="Env#2 RTX4090 PCIe4 EPYC-7542 448G",
    accel_flops=82.6 * TFLOPS * 0.6,
    accel_mem_bytes=24 * GB,
    accel_mem_bw=1008 * GB,
    host_flops=0.7 * TFLOPS,           # 32-core EPYC GEMM
    host_mem_bytes=448 * GB,
    host_mem_bw=120 * GB,              # 8-channel DDR4-3200 effective
    host_attn_eff=0.0022,              # NUMA-penalized (Table 3, 8x22B row)
    h2d_bw=25 * GB, d2h_bw=25 * GB,
)

# One NVIDIA H100 SXM.  Accelerator: the data sheet's dense bf16 peak with
# ENV1's 0.6 decode-GEMM efficiency, and its HBM rate.  The rest was
# measured by chip_smoke.py phase 1 on "NVIDIA H100 80GB HBM3, 700.00 W"
# (nvidia-smi --query-gpu=name,power.limit --format=csv,noheader), on a
# host of 8 CPUs with RLIMIT_MEMLOCK 64 KiB (cudaHostRegister is not held
# to it):
# accel_mem_bytes is torch.cuda.get_device_properties(0).total_memory,
# h2d_bw / d2h_bw the bare pinned<->device copy rate of one 2.7 GiB
# buffer (CUDA events), host_mem_bytes the host's MemTotal, host_flops a
# timed f32 4096^3 CPU matmul.  host_mem_bw, host_attn_eff and the disk
# rates keep the defaults: nothing measures them yet.
H100 = HardwareSpec(
    name="H100 80GB HBM3 700W PCIe5 8-CPU 101G",
    accel_flops=989 * TFLOPS * 0.6,
    accel_mem_bytes=85017493504,       # total_memory
    accel_mem_bw=3.35e12,
    host_flops=0.9057 * TFLOPS,        # f32 4096^3 matmul, 8 threads
    host_mem_bytes=108447924224,       # MemTotal (101.00 GiB)
    h2d_bw=49.158e9, d2h_bw=55.450e9,  # median of 5 copies each way
)

ENVS = {"env1": ENV1, "env2": ENV2, "h100": H100}
