// RG-LRU time recurrence for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::rglru_scan
// (pallas_call at line 49, body _kernel at lines 21-31): over a/g
// (B, S, W) f32 and h0 (B, W) f32, h_t = a_t * h_{t-1} + g_t elementwise
// over the W channels, returning every state h_all (B, S, W) f32 (the
// state stack that speculative rollback selects from).
//
// Bound on this card: bytes.  Each element is read twice (a, g), written
// once (h) and costs one fused multiply-add: 12 bytes per 2 operations,
// far under the ~20 operations per byte the H100 needs in f32 to be
// compute-bound.  The dependence is only along time.
//
// Design: one thread per (b, channel), with h in a register, looping over
// S.  Neighbouring threads own neighbouring channels, so every load of a
// and g and every store of h is coalesced across the warp.  The TPU pads
// W up to its 256-wide block; here the last CTA masks its ragged channels,
// so any W works (RecurrentGemma's 2560 included).  The loads of the next
// kChunk steps do not depend on h, so they are issued together before the
// chunk's chain of FMAs and the latency of one step overlaps the next.
// 128-thread CTAs spread a batch-1 prefill (W = 2560) over 20 SMs.
#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kChunk = 8;

__global__ void __launch_bounds__(kThreads) rglru_scan_kernel(
    const float* __restrict__ a, const float* __restrict__ g,
    const float* __restrict__ h0, float* __restrict__ out, int seq, int width) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= width) return;
  const size_t base = static_cast<size_t>(b) * seq * width + c;
  float h = h0[static_cast<size_t>(b) * width + c];
  for (int t0 = 0; t0 < seq; t0 += kChunk) {
    float av[kChunk], gv[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int t = t0 + i;
      av[i] = t < seq ? a[base + static_cast<size_t>(t) * width] : 0.f;
      gv[i] = t < seq ? g[base + static_cast<size_t>(t) * width] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const int t = t0 + i;
      if (t < seq) {
        h = av[i] * h + gv[i];
        out[base + static_cast<size_t>(t) * width] = h;
      }
    }
  }
}

}  // namespace

extern "C" int rglru_scan(const void* a, const void* g, const void* h0,
                          void* out, int batch, int seq, int width,
                          void* stream) {
  if (batch <= 0 || seq <= 0 || width <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((width + kThreads - 1) / kThreads, batch);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(g),
      static_cast<const float*>(h0), static_cast<float*>(out), seq, width);
  return static_cast<int>(cudaGetLastError());
}
