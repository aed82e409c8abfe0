// Shared by the RG-LRU kernels (rglru_scan.cu and its backward,
// rglru_scan_bwd.cu): the time-parallel layout (the Python wrappers'
// LAYOUT = (kSegSteps, kSegsPerWarp, kSegs)), vector loads and stores
// along W, and the gates' sigmoid and softplus.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPThreads = 256;      // time-parallel kernels
constexpr int kWarps = kPThreads / 32;
constexpr int kTile = 512;          // steps of a tile
constexpr int kQuads = 2;           // channel groups of V a CTA
constexpr int kSegs = kPThreads / kQuads;
constexpr int kSegSteps = kTile / kSegs;
constexpr int kSegsPerWarp = 32 / kQuads;

template <int V>
__device__ __forceinline__ void load_vec(const float* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const float4 u = *reinterpret_cast<const float4*>(p);
    o[0] = u.x; o[1] = u.y; o[2] = u.z; o[3] = u.w;
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = p[v];
  }
}
template <int V>
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&o)[V]) {
  if constexpr (V == 4) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
    for (int v = 0; v < 4; ++v) o[v] = __bfloat162float(e[v]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) o[v] = __bfloat162float(p[v]);
  }
}
template <int V>
__device__ __forceinline__ void store_vec(float* p, const float (&o)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = o[v];
  }
}
template <int V>
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&o)[V]) {
  if constexpr (V == 4) {
    __align__(8) __nv_bfloat162 e[2] = {__floats2bfloat162_rn(o[0], o[1]),
                                        __floats2bfloat162_rn(o[2], o[3])};
    *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(e);
  } else {
#pragma unroll
    for (int v = 0; v < V; ++v) p[v] = __float2bfloat16(o[v]);
  }
}

__device__ __forceinline__ float sigmoid(float z) {
  return 1.f / (1.f + expf(-z));
}
__device__ __forceinline__ float softplus(float z) {   // torch's threshold
  return z > 20.f ? z : log1pf(expf(z));
}

}  // namespace
