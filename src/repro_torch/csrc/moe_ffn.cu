// Grouped expert FFN for Hopper (sm_90a): act(x Wg) * (x Wu) Wd per expert.
//
// Replaces the TPU kernel src/repro/kernels/moe_ffn.py::moe_ffn
// (pallas_call at line 68, body _kernel at lines 29-46): buf (E, C, D)
// capacity buffers through w_gate/w_up (E, D, F) and w_down (E, F, D);
// act is silu for swiglu and tanh-approximate gelu for gelu/geglu.
//
// Bound on this card: bytes at decode, operations at prefill.  Verify
// runs C ~ 20 rows per expert against 3 * D * F weights per expert:
// ~2 * C / 2 = 20 operations per bf16 byte, far under the H100's ~295,
// so Mixtral's 3 * 8 * 4096 * 14336 * 2 B = 2.82 GB of expert weights
// per layer set the floor (~0.84 ms at 3.35 TB/s).  Prefill runs C ~ 257
// rows, and the work grows with C.
//
// Design: two kernels instead of the TPU's one.  The TPU keeps the
// (E, C, F) hidden tensor in VMEM and accumulates the down projection
// across a sequential F grid axis; Hopper has no sequential grid and 227
// KB of shared memory a block, so the hidden tensor goes through an f32
// workspace the wrapper allocates (E * C * F * 4 B: 9 MB at C = 20, 118
// MB at C = 257).  Kernel 1 computes gate and up products together, so
// x is read once for both, and writes act(g) * u; kernel 2 projects it
// down.  Both are one tiled GEMM template: a CTA computes a 32 x 64 tile
// of one expert's output over 32-deep K slices staged in shared memory,
// each thread a 2 x 4 block in f32 registers.  The grid's fastest axis
// runs over row tiles, so the CTAs that share a weight tile run together
// and the weights come from device memory about once.  The products run
// on the CUDA cores: wgmma, TMA and split-K for the skinny decode shape
// are later work.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kBM = 32, kBN = 64, kBK = 32;

enum Act { kNone = 0, kSilu = 1, kGelu = 2 };

__device__ __forceinline__ float act_fn(float x, int act) {
  if (act == kSilu) return x / (1.f + expf(-x));
  // tanh approximation, jax.nn.gelu's default
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

// out[e] (M x N) = A[e] (M x K) @ B0[e] (K x N); when GATED,
// out = act(A @ B0) * (A @ B1).  All row-major, experts contiguous.
template <typename TA, typename TB, typename TO, bool GATED>
__global__ void __launch_bounds__(kThreads) grouped_gemm_kernel(
    const TA* __restrict__ a, const TB* __restrict__ b0,
    const TB* __restrict__ b1, TO* __restrict__ out, int M, int N, int K,
    int act) {
  __shared__ float as[kBK][kBM + 1];                       // A tile, k-major
  __shared__ __align__(16) float bs0[kBK][kBN];
  __shared__ __align__(16) float bs1[GATED ? kBK : 1][kBN];
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN, e = blockIdx.z;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const TA* ae = a + static_cast<size_t>(e) * M * K;
  const TB* b0e = b0 + static_cast<size_t>(e) * K * N;
  const TB* b1e = GATED ? b1 + static_cast<size_t>(e) * K * N : nullptr;

  float acc0[2][4], acc1[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) { acc0[i][j] = 0.f; acc1[i][j] = 0.f; }

  for (int k0 = 0; k0 < K; k0 += kBK) {
#pragma unroll
    for (int u = 0; u < kBM * kBK / kThreads; ++u) {
      const int i = tid + u * kThreads, r = i / kBK, c = i % kBK;
      const int gm = m0 + r, gk = k0 + c;
      as[c][r] = (gm < M && gk < K)
                     ? to_f(ae[static_cast<size_t>(gm) * K + gk]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kBK * kBN / kThreads; ++u) {
      const int i = tid + u * kThreads, r = i / kBN, c = i % kBN;
      const int gk = k0 + r, gn = n0 + c;
      const bool in = gk < K && gn < N;
      const size_t off = static_cast<size_t>(gk) * N + gn;
      bs0[r][c] = in ? to_f(b0e[off]) : 0.f;
      if (GATED) bs1[r][c] = in ? to_f(b1e[off]) : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      const float x0 = as[kk][ty * 2], x1 = as[kk][ty * 2 + 1];
      const float4 w = *reinterpret_cast<const float4*>(&bs0[kk][tx * 4]);
      acc0[0][0] += x0 * w.x; acc0[0][1] += x0 * w.y;
      acc0[0][2] += x0 * w.z; acc0[0][3] += x0 * w.w;
      acc0[1][0] += x1 * w.x; acc0[1][1] += x1 * w.y;
      acc0[1][2] += x1 * w.z; acc0[1][3] += x1 * w.w;
      if (GATED) {
        const float4 u = *reinterpret_cast<const float4*>(&bs1[kk][tx * 4]);
        acc1[0][0] += x0 * u.x; acc1[0][1] += x0 * u.y;
        acc1[0][2] += x0 * u.z; acc1[0][3] += x0 * u.w;
        acc1[1][0] += x1 * u.x; acc1[1][1] += x1 * u.y;
        acc1[1][2] += x1 * u.z; acc1[1][3] += x1 * u.w;
      }
    }
    __syncthreads();
  }

  TO* oe = out + static_cast<size_t>(e) * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int gm = m0 + ty * 2 + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tx * 4 + j;
      if (gn >= N) continue;
      const float val = GATED ? act_fn(acc0[i][j], act) * acc1[i][j]
                              : acc0[i][j];
      oe[static_cast<size_t>(gm) * N + gn] = from_f<TO>(val);
    }
  }
}

template <typename T>
int launch(const void* buf, const void* wg, const void* wu, const void* wd,
           void* hidden, void* out, int e, int c, int d, int f, int act,
           cudaStream_t stream) {
  const int mt = (c + kBM - 1) / kBM;
  grouped_gemm_kernel<T, T, float, true>
      <<<dim3(mt, (f + kBN - 1) / kBN, e), kThreads, 0, stream>>>(
          static_cast<const T*>(buf), static_cast<const T*>(wg),
          static_cast<const T*>(wu), static_cast<float*>(hidden), c, f, d,
          act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_gemm_kernel<float, T, T, false>
      <<<dim3(mt, (d + kBN - 1) / kBN, e), kThreads, 0, stream>>>(
          static_cast<const float*>(hidden), static_cast<const T*>(wd),
          nullptr, static_cast<T*>(out), c, d, f, kNone);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// act: 1 = silu (swiglu), 2 = tanh-approximate gelu (gelu/geglu).
// hidden: an (E, C, F) f32 workspace owned by the caller.
extern "C" int moe_ffn(const void* buf, const void* w_gate, const void* w_up,
                       const void* w_down, void* hidden, void* out, int e,
                       int c, int d, int f, int act, int dtype,
                       void* stream) {
  using namespace repro;
  auto st = static_cast<cudaStream_t>(stream);
  if (act != kSilu && act != kGelu) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32)
    return launch<float>(buf, w_gate, w_up, w_down, hidden, out, e, c, d, f,
                         act, st);
  if (dtype == kBF16)
    return launch<__nv_bfloat16>(buf, w_gate, w_up, w_down, hidden, out, e,
                                 c, d, f, act, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
