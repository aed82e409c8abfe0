// Grouped expert FFN for Hopper (sm_90a): act(x Wg) * (x Wu) Wd per expert.
//
// Replaces the TPU kernel src/repro/kernels/moe_ffn.py::moe_ffn
// (pallas_call at line 68, body _kernel at lines 29-46): buf (E, C, D)
// capacity buffers through w_gate/w_up (E, D, F) and w_down (E, F, D);
// act is silu for swiglu and tanh-approximate gelu for gelu/geglu.
//
// Bound on this card: bytes at verify, close to the ridge at prefill.
// Verify runs C ~ 20 rows per expert against 3 * D * F weights per
// expert, ~20 operations per weight byte against the H100's ~295 in bf16:
// Mixtral's 2.82 GB of expert weights per layer set a floor of ~0.84 ms at
// 3.35 TB/s.  Prefill (C = 257) does 0.72 TFLOP on the same bytes, ~0.73
// ms at the bf16 tensor-core peak, which CUDA-core f32 cannot approach.
//
// bf16 design: the tensor cores, fed by TMA.  The tokens are few and the
// weights many, so the products are taken transposed: the weights are
// wgmma's 64-row A operand, read in their stored layout (MN-major, which
// bf16 allows), and the C tokens are its N, C rounded up to a multiple of
// 8 (24 at C = 20: almost no tensor work is wasted) and cut into at most
// 152-wide tiles (2 x 136 at C = 257):
//   kernel 1: H^T (F x C) = act(Wg^T X^T) * (Wu^T X^T), one CTA per 128
//             F-rows of one expert and one token tile, two accumulators,
//             X read once for both; the epilogue rounds act(g) * u to
//             bf16 into an (E, C, F) workspace (E * C * F * 2 B);
//   kernel 2: out^T (D x C) = Wd^T H^T over K = F, one CTA per 128
//             D-rows.  Mixtral's verify gives 8 experts x 32 tiles = 256
//             CTAs, two full waves of one CTA per SM on 132 SMs (97% of
//             the card busy); each CTA streams 3.6 MB of Wd, so no split-K
//             or persistent schedule is needed to keep the bytes flowing.
// A CTA is one producer warpgroup (one thread starts TMA loads of
// 64 x 64 weight tiles and the token tile with the 128-byte swizzle into
// a ring of 4-8 stages, about 200 KB, against mbarriers) and two consumer
// warpgroups of 64 rows that run wgmma from the ring, keep one product
// group in flight and release each stage when its products are done;
// setmaxnreg moves the producer's registers to the accumulators.  TMA
// zero-fills the ragged edges of C, D and F.
//
// The TPU kernel never materialises (E, C, F): its F grid axis runs in
// order and the down projection accumulates in VMEM.  Here blocks run in
// no order and a block has 227 KB of shared memory, so the hidden tensor
// goes through device memory between the two kernels; in bf16 it is 0.5%
// of the weight bytes at verify.
//
// f32 (the lossless path): the exact CUDA-core kernels, no TF32.  A
// 32 x 64 register-tiled grouped GEMM, two launches through an f32
// workspace (E * C * F * 4 B); f32 products on the tensor cores would be
// TF32 and break token-exact equality with the greedy decode.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

enum Act { kNone = 0, kSilu = 1, kGelu = 2 };

__device__ __forceinline__ float act_fn(float x, int act) {
  if (act == kSilu) return x / (1.f + expf(-x));
  // tanh approximation, jax.nn.gelu's default
  const float inner = 0.7978845608028654f * (x + 0.044715f * x * x * x);
  return 0.5f * x * (1.f + tanhf(inner));
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA

constexpr int kWgThreads = 384;         // producer warpgroup + 2 consumers
constexpr int kTileM = 64;              // weight rows per consumer warpgroup
constexpr int kTileK = 64;              // K per stage: one 128-byte row
constexpr int kTileBytes = kTileM * kTileK * 2;
constexpr int kRingBudget = 210 * 1024;
constexpr int kNMax = 152;              // widest token tile
constexpr int kWidths[] = {8, 16, 24, 32, 40, 48, 64, 80, 96, 128, 136, 152};

template <int NT, bool GATED>
struct Ring {
  static constexpr int kOps = GATED ? 2 : 1;                  // A operands
  static constexpr int kABytes = kOps * 2 * kTileBytes;       // x 2 warpgroups
  static constexpr int kBBytes = NT * kTileK * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;       // 1 KB multiple
  static constexpr int kStages =
      kRingBudget / kStageBytes > 8 ? 8 : kRingBudget / kStageBytes;
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * 8 * kStages;
};

// One consumer warpgroup (w) of the kernel below: 64 weight rows against
// the token tile, over the ring the producer fills.
template <int NT, bool GATED>
__device__ __forceinline__ void consume(
    const uint8_t* ring, uint64_t* full, uint64_t* empty, int w,
    __nv_bfloat16* __restrict__ out, int m0, int n0, int e, int m_valid,
    int ld, int c, int nk, int act) {
  using R = Ring<NT, GATED>;
  constexpr int S = R::kStages;
  auto a_tile = [&](int s, int op) {
    return ring + s * R::kStageBytes + (op * 2 + w) * kTileBytes;
  };
  auto b_tile = [&](int s) { return ring + s * R::kStageBytes + R::kABytes; };
  float acc0[NT / 2], acc1[GATED ? NT / 2 : 1];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc0[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (GATED ? NT / 2 : 1); ++i) acc1[i] = 0.f;

  for (int it = 0; it < nk; ++it) {
    const int s = it % S;
    bar_wait(&full[s], (it / S) & 1);
    // A: MN-major (the weights' stored layout), k16 step = 16 rows of 128 B;
    // B: K-major tokens, k16 step = 32 B inside the swizzled row
    const uint64_t da0 = sw128_desc(a_tile(s, 0), kTileBytes, 1024);
    const uint64_t da1 = GATED ? sw128_desc(a_tile(s, 1), kTileBytes, 1024)
                               : 0;
    const uint64_t db = sw128_desc(b_tile(s), 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTileK / 16; ++kk) {
      Wgmma<NT>::template ss<1, 0>(acc0, da0 + kk * 128, db + kk * 2);
      if constexpr (GATED)
        Wgmma<NT>::template ss<1, 0>(acc1, da1 + kk * 128, db + kk * 2);
    }
    wgmma_commit();
    wgmma_wait<1>();                 // the previous stage's products are done
    if (it > 0) bar_arrive(&empty[(it - 1) % S]);
  }
  wgmma_wait<0>();
  reg_fence(acc0);
  if constexpr (GATED) reg_fence(acc1);

  // accumulator i of a thread: row 16 * warp + lane / 4 + 8 * ((i / 2) % 2),
  // column 8 * (i / 4) + 2 * (lane % 4) + i % 2
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int row = m0 + w * kTileM + warp * 16 + lane / 4;
  __nv_bfloat16* oe = out + static_cast<size_t>(e) * c * ld;
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) {
    const int m = row + 8 * ((i / 2) % 2);
    const int n = n0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    if (m < m_valid && n < c) {
      float v = acc0[i];
      if constexpr (GATED) v = act_fn(v, act) * acc1[i];
      oe[static_cast<size_t>(n) * ld + m] = __float2bfloat16(v);
    }
  }
}

// out[e][c][m0 + r] (row stride ld) for r < 128, c < C: the transposed
// product W^T X^T of one expert's weight rows [m0, m0 + 128) and token
// tile [n0, n0 + NT), over nk 64-deep K steps.  GATED: W0 = Wg, W1 = Wu,
// out = bf16(act(g) * u); else W0 = Wd, out = bf16(acc).
template <int NT, bool GATED>
__global__ void __launch_bounds__(kWgThreads, 1) moe_wgmma_kernel(
    const __grid_constant__ CUtensorMap map_w0,
    const __grid_constant__ CUtensorMap map_w1,
    const __grid_constant__ CUtensorMap map_x, __nv_bfloat16* __restrict__ out,
    int m_valid, int ld, int c, int nk, int act) {
  using R = Ring<NT, GATED>;
  constexpr int S = R::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + S * R::kStageBytes);
  uint64_t* empty = full + S;

  const int n0 = blockIdx.x * NT, m0 = blockIdx.y * 2 * kTileM;
  const int e = blockIdx.z;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 256);
    }
    bar_init_fence();
  }
  __syncthreads();

  // stage s: [op][warpgroup] 64 x 64 weight tiles, then the NT x 64 tokens
  auto a_tile = [&](int s, int op, int w) {
    return ring + s * R::kStageBytes + (op * 2 + w) * kTileBytes;
  };
  auto b_tile = [&](int s) { return ring + s * R::kStageBytes + R::kABytes; };

  if (wg == 0) {                                    // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      prefetch_map(&map_w0);
      if (GATED) prefetch_map(&map_w1);
      prefetch_map(&map_x);
      for (int it = 0; it < nk; ++it) {
        const int s = it % S;
        bar_wait(&empty[s], ((it / S) & 1) ^ 1);
        bar_expect_tx(&full[s], R::kStageBytes);
        for (int w = 0; w < 2; ++w) {
          tma_load_3d(a_tile(s, 0, w), &map_w0, &full[s], m0 + w * kTileM,
                      it * kTileK, e);
          if (GATED)
            tma_load_3d(a_tile(s, 1, w), &map_w1, &full[s], m0 + w * kTileM,
                        it * kTileK, e);
        }
        tma_load_3d(b_tile(s), &map_x, &full[s], it * kTileK, n0, e);
      }
    }
  } else {
    setmaxnreg_inc<232>();                          // consumers
    consume<NT, GATED>(ring, full, empty, wg - 1, out, m0, n0, e, m_valid,
                       ld, c, nk, act);
  }
}

// A (rows, cols) bf16 matrix per expert, cols contiguous, as a 3-D map
// loading 64 x `box_rows` tiles.
bool map3(CUtensorMap* m, const void* p, int e, int rows, int cols,
          int box_rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(cols),
                            static_cast<uint64_t>(rows),
                            static_cast<uint64_t>(e)};
  const uint64_t strides[2] = {static_cast<uint64_t>(cols) * 2,
                               static_cast<uint64_t>(rows) * cols * 2};
  const uint32_t box[3] = {64, static_cast<uint32_t>(box_rows), 1};
  return make_map(m, p, 3, dims, strides, box);
}

template <int NT, bool GATED>
int launch_wgmma(const CUtensorMap& w0, const CUtensorMap& w1,
                 const CUtensorMap& x, __nv_bfloat16* out, int e, int c,
                 int rows, int ld, int k, int act, cudaStream_t stream) {
  using R = Ring<NT, GATED>;
  static unsigned smem_set = 0;
  auto kern = moe_wgmma_kernel<NT, GATED>;
  cudaError_t err = set_smem_once(kern, R::kSmem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c + NT - 1) / NT, (rows + 2 * kTileM - 1) / (2 * kTileM),
                  e);
  kern<<<grid, kWgThreads, R::kSmem, stream>>>(
      w0, w1, x, out, rows, ld, c, (k + kTileK - 1) / kTileK, act);
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_bf16(const void* buf, const void* wg, const void* wu,
                const void* wd, void* hidden, void* out, int e, int c, int d,
                int f, int act, cudaStream_t stream) {
  CUtensorMap m_x, m_wg, m_wu, m_h, m_wd;
  if (!map3(&m_x, buf, e, c, d, NT) || !map3(&m_wg, wg, e, d, f, 64) ||
      !map3(&m_wu, wu, e, d, f, 64) || !map3(&m_h, hidden, e, c, f, NT) ||
      !map3(&m_wd, wd, e, f, d, 64))
    return static_cast<int>(cudaErrorInvalidValue);
  auto* h = static_cast<__nv_bfloat16*>(hidden);
  int rc = launch_wgmma<NT, true>(m_wg, m_wu, m_x, h, e, c, f, f, d, act,
                                  stream);
  if (rc != 0) return rc;
  return launch_wgmma<NT, false>(m_wd, m_wd, m_h,
                                 static_cast<__nv_bfloat16*>(out), e, c, d, d,
                                 f, kNone, stream);
}

int dispatch_bf16(const void* buf, const void* wg, const void* wu,
                  const void* wd, void* hidden, void* out, int e, int c, int d,
                  int f, int act, cudaStream_t stream) {
  const int tiles = (c + kNMax - 1) / kNMax;
  const int per = (c + tiles - 1) / tiles;
  int nt = kNMax;
  for (int w : kWidths)
    if (w >= per) { nt = w; break; }
#define REPRO_MOE_NT(N)                                                     \
  case N:                                                                   \
    return launch_bf16<N>(buf, wg, wu, wd, hidden, out, e, c, d, f, act,    \
                          stream);
  switch (nt) {
    REPRO_MOE_NT(8) REPRO_MOE_NT(16) REPRO_MOE_NT(24) REPRO_MOE_NT(32)
    REPRO_MOE_NT(40) REPRO_MOE_NT(48) REPRO_MOE_NT(64) REPRO_MOE_NT(80)
    REPRO_MOE_NT(96) REPRO_MOE_NT(128) REPRO_MOE_NT(136) REPRO_MOE_NT(152)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_MOE_NT
}

// ---------------------------------------------------------------------------
// f32: the exact CUDA-core kernels

constexpr int kThreads = 256;
constexpr int kBM = 32, kBN = 64, kBK = 32;

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

int launch_f32(const void* buf, const void* wg, const void* wu,
               const void* wd, void* hidden, void* out, int e, int c, int d,
               int f, int act, cudaStream_t stream) {
  const int mt = (c + kBM - 1) / kBM;
  grouped_gemm_kernel<float, float, float, true>
      <<<dim3(mt, (f + kBN - 1) / kBN, e), kThreads, 0, stream>>>(
          static_cast<const float*>(buf), static_cast<const float*>(wg),
          static_cast<const float*>(wu), static_cast<float*>(hidden), c, f, d,
          act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  grouped_gemm_kernel<float, float, float, false>
      <<<dim3(mt, (d + kBN - 1) / kBN, e), kThreads, 0, stream>>>(
          static_cast<const float*>(hidden), static_cast<const float*>(wd),
          nullptr, static_cast<float*>(out), c, d, f, kNone);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// act: 1 = silu (swiglu), 2 = tanh-approximate gelu (gelu/geglu).
// hidden: the caller's (E, C, F) workspace, f32 for dtype f32 and bf16 for
// dtype bf16.  bf16 needs D and F multiples of 8 and 16-byte-aligned
// bases (TMA's strides and addresses); the wrapper checks.
extern "C" int moe_ffn(const void* buf, const void* w_gate, const void* w_up,
                       const void* w_down, void* hidden, void* out, int e,
                       int c, int d, int f, int act, int dtype,
                       void* stream) {
  using namespace repro;
  auto st = static_cast<cudaStream_t>(stream);
  if (act != kSilu && act != kGelu) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kF32)
    return launch_f32(buf, w_gate, w_up, w_down, hidden, out, e, c, d, f, act,
                      st);
  if (dtype == kBF16) {
    if (d % 8 != 0 || f % 8 != 0 || c < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    return dispatch_bf16(buf, w_gate, w_up, w_down, hidden, out, e, c, d, f,
                         act, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
