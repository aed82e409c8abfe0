// Backward of the grouped expert FFN for Hopper (sm_90a).
//
// No TPU kernel has this function: the JAX package differentiates its
// three einsum products (src/repro/models/moe.py:160-167).  The forward
// it differentiates is csrc/moe_ffn.cu's (the counterpart of
// src/repro/kernels/moe_ffn.py::moe_ffn): per expert e, with X = buf[e]
// (C, D), Wg, Wu (D, F), Wd (F, D),
//   g = X Wg,  u = X Wu,  h = act(g) * u,  y = h Wd.
// From dY (C, D):
//   dh = dY Wd^T,  dg = dh * u * act'(g),  du = dh * act(g)
//   dX = dg Wg^T + du Wu^T,  dWg = X^T dg,  dWu = X^T du,  dWd = h^T dY
// (kernels/ref.py::moe_ffn_bwd_ref is the plain version).  act is silu
// (swiglu) or the tanh-approximate gelu (gelu/geglu).
//
// One call is eight launches on the caller's stream:
//   1-2  g, u      (C, F): the forward's products again (nothing of the
//                          forward is saved but its inputs);
//   3    dh        (C, F);
//   4    the elementwise step, in place: g -> dg, u -> du, dh -> h;
//   5    dX        (C, D): both products summed in one accumulator, the
//                          K loop running over Wg's pairs, then Wu's;
//   6-8  dWg, dWu  (D, F) and dWd (F, D), reduced over the C tokens.
// The (E, C, F) workspaces g, u, dh are the caller's, in the dtype of
// the inputs; every product accumulates in f32 and is rounded once to
// that dtype when it is stored (g and u in bf16 as the plain products
// round them; dg, du and h in bf16 before the products that read them).
//
// Bound on this card: operations.  Seven products of 2 E C D F each
// (Mixtral-8x7B at B 1 x S 4096: C = 2049, 13.5 TFLOP a layer, ~13.7 ms
// at the bf16 tensor-core peak) against ~3.3 GB moved (~1 ms).
//
// bf16 design: one tensor-core GEMM kernel, fed by TMA, for all seven
// products.  Each product is out (M x N) = sum over K of A (M x K) B (K x N)
// per expert, with A and B read in their stored layout: K-major (K
// contiguous) or MN-major (M or N contiguous, which bf16 wgmma takes
// transposed), so no operand is ever copied into another layout:
//   g, u:  M = F (Wg, Wu MN-major), N = C (X K-major), out (C, F);
//   dh:    M = F (Wd K-major),      N = C (dY K-major), out (C, F);
//   dX:    M = D (Wg, Wu K-major),  N = C (dg, du K-major), out (C, D);
//   dW*:   M = D or F (X or h MN-major), N = F or D (dg, du or dY
//          MN-major), K = C, out (M, N).
// A CTA computes a 128 x 128 tile of one expert: one producer warpgroup
// (one thread starts TMA loads, with the 128-byte swizzle, of two 64 x 64
// A boxes and a 128 x 64 (K-major) or two 64 x 64 (MN-major) B boxes
// into a ring of 6 stages of 32 KB against mbarriers) and two consumer
// warpgroups of 64 rows that run m64n128k16 wgmma from the ring, keep one
// product group in flight and release each stage when its products are
// done; setmaxnreg moves the producer's registers to the accumulators.
// TMA zero-fills the ragged edges of C, D and F (so ragged K adds zeros),
// and the epilogue stores only rows < M and columns < N.  Mixtral's
// shapes give 15-29 k CTAs a product, so no split-K is needed.  No
// atomics: every output element is written once by one thread, and its
// sum runs in one fixed order.
//
// f32 (the lossless path): the same products on the CUDA cores, no TF32:
// a 64 x 64 register-tiled grouped GEMM over arbitrary strides, the
// elementwise step shared with bf16.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

enum Act { kSilu = 1, kGelu = 2 };

// act(x) and act'(x)
__device__ __forceinline__ void act_grad(float x, int act, float* a,
                                         float* da) {
  if (act == kSilu) {
    const float s = 1.f / (1.f + expf(-x));
    *a = x * s;
    *da = s * (1.f + x * (1.f - s));
    return;
  }
  // tanh approximation, jax.nn.gelu's default
  const float c = 0.7978845608028654f, k = 0.044715f;
  const float t = tanhf(c * (x + k * x * x * x));
  *a = 0.5f * x * (1.f + t);
  *da = 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * c * (1.f + 3.f * k * x * x);
}

// g -> dg, u -> du, dh -> h, element by element.
template <typename T>
__global__ void moe_bwd_act_kernel(T* __restrict__ g, T* __restrict__ u,
                                   T* __restrict__ dh, long long n, int act) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    const float gv = to_f(g[i]), uv = to_f(u[i]), dhv = to_f(dh[i]);
    float a, da;
    act_grad(gv, act, &a, &da);
    g[i] = from_f<T>(dhv * uv * da);
    u[i] = from_f<T>(dhv * a);
    dh[i] = from_f<T>(a * uv);
  }
}

// A matrix per expert, row-major (rows, cols), experts contiguous.
struct Mat {
  const void* p;
  int rows, cols;
};

// out (M x N per expert) = sum over the pairs of A B.  ta: A is stored
// (K, M) (MN-major), else (M, K); tb: B is stored (K, N), else (N, K).
// out_mn: out is stored (M, N), else (N, M).
struct Gemm {
  Mat a[2], b[2];
  int pairs, ta, tb;
  void* out;
  int m, n, out_mn;
};

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA

constexpr int kWgThreads = 384;        // producer warpgroup + 2 consumers
constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr int kBox = 64 * 64 * 2;      // one 64 x 64 bf16 box, 8 KB
constexpr int kStageBytes = 2 * kBox + kBN * kBK * 2;   // 32 KB
constexpr int kStages = 6;
constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * 8 * kStages;

// One consumer warpgroup (w): 64 rows of A against the 128 columns of B.
template <int TA, int TB, bool OUT_MN>
__device__ __forceinline__ void consume(
    const uint8_t* ring, uint64_t* full, uint64_t* empty, int w,
    __nv_bfloat16* __restrict__ out, int m0, int n0, int m_valid,
    int n_valid, int nk) {
  float acc[kBN / 2];
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.f;
  // k16 step: 32 bytes along a K-major row; 16 rows of 128 bytes MN-major
  constexpr int kStepA = TA ? 128 : 2, kStepB = TB ? 128 : 2;
  for (int it = 0; it < nk; ++it) {
    const int s = it % kStages;
    bar_wait(&full[s], (it / kStages) & 1);
    const uint8_t* st = ring + s * kStageBytes;
    // MN-major: 64-wide blocks kBox apart (lbo), 8-row groups 1 KB apart
    const uint64_t da = sw128_desc(st + w * kBox, TA ? kBox : 16, 1024);
    const uint64_t db = sw128_desc(st + 2 * kBox, TB ? kBox : 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk)
      Wgmma<kBN>::template ss<TA, TB>(acc, da + kk * kStepA,
                                      db + kk * kStepB);
    wgmma_commit();
    wgmma_wait<1>();                 // the previous stage's products are done
    if (it > 0) bar_arrive(&empty[(it - 1) % kStages]);
  }
  wgmma_wait<0>();
  reg_fence(acc);

  // accumulator i of a thread: row 16 * warp + lane / 4 + 8 * ((i / 2) % 2),
  // column 8 * (i / 4) + 2 * (lane % 4) + i % 2
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int row = m0 + w * 64 + warp * 16 + lane / 4;
#pragma unroll
  for (int i = 0; i < kBN / 2; ++i) {
    const int m = row + 8 * ((i / 2) % 2);
    const int n = n0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
    if (m < m_valid && n < n_valid) {
      const size_t at = OUT_MN ? static_cast<size_t>(m) * n_valid + n
                               : static_cast<size_t>(n) * m_valid + m;
      out[at] = __float2bfloat16(acc[i]);
    }
  }
}

// One 128 x 128 tile of expert blockIdx.z's product: nk0 64-deep K steps
// of (a0, b0), then nk1 of (a1, b1), into one accumulator.
template <int TA, int TB, bool OUT_MN>
__global__ void __launch_bounds__(kWgThreads, 1) moe_bwd_wgmma_kernel(
    const __grid_constant__ CUtensorMap a0,
    const __grid_constant__ CUtensorMap b0,
    const __grid_constant__ CUtensorMap a1,
    const __grid_constant__ CUtensorMap b1, int nk0, int nk1,
    __nv_bfloat16* __restrict__ out, int m_valid, int n_valid) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStageBytes);
  uint64_t* empty = full + kStages;

  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM, e = blockIdx.z;
  const int wg = threadIdx.x / 128;
  const int nk = nk0 + nk1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 256);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {                                    // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      prefetch_map(&a0);
      prefetch_map(&b0);
      if (nk1 > 0) {
        prefetch_map(&a1);
        prefetch_map(&b1);
      }
      for (int it = 0; it < nk; ++it) {
        const int s = it % kStages;
        const bool second = it >= nk0;
        const CUtensorMap* ma = second ? &a1 : &a0;
        const CUtensorMap* mb = second ? &b1 : &b0;
        const int k0 = (second ? it - nk0 : it) * kBK;
        uint8_t* st = ring + s * kStageBytes;
        bar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        bar_expect_tx(&full[s], kStageBytes);
        for (int w = 0; w < 2; ++w) {
          if (TA)
            tma_load_3d(st + w * kBox, ma, &full[s], m0 + 64 * w, k0, e);
          else
            tma_load_3d(st + w * kBox, ma, &full[s], k0, m0 + 64 * w, e);
        }
        if (TB) {
          tma_load_3d(st + 2 * kBox, mb, &full[s], n0, k0, e);
          tma_load_3d(st + 3 * kBox, mb, &full[s], n0 + 64, k0, e);
        } else {
          tma_load_3d(st + 2 * kBox, mb, &full[s], k0, n0, e);
        }
      }
    }
  } else {
    setmaxnreg_inc<232>();                          // consumers
    consume<TA, TB, OUT_MN>(
        ring, full, empty, wg - 1,
        out + static_cast<size_t>(e) * m_valid * n_valid, m0, n0, m_valid,
        n_valid, nk);
  }
}

// A (rows, cols) bf16 matrix per expert as a 3-D map loading boxes of 64
// columns x box_rows rows.
bool map3(CUtensorMap* m, const Mat& x, int e, int box_rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(x.cols),
                            static_cast<uint64_t>(x.rows),
                            static_cast<uint64_t>(e)};
  const uint64_t strides[2] = {static_cast<uint64_t>(x.cols) * 2,
                               static_cast<uint64_t>(x.rows) * x.cols * 2};
  const uint32_t box[3] = {64, static_cast<uint32_t>(box_rows), 1};
  return make_map(m, x.p, 3, dims, strides, box);
}

template <int TA, int TB, bool OUT_MN>
int launch_wgmma(const Gemm& g, int e, cudaStream_t stream) {
  CUtensorMap ma[2], mb[2];
  int nk[2] = {0, 0};
  for (int p = 0; p < g.pairs; ++p) {
    if (!map3(&ma[p], g.a[p], e, 64) ||
        !map3(&mb[p], g.b[p], e, TB ? 64 : kBN))
      return static_cast<int>(cudaErrorInvalidValue);
    const int k = TA ? g.a[p].rows : g.a[p].cols;
    nk[p] = (k + kBK - 1) / kBK;
  }
  if (g.pairs == 1) {
    ma[1] = ma[0];
    mb[1] = mb[0];
  }
  static unsigned smem_set = 0;
  auto kern = moe_bwd_wgmma_kernel<TA, TB, OUT_MN>;
  cudaError_t err = set_smem_once(kern, kSmem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((g.n + kBN - 1) / kBN, (g.m + kBM - 1) / kBM, e);
  kern<<<grid, kWgThreads, kSmem, stream>>>(
      ma[0], mb[0], ma[1], mb[1], nk[0], nk[1],
      static_cast<__nv_bfloat16*>(g.out), g.m, g.n);
  return static_cast<int>(cudaGetLastError());
}

int run_bf16(const Gemm& g, int e, cudaStream_t stream) {
  if (g.ta && !g.tb && !g.out_mn) return launch_wgmma<1, 0, false>(g, e, stream);
  if (!g.ta && !g.tb && !g.out_mn) return launch_wgmma<0, 0, false>(g, e, stream);
  if (g.ta && g.tb && g.out_mn) return launch_wgmma<1, 1, true>(g, e, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// f32: the exact CUDA-core kernel

constexpr int kThreads = 256;
constexpr int kFM = 64, kFN = 64, kFK = 16;

// Element (i, k) of a per-expert operand: p[e * se + i * si + k * sk].
struct Op {
  const float* p;
  long long se, si, sk;
};

__device__ __forceinline__ void load_tile(float (*t)[kFM + 4], const Op& x,
                                          int e, int i0, int k0, int n_i,
                                          int n_k) {
  // walk the operand's contiguous axis fastest
  const bool k_fast = x.sk == 1;
#pragma unroll
  for (int q = 0; q < kFM * kFK / kThreads; ++q) {
    const int idx = threadIdx.x + q * kThreads;
    const int r = k_fast ? idx / kFK : idx % kFM;
    const int c = k_fast ? idx % kFK : idx / kFM;
    const int gi = i0 + r, gk = k0 + c;
    t[c][r] = (gi < n_i && gk < n_k)
                  ? x.p[e * x.se + gi * x.si + gk * x.sk] : 0.f;
  }
}

// out[e * M * N + m * om + n * on] = sum over the pairs of A B.
__global__ void __launch_bounds__(kThreads) moe_bwd_f32_kernel(
    Op a0, Op b0, int k0_len, Op a1, Op b1, int k1_len, float* out, int M,
    int N, long long om, long long on) {
  __shared__ float as[kFK][kFM + 4];
  __shared__ float bs[kFK][kFN + 4];
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN, e = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int p = 0; p < 2; ++p) {
    const Op& a = p ? a1 : a0;
    const Op& b = p ? b1 : b0;
    const int kl = p ? k1_len : k0_len;
    for (int kb = 0; kb < kl; kb += kFK) {
      load_tile(as, a, e, m0, kb, M, kl);
      load_tile(bs, b, e, n0, kb, N, kl);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kFK; ++kk) {
        float x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = as[kk][ty * 4 + i];
          y[i] = bs[kk][tx * 4 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += x[i] * y[j];
      }
      __syncthreads();
    }
  }
  float* oe = out + static_cast<size_t>(e) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < M && n < N) oe[m * om + n * on] = acc[i][j];
    }
  }
}

// The operand of a Mat as (i, k) elements: i along M (A) or N (B).
Op as_op(const Mat& x, bool k_rows) {
  const long long cols = x.cols;
  Op o{static_cast<const float*>(x.p), static_cast<long long>(x.rows) * cols,
       k_rows ? 1 : cols, k_rows ? cols : 1};
  return o;
}

int run_f32(const Gemm& g, int e, cudaStream_t stream) {
  Op a[2], b[2];
  int kl[2] = {0, 0};
  for (int p = 0; p < 2; ++p) {
    const int q = p < g.pairs ? p : 0;
    a[p] = as_op(g.a[q], g.ta);
    b[p] = as_op(g.b[q], g.tb);
    if (p < g.pairs) kl[p] = g.ta ? g.a[p].rows : g.a[p].cols;
  }
  const long long om = g.out_mn ? g.n : 1, on = g.out_mn ? 1 : g.m;
  const dim3 grid((g.n + kFN - 1) / kFN, (g.m + kFM - 1) / kFM, e);
  moe_bwd_f32_kernel<<<grid, kThreads, 0, stream>>>(
      a[0], b[0], kl[0], a[1], b[1], kl[1], static_cast<float*>(g.out), g.m,
      g.n, om, on);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// buf and dy (E, C, D); w_gate, w_up (E, D, F); w_down (E, F, D); all
// contiguous, one dtype (f32 or bf16).  Writes dbuf (E, C, D), dw_gate,
// dw_up (E, D, F), dw_down (E, F, D) in that dtype.  g, u, dh: the
// caller's (E, C, F) workspaces in that dtype.  act: 1 = silu (swiglu),
// 2 = tanh-approximate gelu.  bf16 needs D and F multiples of 8 and
// 16-byte-aligned bases (TMA's strides and addresses); the wrapper
// checks.
extern "C" int moe_ffn_bwd(const void* buf, const void* w_gate,
                           const void* w_up, const void* w_down,
                           const void* dy, void* g, void* u, void* dh,
                           void* dbuf, void* dw_gate, void* dw_up,
                           void* dw_down, int e, int c, int d, int f,
                           int act, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if ((act != kSilu && act != kGelu) || e < 1 || c < 1 || d < 1 || f < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16 && (d % 8 != 0 || f % 8 != 0))
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != kF32 && dtype != kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const Mat X{buf, c, d}, Wg{w_gate, d, f}, Wu{w_up, d, f}, Wd{w_down, f, d},
      dY{dy, c, d}, G{g, c, f}, U{u, c, f}, H{dh, c, f};
  // Gemm: {a pairs}, {b pairs}, pairs, ta, tb, out, M, N, out_mn
  const Gemm steps_before[3] = {
      {{Wg, Wg}, {X, X}, 1, 1, 0, g, f, c, 0},       // g  (C, F)
      {{Wu, Wu}, {X, X}, 1, 1, 0, u, f, c, 0},       // u  (C, F)
      {{Wd, Wd}, {dY, dY}, 1, 0, 0, dh, f, c, 0}};   // dh (C, F)
  // after the elementwise step G holds dg, U du and H h
  const Gemm steps_after[4] = {
      {{Wg, Wu}, {G, U}, 2, 0, 0, dbuf, d, c, 0},    // dX  (C, D)
      {{X, X}, {G, G}, 1, 1, 1, dw_gate, d, f, 1},   // dWg (D, F)
      {{X, X}, {U, U}, 1, 1, 1, dw_up, d, f, 1},     // dWu (D, F)
      {{H, H}, {dY, dY}, 1, 1, 1, dw_down, f, d, 1}};  // dWd (F, D)
  auto run = [&](const Gemm& s) {
    return dtype == kBF16 ? run_bf16(s, e, st) : run_f32(s, e, st);
  };
  for (const Gemm& s : steps_before) {
    const int rc = run(s);
    if (rc != 0) return rc;
  }
  const long long n = static_cast<long long>(e) * c * f;
  const int blocks = static_cast<int>(
      n / 256 + 1 < 132 * 16 ? n / 256 + 1 : 132 * 16);
  if (dtype == kBF16)
    moe_bwd_act_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<__nv_bfloat16*>(g), static_cast<__nv_bfloat16*>(u),
        static_cast<__nv_bfloat16*>(dh), n, act);
  else
    moe_bwd_act_kernel<float><<<blocks, 256, 0, st>>>(
        static_cast<float*>(g), static_cast<float*>(u),
        static_cast<float*>(dh), n, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (const Gemm& s : steps_after) {
    const int rc = run(s);
    if (rc != 0) return rc;
  }
  return 0;
}
