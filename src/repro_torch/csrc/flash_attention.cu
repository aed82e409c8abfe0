// Forward GQA flash attention for Hopper (sm_90a): the prefill attention.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (pallas_call at line 111, body _kernel at lines 28-72):
// q (B, Hq, Sq, d) against k/v (B, Hkv, Skv, d), causal, bidirectional or
// sliding-window, the KV head of query head hq being hq // g.  Query and
// key positions both start at 0; keys past Skv never attend.
//
// Bound on this card: operations.  At prefill Sq == Skv, and every KV
// tile is reused by every query tile, so the work grows as Sq^2 * d while
// the bytes grow as Sq * d; at Sq = 512, d = 128 it is ~64 operations per
// byte on the causal half and rising with Sq.
//
// Design: one CTA of 256 threads per (b * Hq + hq, BQ-row query tile).
// The TPU runs the KV axis as a sequential grid dimension with the
// online-softmax state in VMEM scratch; here a loop inside the CTA walks
// the 64-row KV tiles from the window's first key (sliding window) to
// the query tile's last row (causal) or to Skv, so masked-out tiles are
// never read.  Each thread owns a (BQ/16) x 4 block of the BQ x 64 score
// tile and a (BQ/16) x (d/16) block of the output, kept in registers with
// the row's running max and sum in f32; masked scores are -1e30 and the
// final division uses max(l, 1e-30), as on the TPU.  The products run on
// the CUDA cores in f32: wgmma with TMA-fed shared-memory tiles is later
// work.
//
// Head dim 256 (RecurrentGemma's MQA sliding-window layers) shrinks the
// query tile to BQ = 32 rows; the tiles stay f32 in shared memory.  At
// d = 256 a 64-row f32 query tile alone is 64 KB and the four tiles take
// 209 KB, one CTA per SM, with only 80 CTAs at RecurrentGemma's prefill
// shape (Hq 10, 512 tokens); 32 rows take 169 KB and give 160 CTAs and
// half the output registers per thread.  d = 64 and 128 keep BQ = 64.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kBK = 64;            // KV rows per iteration

// query rows per CTA at head dim D
template <int D>
__host__ __device__ constexpr int query_tile() { return D > 128 ? 32 : 64; }

template <int D>
__host__ __device__ constexpr size_t smem_floats() {
  constexpr int kBQ = query_tile<D>();
  return kBQ * (D + 1) + kBK * (D + 1) + kBK * D + kBQ * (kBK + 1);
}

template <typename T, int D>
__device__ __forceinline__ void load_rows(float* dst, const T* src, int r0,
                                          int n_rows, int n_valid, int tid) {
  // rows [r0, r0 + n_rows) of a (S, D) matrix into an (n_rows, D + 1) tile
  for (int i = tid; i < n_rows * D / 8; i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    float v[8];
    if (r0 + r < n_valid) {
      load8(src + static_cast<size_t>(r0 + r) * D + c, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[r * (D + 1) + c + j] = v[j];
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int n_q_heads, int n_kv_heads, int sq, int skv,
    float scale, int causal, int window) {
  constexpr int NC = D / 16;       // output columns per thread
  constexpr int kBQ = query_tile<D>();
  constexpr int RQ = kBQ / 16;     // query rows per thread
  const int bh = blockIdx.x, q0 = blockIdx.y * kBQ;
  const int b = bh / n_q_heads, hq = bh % n_q_heads;
  const int hk = hq / (n_q_heads / n_kv_heads);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  extern __shared__ float smem[];
  float* qs = smem;                          // kBQ x (D + 1)
  float* ks = qs + kBQ * (D + 1);            // kBK x (D + 1)
  float* vs = ks + kBK * (D + 1);            // kBK x D
  float* ps = vs + kBK * D;                  // kBQ x (kBK + 1)

  const T* qb = q + static_cast<size_t>(bh) * sq * D;
  const size_t kv_off = static_cast<size_t>(b * n_kv_heads + hk) * skv * D;
  load_rows<T, D>(qs, qb, q0, kBQ, sq, tid);

  float m_i[RQ], l_i[RQ], acc[RQ][NC];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m_i[i] = REPRO_NEG_INF;
    l_i[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  for (int k0 = (kv_begin / kBK) * kBK; k0 < kv_end; k0 += kBK) {
    __syncthreads();                         // previous tile fully used
    load_rows<T, D>(ks, k + kv_off, k0, kBK, skv, tid);
    for (int i = tid; i < kBK * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      float vv[8];
      if (k0 + r < skv) {
        load8(v + kv_off + static_cast<size_t>(k0 + r) * D + c, vv);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) vv[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) vs[r * D + c + j] = vv[j];
    }
    __syncthreads();

    // S = Q K^T for rows ty*RQ + i, keys tx + 16*j
    float s[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int c = 0; c < D; ++c) {
      float a[RQ], bb[4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) a[i] = qs[(ty * RQ + i) * (D + 1) + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) bb[j] = ks[(tx + 16 * j) * (D + 1) + c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * bb[j];
    }

    // mask + online softmax; a row's 64 keys live in 16 lanes of a warp
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qpos = q0 + ty * RQ + i;
      float mx = REPRO_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        bool ok = kpos < skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        s[i][j] = ok ? s[i][j] * scale : REPRO_NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_i[i], mx);
      const float corr = expf(m_i[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty * RQ + i) * (kBK + 1) + tx + 16 * j] = p;
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l_i[i] = l_i[i] * corr + sum;
      m_i[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncwarp();                            // P rows are this warp's own

    // acc += P V
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        const float p = ps[(ty * RQ + i) * (kBK + 1) + kk];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] += p * vv[c];
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qpos = q0 + ty * RQ + i;
    if (qpos >= sq) continue;
    const float inv = 1.f / fmaxf(l_i[i], 1e-30f);
    T* o = out + (static_cast<size_t>(bh) * sq + qpos) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tx + 16 * c] = from_f<T>(acc[i][c] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int batch,
           int hq, int hkv, int sq, int skv, float scale, int causal,
           int window, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kBQ = query_tile<D>();
  const dim3 grid(batch * hq, (sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), hq, hkv, sq, skv,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v, void* out,
               int batch, int hq, int hkv, int sq, int skv, float scale,
               int causal, int window, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, out, batch, hq, hkv, sq, skv, scale,
                           causal, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, batch, hq, hkv, sq, skv, scale,
                            causal, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, batch, hq, hkv, sq, skv, scale,
                            causal, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0 means no sliding window.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int batch, int hq, int hkv, int sq,
                               int skv, int d, float scale, int causal,
                               int window, int dtype, void* stream) {
  using namespace repro;
  if (hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_d<float>(d, q, k, v, out, batch, hq, hkv, sq, skv, scale,
                             causal, window, st);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, out, batch, hq, hkv, sq,
                                     skv, scale, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
