// Paged verify attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// paged_decode_attention (pallas_call at line 297, body _paged_kernel at
// lines 156-210): skinny-q attention of the m = n_cand+1 verify tokens of
// each sequence against its KV, read through a block table from a shared
// (NB, BS, Hkv, d) pool.  Causal over the last m positions, or
// ancestor-bitmask masking of a speculation-tree buffer (anc_bits);
// f32 / bf16 pools, or int8 pools with (NB, BS, Hkv, 1) f32 row scales.
//
// Bound on this card: bytes.  Each KV row is used by the g*m query rows
// of its head and nothing else, so the arithmetic intensity is ~g*m/2
// operations per byte (about 10 at g=4, m=5), far under the ~295 the
// H100 needs to be compute-bound.  At the serving path's ~600-token
// contexts the whole call moves ~10 MB and is bound by launch latency.
//
// Design: one CTA per (sequence, KV head); the g*m query rows of that
// head share the CTA, so every KV row is read from device memory once.
// The TPU grid walks every logical block of the table in order
// (decode_attention.py:281); here a loop inside the CTA walks only the
// ceil(len / 32) tiles of 32 rows that hold the sequence's tokens, with
// each row's physical block looked up in the table (entries <= 0 resolve
// to block 0).  K and V tiles are loaded with 8-element vector loads,
// dequantized to f32 in shared memory, and an online softmax in f32
// (masked scores -1e30, final division by max(l, 1e-30), as on the TPU)
// accumulates the output in shared memory.  Split-KV across CTAs, TMA
// and wgmma are later work.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kThreads = 256;
constexpr int kTile = 32;          // KV rows per iteration: one per lane
constexpr int kMaxRows = 128;      // g * m query rows per CTA

template <int D>
__host__ __device__ constexpr size_t smem_floats(int rows) {
  return 2 * static_cast<size_t>(rows) * D      // Qs, Acc
         + kTile * (D + 1) + kTile * D          // Ks (padded), Vs
         + static_cast<size_t>(rows) * kTile    // scores / probabilities
         + 3 * static_cast<size_t>(rows);       // running max, sum, corr
}

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pool,
    const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ lengths, const int* __restrict__ anc,
    QT* __restrict__ out, int n_q_heads, int n_kv_heads, int m,
    int block_size, int max_blocks, float scale) {
  static_assert(kTile == 32, "one KV row per lane in the softmax");
  static_assert(D % 8 == 0, "8-element vector loads");
  const int b = blockIdx.x, h = blockIdx.y;
  const int g = n_q_heads / n_kv_heads, rows = g * m;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int len = lengths[b];

  extern __shared__ float smem[];
  float* qs = smem;                         // rows x D
  float* acc = qs + rows * D;               // rows x D
  float* ks = acc + rows * D;               // kTile x (D + 1)
  float* vs = ks + kTile * (D + 1);         // kTile x D
  float* ss = vs + kTile * D;               // rows x kTile
  float* m_run = ss + rows * kTile;         // rows
  float* l_run = m_run + rows;              // rows
  float* corr = l_run + rows;               // rows

  // query row r = gi * m + mi is token mi of query head h * g + gi
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D, gi = r / m, mi = r % m;
    qs[i] = to_f(q[((static_cast<size_t>(b) * n_q_heads + h * g + gi) * m
                    + mi) * D + c]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_run[r] = REPRO_NEG_INF;
    l_run[r] = 0.f;
  }
  __syncthreads();

  const int* table = tables + static_cast<size_t>(b) * max_blocks;
  const int n_tiles = (len + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    // K/V rows [k0, k0 + 32) through the block table, 8 elements a thread
    for (int i = tid; i < kTile * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8, pos = k0 + r;
      float kv[8], vv[8];
      if (pos < len) {
        const int lb = min(pos / block_size, max_blocks - 1);
        const int blk = max(table[lb], 0);
        const size_t row = (static_cast<size_t>(blk) * block_size
                            + pos % block_size) * n_kv_heads + h;
        load8(k_pool + row * D + c, kv);
        load8(v_pool + row * D + c, vv);
        if (k_scale != nullptr) {
          const float sk = k_scale[row], sv = v_scale[row];
#pragma unroll
          for (int j = 0; j < 8; ++j) { kv[j] *= sk; vv[j] *= sv; }
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) { kv[j] = 0.f; vv[j] = 0.f; }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        ks[r * (D + 1) + c + j] = kv[j];
        vs[r * D + c + j] = vv[j];
      }
    }
    __syncthreads();

    // scores: one (row, key) pair per thread and step
    for (int i = tid; i < rows * kTile; i += kThreads) {
      const int r = i / kTile, kk = i % kTile, mi = r % m;
      const float* qr = qs + r * D;
      const float* kr = ks + kk * (D + 1);
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s += qr[c] * kr[c];
      s *= scale;
      const int kpos = k0 + kk;
      bool ok;
      if (anc != nullptr) {
        const int spec0 = len - m, col = kpos - spec0;
        const int bit = (anc[mi] >> min(max(col, 0), 31)) & 1;
        ok = (kpos < spec0) || (col >= 0 && kpos < len && bit);
      } else {
        const int qpos = len - m + mi;
        ok = (kpos <= qpos) && (kpos < len);
      }
      ss[i] = ok ? s : REPRO_NEG_INF;
    }
    __syncthreads();

    // online softmax: one warp per query row, one key per lane
    for (int r = warp; r < rows; r += kThreads / 32) {
      const float s = ss[r * kTile + lane];
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_run[r];
      const float m_new = fmaxf(m_prev, mx);
      const float p = expf(s - m_new);
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      ss[r * kTile + lane] = p;
      if (lane == 0) {
        const float c = expf(m_prev - m_new);
        corr[r] = c;
        l_run[r] = l_run[r] * c + sum;
        m_run[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * corr + P V
    for (int i = tid; i < rows * D; i += kThreads) {
      const int r = i / D, c = i % D;
      const float* pr = ss + r * kTile;
      float a = acc[i] * corr[r];
#pragma unroll 8
      for (int kk = 0; kk < kTile; ++kk) a += pr[kk] * vs[kk * D + c];
      acc[i] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D, c = i % D, gi = r / m, mi = r % m;
    out[((static_cast<size_t>(b) * n_q_heads + h * g + gi) * m + mi) * D + c] =
        from_f<QT>(acc[i] / fmaxf(l_run[r], 1e-30f));
  }
}

template <typename QT, typename KT, int D>
int launch(const void* q, const void* kp, const void* vp, const void* ksc,
           const void* vsc, const void* tables, const void* lengths,
           const void* anc, void* out, int batch, int hq, int hkv, int m,
           int block_size, int max_blocks, float scale,
           cudaStream_t stream) {
  const int rows = (hq / hkv) * m;
  const size_t smem = smem_floats<D>(rows) * sizeof(float);
  auto kern = paged_decode_kernel<QT, KT, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(batch, hkv), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<const int*>(anc),
      static_cast<QT*>(out), hq, hkv, m, block_size, max_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int dispatch_d(int d, const void* q, const void* kp, const void* vp,
               const void* ksc, const void* vsc, const void* tables,
               const void* lengths, const void* anc, void* out, int batch,
               int hq, int hkv, int m, int block_size, int max_blocks,
               float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<QT, KT, 64>(q, kp, vp, ksc, vsc, tables, lengths, anc,
                                out, batch, hq, hkv, m, block_size,
                                max_blocks, scale, stream);
    case 128:
      return launch<QT, KT, 128>(q, kp, vp, ksc, vsc, tables, lengths, anc,
                                 out, batch, hq, hkv, m, block_size,
                                 max_blocks, scale, stream);
    case 256:
      return launch<QT, KT, 256>(q, kp, vp, ksc, vsc, tables, lengths, anc,
                                 out, batch, hq, hkv, m, block_size,
                                 max_blocks, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, const void* anc, void* out, int batch, int hq,
    int hkv, int m, int d, int block_size, int max_blocks, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  using namespace repro;
  if (hq % hkv != 0 || (hq / hkv) * m > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_PAGED(QT, KT)                                                  \
  return dispatch_d<QT, KT>(d, q, k_pool, v_pool, k_scale, v_scale, tables, \
                            lengths, anc, out, batch, hq, hkv, m,           \
                            block_size, max_blocks, scale, st)
  if (q_dtype == kF32 && kv_dtype == kF32) REPRO_PAGED(float, float);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    REPRO_PAGED(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == kF32 && kv_dtype == kI8) REPRO_PAGED(float, int8_t);
  if (q_dtype == kBF16 && kv_dtype == kI8) REPRO_PAGED(__nv_bfloat16, int8_t);
#undef REPRO_PAGED
  return static_cast<int>(cudaErrorInvalidValue);
}
