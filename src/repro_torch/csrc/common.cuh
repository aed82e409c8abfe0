// Shared helpers of the port's Hopper kernels: element conversions
// between the storage types (f32, bf16, int8) and the f32 the kernels
// compute in, the dtype codes the Python wrappers pass, and the body of
// the skinny-q verify attention that the contiguous (decode_attention.cu)
// and the paged (paged_decode_attention.cu) kernels share.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// masked score: finite, like the TPU kernels' NEG_INF
#define REPRO_NEG_INF (-1e30f)

namespace repro {

enum DType { kF32 = 0, kBF16 = 1, kI8 = 2 };


__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }

// Eight consecutive elements as f32, with one or two 8/16-byte loads.
// The caller guarantees an element offset that is a multiple of 8 from a
// 16-byte-aligned base (the wrappers check both).
__device__ __forceinline__ void load8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
  o[4] = b.x; o[5] = b.y; o[6] = b.z; o[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = __bfloat162float(h[i]);
}
__device__ __forceinline__ void load8(const int8_t* p, float* o) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const int8_t* c = reinterpret_cast<const int8_t*>(&u);
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = static_cast<float>(c[i]);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// ---------------------------------------------------------------------------
// Skinny-q verify attention: one CTA per (sequence, KV head) holds the g*m
// query rows of that head, so every KV row is read from device memory
// once.  A loop inside the CTA walks the kDecodeTile-row tiles that hold
// visible keys: from the sliding window's first key (if any) to
// kv_end = the number of valid rows.  K and V tiles are loaded with
// 8-element vector loads, dequantized to f32 in shared memory, and an
// online softmax in f32 (masked scores -1e30, final division by
// max(l, 1e-30), as on the TPU) accumulates the output in shared memory.
// The caller's row function maps a logical key position to the addresses
// of its K and V rows (and its int8 scale index): a block-table lookup for
// the paged pool, strides for a contiguous cache.

constexpr int kDecodeThreads = 256;
constexpr int kDecodeTile = 32;        // KV rows per iteration: one per lane

template <typename KT>
struct KVRow {
  const KT* k;
  const KT* v;
  size_t scale_idx;
};

template <int D>
__host__ __device__ constexpr size_t decode_smem_floats(int rows) {
  return 2 * static_cast<size_t>(rows) * D                  // Qs, Acc
         + kDecodeTile * (D + 1) + kDecodeTile * D          // Ks (padded), Vs
         + static_cast<size_t>(rows) * kDecodeTile          // scores / probs
         + 3 * static_cast<size_t>(rows);                   // max, sum, corr
}

// q/out (B, Hq, m, D) contiguous; query row r = gi * m + mi is token mi of
// query head h * g + gi, at logical position len - m + mi.  Keys are
// visible causally (k_pos <= q_pos), inside the window (k_pos > q_pos -
// window) when window > 0, or by ancestor bitmask over the last m rows
// when anc is given; never at k_pos >= kv_end.
template <typename QT, typename KT, int D, typename RowFn>
__device__ __forceinline__ void decode_attention_body(
    const QT* __restrict__ q, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ anc,
    QT* __restrict__ out, int b, int h, int n_q_heads, int n_kv_heads,
    int m, int len, int kv_end, int window, float scale, RowFn row_of) {
  static_assert(kDecodeTile == 32, "one KV row per lane in the softmax");
  static_assert(D % 8 == 0, "8-element vector loads");
  constexpr int kThreads = kDecodeThreads, kTile = kDecodeTile;
  const int g = n_q_heads / n_kv_heads, rows = g * m;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  extern __shared__ float smem[];
  float* qs = smem;                         // rows x D
  float* acc = qs + rows * D;               // rows x D
  float* ks = acc + rows * D;               // kTile x (D + 1)
  float* vs = ks + kTile * (D + 1);         // kTile x D
  float* ss = vs + kTile * D;               // rows x kTile
  float* m_run = ss + rows * kTile;         // rows
  float* l_run = m_run + rows;              // rows
  float* corr = l_run + rows;               // rows

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

  const int first = window > 0 ? max(0, len - m - window + 1) : 0;
  const int n_tiles = (kv_end + kTile - 1) / kTile;
  for (int t = first / kTile; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    // K/V rows [k0, k0 + 32), 8 elements a thread
    for (int i = tid; i < kTile * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8, pos = k0 + r;
      float kv[8], vv[8];
      if (pos < kv_end) {
        const KVRow<KT> kvr = row_of(pos);
        load8(kvr.k + c, kv);
        load8(kvr.v + c, vv);
        if (k_scale != nullptr) {
          const float sk = k_scale[kvr.scale_idx], sv = v_scale[kvr.scale_idx];
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
        if (window > 0) ok = ok && (kpos > qpos - window);
      }
      ss[i] = (ok && kpos < kv_end) ? s : REPRO_NEG_INF;
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

}  // namespace repro
