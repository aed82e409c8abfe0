// Shared helpers of the port's Hopper kernels: element conversions
// between the storage types (f32, bf16, int8) and the f32 the kernels
// compute in, the dtype codes the Python wrappers pass, and the split-KV
// verify attention that the contiguous (decode_attention.cu) and the
// paged (paged_decode_attention.cu) kernels share (its note below).
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
// Split-KV verify attention: the body the contiguous (decode_attention.cu)
// and the paged (paged_decode_attention.cu) kernels share.
//
// The work of one call is B * Hkv skinny products: the g*m query rows of
// one KV head (20 at Mixtral's verify shape) against that head's keys.
// Each KV row serves only those g*m rows, so the call is bound by bytes
// (~g*m/2 operations per byte, far under the H100's ~295), and B * Hkv
// CTAs (32 at the serving shape) cannot keep 132 SMs' worth of loads in
// flight.  So the key axis is split as well: the grid is (B, Hkv,
// n_split), n_split chosen by the wrapper from shapes alone (about two
// CTAs per SM; kernels/decode_attention.py::n_split), never from the
// lengths, which stay on the card.  Each CTA cuts [first, kv_end) -- from
// the sliding window's first key, if any, to the number of valid rows --
// into n_split chunks of whole kKeyTile-row tiles, computed on the device
// from lengths[b], and runs an online softmax over its chunk into a
// partial (acc, m, l) per query row.  A CTA whose chunk is empty reads no
// KV and leaves the partial (m = -1e30, l = 0).
//
// Row groups: one CTA holds at most group_rows query rows (the wrapper's
// kernels/decode_attention.py::row_groups: the smem and n-tile capacity of
// the bodies below, max_rows there).  Where g*m is larger -- Llama-3-405B's
// 16 query heads a KV head under a 10-node tree, 160 rows -- the rows are
// dealt out to n_groups CTAs, the grid's y axis being (head, group), and
// every group reads the same KV tiles (the second read mostly hits L2).
// Each group is a merge unit of its own.
//
// Merge: in one launch.  Every CTA writes its partial to the wrapper's
// f32 workspace and takes a ticket from an int32 counter per (b, h, row
// group); the CTA that draws the last ticket merges the n_split partials
// of that unit in split order 0, 1, ... (so the result has the same bits
// whichever CTA finishes last; no float atomics), writes the output and
// sets the counter back to 0 for the next call.  A partial with l = 0 is
// empty and skipped.  A split can hold no visible key for some row (its
// keys lie after the row's position, before the window, or outside the
// row's tree ancestors): with the finite -1e30 every masked score then
// gives exp(0) = 1 and the partial holds a finite sum of V rows under
// m = -1e30, which the merge weights by exp(-1e30 - m_global) = 0.  The
// final division by max(l, 1e-30) is done once, after the merge.  With
// n_split = 1 the CTA writes the output itself.
//
// Two bodies compute a partial:
// - decode_mma_body (bf16 q and KV: the path every serve run takes):
//   tensor cores, mma.sync m16n8k16 with f32 accumulators.  The keys are
//   the M side of S^T = K Q^T and the g*m rows the N side, rounded to 8
//   (20 rows: 3 n-tiles); P is rounded to bf16 and O^T = V^T P^T puts the
//   head dim on M.  KV tiles of 64 rows stream through a 3-stage cp.async
//   ring (XOR-swizzled 16-byte chunks, no padding, so two CTAs fit an SM
//   at d <= 128); operands come from shared memory by ldmatrix (.trans
//   for V), q's fragments stay in registers.  Warp w owns query n-tiles
//   w and w + 8 and runs their softmax on the S^T fragment in registers
//   (row max and sum over the 8 lanes that share a column; exp by
//   __expf, whose error is far under P's bf16 rounding; the mask is
//   skipped on tiles every row sees whole).  In O^T = V^T P^T each warp
//   owns head-dim m-tiles and runs every n-tile up to the capacity NTC
//   (g*m rounded up to 1, 2, 4, 8, 16 n-tiles) with no test, so the
//   products of one V^T fragment interleave instead of waiting on a
//   branch per (m-tile, n-tile) pair.
// - decode_core_body (f32 or int8 KV: the lossless path and int8 pools):
//   the exact f32 body on the CUDA cores, 32-row tiles dequantized into
//   shared memory, one (row, key) score per thread and step.
// Both read q and write the output through (batch, head, token) strides,
// so the model hands over its (B, S, H, d) tensors as transposed views.

constexpr int kKeyTile = 64;           // keys per split unit and mma tile
constexpr int kDecodeThreads = 256;    // CUDA-core body
constexpr int kDecodeTile = 32;        // CUDA-core body: KV rows a step
constexpr int kDecodeStages = 3;       // mma body: cp.async ring depth

template <typename KT>
struct KVRow {
  const KT* k;
  const KT* v;
  size_t scale_idx;
};

// What both kernels pass their body: q/out through element strides of
// their (batch, head, token) axes, the lengths, the optional ancestor
// bitmasks, the merge workspace and the shapes.
struct DecodeArgs {
  const void* q;
  void* out;
  long long q_sb, q_sh, q_sm, o_sb, o_sh, o_sm;
  const int* lengths;
  const int* anc;
  float* part_acc;        // (B, Hkv, n_split, g*m, d), n_split > 1 only
  float2* part_ml;        // (B, Hkv, n_split, g*m): (m, l)
  int* counters;          // (B * Hkv * n_groups), zero between calls
  int n_q_heads, n_kv_heads, m, n_split, window;
  // row groups: the g*m query rows of a KV head are dealt out to n_groups
  // CTAs of at most group_rows rows each (group rg holds rows [rg *
  // group_rows, min((rg + 1) * group_rows, g*m)))
  int n_groups, group_rows;
  float scale;
  // the cache holds slots [kv_offset, kv_offset + n_slots) of the
  // sequence (lengths and the masks stay global); lse, when not null, gets
  // each row's log-sum-exp (B, Hq, m), -inf for a row with no visible key.
  // Both zero where the paged kernel leaves them out.
  int kv_offset;
  float* lse;
};

// The most query rows one CTA holds at head dim d (the wrapper's
// max_rows): 16 n-tiles of the mma body below (10 at d > 128), and what
// the CUDA-core body's shared memory (decode_smem_floats) fits in 227 KB.
__host__ __device__ constexpr int max_group_rows(int d) {
  return (d > 128 ? 80 : 128)
                 < (232448 / 4 - kDecodeTile * (2 * d + 1))
                       / (2 * d + kDecodeTile + 3)
             ? (d > 128 ? 80 : 128)
             : (232448 / 4 - kDecodeTile * (2 * d + 1))
                   / (2 * d + kDecodeTile + 3);
}

// Whether n_groups groups of group_rows rows cover the g*m rows, each
// group non-empty and within one CTA's capacity.
inline bool row_groups_valid(int hq, int hkv, int m, int d, int n_groups,
                             int group_rows) {
  const int total = (hq / hkv) * m;
  return n_groups >= 1 && group_rows >= 1 && group_rows <= max_group_rows(d)
         && n_groups * group_rows >= total
         && (n_groups - 1) * group_rows < total;
}

// The rows [r0, r0 + rows) of the g*m query rows that row group rg holds.
struct RowGroup {
  int r0, rows;
};

__device__ __forceinline__ RowGroup row_group(const DecodeArgs& a, int rg) {
  const int total = (a.n_q_heads / a.n_kv_heads) * a.m;
  RowGroup g;
  g.r0 = rg * a.group_rows;
  g.rows = min(a.group_rows, total - g.r0);
  return g;
}

// The keys [k_begin, k_end) of split `split`, as slots of the cache (slot
// i holds position off + i): the nt whole kKeyTile tiles that hold
// [first, kv_end) dealt out in order, split s taking tiles [s * nt /
// n_split, (s + 1) * nt / n_split) (empty when nt < n_split and the share
// rounds to nothing).  kv_end is a slot too; first is the window's first
// position less off, at least 0.
struct SplitRange {
  int k_begin, k_end;
};

__device__ __forceinline__ SplitRange split_range(int len, int kv_end, int m,
                                                  int window, int n_split,
                                                  int split, int off) {
  const int first = window > 0 ? max(0, len - m - window + 1 - off) : 0;
  const int t_lo = first / kKeyTile;
  const int t_hi = (max(kv_end, 0) + kKeyTile - 1) / kKeyTile;
  const int nt = max(t_hi - t_lo, 0);
  const int ts = t_lo + split * nt / n_split;
  const int te = t_lo + (split + 1) * nt / n_split;
  SplitRange r;
  r.k_begin = ts * kKeyTile;
  r.k_end = te > ts ? min(te * kKeyTile, kv_end) : r.k_begin;
  return r;
}

// Whether query row token mi (at position len - m + mi) sees key kpos:
// causal, inside the window when window > 0, or by ancestor bitmask
// `bits` over the last m rows when has_anc; never at kpos >= kv_end.
__device__ __forceinline__ bool key_visible(int kpos, int mi, int len, int m,
                                            int kv_end, int window,
                                            bool has_anc, int bits) {
  bool ok;
  if (has_anc) {
    const int spec0 = len - m, col = kpos - spec0;
    const int bit = (bits >> min(max(col, 0), 31)) & 1;
    ok = (kpos < spec0) || (col >= 0 && kpos < len && bit);
  } else {
    const int qpos = len - m + mi;
    ok = (kpos <= qpos) && (kpos < len);
    if (window > 0) ok = ok && (kpos > qpos - window);
  }
  return ok && kpos < kv_end;
}

// Query row r = gi * m + mi is token mi of query head h * g + gi.
__device__ __forceinline__ long long q_row_off(const DecodeArgs& a, int b,
                                               int h, int r, bool out) {
  const int g = a.n_q_heads / a.n_kv_heads, gi = r / a.m, mi = r % a.m;
  return out ? b * a.o_sb + (h * g + gi) * a.o_sh + mi * a.o_sm
             : b * a.q_sb + (h * g + gi) * a.q_sh + mi * a.q_sm;
}

constexpr int kMergeChunk = 8;       // splits merged per pass

// The end of every CTA: acc (rows x D f32 in shared memory, not yet
// divided by l) with m_s / l_s (rows) is this split's partial.  With one
// split it is the answer; otherwise it goes to the workspace, and the CTA
// that draws the last ticket of its (b, h) merges all of them in split
// order, kMergeChunk splits a pass: the passes' (m, l) pairs are loaded
// at once into `scratch` ((2 * kMergeChunk + 1) * rows floats of shared
// memory), and acc, m_s and l_s become the running merge, so every
// thread keeps up to kMergeChunk loads of 16 bytes in flight.
template <typename QT, int D>
__device__ __forceinline__ void split_epilogue(const DecodeArgs& a,
                                               float* acc, float* m_s,
                                               float* l_s, float* scratch,
                                               int b, int h, RowGroup grp,
                                               int split, bool empty,
                                               int nthreads) {
  __shared__ int last;
  constexpr int kV = D / 4;                 // float4 units of a row
  static_assert(D % 4 == 0, "float4 rows");
  const int tid = threadIdx.x;
  const int rows = grp.rows;
  QT* out = static_cast<QT*>(a.out);
  if (a.n_split > 1) {
    // the merge unit (b, h, row group); its partials group_rows apart
    const size_t bh = (static_cast<size_t>(b) * a.n_kv_heads + h)
                      * a.n_groups + grp.r0 / a.group_rows;
    const size_t base = (bh * a.n_split + split) * a.group_rows;
    for (int r = tid; r < rows; r += nthreads)
      a.part_ml[base + r] = make_float2(m_s[r], l_s[r]);
    if (!empty) {
      float4* dst = reinterpret_cast<float4*>(a.part_acc + base * D);
      for (int i = tid; i < rows * kV; i += nthreads)
        dst[i] = reinterpret_cast<const float4*>(acc)[i];
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(a.counters + bh, 1) == a.n_split - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();

    float2* ml = reinterpret_cast<float2*>(scratch);   // chunk x rows
    float* resc = scratch + 2 * kMergeChunk * rows;    // rows
    const size_t first = bh * a.n_split * a.group_rows;
    for (int i = tid; i < rows * kV; i += nthreads)
      reinterpret_cast<float4*>(acc)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = tid; r < rows; r += nthreads) {
      m_s[r] = REPRO_NEG_INF;
      l_s[r] = 0.f;
    }
    for (int s0 = 0; s0 < a.n_split; s0 += kMergeChunk) {
      const int ns = min(kMergeChunk, a.n_split - s0);
      __syncthreads();                     // the last pass is done
      for (int i = tid; i < ns * rows; i += nthreads)
        ml[i] = __ldcg(a.part_ml + first + (s0 + i / rows) * a.group_rows
                       + i % rows);
      __syncthreads();
      // per row: the new running max, the old sum's factor, and each
      // split's weight (0 for an empty split, whose acc was not written)
      for (int r = tid; r < rows; r += nthreads) {
        float mg = m_s[r];
        for (int s = 0; s < ns; ++s)
          if (ml[s * rows + r].y > 0.f) mg = fmaxf(mg, ml[s * rows + r].x);
        const float c = expf(m_s[r] - mg);
        float l = l_s[r] * c;
        for (int s = 0; s < ns; ++s) {
          float2& e = ml[s * rows + r];
          const float w = e.y > 0.f ? expf(e.x - mg) : 0.f;
          l += e.y * w;
          e.x = w;
        }
        m_s[r] = mg;
        l_s[r] = l;
        resc[r] = c;
      }
      __syncthreads();
      for (int i = tid; i < rows * kV; i += nthreads) {
        const int r = i / kV;
        float4 o = reinterpret_cast<float4*>(acc)[i];
        const float c = resc[r];
        o.x *= c; o.y *= c; o.z *= c; o.w *= c;
        float4 v[kMergeChunk];
#pragma unroll
        for (int s = 0; s < kMergeChunk; ++s)
          if (s < ns && ml[s * rows + r].x != 0.f)
            v[s] = __ldcg(reinterpret_cast<const float4*>(
                              a.part_acc
                              + (first + (s0 + s) * a.group_rows) * D)
                          + i);
#pragma unroll
        for (int s = 0; s < kMergeChunk; ++s) {
          const float w = s < ns ? ml[s * rows + r].x : 0.f;
          if (w != 0.f) {
            o.x += w * v[s].x; o.y += w * v[s].y;
            o.z += w * v[s].z; o.w += w * v[s].w;
          }
        }
        reinterpret_cast<float4*>(acc)[i] = o;
      }
    }
    __syncthreads();
    if (tid == 0) a.counters[bh] = 0;
  }
  // a row with no visible key kept the masked score as its max: it
  // writes 0 and reports a log-sum-exp of -inf
  for (int i = tid; i < rows * D; i += nthreads) {
    const int r = i / D, c = i % D;
    out[q_row_off(a, b, h, grp.r0 + r, true) + c] =
        m_s[r] > 0.5f * REPRO_NEG_INF
            ? from_f<QT>(acc[i] / fmaxf(l_s[r], 1e-30f))
            : from_f<QT>(0.f);
  }
  if (a.lse != nullptr) {
    const int g = a.n_q_heads / a.n_kv_heads;
    for (int r = tid; r < rows; r += nthreads) {
      const int gr = grp.r0 + r;
      a.lse[(static_cast<size_t>(b) * a.n_q_heads + h * g + gr / a.m) * a.m
            + gr % a.m] = m_s[r] > 0.5f * REPRO_NEG_INF
                              ? m_s[r] + logf(l_s[r])
                              : __int_as_float(0xff800000);  // -inf
    }
  }
}

// ---------------------------------------------------------------------------
// CUDA-core body (f32 and int8 KV): exact f32 arithmetic.

template <int D>
__host__ __device__ constexpr size_t decode_smem_floats(int rows) {
  return 2 * static_cast<size_t>(rows) * D                  // Qs, Acc
         + kDecodeTile * (D + 1) + kDecodeTile * D          // Ks (padded), Vs
         + static_cast<size_t>(rows) * kDecodeTile          // scores / probs
         + 3 * static_cast<size_t>(rows);                   // max, sum, corr
}

template <typename QT, typename KT, int D, typename RowFn>
__device__ __forceinline__ void decode_core_body(
    const DecodeArgs& a, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, int b, int h, int rg, int split,
    int len, int kv_end, RowFn row_of) {
  // kv_end: the cache's slots that hold keys (at most n_slots); slot i is
  // position off + i
  static_assert(kDecodeTile == 32, "one KV row per lane in the softmax");
  static_assert(kKeyTile % kDecodeTile == 0, "splits hold whole tiles");
  static_assert(D % 8 == 0, "8-element vector loads");
  constexpr int kThreads = kDecodeThreads, kTile = kDecodeTile;
  const RowGroup grp = row_group(a, rg);
  const int m = a.m, rows = grp.rows, r0 = grp.r0;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const QT* q = static_cast<const QT*>(a.q);
  const int off = a.kv_offset;
  const SplitRange sr = split_range(len, kv_end, m, a.window, a.n_split,
                                    split, off);

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
    const int r = i / D, c = i % D;
    qs[i] = to_f(q[q_row_off(a, b, h, r0 + r, false) + c]);
    acc[i] = 0.f;
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_run[r] = REPRO_NEG_INF;
    l_run[r] = 0.f;
  }
  __syncthreads();

  for (int k0 = sr.k_begin; k0 < sr.k_end; k0 += kTile) {
    // K/V rows [k0, k0 + 32), 8 elements a thread
    for (int i = tid; i < kTile * D / 8; i += kThreads) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8, pos = k0 + r;
      float kv[8], vv[8];
      if (pos < sr.k_end) {
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
      const int r = i / kTile, kk = i % kTile, mi = (r0 + r) % m;
      const float* qr = qs + r * D;
      const float* kr = ks + kk * (D + 1);
      float s = 0.f;
#pragma unroll 8
      for (int c = 0; c < D; ++c) s += qr[c] * kr[c];
      const bool ok = key_visible(off + k0 + kk, mi, len, m, off + kv_end,
                                  a.window,
                                  a.anc != nullptr,
                                  a.anc != nullptr ? a.anc[mi] : 0);
      ss[i] = ok ? s * a.scale : REPRO_NEG_INF;
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
      float s = acc[i] * corr[r];
#pragma unroll 8
      for (int kk = 0; kk < kTile; ++kk) s += pr[kk] * vs[kk * D + c];
      acc[i] = s;
    }
    __syncthreads();
  }
  __syncthreads();                   // qs is free: the merge's scratch
  split_epilogue<QT, D>(a, acc, m_run, l_run, qs, b, h, grp, split,
                        sr.k_begin >= sr.k_end, kThreads);
}

// ---------------------------------------------------------------------------
// Tensor-core body (bf16 q and KV): mma.sync m16n8k16, f32 accumulators.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x2(uint32_t& r0, uint32_t& r1,
                                        const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(smem_addr(p)));
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Shared-memory tiles of `cols` bf16 columns, rows of 16-byte chunks
// placed at chunk ^ (row % 8): ldmatrix's eight row addresses of one
// column chunk then fall in eight different bank groups, with no padding.
__device__ __forceinline__ int swz(int row, int chunk, int cols) {
  return row * cols + ((chunk ^ (row & 7)) << 3);
}

// NTC: the query n-tiles (8 rows each) the CTA computes, its rows
// rounded up to 1, 2, 4, 8 or 16 (10 at d > 128, whose CTAs hold at most
// 76 rows at d 256 and 80 at d 240): the n-tile loops of the P V product
// run to NTC with no test, so their products interleave; the padded
// columns are computed and never written.
//
// kDT: the shared-memory tile's width, the head dim rounded up to 64 (8
// swizzled 16-byte chunks a row).  At d 240 (Gemma-3) the tile is 256
// wide and its last 16 columns are zeros written into the ring, never
// read from device memory: the S product runs d / 16 = 15 k-steps over
// the real columns, the P V product writes 16 m-tiles and the zero ones
// are dropped when the accumulators go to shared memory.
template <int D, int NTC>
struct MmaCfg {
  static constexpr int kWarps = 8;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kDT = (D + 63) / 64 * 64;
  static constexpr int kMT = kDT / 16;                // head-dim m-tiles
  // S phase: warp w owns n-tiles w and w + 8
  static constexpr int kNTS = (NTC + kWarps - 1) / kWarps;
  // P V phase: warp w owns m-tiles w % kMTB + 8 u (u < kMTW) and, where
  // there are fewer m-tiles than warps (d 64), every kWPM-th n-tile
  static constexpr int kMTB = kMT < kWarps ? kMT : kWarps;
  static constexpr int kMTW = kMT / kMTB;
  static constexpr int kWPM = kWarps / kMTB;
  static constexpr int kNTO = (NTC + kWPM - 1) / kWPM;
  static constexpr int kRowsP = 8 * kNTO * kWPM;      // P rows held
  static constexpr int kStageElems = 2 * kKeyTile * kDT;  // K then V
  static constexpr int kSmem = kDecodeStages * kStageElems * 2  // ring
                               + kRowsP * kKeyTile * 2          // P
                               + 3 * kRowsP * 4;                // corr, m, l
  // two CTAs an SM where registers (128 a thread) and shared memory allow
  static constexpr int kMinBlocks = D <= 128 && kNTS * kMTW * kNTO < 8 ? 2 : 1;
  static_assert(D % 16 == 0, "whole k16 steps of the S product");
};

// The n-tile capacity the dispatch picks for g*m query rows.
__host__ __device__ constexpr int n_tile_cap(int rows, int d) {
  return rows <= 8 ? 1 : rows <= 16 ? 2 : rows <= 32 ? 4 : rows <= 64 ? 8
         : d > 128 ? 10 : 16;
}

template <int D, int NTC, typename RowFn>
__device__ __forceinline__ void decode_mma_body(const DecodeArgs& a, int b,
                                                int h, int rg, int split,
                                                int len, int kv_end,
                                                RowFn row_of) {
  using C = MmaCfg<D, NTC>;
  constexpr int kW = C::kWarps, kT = C::kThreads, kDT = C::kDT;
  constexpr int kCh = kDT / 8, kChR = D / 8;    // chunks: tile, stored row
  constexpr int NTW = C::kNTS;
  const RowGroup grp = row_group(a, rg);
  const int m = a.m, rows = grp.rows, r0 = grp.r0;
  const int n_nt = (rows + 7) / 8;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const bool has_anc = a.anc != nullptr;
  const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(a.q);
  // slots as in decode_core_body: slot i holds position off + i
  const int off = a.kv_offset, kv_end_pos = off + kv_end;
  const SplitRange sr = split_range(len, kv_end, m, a.window, a.n_split,
                                    split, off);
  const int n_tiles = (sr.k_end - sr.k_begin + kKeyTile - 1) / kKeyTile;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* p_s = ring + kDecodeStages * C::kStageElems;  // rows x 64
  float* corr_s = reinterpret_cast<float*>(p_s + C::kRowsP * kKeyTile);
  float* m_s = corr_s + C::kRowsP;
  float* l_s = m_s + C::kRowsP;
  // the warp's P V tiles: m-tiles mt0 + 8 u, n-tiles nt0 + kWPM i
  const int mt0 = warp % C::kMTB, nt0 = warp / C::kMTB;

  // q's B fragments (k = head dim, n = row) for the warp's n-tiles, the
  // running max / sum of its rows 2tq, 2tq + 1 of each n-tile
  uint32_t qf[NTW][D / 16][2];
  float m_run[NTW][2], l_run[NTW][2];
  int bits[NTW][2];
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int nt = warp + j * kW, rq = nt * 8 + gq;
    const bool ok = nt < n_nt && rq < rows;
    const __nv_bfloat16* qr = q + (ok ? q_row_off(a, b, h, r0 + rq, false)
                                      : 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const int c = ks * 16 + 2 * tq;
      qf[j][ks][0] = ok ? *reinterpret_cast<const uint32_t*>(qr + c) : 0u;
      qf[j][ks][1] = ok ? *reinterpret_cast<const uint32_t*>(qr + c + 8) : 0u;
    }
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      m_run[j][e] = REPRO_NEG_INF;
      l_run[j][e] = 0.f;
      bits[j][e] = has_anc ? a.anc[(r0 + nt * 8 + 2 * tq + e) % m] : 0;
    }
  }
  float o[C::kMTW][C::kNTO][4];
#pragma unroll
  for (int u = 0; u < C::kMTW; ++u)
#pragma unroll
    for (int i = 0; i < C::kNTO; ++i)
      o[u][i][0] = o[u][i][1] = o[u][i][2] = o[u][i][3] = 0.f;

  // K/V tile t (64 rows from k_begin + 64 t) into ring stage `st`; rows
  // past k_end are zero (their P is 0, and 0 * garbage could be NaN), and
  // so are the columns past d in a tile rounded up to kDT
  auto load_tile = [&](int t, int st) {
    __nv_bfloat16* kd = ring + st * C::kStageElems;
    __nv_bfloat16* vd = kd + kKeyTile * kDT;
    const int k0 = sr.k_begin + t * kKeyTile;
    for (int i = tid; i < kKeyTile * kCh; i += kT) {
      const int r = i / kCh, c = i % kCh, pos = k0 + r;
      const int off = swz(r, c, kDT);
      if (pos < sr.k_end && c < kChR) {
        const KVRow<__nv_bfloat16> kvr = row_of(pos);
        cp_async16(kd + off, kvr.k + c * 8);
        cp_async16(vd + off, kvr.v + c * 8);
      } else {
        *reinterpret_cast<uint4*>(kd + off) = make_uint4(0, 0, 0, 0);
        *reinterpret_cast<uint4*>(vd + off) = make_uint4(0, 0, 0, 0);
      }
    }
  };

#pragma unroll
  for (int t = 0; t < kDecodeStages - 1; ++t) {
    if (t < n_tiles) load_tile(t, t);
    cp_async_commit();
  }
  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kDecodeStages - 2>();
    __syncthreads();                 // tile t landed; tile t - 1 consumed
    if (t + kDecodeStages - 1 < n_tiles)
      load_tile(t + kDecodeStages - 1, (t + kDecodeStages - 1) % kDecodeStages);
    cp_async_commit();
    const __nv_bfloat16* kt = ring + (t % kDecodeStages) * C::kStageElems;
    const __nv_bfloat16* vt = kt + kKeyTile * kDT;
    const int k0 = off + sr.k_begin + t * kKeyTile;     // a position
    // every key of the tile visible to every query row
    const bool full =
        k0 + kKeyTile <= kv_end_pos
        && (has_anc ? k0 + kKeyTile <= len - m
                    : k0 + kKeyTile <= len - m + 1
                          && (a.window <= 0 || k0 > len - 1 - a.window));

    // S^T = K Q^T for the warp's n-tiles, softmax in registers, P to smem
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
      const int nt = warp + j * kW;
      if (nt >= n_nt) continue;      // warp-uniform
      float s[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) s[mt][0] = s[mt][1] = s[mt][2] = s[mt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          uint32_t af[4];
          ldsm_x4(af, kt + swz(mt * 16 + (lane & 15), ks * 2 + (lane >> 4),
                               kDT));
          mma_bf16(s[mt], af, qf[j][ks][0], qf[j][ks][1]);
        }
      }
      // scale and mask; a tile whose every key every row sees needs no mask
      if (full) {
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[mt][i] *= a.scale;
      } else {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int mi = (r0 + nt * 8 + 2 * tq + e) % m;
#pragma unroll
          for (int mt = 0; mt < 4; ++mt)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              float& v = s[mt][2 * hf + e];
              v = key_visible(k0 + mt * 16 + gq + 8 * hf, mi, len, m,
                              kv_end_pos, a.window, has_anc, bits[j][e])
                      ? v * a.scale
                      : REPRO_NEG_INF;
            }
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int r = nt * 8 + 2 * tq + e;
        float mx = REPRO_NEG_INF;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt)
          mx = fmaxf(mx, fmaxf(s[mt][e], s[mt][2 + e]));
#pragma unroll
        for (int x = 4; x < 32; x <<= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
        const float m_new = fmaxf(m_run[j][e], mx);
        float sum = 0.f;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float p = __expf(s[mt][2 * hf + e] - m_new);
            sum += p;
            const int kk = mt * 16 + gq + 8 * hf;
            p_s[swz(r, kk >> 3, kKeyTile) + (kk & 7)] = __float2bfloat16(p);
          }
        }
#pragma unroll
        for (int x = 4; x < 32; x <<= 1)
          sum += __shfl_xor_sync(0xffffffffu, sum, x);
        const float c = __expf(m_run[j][e] - m_new);
        l_run[j][e] = l_run[j][e] * c + sum;
        m_run[j][e] = m_new;
        if (gq == 0) corr_s[r] = c;
      }
    }
    __syncthreads();                 // P and corr of tile t

    // O^T = O^T * corr + V^T P^T: each V^T fragment serves the warp's
    // kNTO n-tiles, whose products are independent
#pragma unroll
    for (int i = 0; i < C::kNTO; ++i) {
      const int r = (nt0 + C::kWPM * i) * 8 + 2 * tq;
      const float c0 = corr_s[r], c1 = corr_s[r + 1];
#pragma unroll
      for (int u = 0; u < C::kMTW; ++u) {
        o[u][i][0] *= c0; o[u][i][1] *= c1; o[u][i][2] *= c0; o[u][i][3] *= c1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kKeyTile / 16; ++kk) {
      uint32_t af[C::kMTW][4], bf[C::kNTO][2];
#pragma unroll
      for (int u = 0; u < C::kMTW; ++u)
        ldsm_x4_t(af[u], vt + swz(kk * 16 + (lane & 7) + ((lane >> 4) << 3),
                                  (mt0 + 8 * u) * 2 + ((lane >> 3) & 1),
                                  kDT));
#pragma unroll
      for (int i = 0; i < C::kNTO; ++i)
        ldsm_x2(bf[i][0], bf[i][1],
                p_s + swz((nt0 + C::kWPM * i) * 8 + (lane & 7),
                          kk * 2 + ((lane >> 3) & 1), kKeyTile));
#pragma unroll
      for (int u = 0; u < C::kMTW; ++u)
#pragma unroll
        for (int i = 0; i < C::kNTO; ++i)
          mma_bf16(o[u][i], af[u], bf[i][0], bf[i][1]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();                   // the ring is free: acc goes there

  float* acc = reinterpret_cast<float*>(ring);     // rows x D
#pragma unroll
  for (int u = 0; u < C::kMTW; ++u)
#pragma unroll
    for (int i = 0; i < C::kNTO; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = (nt0 + C::kWPM * i) * 8 + 2 * tq + (e & 1);
        const int c = (mt0 + 8 * u) * 16 + gq + 8 * (e >> 1);
        if (r < rows && c < D) acc[r * D + c] = o[u][i][e];
      }
#pragma unroll
  for (int j = 0; j < NTW; ++j) {
    const int nt = warp + j * kW;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r = nt * 8 + 2 * tq + e;
      if (nt < n_nt && r < rows && gq == 0) {
        m_s[r] = m_run[j][e];
        l_s[r] = l_run[j][e];
      }
    }
  }
  __syncthreads();
  // P is free: the merge's scratch ((2 * kMergeChunk + 1) * rows floats
  // of kRowsP * 32)
  split_epilogue<__nv_bfloat16, D>(a, acc, m_s, l_s,
                                   reinterpret_cast<float*>(p_s), b, h, grp,
                                   split, n_tiles == 0, kT);
}

}  // namespace repro
