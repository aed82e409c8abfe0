// Forward GQA flash attention for Hopper (sm_90a): the prefill attention.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (pallas_call at line 111, body _kernel at lines 28-72):
// q (B, Hq, Sq, d) against k/v (B, Hkv, Skv, d), causal, bidirectional or
// sliding-window, the KV head of query head hq being hq // g.  Query and
// key positions both start at 0; keys past Skv never attend.
//
// Bound on this card: operations.  At prefill Sq == Skv and every KV tile
// is reused by every query tile, so the work grows as Sq^2 * d and the
// bytes as Sq * d: ~64 operations per byte at Sq = 512, d = 128 on the
// causal half, ~500 at Sq = 4096, past the bf16 ridge (~295).
//
// bf16 design: wgmma fed by TMA, in the model's layout.  A CTA owns one
// (b, hq) and 64 * NWG query rows: one producer warpgroup whose first
// thread loads the Q tile once and then K/V tiles (BKV rows) through a
// 2-stage ring of mbarriers, and NWG consumer warpgroups of 64 rows each.
// Per KV tile a consumer runs S = Q K^T as wgmma from shared memory (Q and
// K K-major, 128-byte swizzle), masks and runs the online softmax on the
// S fragment in registers in f32 (masked scores -1e30, row max and sum
// over the 4 lanes of a quad, exp2 with log2(e) folded into the scale),
// rounds P to bf16 in registers and feeds it as the register A operand of
// O += P V, V read N-major (its stored layout) from shared memory.  The
// loop runs from the window's first key to the causal end or Skv, as
// before, so masked-out tiles are never loaded; only tiles that cross the
// diagonal, the window edge or Skv compute the mask.  The final division
// uses max(l, 1e-30), as on the TPU.  The tensor maps read q/k/v through
// their strides (the model passes (B, S, H, d) tensors as transposed
// views) and the output is written through out's strides, so no copies
// surround the call.  Query tiles start heaviest first (the causal
// tail), and the shared-memory limit is raised once per process.
//
//   d = 64, 128: NWG = 2 (128 query rows), BKV = 128, 384 threads, and
//   setmaxnreg gives each consumer thread 240 registers and the producer's
//   24.  d = 256: NWG = 1 (64 rows, so RecurrentGemma's MQA prefill of Hq
//   10 x 512 tokens runs 80 CTAs, not 40), BKV = 64, 256 threads.  Its O
//   accumulator is 128 f32 registers a thread and the consumer needs ~160
//   live; with 256 threads a CTA the launch bounds already allow every
//   thread 255, so there is nothing for setmaxnreg to move (ptxas holds
//   the whole kernel to the launch bound, and 128 registers, which two
//   CTAs an SM would need, cannot hold the n256 product).
//   d = 240 (Gemma-3): the d = 256 configuration on 256-wide tiles whose
//   last 16 columns TMA fills with zeros (FlashCfg's note): no padded
//   copy of q, k or v is made.  d = 32 (the reduced configs the training
//   launcher runs) takes the d = 64 configuration the same way: 64-wide
//   tiles whose last 32 columns TMA fills with zeros.
//   Shared memory: 80 KB (d 32, 64), 160 KB (d 128, 240 and 256).
//
// Training: given an lse pointer, both bodies also write each query row's
// log-sum-exp, m + log(max(l, 1e-30)) in natural units as the JAX
// package's _flash_forward forms it (src/repro/models/attention.py:191-193),
// which the backward kernel (flash_attention_bwd.cu) reads to recompute P.
// Serving passes null and writes nothing more.
//
// f32 (the lossless path): the exact CUDA-core kernel, no TF32 (which
// would break token-exact equality with the greedy decode).  One CTA of
// 256 threads per (b * Hq + hq, BQ-row query tile) walks the same 64-row
// KV tiles from f32 shared-memory tiles, each thread a (BQ/16) x 4 block
// of scores and a (BQ/16) x (d/16) block of the output in registers; BQ =
// 32 at d = 240 and 256 (162 and 169 KB of shared memory), 64 otherwise.  It takes
// contiguous (B, H, S, d) tensors.  It alone also runs d = 16 (the reduced
// Mistral draft of the serving example), one output column a thread.
#include "common.cuh"
#include "flash_tma.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA

// kDT: the shared-memory tiles' width, the head dim rounded up to 64.  At
// d 240 (Gemma-3) the tiles are 256 wide: the tensor maps have the real
// width, so the TMA box of columns 192-255 reads zeros past column 240,
// S = Q K^T runs d / 16 = 15 k-steps, O += P V runs 256 wide over zero V
// columns, and the epilogue writes the first d columns.
template <int D>
struct FlashCfg {
  static constexpr int kDT = (D + 63) / 64 * 64;
  static constexpr int kNWG = kDT > 128 ? 1 : 2;     // consumer warpgroups
  static constexpr int kBQ = 64 * kNWG;
  static constexpr int kBKV = kDT > 128 ? 64 : 128;
  static constexpr int kThreads = 128 * (kNWG + 1);
  static constexpr int kDB = kDT / 64;                // 64-wide column blocks
  static constexpr int kQBytes = kNWG * kDB * 64 * 128;
  static constexpr int kKVBytes = kDB * kBKV * 128;   // one of K, V
  static constexpr int kSmem = kQBytes + 4 * kKVBytes + 1024 + 64;
  static_assert(D % 16 == 0, "whole k16 steps of Q K^T");
};

// One consumer warpgroup (w) of the kernel below: its 64 query rows
// against the KV tiles the producer brings into the ring.
template <int D>
__device__ __forceinline__ void consume(
    const uint8_t* qs, const uint8_t* k_base, const uint8_t* v_base,
    uint64_t* bar_q, uint64_t* full, uint64_t* empty, int w,
    __nv_bfloat16* __restrict__ out, int64_t out_off, int64_t oss,
    float* __restrict__ lse, int q0, int sq, int skv, int k_first,
    int n_tiles, float scale_log2, int causal, int window) {
  using C = FlashCfg<D>;
  constexpr int kBKV = C::kBKV, kDB = C::kDB, kDT = C::kDT;
  auto k_tile = [&](int s) { return k_base + 2 * s * C::kKVBytes; };
  auto v_tile = [&](int s) { return v_base + 2 * s * C::kKVBytes; };
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int row_lo = q0 + w * 64;                     // this warpgroup's rows
  const int row0 = row_lo + warp * 16 + lane / 4;     // + 8 for the second

  float o[kDT / 2];
#pragma unroll
  for (int i = 0; i < kDT / 2; ++i) o[i] = 0.f;
  float m_run[2] = {REPRO_NEG_INF, REPRO_NEG_INF}, l_run[2] = {0.f, 0.f};
  const uint64_t dq = sw128_desc(qs + w * kDB * 8192, 16, 1024);
  bar_wait(bar_q, 0);

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % 2, k0 = k_first + t * kBKV;
    bar_wait(&full[s], (t / 2) & 1);

    // S = Q K^T: K-major both, k16 step = 32 B in a row, 64-column blocks
    float sc[kBKV / 2];
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) sc[i] = 0.f;
    const uint64_t dk = sw128_desc(k_tile(s), 16, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      Wgmma<kBKV>::template ss<0, 0>(
          sc, dq + (kk / 4) * (8192 >> 4) + (kk % 4) * 2,
          dk + (kk / 4) * (kBKV * 128 >> 4) + (kk % 4) * 2);
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(sc);

    // mask (only tiles that cross the diagonal, the window edge or Skv)
    // and online softmax; accumulator i sits at row row0 + 8 * ((i / 2) % 2),
    // key k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2
    const bool whole = k0 + kBKV <= skv &&
                       (!causal || k0 + kBKV - 1 <= row_lo) &&
                       (window <= 0 || k0 > row_lo + 63 - window);
    float mx[2] = {REPRO_NEG_INF, REPRO_NEG_INF};
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) {
      float x = sc[i] * scale_log2;
      if (!whole) {
        const int kpos = k0 + 8 * (i / 4) + 2 * (lane % 4) + i % 2;
        const int qpos = row0 + 8 * ((i / 2) % 2);
        bool ok = kpos < skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window > 0) ok = ok && kpos > qpos - window;
        x = ok ? x : REPRO_NEG_INF;
      }
      sc[i] = x;
      mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], x);
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      const float m_new = fmaxf(m_run[h], mx[h]);
      corr[h] = exp2f(m_run[h] - m_new);
      m_run[h] = m_new;
      l_run[h] *= corr[h];
    }
#pragma unroll
    for (int i = 0; i < kBKV / 2; ++i) {
      const int h = (i / 2) % 2;
      sc[i] = exp2f(sc[i] - m_run[h]);
      l_run[h] += sc[i];
    }
#pragma unroll
    for (int i = 0; i < kDT / 2; ++i) o[i] *= corr[(i / 2) % 2];

    // O += P V: P rounded to bf16 as the register A operand (its fragment
    // is the S accumulator's), V N-major, 64-column blocks kBKV * 128 B apart
    const uint64_t dv = sw128_desc(v_tile(s), kBKV * 128, 1024);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBKV / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(sc[8 * kk], sc[8 * kk + 1]),
                             pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]),
                             pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]),
                             pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7])};
      Wgmma<kDT>::template rs<1>(o, a, dv + kk * (2048 >> 4));
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(o);
    bar_arrive(&empty[s]);
  }

  __nv_bfloat16* ob = out + out_off;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 1);
    l_run[h] += __shfl_xor_sync(0xffffffffu, l_run[h], 2);
    // the row's log-sum-exp, natural units (m_run is in log2 units)
    const int qpos = row0 + 8 * h;
    if (lse != nullptr && lane % 4 == 0 && qpos < sq)
      lse[qpos] = m_run[h] * 0.6931471805599453f +
                  logf(fmaxf(l_run[h], 1e-30f));
    l_run[h] = 1.f / fmaxf(l_run[h], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < kDT / 2; i += 2) {
    const int h = (i / 2) % 2;
    const int qpos = row0 + 8 * h;
    const int col = 8 * (i / 4) + 2 * (lane % 4);
    if (qpos < sq && col < D) {
      *reinterpret_cast<__nv_bfloat162*>(ob + qpos * oss + col) =
          __floats2bfloat162_rn(o[i] * l_run[h], o[i + 1] * l_run[h]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FlashCfg<D>::kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap map_q,
                           const __grid_constant__ CUtensorMap map_k,
                           const __grid_constant__ CUtensorMap map_v,
                           int q_hf, int k_hf, int v_hf,
                           __nv_bfloat16* __restrict__ out, int64_t osb,
                           int64_t osh, int64_t oss,
                           float* __restrict__ lse, int n_q_heads,
                           int n_kv_heads, int sq, int skv, float scale_log2,
                           int causal, int window) {
  using C = FlashCfg<D>;
  constexpr int kBQ = C::kBQ, kBKV = C::kBKV, kDB = C::kDB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* qs = base;                                 // [wg][db][64][64]
  uint8_t* kvs = base + C::kQBytes;                   // [stage][K, V][db][BKV][64]
  uint64_t* bars = reinterpret_cast<uint64_t*>(kvs + 4 * C::kKVBytes);
  uint64_t* bar_q = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 3;

  const int bh = blockIdx.x;
  const int b = bh / n_q_heads, hq = bh % n_q_heads;
  const int hk = hq / (n_q_heads / n_kv_heads);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest tiles first
  const int kv_end = causal ? min(skv, q0 + kBQ) : skv;
  const int kv_begin = window > 0 ? max(0, q0 - window + 1) : 0;
  const int k_first = (kv_begin / kBKV) * kBKV;
  const int n_tiles = kv_end > k_first ? (kv_end - k_first + kBKV - 1) / kBKV
                                       : 0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    bar_init(bar_q, 1);
    for (int s = 0; s < 2; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 128 * C::kNWG);
    }
    bar_init_fence();
  }
  __syncthreads();

  auto k_tile = [&](int s) { return kvs + (2 * s) * C::kKVBytes; };
  auto v_tile = [&](int s) { return kvs + (2 * s + 1) * C::kKVBytes; };

  if (wg == 0) {                                      // producer
    if constexpr (C::kNWG == 2) setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      prefetch_map(&map_q);
      prefetch_map(&map_k);
      prefetch_map(&map_v);
      bar_expect_tx(bar_q, C::kQBytes);
      for (int w = 0; w < C::kNWG; ++w)
        for (int db = 0; db < kDB; ++db)
          tma_rows(qs + (w * kDB + db) * 8192, &map_q, q_hf, bar_q, db * 64,
                    q0 + w * 64, hq, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % 2, k0 = k_first + t * kBKV;
        bar_wait(&empty[s], ((t / 2) & 1) ^ 1);
        bar_expect_tx(&full[s], 2 * C::kKVBytes);
        for (int db = 0; db < kDB; ++db) {
          tma_rows(k_tile(s) + db * kBKV * 128, &map_k, k_hf, &full[s],
                    db * 64, k0, hk, b);
          tma_rows(v_tile(s) + db * kBKV * 128, &map_v, v_hf, &full[s],
                    db * 64, k0, hk, b);
        }
      }
    }
  } else {                                            // consumers
    if constexpr (C::kNWG == 2) setmaxnreg_inc<240>();
    consume<D>(qs, k_tile(0), v_tile(0), bar_q, full, empty, wg - 1, out,
               b * osb + hq * osh, oss,
               lse == nullptr ? nullptr : lse + static_cast<int64_t>(bh) * sq,
               q0, sq, skv, k_first, n_tiles, scale_log2, causal, window);
  }
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                float* lse, const int64_t* st, int batch, int hq, int hkv, int sq,
                int skv, float scale, int causal, int window,
                cudaStream_t stream) {
  using C = FlashCfg<D>;
  // st: q, k, v, out strides (b, h, s) in elements
  QKVMap mq, mk, mv;
  if (!make_qkv_map(&mq, q, batch, hq, sq, D, st[0], st[1], st[2], 64) ||
      !make_qkv_map(&mk, k, batch, hkv, skv, D, st[3], st[4], st[5],
                    C::kBKV) ||
      !make_qkv_map(&mv, v, batch, hkv, skv, D, st[6], st[7], st[8],
                    C::kBKV))
    return static_cast<int>(cudaErrorInvalidValue);
  static unsigned smem_set = 0;
  auto kern = flash_fwd_wgmma_kernel<D>;
  cudaError_t err = set_smem_once(kern, C::kSmem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch * hq, (sq + C::kBQ - 1) / C::kBQ);
  kern<<<grid, C::kThreads, C::kSmem, stream>>>(
      mq.map, mk.map, mv.map, mq.heads_first, mk.heads_first, mv.heads_first,
      static_cast<__nv_bfloat16*>(out), st[9], st[10], st[11], lse, hq, hkv,
      sq, skv, scale * 1.4426950408889634f, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: the exact CUDA-core kernel

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
    T* __restrict__ out, float* __restrict__ lse, int n_q_heads,
    int n_kv_heads, int sq, int skv, float scale, int causal, int window) {
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
    if (lse != nullptr && tx == 0)
      lse[static_cast<size_t>(bh) * sq + qpos] =
          m_i[i] + logf(fmaxf(l_i[i], 1e-30f));
    const float inv = 1.f / fmaxf(l_i[i], 1e-30f);
    T* o = out + (static_cast<size_t>(bh) * sq + qpos) * D;
#pragma unroll
    for (int c = 0; c < NC; ++c) o[tx + 16 * c] = from_f<T>(acc[i][c] * inv);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out,
               float* lse, int batch, int hq, int hkv, int sq, int skv, float scale,
               int causal, int window, cudaStream_t stream) {
  using T = float;
  const size_t smem = smem_floats<D>() * sizeof(float);
  static unsigned smem_set = 0;
  auto kern = flash_fwd_kernel<T, D>;
  cudaError_t err = set_smem_once(kern, static_cast<int>(smem), &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int kBQ = query_tile<D>();
  const dim3 grid(batch * hq, (sq + kBQ - 1) / kBQ);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, hq, hkv, sq, skv,
      scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/k/v/out (B, H, S, d).  f32: contiguous; bf16: any strides with a
// contiguous last dim, given in `strides` as (b, h, s) element strides of
// q, k, v and out, each a multiple of 8 with 16-byte-aligned bases.
// window <= 0 means no sliding window.  lse, when not null, receives each
// query row's log-sum-exp (B, Hq, Sq) f32 (contiguous) for the backward.
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, void* lse, const int64_t* strides,
                               int batch,
                               int hq, int hkv, int sq, int skv, int d,
                               float scale, int causal, int window, int dtype,
                               void* stream) {
  using namespace repro;
  if (hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_FLASH_D(D)                                                     \
  case D:                                                                    \
    return dtype == kF32                                                     \
               ? launch_f32<D>(q, k, v, out, lse_f, batch, hq, hkv, sq, skv, \
                               scale, causal, window, st)                    \
               : launch_bf16<D>(q, k, v, out, lse_f, strides, batch, hq, hkv,\
                                sq, skv, scale, causal, window, st);
  if (dtype != kF32 && dtype != kBF16)
    return static_cast<int>(cudaErrorInvalidValue);
  float* lse_f = static_cast<float*>(lse);
  switch (d) {
    case 16:                       // the exact kernel only (NC = 1)
      return dtype == kF32
                 ? launch_f32<16>(q, k, v, out, lse_f, batch, hq, hkv, sq,
                                  skv, scale, causal, window, st)
                 : static_cast<int>(cudaErrorInvalidValue);
    REPRO_FLASH_D(32) REPRO_FLASH_D(64) REPRO_FLASH_D(128) REPRO_FLASH_D(240)
    REPRO_FLASH_D(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_FLASH_D
}
