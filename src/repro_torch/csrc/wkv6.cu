// RWKV-6 WKV recurrence for Hopper (sm_90a): a serial kernel for verify
// and decode, a chunked one for prefill.
//
// Replaces the TPU kernel src/repro/kernels/wkv6.py::wkv6 (pallas_call at
// line 57, body _kernel at lines 22-40): per (sequence, head), with the
// (hd, hd) f32 state S,
//   y_t = r_t (S + diag(u) k_t v_t^T),   S <- diag(w_t) S + k_t v_t^T,
// over r/k/v/w (B, H, S, hd) f32, u (H, hd), s0 (B, H, hd, hd).  Returns y
// and the final S.  Speculative verify also needs every per-step state
// for rollback (src/repro/models/rwkv.py:131-144), which the TPU kernel
// does not return; here an optional output (B, S + 1, H, hd, hd) f32
// receives the state before the first step and after every step, the
// same tensor the JAX package's plain verify path builds.
//
// Bound on this card: bytes, narrowly.  A step reads r, k, v, w and
// writes y (5 hd-vectors, 1.25 KiB per head at hd = 64) and does ~6 hd^2
// f32 operations: ~19 per byte, just under the ~20 the H100 needs in f32
// outside the tensor cores to be compute-bound.  With the state stack a
// step also writes hd^2 f32 per head — 1 MiB per (sequence, step) at
// RWKV-6-7B's 64 heads of 64 — and verify is bound by those bytes.
//
// Serial kernel (verify: S <= 16, with or without the stack): one CTA per
// (b, h) with hd threads.  Thread j owns column j of S, hd f32 in
// registers for the whole sequence, so the state never touches memory
// between steps (the TPU keeps it in VMEM scratch).  Per step r_t, k_t,
// w_t are staged in shared memory (double-buffered, one barrier a step),
// thread j holds v_j, and computes
//   y_j = sum_i r_i (S_ij + u_i k_i v_j),  S_ij <- w_i S_ij + k_i v_j.
// Its per-step arithmetic is that of the S = 1 decode, so a verify
// rounds as the greedy decode does.  Stack rows are written with column
// j in thread j, so every store of a row is coalesced.
//
// Chunked kernel (prefill: S > 16, no stack).  Serially a step is a
// 64-long dependent FMA chain behind a barrier and a load: 512 steps cost
// 30x the bytes bound.  Instead time is cut into chunks of
// kChunk = 16 steps.  Within a chunk starting from state S0, with
//   P_t = prod_{tau<t} w_tau,  Q_s = prod_{tau>s} w_tau,
//   D_ts = prod_{s<tau<t} w_tau   (all per channel i, inside the chunk),
//   A_ts = sum_i r_ti D_tsi k_si  (s < t),   A_tt = sum_i r_ti u_i k_ti,
//   y_t = (r_t * P_t) S0 + sum_{s<=t} A_ts v_s,
//   S   <- diag(prod_t w_t) S0 + sum_s (k_s * Q_s) v_s^T.
// Every decay factor is a product of w's in [0, 1], formed by running
// multiplication (D through 4-step sub-chunks, see produce) and never by
// dividing two cumulative products or subtracting two cumulative logs:
// those overflow once the summed log decay passes ~88 (12 steps at
// w_log = 2 already) and give -inf - -inf = NaN at w == 0.  Here w == 0
// gives exact zeros (S <- k v^T) and w near 1 a rounding a product.
// Columns of S are independent (column j needs only v_j), so a CTA owns
// a slab of its (b, h)'s columns: 32 (at batch 1, 64 heads of 64 make
// 128 CTAs on 132 SMs) or, with enough heads to fill the card twice, the
// whole head of 64, which forms the chunk's A once instead of per slab.
// In a CTA, producer warps form what does not depend on the state (A,
// r_t P_t, k_s Q_s, the chunk's decay) one chunk ahead of the consumer
// warps, which hold the slab of S in registers and run the two products
// per chunk on the tensor cores in 3xTF32 (about f32's accuracy), the
// state carried as a compensated pair.  TMA copies each chunk's r, k, w
// and v two chunks ahead (three stages); a ragged last chunk loads as
// zeros and its w is set to 1, which leaves the state as it is.
//
// Inputs are read through (batch, head, step) strides with a contiguous
// last dimension, so the model passes its (B, S, H, hd) projections as a
// transposed view without a copy.
#include "common.cuh"
#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace {

using repro::Frag;
using repro::FragB;
using repro::halve;
using repro::mma_3xtf32;

template <int HD>
__global__ void __launch_bounds__(HD) wkv6_kernel(
    const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ w,
    const float* __restrict__ u, const float* __restrict__ s0,
    float* __restrict__ y, float* __restrict__ s_out,
    float* __restrict__ stack, int n_heads, int seq, long long sb,
    long long sh, long long ss) {
  const int bh = blockIdx.x, b = bh / n_heads, h = bh % n_heads;
  const int j = threadIdx.x;
  constexpr size_t kState = static_cast<size_t>(HD) * HD;
  __shared__ float rs[2][HD], ks[2][HD], ws[2][HD], us[HD];

  float S[HD];
  const float* s0p = s0 + bh * kState;
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = s0p[i * HD + j];
  us[j] = u[h * HD + j];
  // stack[b, t, h] is the state after t steps
  auto stack_row = [&](int t) {
    return stack + ((static_cast<size_t>(b) * (seq + 1) + t) * n_heads + h)
                       * kState;
  };
  if (stack != nullptr) {
    float* dst = stack_row(0);
#pragma unroll
    for (int i = 0; i < HD; ++i) dst[i * HD + j] = S[i];
  }

  const size_t in0 = static_cast<size_t>(b) * sb + static_cast<size_t>(h) * sh;
  float* yp = y + static_cast<size_t>(bh) * seq * HD;
  for (int t = 0; t < seq; ++t) {
    const int buf = t & 1;
    const size_t off = in0 + static_cast<size_t>(t) * ss + j;
    rs[buf][j] = r[off];
    ks[buf][j] = k[off];
    ws[buf][j] = w[off];
    const float vj = v[off];
    __syncthreads();   // also orders step t-1's reads of this buffer's twin
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float kv = ks[buf][i] * vj;
      acc = fmaf(rs[buf][i], fmaf(us[i], kv, S[i]), acc);
      S[i] = fmaf(ws[buf][i], S[i], kv);
    }
    yp[static_cast<size_t>(t) * HD + j] = acc;
    if (stack != nullptr) {
      float* dst = stack_row(t + 1);
#pragma unroll
      for (int i = 0; i < HD; ++i) dst[i * HD + j] = S[i];
    }
  }
  if (s_out != nullptr) {
    float* dst = s_out + bh * kState;
#pragma unroll
    for (int i = 0; i < HD; ++i) dst[i * HD + j] = S[i];
  }
}

template <int HD>
int launch(const void* r, const void* k, const void* v, const void* w,
           const void* u, const void* s0, void* y, void* s_out, void* stack,
           int batch, int n_heads, int seq, long long sb, long long sh,
           long long ss, cudaStream_t stream) {
  wkv6_kernel<HD><<<batch * n_heads, HD, 0, stream>>>(
      static_cast<const float*>(r), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(w),
      static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out),
      static_cast<float*>(stack), n_heads, seq, sb, sh, ss);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Chunked prefill kernel (see the note at the top).

constexpr int kChunk = 16;                    // steps a chunk
constexpr int kStages = 3;                    // chunks in flight
constexpr int kSub = 4;                       // steps a sub-chunk
constexpr int kSubs = kChunk / kSub;
constexpr int kRowPad = 8;                    // rp/kq rows: no bank conflicts
constexpr int kAPad = 4;                      // A rows likewise

// A CTA's shape: head size, columns of S it owns (the slab), producer
// warps.  Consumer warps: one per (32 rows of S, 16 columns of the slab).
// Producer warp w owns rows w and kChunk - 1 - w of A when there are
// kChunk / 2 of them, row w when there are kChunk; lane = channel group.
template <int HD_, int SLAB_, int PW_>
struct Cfg {
  static constexpr int HD = HD_, SLAB = SLAB_;
  static constexpr int kProducers = 32 * PW_;
  static constexpr int kRowsPerWarp = kChunk / PW_;
  static constexpr int kIg = HD / 32;              // channels of a lane
  static constexpr int kRowBlocks = HD / 32, kColBlocks = SLAB / 16;
  static constexpr int kConsumers = 32 * kRowBlocks * kColBlocks;
  static constexpr int kThreads = kProducers + kConsumers;
  static_assert(kRowsPerWarp == 1 || kRowsPerWarp == 2, "producer warps");
  static_assert(HD % 32 == 0 && SLAB % 16 == 0 && HD % SLAB == 0, "shape");
  static_assert(HD <= kProducers, "u and the chains");
};

template <class C>
struct ChunkSmem {
  float rkw[kStages][3][kChunk][C::HD];   // r, k, w of a chunk
  float v[kStages][kChunk][C::SLAB];      // v of the slab's columns
  float rp[2][kChunk][C::HD + kRowPad];   // r_t * P_t, by chunk parity
  float kq[2][kChunk][C::HD + kRowPad];   // k_s * Q_s
  float tot[2][C::HD];                    // prod over the chunk of w
  float amat[2][kChunk][kChunk + kAPad];  // A_ts
  float u[C::HD];
  float kqs[kChunk][C::HD];               // k_s * prod_{s<tau in sub-chunk} w
  float subt[kSubs][C::HD];               // prod over a sub-chunk of w
  float yred[C::kRowBlocks][C::kColBlocks][8][32];   // y shares by rows
  uint64_t full[kStages];                 // a stage's copies have landed
};

// r, k, w and v as (hd, H, S, B) tensor maps (innermost first): one copy
// brings a chunk's kChunk rows of one head, hd wide (the slab for v).
struct ChunkMaps {
  CUtensorMap r, k, w, v;
};

template <int N>
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(N));
}

// One thread starts the four copies of chunk ``t0`` into ``stage``; they
// complete on the stage's mbarrier.  Rows past the end load as zeros
// (produce sets their w to 1).
template <class C>
__device__ __forceinline__ void load_chunk(ChunkSmem<C>& sm,
                                           const ChunkMaps& maps, int stage,
                                           int b, int h, int t0, int seq,
                                           int j0) {
  if (t0 >= seq) return;
  uint64_t* bar = &sm.full[stage];
  repro::bar_expect_tx(bar, kChunk * (3 * C::HD + C::SLAB) * sizeof(float));
  repro::tma_load_4d(sm.rkw[stage][0], &maps.r, bar, 0, h, t0, b);
  repro::tma_load_4d(sm.rkw[stage][1], &maps.k, bar, 0, h, t0, b);
  repro::tma_load_4d(sm.rkw[stage][2], &maps.w, bar, 0, h, t0, b);
  repro::tma_load_4d(sm.v[stage], &maps.v, bar, j0, h, t0, b);
}

// S <- tot * S + d with S carried as hi + lo.  A channel that barely
// decays (w = 1 - 1e-7) sums a whole prompt into S, and one rounding of
// S a chunk then drifts it over a long prompt (the serial f32
// recurrence, one rounding a step, drifts further; chip_smoke.py prints
// by how much).  The product's error (an FMA) and the sum's (TwoSum) go
// into lo, so the carried state stays within a rounding of the exact
// one; y reads hi alone.  The intrinsics keep the compiler from fusing
// what must round separately.
__device__ __forceinline__ void carry_state(float tot, float d, float& hi,
                                            float& lo) {
  const float p = __fmul_rn(tot, hi);
  const float pe = fmaf(tot, hi, -p);              // tot * hi - p, exactly
  const float s = __fadd_rn(p, d);
  const float bv = __fsub_rn(s, p);
  const float e = __fadd_rn(__fsub_rn(p, __fsub_rn(s, bv)), __fsub_rn(d, bv));
  const float l = fmaf(tot, lo, __fadd_rn(e, pe));
  hi = __fadd_rn(s, l);
  lo = __fsub_rn(l, __fsub_rn(hi, s));
}

// What does not depend on the state, for the chunk in ``stage`` (its
// first ``n`` rows real), into buffer ``set``.  The decay between steps
// s < t factors, with no division and every factor in [0, 1], through
// the sub-chunks of kSub steps that hold them (a < b):
//   D_ts = Q'_s (prod_{a < j < b} T_j) P'_t,
// Q'_s the product over the rest of s's sub-chunk, P'_t over t's
// sub-chunk before t, T_j a whole sub-chunk's.  So:
//  1. per (sub-chunk, channel): k_s Q'_s and T_j (chains of kSub);
//  2. for its row t, a producer lane owns channel group g.  It walks s
//     down through t's own sub-chunk with D_ts as a running product (at
//     most kSub - 1 steps), which leaves r_t P'_t; that times T_j for
//     each sub-chunk it passes gives A_ts = sum_i (r_t P'_t prod T)_i
//     (k_s Q'_s)_i for the earlier ones, independent sums, and ends at
//     r_t P_t.  The row also writes k_t Q_t = k_t Q'_t prod_{j > b} T_j,
//     and row 0 the chunk's decay;
//  3. A's row t is summed over the warp's lanes with shuffles.
template <class C, class Load>
__device__ __forceinline__ void produce(ChunkSmem<C>& sm, int stage,
                                        int set, int n, int p,
                                        const Load& load_next) {
  constexpr int HD = C::HD, kIg = C::kIg;
  float(*ww)[HD] = sm.rkw[stage][2];
  for (int e = n * HD + p; e < kChunk * HD; e += C::kProducers)
    ww[e / HD][e % HD] = 1.f;      // pad steps leave the state as it is
  if (n < kChunk) named_sync<C::kProducers>(2);
  const float(*rr)[HD] = sm.rkw[stage][0];
  const float(*kk)[HD] = sm.rkw[stage][1];
  for (int e = p; e < kSubs * HD; e += C::kProducers) {
    const int j = e / HD, i = e % HD;
    float q = 1.f;
#pragma unroll
    for (int d = kSub - 1; d >= 0; --d) {
      const int s = kSub * j + d;
      sm.kqs[s][i] = kk[s][i] * q;
      q *= ww[s][i];
    }
    sm.subt[j][i] = q;
  }
  named_sync<C::kProducers>(2);
  // row 0 has the least to do: its thread 0 starts the copies of a
  // later chunk there, off the other producers' path
  if (p == 0) load_next();
  const int g = p % 32, c0 = g * kIg;
  float tj[kSubs][kIg];            // T_j of this lane's channels
#pragma unroll
  for (int j = 0; j < kSubs; ++j) {
#pragma unroll
    for (int ii = 0; ii < kIg; ++ii) tj[j][ii] = sm.subt[j][c0 + ii];
  }
#pragma unroll
  for (int half = 0; half < C::kRowsPerWarp; ++half) {
    const int t = half == 0 ? p / 32 : kChunk - 1 - p / 32;
    const int sb = t / kSub;
    float rt[kIg], dd[kIg], pa[kChunk];   // pa[s]: A_ts over the group
    float diag = 0.f;
#pragma unroll
    for (int ii = 0; ii < kIg; ++ii) {
      rt[ii] = rr[t][c0 + ii];
      dd[ii] = 1.f;
      diag = fmaf(rt[ii] * sm.u[c0 + ii], kk[t][c0 + ii], diag);
    }
#pragma unroll
    for (int s = 0; s < kChunk; ++s) pa[s] = s == t ? diag : 0.f;
#pragma unroll
    for (int s = kChunk - 2; s >= 0; --s) {   // t's own sub-chunk, downwards
      if (s < t && s >= kSub * sb) {   // dd = D_ts = prod_{s<tau<t} w_tau
#pragma unroll
        for (int ii = 0; ii < kIg; ++ii) {
          pa[s] = fmaf(rt[ii] * dd[ii], kk[s][c0 + ii], pa[s]);
          dd[ii] *= ww[s][c0 + ii];
        }
      }
    }
#pragma unroll
    for (int ii = 0; ii < kIg; ++ii) rt[ii] *= dd[ii];      // r_t P'_t
#pragma unroll
    for (int a = kSubs - 2; a >= 0; --a) {
      if (a < sb) {
#pragma unroll
        for (int d = kSub - 1; d >= 0; --d) {
          const int s = kSub * a + d;
#pragma unroll
          for (int ii = 0; ii < kIg; ++ii)
            pa[s] = fmaf(rt[ii], sm.kqs[s][c0 + ii], pa[s]);
        }
#pragma unroll
        for (int ii = 0; ii < kIg; ++ii) rt[ii] *= tj[a][ii];
      }
    }
    float later[kIg];              // prod_{j > sb} T_j
#pragma unroll
    for (int ii = 0; ii < kIg; ++ii) later[ii] = 1.f;
#pragma unroll
    for (int j = kSubs - 1; j > 0; --j) {
      if (j > sb) {
#pragma unroll
        for (int ii = 0; ii < kIg; ++ii) later[ii] *= tj[j][ii];
      }
    }
#pragma unroll
    for (int ii = 0; ii < kIg; ++ii) {
      sm.rp[set][t][c0 + ii] = rt[ii];
      sm.kq[set][t][c0 + ii] = sm.kqs[t][c0 + ii] * later[ii];
      if (t == 0) sm.tot[set][c0 + ii] = later[ii] * tj[0][ii];
    }
    // A_ts = the sum of pa[s] over the warp's lanes: halve the values a
    // lane holds at each of four exchanges (offsets 16, 8, 4, 2), then
    // add the pair at offset 1; lanes 2 s and 2 s + 1 end with s.  A
    // fixed order, so the same bits every call.
    halve<8>(pa, 16, g);
    halve<4>(pa, 8, g);
    halve<2>(pa, 4, g);
    halve<1>(pa, 2, g);
    pa[0] += __shfl_xor_sync(0xffffffffu, pa[0], 1);
    if (g % 2 == 0) sm.amat[set][t][g / 2] = pa[0];
  }
}

// One CTA: columns [j0, j0 + SLAB) of S for one (b, h), every chunk in
// order.  Warp-specialized: while the consumer warps use chunk c, the
// producer warps form A, r_t * P_t, k_s * Q_s and the decay of chunk
// c + 1 (produce), during which one producer thread starts the copies of
// chunk c + 2, so one barrier a chunk hands both over.
//
// The consumers' products run on the tensor cores as 3xTF32 mma.sync
// (m16n8k8, about f32's accuracy; on the CUDA cores each of their FMAs
// waited on a shared-memory broadcast, and shared memory, not
// arithmetic, set the pace).  Consumer warp (rb, cb) keeps the block of
// S of rows [32 rb, 32 rb + 32) and slab columns [16 cb, 16 cb + 16) in
// registers, laid out as the accumulator of
//   dS^T (j x i) = V^T (j x s) (k_s Q_s) (s x i),
// so the state update adds into it in place (carry_state), and read as
// the B operand of
//   Y (t x j) += (r_t P_t) (t x i) S (i x j)
// with the sum's index i permuted (k-slot t4 <-> i = 2 t4, t4 + 4 <->
// 2 t4 + 1 within each 8) so both layouts hold the same elements.  The
// row blocks' shares of Y meet in shared memory in a fixed order; the
// warps of row block 0 add A V (t x j) and store y.
template <class C>
__global__ void __launch_bounds__(C::kThreads) wkv6_chunked_kernel(
    const __grid_constant__ ChunkMaps maps, const float* __restrict__ u,
    const float* __restrict__ s0, float* __restrict__ y,
    float* __restrict__ s_out, int n_heads, int seq) {
  constexpr int HD = C::HD, SLAB = C::SLAB;
  constexpr int kSlabs = HD / SLAB, kConsumers = C::kConsumers;
  constexpr int kRowBlocks = C::kRowBlocks, kColBlocks = C::kColBlocks;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  ChunkSmem<C>& sm = *reinterpret_cast<ChunkSmem<C>*>(smem_raw);

  const int slab = blockIdx.x % kSlabs, bh = blockIdx.x / kSlabs;
  const int b = bh / n_heads, h = bh % n_heads;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool producer = tid >= kConsumers;
  const int p = tid - kConsumers;
  const int j0 = slab * SLAB;
  constexpr size_t kState = static_cast<size_t>(HD) * HD;
  const int n_chunks = (seq + kChunk - 1) / kChunk;
  const auto rows = [&](int c) { return min(kChunk, seq - c * kChunk); };

  // consumer warp (rb, cb); lane (g, t4) holds S[r0 + 8 ks + 2 t4 + (e & 1)]
  // [c0 + g + 8 (e >> 1)] as st[ks][e] + sl[ks][e]
  const int cb = warp % kColBlocks, rb = warp / kColBlocks;
  const int g = lane / 4, t4 = lane % 4;
  const int r0 = 32 * rb, c0 = 16 * cb;
  const auto row = [&](int ks, int e) { return r0 + 8 * ks + 2 * t4 + (e & 1); };
  const auto col = [&](int e) { return c0 + g + 8 * (e >> 1); };
  float st[4][4], sl[4][4];
  if (producer) {
    for (int i = p; i < HD; i += C::kProducers) sm.u[i] = u[h * HD + i];
    if (p == 0) {
      for (const CUtensorMap* m : {&maps.r, &maps.k, &maps.w, &maps.v})
        repro::prefetch_map(m);
      for (int q = 0; q < kStages; ++q) repro::bar_init(&sm.full[q], 1);
      repro::bar_init_fence();
      load_chunk<C>(sm, maps, 0, b, h, 0, seq, j0);
      load_chunk<C>(sm, maps, 1, b, h, kChunk, seq, j0);
    }
    named_sync<C::kProducers>(2);   // u and the barriers
    repro::bar_wait(&sm.full[0], 0);
    produce<C>(sm, 0, 0, rows(0), p, [] {});
  } else {
    const float* s0p = s0 + bh * kState + j0;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        st[ks][e] = s0p[row(ks, e) * HD + col(e)];
        sl[ks][e] = 0.f;
      }
    }
  }
  __syncthreads();
  float* yp = y + static_cast<size_t>(bh) * seq * HD + j0 + c0 + 2 * t4;

  for (int c = 0; c < n_chunks; ++c) {
    const int stage = c % kStages, set = c & 1, t0 = c * kChunk;
    if (producer) {
      if (c + 1 < n_chunks) {      // chunk c + 1 has landed
        repro::bar_wait(&sm.full[(c + 1) % kStages], ((c + 1) / kStages) & 1);
        // chunk c + 2 goes to the stage of chunk c - 1, read before the
        // barrier above
        produce<C>(sm, (c + 1) % kStages, set ^ 1, rows(c + 1), p, [&] {
          load_chunk<C>(sm, maps, (c + 2) % kStages, b, h, t0 + 2 * kChunk,
                        seq, j0);
        });
      }
    } else {
      repro::bar_wait(&sm.full[stage], (c / kStages) & 1);
      const float(*rp)[HD + kRowPad] = sm.rp[set];
      const float(*kq)[HD + kRowPad] = sm.kq[set];
      const float(*vv)[SLAB] = sm.v[stage];        // zero on pad steps
      // Y over this row block: (r_t P_t)[t][i] S[i][j], in two halves of
      // the sum (independent chains of mma)
      float yacc[2][4] = {}, yacc2[2][4] = {};
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const int i = r0 + 8 * ks + 2 * t4;
        const float2 x0 = *reinterpret_cast<const float2*>(&rp[g][i]);
        const float2 x1 = *reinterpret_cast<const float2*>(&rp[g + 8][i]);
        Frag fa;
        fa.set(x0.x, x1.x, x0.y, x1.y);
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
          FragB fb;
          fb.set(st[ks][2 * nj], st[ks][2 * nj + 1]);
          mma_3xtf32(ks % 2 ? yacc2[nj] : yacc[nj], fa, fb);
        }
      }
      // dS^T[j][i] = sum_s v[s][j] (k_s Q_s)[s][i]
      float ds[4][4] = {};
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int s = 8 * kk + t4;
        Frag fa;
        fa.set(vv[s][c0 + g], vv[s][c0 + g + 8], vv[s + 4][c0 + g],
               vv[s + 4][c0 + g + 8]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          FragB fb;
          fb.set(kq[s][r0 + 8 * nt + g], kq[s + 4][r0 + 8 * nt + g]);
          mma_3xtf32(ds[nt], fa, fb);
        }
      }
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          carry_state(sm.tot[set][row(ks, e)], ds[ks][e], st[ks][e],
                      sl[ks][e]);
      }
      if (rb == 0) {   // + A V: A[t][s] v[s][j]
        const float(*am)[kChunk + kAPad] = sm.amat[set];
#pragma unroll
        for (int kk = 0; kk < 2; ++kk) {
          const int s = 8 * kk + t4;
          Frag fa;
          fa.set(am[g][s], am[g + 8][s], am[g][s + 4], am[g + 8][s + 4]);
#pragma unroll
          for (int nj = 0; nj < 2; ++nj) {
            FragB fb;
            fb.set(vv[s][c0 + 8 * nj + g], vv[s + 4][c0 + 8 * nj + g]);
            mma_3xtf32(yacc2[nj], fa, fb);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) yacc[e / 4][e % 4] += yacc2[e / 4][e % 4];
      if (rb != 0) {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          sm.yred[rb][cb][e][lane] = yacc[e / 4][e % 4];
      }
      if constexpr (kRowBlocks > 1) named_sync<kConsumers>(1);
      if (rb == 0) {
#pragma unroll
        for (int q = 1; q < kRowBlocks; ++q) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            yacc[e / 4][e % 4] += sm.yred[q][cb][e][lane];
        }
        // yacc[nj]: (t = g, j = c0 + 8 nj + 2 t4 .. +1), then t = g + 8
#pragma unroll
        for (int nj = 0; nj < 2; ++nj) {
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const int t = t0 + g + 8 * hh;
            if (t < seq)
              *reinterpret_cast<float2*>(yp + static_cast<size_t>(t) * HD
                                         + 8 * nj) =
                  make_float2(yacc[nj][2 * hh], yacc[nj][2 * hh + 1]);
          }
        }
      }
    }
    __syncthreads();
  }
  if (!producer && s_out != nullptr) {
    float* dst = s_out + bh * kState + j0;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dst[row(ks, e) * HD + col(e)] = st[ks][e] + sl[ks][e];
    }
  }
}

template <class C>
int launch_chunked(const void* r, const void* k, const void* v,
                   const void* w, const void* u, const void* s0, void* y,
                   void* s_out, int batch, int n_heads, int seq, long long sb,
                   long long sh, long long ss, cudaStream_t stream) {
  // (hd, H, S, B), innermost first; the stride of an axis of one element
  // addresses nothing, so any multiple of 16 bytes will do for it
  const uint64_t dims[4] = {static_cast<uint64_t>(C::HD),
                            static_cast<uint64_t>(n_heads),
                            static_cast<uint64_t>(seq),
                            static_cast<uint64_t>(batch)};
  const auto bytes = [](long long st, int n) {
    return n > 1 ? static_cast<uint64_t>(st) * 4 : 16ull;
  };
  const uint64_t strides[3] = {bytes(sh, n_heads), bytes(ss, seq),
                               bytes(sb, batch)};
  const uint32_t box[4] = {C::HD, 1, kChunk, 1};
  const uint32_t vbox[4] = {C::SLAB, 1, kChunk, 1};
  const auto f32_map = [&](CUtensorMap* map, const void* base,
                           const uint32_t* b) {
    return repro::make_map(map, base, 4, dims, strides, b,
                           CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
  };
  ChunkMaps maps;
  if (!f32_map(&maps.r, r, box) || !f32_map(&maps.k, k, box) ||
      !f32_map(&maps.w, w, box) || !f32_map(&maps.v, v, vbox))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(ChunkSmem<C>);
  auto kern = wkv6_chunked_kernel<C>;
  static unsigned smem_set = 0;
  cudaError_t err = repro::set_smem_once(kern, static_cast<int>(smem),
                                         &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<batch * n_heads * (C::HD / C::SLAB), C::kThreads, smem, stream>>>(
      maps, static_cast<const float*>(u), static_cast<const float*>(s0),
      static_cast<float*>(y), static_cast<float*>(s_out), n_heads, seq);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r/k/v/w share the element strides (sb, sh, ss) of their (batch, head,
// step) axes; u, s0, y, s_out and stack are contiguous.  s_out or stack
// may be null.
extern "C" int wkv6(const void* r, const void* k, const void* v,
                    const void* w, const void* u, const void* s0, void* y,
                    void* s_out, void* stack, int batch, int n_heads, int seq,
                    int hd, long long sb, long long sh, long long ss,
                    void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:        // the training launcher's reduced config, any length
      return launch<32>(r, k, v, w, u, s0, y, s_out, stack, batch, n_heads,
                        seq, sb, sh, ss, st);
    case 64:
      return launch<64>(r, k, v, w, u, s0, y, s_out, stack, batch, n_heads,
                        seq, sb, sh, ss, st);
    case 128:
      return launch<128>(r, k, v, w, u, s0, y, s_out, stack, batch, n_heads,
                         seq, sb, sh, ss, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The chunked prefill route: the same arguments without the stack, and
// the columns of S a CTA owns (``slab``: 32, or 64 = a whole head at head
// size 64, which forms A once per head, not once per slab; the wrapper
// picks it from shapes).  r, k, v and w must be 16-byte aligned with
// strides that are multiples of 4 elements (the wrapper checks; the
// tensor maps need both).
extern "C" int wkv6_chunked(const void* r, const void* k, const void* v,
                            const void* w, const void* u, const void* s0,
                            void* y, void* s_out, int batch, int n_heads,
                            int seq, int hd, int slab, long long sb,
                            long long sh, long long ss, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if (batch <= 0 || n_heads <= 0 || seq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd == 64 && slab == 64)
    return launch_chunked<Cfg<64, 64, 8>>(r, k, v, w, u, s0, y, s_out, batch,
                                          n_heads, seq, sb, sh, ss, st);
  if (hd == 64 && slab == 32)
    return launch_chunked<Cfg<64, 32, 16>>(r, k, v, w, u, s0, y, s_out,
                                           batch, n_heads, seq, sb, sh, ss,
                                           st);
  if (hd == 128 && slab == 32)
    return launch_chunked<Cfg<128, 32, 8>>(r, k, v, w, u, s0, y, s_out,
                                           batch, n_heads, seq, sb, sh, ss,
                                           st);
  return static_cast<int>(cudaErrorInvalidValue);
}
