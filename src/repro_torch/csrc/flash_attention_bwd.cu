// Backward GQA flash attention for Hopper (sm_90a): the training gradient
// of the prefill attention.
//
// Replaces the JAX package's hand-written custom VJP of its flash
// attention, src/repro/models/attention.py::_flash_bwd_rule (line 231; no
// pallas_call: the TPU runs it as plain jnp over KV chunks).  Given the
// forward's q/out/dout (B, Hq, Sq, d), k/v (B, Hkv, Skv, d) and the
// log-sum-exp lse (B, Hq, Sq) f32 that flash_attention.cu writes, it
// recomputes P = exp(S - lse) tile by tile and forms
//   D  = rowsum(dout * out)              (out cast to f32, as in JAX)
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D) scale,
//   dQ = dS K,    dK = dS^T Q,
// dK and dV summed over the g query heads of each KV head, under the
// forward's masks (causal, sliding window, bidirectional; Sq != Skv; keys
// and queries past the lengths masked; query row i at position q_offset +
// i, a rank's block of the queries under context parallelism) and head
// dims (32, 64, 128, 240, 256).  It never materialises an (Sq, Skv) matrix.
//
// Bound on this card: operations.  Five products of 2 * Sq * Skv_live * d
// per (b, q head) against q, k, v, o, dO, lse read once and dq, dk, dv
// written once: at Gemma-3's S 4096, d 240 the causal half does ~1000
// operations a byte, far past the bf16 ridge (~295).
//
// Deterministic, no atomics: dK / dV of a KV tile are summed over the g
// query heads inside one CTA, and dQ comes from a kernel of its own, so
// the bits never depend on the order in which CTAs finish (the training
// step's bitwise-equal-twice check relies on it).  The price is that the
// dQ kernel recomputes S and dP: 7 products where the bound counts 5, so
// this design's own floor is 1.4x the bound.  (f32 atomics on a dQ
// accumulator would save the two products and lose the determinism.)
//
// bf16 design: wgmma fed by TMA, warp-specialised, as the forward.
// Three launches on the caller's stream:
// 1. rows: one warp a query row, D = rowsum(dO * O) in f32, written with
//    lse * log2(e) into a packed workspace, [b, h][64-row chunk][lse, D]
//    (chunks padded to 128 rows, zeros past Sq), so that one bulk copy of
//    512 bytes brings a Q tile's 64 pairs.
// 2. dK / dV: one CTA per (b, KV head, KV tile), low key tiles first
//    (under a causal mask they walk the most query tiles).  A producer
//    warpgroup, one thread of which issues TMA loads: K and V once, then
//    (Q, dO, rows) tiles of 64 queries, for each of the g heads every
//    tile the masks leave live, through a ring of full / empty mbarriers
//    (2-4 stages).  Two consumer warpgroups; setmaxnreg moves registers
//    from the producer (24) to them (240).  Every product is a wgmma:
//    S^T = K Q^T and dP^T = V dO^T with both operands K-major as stored
//    (ss), dV += P^T dO and dK += dS^T Q with dO and Q read MN-major.
//    d <= 128: 128 key rows, a warpgroup per 64 keys; P^T and dS^T go
//      from the S^T / dP^T accumulators straight into the register A
//      operand of dV / dK (rs), as the forward's P V: no shared memory
//      round trip.  A consumer thread holds dK + dV (128 f32 at d 128)
//      and S^T + dP^T (64).
//    d 240 / 256: 64 key rows.  The warpgroups split S^T / dP^T by query
//      columns (32 each), write P^T and dS^T in bf16 to shared memory
//      (16 KB, 128-byte swizzle), meet at a named barrier, and each
//      accumulates half of the 256 head-dim columns of both dV and dK
//      from shared memory (ss); a consumer thread holds 128 + 32 f32.
//      K + V 64 KB, a 2-stage ring 130 KB.
// 3. dQ: one CTA per (b, q head, 128 query rows), high query tiles first
//    (the causal tail), the same producer and two consumer warpgroups of
//    64 query rows.  Q, dO and the rows are loaded once; K / V tiles of
//    the live range come through the ring.  S = Q K^T and dP = dO V^T
//    (ss), dS from the accumulators into the A registers of dQ += dS K
//    (rs, K read MN-major).  d <= 128: 128-row KV tiles, a consumer
//    thread holds dQ + S + dP = 192 f32 at d 128; d 240 / 256: 32-row KV
//    tiles in a 3-stage ring (Q, dO 128 KB + ring 96 KB), 128 + 32 f32:
//    two warpgroups on one K / V tile halve the L2 traffic a product
//    that one warpgroup on 64-row tiles needed.
// Tiles the causal or window mask empties are never loaded; a warpgroup
// skips a tile that holds no visible pair of its own; only tiles that
// cross the diagonal, the window edge or the lengths run the per-element
// mask, in a copy of the P / dS code of their own (the whole tiles' copy
// has no mask at all).  exp2 (ex2.approx, one MUFU instruction) with
// log2(e) folded into the scale and the lse.  Head dims 240 and 32 run on
// tiles 256 and 64 wide whose columns past d TMA fills with zeros, as in
// the forward: no padded copy.
//
// What keeps ptxas from serialising the wgmmas or injecting warpgroup
// fences and waits between them (its C7520 / C7519 / C7517 notes, which
// chip_smoke.py phase 1 requires absent from this source's report): every
// branch around wgmma code tests a value made warp-uniform by a shuffle
// (warp_uniform), the first k16 step of S / dP overwrites its accumulator
// (scale-d 0) instead of a zeroing the compiler would schedule between
// the fence and the wgmma, and the A fragments are complete before the
// fence.
//
// f32 (exact, CUDA cores, no TF32): the same three launches with 32 x 32
// tiles in f32 shared memory (rows padded to d + 1 floats), each thread 4
// scores of a tile and 4 x ceil(d / 32) accumulators; expf as in JAX; the
// row sums D in a plain (B, Hq, Sq) layout.
//
// Inputs and outputs are read and written through (b, h, s) element
// strides with a contiguous last dim (the model hands over (B, S, H, d)
// tensors as transposed views); bf16 needs strides that are multiples of
// 8 elements and 16-byte-aligned bases (the wrapper checks both).
#include <type_traits>

#include "common.cuh"
#include "flash_tma.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int kT = 256;            // threads of the rows and f32 kernels
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                // (B, Hq, Sq) contiguous
  float* delta;                    // written by 1.: f32 (B, Hq, Sq); bf16
                                   // the packed rows (row_chunks)
  void* dq;
  void* dk;
  void* dv;
  int64_t st[8][3];                // (b, h, s) strides: q k v o dout dq dk dv
  int hq, hkv, sq, skv;
  float scale;
  int causal, window;
  int qoff;                        // query row i sits at position qoff + i
};

enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV };

__device__ __forceinline__ int64_t row_off(const BwdArgs& a, int t, int b,
                                           int h, int s) {
  return b * a.st[t][0] + h * a.st[t][1] + s * a.st[t][2];
}

__device__ __forceinline__ bool visible(const BwdArgs& a, int i, int j) {
  bool ok = i < a.sq && j < a.skv;
  if (a.causal) ok = ok && j <= i + a.qoff;
  if (a.window > 0) ok = ok && j > i + a.qoff - a.window;
  return ok;
}

// the live query rows [lo, hi) of keys [k0, k0 + rows)
__device__ __forceinline__ void q_range(const BwdArgs& a, int k0, int rows,
                                        int* lo, int* hi) {
  *lo = a.causal ? max(0, k0 - a.qoff) : 0;
  *hi = a.window > 0 ? min(a.sq, k0 + rows - 1 + a.window - a.qoff) : a.sq;
}

// the live keys [lo, hi) of query rows [q0, q0 + rows)
__device__ __forceinline__ void kv_range(const BwdArgs& a, int q0, int rows,
                                         int* lo, int* hi) {
  *lo = a.window > 0 ? max(0, q0 + a.qoff - a.window + 1) : 0;
  *hi = a.causal ? min(a.skv, q0 + a.qoff + rows) : a.skv;
}

// every (query, key) pair of the tile visible: no per-element mask
__device__ __forceinline__ bool whole_tile(const BwdArgs& a, int q0, int nq,
                                           int k0, int nk) {
  return q0 + nq <= a.sq && k0 + nk <= a.skv &&
         (!a.causal || k0 + nk - 1 <= q0 + a.qoff) &&
         (a.window <= 0 || k0 > q0 + a.qoff + nq - 1 - a.window);
}

// some (query, key) pair of the tile may be visible (false: none is)
__device__ __forceinline__ bool live_tile(const BwdArgs& a, int q0, int nq,
                                          int k0, int nk) {
  return q0 < a.sq && k0 < a.skv &&
         (!a.causal || k0 <= q0 + a.qoff + nq - 1) &&
         (a.window <= 0 || q0 + a.qoff < k0 + nk - 1 + a.window);
}

// 64-row chunks of a head's packed rows (lse * log2 e, D): Sq rounded up
// to 128, so that the dQ kernel's 128-row tiles read whole chunks
__host__ __device__ __forceinline__ int row_chunks(int sq) {
  return 2 * ((sq + 127) / 128);
}

// ---------------------------------------------------------------------------
// 1. D = rowsum(dO * O), one warp a row.  f32: delta[b, h, i].  bf16: the
// packed rows, lse * log2 e beside D, every slot of every chunk written
// (zeros past Sq).

template <typename T, int D>
__global__ void __launch_bounds__(kT) bwd_delta_kernel(BwdArgs a, int rows) {
  constexpr bool kPacked = sizeof(T) == 2;
  const int row = blockIdx.x * (kT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int per = kPacked ? row_chunks(a.sq) * 64 : a.sq;
  const int bh = row / per, i = row % per;
  const int b = bh / a.hq, h = bh % a.hq;
  float s = 0.f;
  if (i < a.sq) {
    const T* o = static_cast<const T*>(a.o) + row_off(a, kO, b, h, i);
    const T* d = static_cast<const T*>(a.dout) + row_off(a, kDO, b, h, i);
    for (int c = lane; c < D; c += 32) s += to_f(d[c]) * to_f(o[c]);
  }
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) s += __shfl_xor_sync(0xffffffffu, s, x);
  if (lane != 0) return;
  if constexpr (kPacked) {
    float* r = a.delta + (static_cast<int64_t>(bh) * (per / 64) + i / 64) * 128 +
               i % 64;
    r[0] = i < a.sq ? a.lse[static_cast<int64_t>(bh) * a.sq + i] * kLog2e
                    : 0.f;
    r[64] = s;
  } else {
    a.delta[row] = s;
  }
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA

template <int D>
struct WgCfg {
  static constexpr int kDT = (D + 63) / 64 * 64;      // tile width
  static constexpr int kDB = kDT / 64;                // 64-wide column blocks
  static constexpr bool kWide = kDT > 128;            // d 240 / 256
  static constexpr int kBKV = kWide ? 64 : 128;       // keys: a dK/dV CTA
  static constexpr int kBKVQ = kWide ? 32 : 128;      // keys: a dQ ring tile
  static constexpr int kThreads = 384;                // producer + 2 consumers
  static constexpr int kQTile = 64 * kDT * 2;         // bytes: 64 rows of Q or dO
  static constexpr int kKVTile = kBKV * kDT * 2;      // bytes: K or V
  static constexpr int kKVTileQ = kBKVQ * kDT * 2;    // the same in the dQ ring
  static constexpr int kRows = 512;                   // a chunk of packed rows
  static constexpr int kAvail = 232448 - 1024 - 256;  // less alignment, barriers
  // dK / dV: K, V, (wide) P^T and dS^T, a ring of (Q, dO, rows)
  static constexpr int kPS = kWide ? 2 * 64 * 64 * 2 : 0;
  static constexpr int kStageKV = 2 * kQTile + 1024;
  static constexpr int kFitKV = (kAvail - 2 * kKVTile - kPS) / kStageKV;
  static constexpr int kStagesKV = kFitKV > 4 ? 4 : kFitKV;
  static constexpr int kSmemKV =
      2 * kKVTile + kPS + kStagesKV * kStageKV + 1024 + 256;
  // dQ: Q, dO and rows of its 128 queries, a ring of (K, V)
  static constexpr int kFixedQ = 2 * 2 * kQTile + 1024;
  static constexpr int kFitQ = (kAvail - kFixedQ) / (2 * kKVTileQ);
  static constexpr int kStagesQ = kFitQ > 4 ? 4 : kFitQ;
  static constexpr int kSmemQ = kFixedQ + kStagesQ * 2 * kKVTileQ + 1024 + 256;
  static_assert(D % 16 == 0, "whole k16 steps");
  static_assert(kStagesKV >= 2 && kStagesQ >= 2, "two stages fit");
};

struct Maps {
  CUtensorMap q, k, v, dout;       // boxes of 64 (q, dout) / kBKV (k, v) rows
  CUtensorMap kq, vq;              // k, v in boxes of kBKVQ rows
  int q_hf, k_hf, v_hf, do_hf;     // heads_first of each
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

// k16 step kk of a K-major operand tile of `rows` rows: 32 bytes along
// the swizzled row, 64-wide column blocks rows * 128 bytes apart
__device__ __forceinline__ uint64_t kstep(uint64_t desc, int kk, int rows) {
  return desc + (kk / 4) * (rows * 128 >> 4) + (kk % 4) * 2;
}

// Thread's share of a warpgroup's 64 x (2 NA) f32 accumulator, rows
// row0 + warp * 16 + lane / 4 (+ 8), columns col0 + 8 (i / 4) + 2 (lane %
// 4) (+ 1), rounded to bf16 into rows < limit and columns < D of tensor
// t, head h.
template <int D, int NA>
__device__ __forceinline__ void store_acc(const BwdArgs& a, void* dst, int t,
                                          int b, int h, int row0, int limit,
                                          int col0, const float (&acc)[NA]) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  __nv_bfloat16* base = static_cast<__nv_bfloat16*>(dst);
#pragma unroll
  for (int i = 0; i < NA; i += 2) {
    const int r = row0 + warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
    const int c = col0 + 8 * (i / 4) + 2 * (lane % 4);
    if (r < limit && c < D)
      *reinterpret_cast<__nv_bfloat162*>(base + row_off(a, t, b, h, r) + c) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// 2^x, one MUFU instruction (relative error ~2^-22; P is rounded to bf16
// before its products anyway)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// b as the compiler can see it: the same in every lane of the warp (a
// warpgroup's tile tests are; wgmma code in a branch the compiler takes for
// divergent gets serialised)
__device__ __forceinline__ bool warp_uniform(bool b) {
  return __shfl_sync(0xffffffffu, static_cast<int>(b), 0) != 0;
}

// P and dS of a thread's accumulator pair (i, i + 1) at query positions
// (qi, qi + di) x key positions (kj, kj + dj); lse2 / dl are the rows'
// lse * log2 e and D.  kMask: the tile crosses a mask edge, and masked
// pairs give 0.
template <bool kMask>
__device__ __forceinline__ void p_ds(const BwdArgs& a, float sl2,
                                     const float* s, const float* dp,
                                     int qi, int di, int kj, int dj,
                                     const float* lse2, const float* dl,
                                     uint32_t* p_out, uint32_t* ds_out) {
  float p[2], ds[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    p[e] = ex2(s[e] * sl2 - lse2[e]);
    if (kMask && !visible(a, qi + e * di, kj + e * dj)) p[e] = 0.f;
    ds[e] = p[e] * (dp[e] - dl[e]) * a.scale;
  }
  *p_out = pack_bf16(p[0], p[1]);
  *ds_out = pack_bf16(ds[0], ds[1]);
}

// f(std::false_type) on tiles every pair of which is visible, else
// f(std::true_type): the per-element mask compiled out of whole tiles
template <typename F>
__device__ __forceinline__ void masked_or_whole(bool whole, F&& f) {
  if (warp_uniform(whole))
    f(std::false_type{});
  else
    f(std::true_type{});
}

// 2. dK / dV.  Consumers of d <= 128: warpgroup w owns keys k0 + 64 w ...
// + 63; per live Q tile S^T, dP^T (64 x 64) from shared memory, then P^T,
// dS^T in registers as the A operand of dV / dK (64 x kDT).
template <int D>
__device__ __forceinline__ void dkdv_narrow(
    const BwdArgs& a, const uint8_t* ks, const uint8_t* vs,
    const uint8_t* ring, uint64_t* bar_kv, uint64_t* full, uint64_t* empty,
    int b, int hk, int k0, int t_lo, int n_qt, int n_it) {
  using C = WgCfg<D>;
  constexpr int kDT = C::kDT, kBKV = C::kBKV, kS = C::kStagesKV;
  const int w = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int kw0 = k0 + 64 * w;
  const int krow = kw0 + warp * 16 + lane / 4;          // + 8: odd pairs
  const float sl2 = a.scale * kLog2e;
  float dk[kDT / 2], dv[kDT / 2];
  zero(dk);
  zero(dv);
  const uint64_t ka = sw128_desc(ks + w * 64 * 128, 16, 1024);
  const uint64_t va = sw128_desc(vs + w * 64 * 128, 16, 1024);
  if (n_it > 0) bar_wait(bar_kv, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % kS;
    const int q0 = (t_lo + it % n_qt) * 64;
    const uint8_t* qs = ring + s * C::kStageKV;
    const uint8_t* dos = qs + C::kQTile;
    const float* lse2 = reinterpret_cast<const float*>(dos + C::kQTile);
    const float* dl = lse2 + 64;
    bar_wait(&full[s], (it / kS) & 1);
    if (warp_uniform(live_tile(a, q0, 64, kw0, 64))) {
      float st[32], dpt[32];                 // the first k16 step sets them
      const uint64_t bq = sw128_desc(qs, 16, 1024);
      const uint64_t bdo = sw128_desc(dos, 16, 1024);
      wgmma_fence();
      Wgmma<64>::template ss<0, 0, 0>(st, ka, bq);
      Wgmma<64>::template ss<0, 0, 0>(dpt, va, bdo);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        Wgmma<64>::template ss<0, 0>(st, kstep(ka, kk, kBKV), kstep(bq, kk, 64));
        Wgmma<64>::template ss<0, 0>(dpt, kstep(va, kk, kBKV),
                                     kstep(bdo, kk, 64));
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(st);
      reg_fence(dpt);

      // accumulator i: key krow + 8 ((i / 2) % 2), query q0 + c + i % 2
      uint32_t pa[4][4], da[4][4];     // A fragments of the 4 k16 steps
      masked_or_whole(whole_tile(a, q0, 64, kw0, 64), [&](auto mask) {
#pragma unroll
        for (int i = 0; i < 32; i += 2) {
          const int c = 8 * (i / 4) + 2 * (lane % 4);
          p_ds<decltype(mask)::value>(
              a, sl2, st + i, dpt + i, q0 + c, 1, krow + 8 * ((i / 2) % 2), 0,
              lse2 + c, dl + c, &pa[i / 8][(i / 2) % 4],
              &da[i / 8][(i / 2) % 4]);
        }
      });

      // dV += P^T dO, dK += dS^T Q: dO and Q MN-major as stored, 64-wide
      // column blocks 8 KB apart, a k16 step 16 rows
      const uint64_t mdo = sw128_desc(dos, 64 * 128, 1024);
      const uint64_t mq = sw128_desc(qs, 64 * 128, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Wgmma<kDT>::template rs<1>(dv, pa[kk], mdo + kk * (2048 >> 4));
        Wgmma<kDT>::template rs<1>(dk, da[kk], mq + kk * (2048 >> 4));
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dv);
      reg_fence(dk);
    }
    bar_arrive(&empty[s]);
  }
  store_acc<D>(a, a.dv, kDV, b, hk, kw0, a.skv, 0, dv);
  store_acc<D>(a, a.dk, kDK, b, hk, kw0, a.skv, 0, dk);
}

// Consumers of d 240 / 256: 64 keys; warpgroup w computes S^T, dP^T for
// queries 32 w ... + 31 of the tile, both write P^T, dS^T to shared memory,
// and w accumulates head-dim columns 128 w ... + 127 of dV and dK.
template <int D>
__device__ __forceinline__ void dkdv_wide(
    const BwdArgs& a, const uint8_t* ks, const uint8_t* vs, uint8_t* ps,
    const uint8_t* ring, uint64_t* bar_kv, uint64_t* full, uint64_t* empty,
    int b, int hk, int k0, int t_lo, int n_qt, int n_it) {
  using C = WgCfg<D>;
  constexpr int kS = C::kStagesKV;
  const int w = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int kl = warp * 16 + lane / 4;                  // key row in the tile
  const float sl2 = a.scale * kLog2e;
  uint8_t* pts = ps;                                    // P^T [64 keys][64 q]
  uint8_t* dsts = ps + 64 * 128;                        // dS^T
  float dk[64], dv[64];
  zero(dk);
  zero(dv);
  const uint64_t ka = sw128_desc(ks, 16, 1024);
  const uint64_t va = sw128_desc(vs, 16, 1024);
  if (n_it > 0) bar_wait(bar_kv, 0);

  for (int it = 0; it < n_it; ++it) {
    const int s = it % kS;
    const int q0 = (t_lo + it % n_qt) * 64;
    const uint8_t* qs = ring + s * C::kStageKV;
    const uint8_t* dos = qs + C::kQTile;
    const float* lse2 = reinterpret_cast<const float*>(dos + C::kQTile);
    const float* dl = lse2 + 64;
    bar_wait(&full[s], (it / kS) & 1);
    if (warp_uniform(live_tile(a, q0, 64, k0, 64))) {   // both warpgroups alike
      float st[16], dpt[16];                 // the first k16 step sets them
      // B: rows 32 w ... of each 64-row column block (8 KB apart)
      const uint64_t bq = sw128_desc(qs + w * 32 * 128, 16, 1024);
      const uint64_t bdo = sw128_desc(dos + w * 32 * 128, 16, 1024);
      wgmma_fence();
      Wgmma<32>::template ss<0, 0, 0>(st, ka, bq);
      Wgmma<32>::template ss<0, 0, 0>(dpt, va, bdo);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        Wgmma<32>::template ss<0, 0>(st, kstep(ka, kk, 64), kstep(bq, kk, 64));
        Wgmma<32>::template ss<0, 0>(dpt, kstep(va, kk, 64), kstep(bdo, kk, 64));
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(st);
      reg_fence(dpt);

      uint32_t pa[8], da[8];
      masked_or_whole(whole_tile(a, q0, 64, k0, 64), [&](auto mask) {
#pragma unroll
        for (int i = 0; i < 16; i += 2) {
          const int c = 32 * w + 8 * (i / 4) + 2 * (lane % 4);
          p_ds<decltype(mask)::value>(
              a, sl2, st + i, dpt + i, q0 + c, 1, k0 + kl + 8 * ((i / 2) % 2),
              0, lse2 + c, dl + c, &pa[i / 2], &da[i / 2]);
        }
      });
      named_bar_sync(1, 256);        // the last tile's P^T, dS^T read by both
#pragma unroll
      for (int i = 0; i < 16; i += 2) {
        const int r = kl + 8 * ((i / 2) % 2);
        const int c = 32 * w + 8 * (i / 4) + 2 * (lane % 4);
        const int off = r * 128 + ((((c >> 3) ^ (r & 7)) << 4) | ((c & 7) << 1));
        *reinterpret_cast<uint32_t*>(pts + off) = pa[i / 2];
        *reinterpret_cast<uint32_t*>(dsts + off) = da[i / 2];
      }
      fence_proxy_async();
      named_bar_sync(1, 256);        // both halves written

      // dV[:, 128 w ...] += P^T dO[:, 128 w ...], dK likewise with dS^T, Q:
      // A K-major from shared memory, B MN-major column blocks 2 w, 2 w + 1
      const uint64_t pa_d = sw128_desc(pts, 16, 1024);
      const uint64_t da_d = sw128_desc(dsts, 16, 1024);
      const uint64_t mdo = sw128_desc(dos + 2 * w * 64 * 128, 64 * 128, 1024);
      const uint64_t mq = sw128_desc(qs + 2 * w * 64 * 128, 64 * 128, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        Wgmma<128>::template ss<0, 1>(dv, pa_d + 2 * kk, mdo + kk * (2048 >> 4));
        Wgmma<128>::template ss<0, 1>(dk, da_d + 2 * kk, mq + kk * (2048 >> 4));
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dv);
      reg_fence(dk);
    }
    bar_arrive(&empty[s]);
  }
  store_acc<D>(a, a.dv, kDV, b, hk, k0, a.skv, 128 * w, dv);
  store_acc<D>(a, a.dk, kDK, b, hk, k0, a.skv, 128 * w, dk);
}

template <int D>
__global__ void __launch_bounds__(WgCfg<D>::kThreads, 1)
    bwd_dkdv_wgmma_kernel(const __grid_constant__ Maps m,
                          const __grid_constant__ BwdArgs a) {
  using C = WgCfg<D>;
  constexpr int kBKV = C::kBKV, kS = C::kStagesKV;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ks = align1024(smem_raw);
  uint8_t* vs = ks + C::kKVTile;
  uint8_t* ps = vs + C::kKVTile;                 // wide: P^T, dS^T
  uint8_t* ring = ps + C::kPS;                   // [stage][Q, dO, rows]
  uint64_t* bar_kv = reinterpret_cast<uint64_t*>(ring + kS * C::kStageKV);
  uint64_t* full = bar_kv + 1;
  uint64_t* empty = full + kS;

  const int b = blockIdx.x / a.hkv, hk = blockIdx.x % a.hkv;
  const int g = a.hq / a.hkv;
  const int k0 = blockIdx.y * kBKV;              // low key tiles first
  int q_lo, q_hi;
  q_range(a, k0, kBKV, &q_lo, &q_hi);
  const int t_lo = q_lo / 64;
  const int n_qt = q_hi > q_lo ? (q_hi + 63) / 64 - t_lo : 0;
  const int n_it = g * n_qt;

  if (threadIdx.x == 0) {
    bar_init(bar_kv, 1);
    for (int s = 0; s < kS; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 256);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {                       // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_it > 0) {
      prefetch_map(&m.q);
      prefetch_map(&m.k);
      prefetch_map(&m.v);
      prefetch_map(&m.dout);
      bar_expect_tx(bar_kv, 2 * C::kKVTile);
      for (int db = 0; db < C::kDB; ++db) {
        tma_rows(ks + db * kBKV * 128, &m.k, m.k_hf, bar_kv, db * 64, k0, hk, b);
        tma_rows(vs + db * kBKV * 128, &m.v, m.v_hf, bar_kv, db * 64, k0, hk, b);
      }
      const int chunks = row_chunks(a.sq);
      for (int it = 0; it < n_it; ++it) {
        const int s = it % kS;
        const int h = hk * g + it / n_qt, t = t_lo + it % n_qt;
        uint8_t* st = ring + s * C::kStageKV;
        bar_wait(&empty[s], ((it / kS) & 1) ^ 1);
        bar_expect_tx(&full[s], 2 * C::kQTile + C::kRows);
        for (int db = 0; db < C::kDB; ++db) {
          tma_rows(st + db * 64 * 128, &m.q, m.q_hf, &full[s], db * 64, t * 64,
                   h, b);
          tma_rows(st + C::kQTile + db * 64 * 128, &m.dout, m.do_hf, &full[s],
                   db * 64, t * 64, h, b);
        }
        bulk_load(st + 2 * C::kQTile,
                  a.delta + (static_cast<int64_t>(b * a.hq + h) * chunks + t) * 128,
                  C::kRows, &full[s]);
      }
    }
  } else {                                       // consumers
    setmaxnreg_inc<240>();
    if constexpr (C::kWide)
      dkdv_wide<D>(a, ks, vs, ps, ring, bar_kv, full, empty, b, hk, k0, t_lo,
                   n_qt, n_it);
    else
      dkdv_narrow<D>(a, ks, vs, ring, bar_kv, full, empty, b, hk, k0, t_lo,
                     n_qt, n_it);
  }
}

// Consumer warpgroup w (0, 1) of the dQ kernel: query rows q0 + 64 w ...
// + 63 against the K / V tiles of the ring.
template <int D>
__device__ __forceinline__ void dq_consume(
    const BwdArgs& a, const uint8_t* qs, const uint8_t* dos,
    const uint8_t* rows, const uint8_t* ring, uint64_t* bar_q,
    uint64_t* full, uint64_t* empty, int b, int h, int q0, int k_first,
    int n_tiles) {
  using C = WgCfg<D>;
  constexpr int kDT = C::kDT, kBKV = C::kBKVQ, kS = C::kStagesQ;
  const int w = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  const int qw0 = q0 + 64 * w;
  const int ql = warp * 16 + lane / 4;                  // + 8: odd pairs
  const float sl2 = a.scale * kLog2e;
  float dq[kDT / 2];
  zero(dq);
  const uint64_t aq = sw128_desc(qs + w * C::kQTile, 16, 1024);
  const uint64_t ado = sw128_desc(dos + w * C::kQTile, 16, 1024);
  float lse2[2], dl[2];
  if (n_tiles > 0) {
    bar_wait(bar_q, 0);
    const float* rw = reinterpret_cast<const float*>(rows + w * C::kRows);
    for (int hh = 0; hh < 2; ++hh) {
      lse2[hh] = rw[ql + 8 * hh];
      dl[hh] = rw[64 + ql + 8 * hh];
    }
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kS, k0 = k_first + t * kBKV;
    const uint8_t* kt = ring + s * 2 * C::kKVTileQ;
    const uint8_t* vt = kt + C::kKVTileQ;
    bar_wait(&full[s], (t / kS) & 1);
    if (warp_uniform(live_tile(a, qw0, 64, k0, kBKV))) {
      float sc[kBKV / 2], dp[kBKV / 2];      // the first k16 step sets them
      const uint64_t bk = sw128_desc(kt, 16, 1024);
      const uint64_t bv = sw128_desc(vt, 16, 1024);
      wgmma_fence();
      Wgmma<kBKV>::template ss<0, 0, 0>(sc, aq, bk);
      Wgmma<kBKV>::template ss<0, 0, 0>(dp, ado, bv);
#pragma unroll
      for (int kk = 1; kk < D / 16; ++kk) {
        Wgmma<kBKV>::template ss<0, 0>(sc, kstep(aq, kk, 64), kstep(bk, kk, kBKV));
        Wgmma<kBKV>::template ss<0, 0>(dp, kstep(ado, kk, 64),
                                       kstep(bv, kk, kBKV));
      }
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(sc);
      reg_fence(dp);

      // accumulator i: query qw0 + ql + 8 ((i / 2) % 2), key k0 + c + i % 2
      uint32_t pa, da[kBKV / 16][4];   // dS: A fragments of the k16 steps
      masked_or_whole(whole_tile(a, qw0, 64, k0, kBKV), [&](auto mask) {
#pragma unroll
        for (int i = 0; i < kBKV / 2; i += 2) {
          const int hh = (i / 2) % 2;
          const int c = 8 * (i / 4) + 2 * (lane % 4);
          const float l2[2] = {lse2[hh], lse2[hh]}, d2[2] = {dl[hh], dl[hh]};
          p_ds<decltype(mask)::value>(a, sl2, sc + i, dp + i,
                                      qw0 + ql + 8 * hh, 0, k0 + c, 1, l2, d2,
                                      &pa, &da[i / 8][(i / 2) % 4]);
        }
      });

      // dQ += dS K: K MN-major as stored, 64-wide column blocks kBKV * 128
      // bytes apart, a k16 step 16 rows
      const uint64_t mk = sw128_desc(kt, kBKV * 128, 1024);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBKV / 16; ++kk)
        Wgmma<kDT>::template rs<1>(dq, da[kk], mk + kk * (2048 >> 4));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(dq);
    }
    bar_arrive(&empty[s]);
  }
  store_acc<D>(a, a.dq, kDQ, b, h, qw0, a.sq, 0, dq);
}

// 3. dQ: 128 query rows a CTA, consumer warpgroup w owns rows q0 + 64 w
// ... + 63; kBKVQ-row K / V tiles (128 at d <= 128, 32 at d 240 / 256) come
// through the ring.
template <int D>
__global__ void __launch_bounds__(WgCfg<D>::kThreads, 1)
    bwd_dq_wgmma_kernel(const __grid_constant__ Maps m,
                        const __grid_constant__ BwdArgs a) {
  using C = WgCfg<D>;
  constexpr int kBKV = C::kBKVQ, kS = C::kStagesQ;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* qs = align1024(smem_raw);             // [w][64][kDT]
  uint8_t* dos = qs + 2 * C::kQTile;
  uint8_t* rows = dos + 2 * C::kQTile;           // [w][lse, D] (1 KB)
  uint8_t* ring = rows + 1024;                   // [stage][K, V]
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(ring + kS * 2 * C::kKVTileQ);
  uint64_t* full = bar_q + 1;
  uint64_t* empty = full + kS;

  const int bh = blockIdx.x, b = bh / a.hq, h = bh % a.hq;
  const int hk = h / (a.hq / a.hkv);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * 128;  // causal tail first
  int kv_lo, kv_hi;
  kv_range(a, q0, 128, &kv_lo, &kv_hi);
  const int k_first = (kv_lo / kBKV) * kBKV;
  const int n_tiles =
      kv_hi > k_first ? (kv_hi - k_first + kBKV - 1) / kBKV : 0;

  if (threadIdx.x == 0) {
    bar_init(bar_q, 1);
    for (int s = 0; s < kS; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 256);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x < 128) {                       // producer
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0 && n_tiles > 0) {
      prefetch_map(&m.q);
      prefetch_map(&m.kq);
      prefetch_map(&m.vq);
      prefetch_map(&m.dout);
      bar_expect_tx(bar_q, 2 * (2 * C::kQTile + C::kRows));
      const int chunks = row_chunks(a.sq);
      for (int w = 0; w < 2; ++w) {
        const int r0 = q0 + 64 * w;
        for (int db = 0; db < C::kDB; ++db) {
          tma_rows(qs + w * C::kQTile + db * 64 * 128, &m.q, m.q_hf, bar_q,
                   db * 64, r0, h, b);
          tma_rows(dos + w * C::kQTile + db * 64 * 128, &m.dout, m.do_hf,
                   bar_q, db * 64, r0, h, b);
        }
        bulk_load(rows + w * C::kRows,
                  a.delta + (static_cast<int64_t>(bh) * chunks + r0 / 64) * 128,
                  C::kRows, bar_q);
      }
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kS, k0 = k_first + t * kBKV;
        uint8_t* kt = ring + s * 2 * C::kKVTileQ;
        bar_wait(&empty[s], ((t / kS) & 1) ^ 1);
        bar_expect_tx(&full[s], 2 * C::kKVTileQ);
        for (int db = 0; db < C::kDB; ++db) {
          tma_rows(kt + db * kBKV * 128, &m.kq, m.k_hf, &full[s], db * 64, k0,
                   hk, b);
          tma_rows(kt + C::kKVTileQ + db * kBKV * 128, &m.vq, m.v_hf, &full[s],
                   db * 64, k0, hk, b);
        }
      }
    }
  } else {                                       // consumers
    setmaxnreg_inc<240>();
    dq_consume<D>(a, qs, dos, rows, ring, bar_q, full, empty, b, h, q0,
                  k_first, n_tiles);
  }
}

template <int D>
int launch_wgmma(const BwdArgs& a, int batch, cudaStream_t st) {
  using C = WgCfg<D>;
  Maps m;
  QKVMap mq, mk, mv, mdo, mkq, mvq;
  if (!make_qkv_map(&mq, a.q, batch, a.hq, a.sq, D, a.st[kQ][0], a.st[kQ][1],
                    a.st[kQ][2], 64) ||
      !make_qkv_map(&mdo, a.dout, batch, a.hq, a.sq, D, a.st[kDO][0],
                    a.st[kDO][1], a.st[kDO][2], 64) ||
      !make_qkv_map(&mk, a.k, batch, a.hkv, a.skv, D, a.st[kK][0],
                    a.st[kK][1], a.st[kK][2], C::kBKV) ||
      !make_qkv_map(&mv, a.v, batch, a.hkv, a.skv, D, a.st[kV][0],
                    a.st[kV][1], a.st[kV][2], C::kBKV) ||
      !make_qkv_map(&mkq, a.k, batch, a.hkv, a.skv, D, a.st[kK][0],
                    a.st[kK][1], a.st[kK][2], C::kBKVQ) ||
      !make_qkv_map(&mvq, a.v, batch, a.hkv, a.skv, D, a.st[kV][0],
                    a.st[kV][1], a.st[kV][2], C::kBKVQ))
    return static_cast<int>(cudaErrorInvalidValue);
  m.q = mq.map; m.k = mk.map; m.v = mv.map; m.dout = mdo.map;
  m.kq = mkq.map; m.vq = mvq.map;
  m.q_hf = mq.heads_first; m.k_hf = mk.heads_first;
  m.v_hf = mv.heads_first; m.do_hf = mdo.heads_first;
  static unsigned set_kv = 0, set_q = 0;
  cudaError_t err = set_smem_once(bwd_dkdv_wgmma_kernel<D>, C::kSmemKV,
                                  &set_kv);
  if (err == cudaSuccess)
    err = set_smem_once(bwd_dq_wgmma_kernel<D>, C::kSmemQ, &set_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows = batch * a.hq * row_chunks(a.sq) * 64;
  const int per = kT / 32;
  bwd_delta_kernel<__nv_bfloat16, D><<<(rows + per - 1) / per, kT, 0, st>>>(
      a, rows);
  bwd_dkdv_wgmma_kernel<D><<<dim3(batch * a.hkv,
                                  (a.skv + C::kBKV - 1) / C::kBKV),
                             C::kThreads, C::kSmemKV, st>>>(m, a);
  bwd_dq_wgmma_kernel<D><<<dim3(batch * a.hq, (a.sq + 127) / 128),
                           C::kThreads, C::kSmemQ, st>>>(m, a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// f32: exact, CUDA cores

constexpr int kFT = 32;            // query rows and key rows a tile

template <int D>
__host__ __device__ constexpr int f32_smem_floats() {
  return 4 * kFT * (D + 1) + 2 * kFT * (kFT + 1) + 2 * kFT;
}

// rows [r0, r0 + kFT) of tensor t into a kFT x (D + 1) f32 tile (zeros
// past limit)
template <int D>
__device__ __forceinline__ void load_f32(float* dst, const BwdArgs& a,
                                         const void* src, int t, int b, int h,
                                         int r0, int limit) {
  const float* base = static_cast<const float*>(src);
  for (int i = threadIdx.x; i < kFT * D; i += kT) {
    const int r = i / D, c = i % D;
    dst[r * (D + 1) + c] =
        r0 + r < limit ? base[row_off(a, t, b, h, r0 + r) + c] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kT) bwd_dkdv_f32_kernel(BwdArgs a) {
  constexpr int NC = (D + 31) / 32;           // output columns a thread
  const int b = blockIdx.y / a.hkv, hk = blockIdx.y % a.hkv;
  const int g = a.hq / a.hkv;
  const int k0 = blockIdx.x * kFT;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;   // 32 x 8

  extern __shared__ float fsm[];
  float* ks = fsm;
  float* vs = ks + kFT * (D + 1);
  float* qs = vs + kFT * (D + 1);
  float* dos = qs + kFT * (D + 1);
  float* pt = dos + kFT * (D + 1);            // P^T [key][query]
  float* dst = pt + kFT * (kFT + 1);          // dS^T
  float* lse_s = dst + kFT * (kFT + 1);
  float* dl_s = lse_s + kFT;

  int q_lo, q_hi;
  q_range(a, k0, kFT, &q_lo, &q_hi);
  const int t_lo = q_lo / kFT;
  const int n_qt = q_hi > q_lo ? (q_hi + kFT - 1) / kFT - t_lo : 0;

  float dk[4][NC], dv[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk[i][c] = dv[i][c] = 0.f;
  if (n_qt > 0) {
    load_f32<D>(ks, a, a.k, kK, b, hk, k0, a.skv);
    load_f32<D>(vs, a, a.v, kV, b, hk, k0, a.skv);
  }
  for (int it = 0; it < g * n_qt; ++it) {
    const int h = hk * g + it / n_qt, q0 = (t_lo + it % n_qt) * kFT;
    __syncthreads();                  // the previous tile fully used
    load_f32<D>(qs, a, a.q, kQ, b, h, q0, a.sq);
    load_f32<D>(dos, a, a.dout, kDO, b, h, q0, a.sq);
    if (threadIdx.x < kFT) {
      const int i = q0 + threadIdx.x;
      const int64_t r = static_cast<int64_t>(b * a.hq + h) * a.sq + i;
      lse_s[threadIdx.x] = i < a.sq ? a.lse[r] : 0.f;
      dl_s[threadIdx.x] = i < a.sq ? a.delta[r] : 0.f;
    }
    __syncthreads();
    // S^T, dP^T: keys ty * 4 + i, query tx
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = ty * 4 + i;
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < D; ++c) {
        s += ks[kr * (D + 1) + c] * qs[tx * (D + 1) + c];
        dp += vs[kr * (D + 1) + c] * dos[tx * (D + 1) + c];
      }
      const bool ok = visible(a, q0 + tx, k0 + kr);
      const float p = ok ? expf(s * a.scale - lse_s[tx]) : 0.f;
      pt[kr * (kFT + 1) + tx] = p;
      dst[kr * (kFT + 1) + tx] = p * (dp - dl_s[tx]) * a.scale;
    }
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q: keys ty * 4 + i, columns tx + 32 c
    for (int qr = 0; qr < kFT; ++qr) {
      float dov[NC], qv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 32 * c;
        dov[c] = col < D ? dos[qr * (D + 1) + col] : 0.f;
        qv[c] = col < D ? qs[qr * (D + 1) + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = pt[(ty * 4 + i) * (kFT + 1) + qr];
        const float ds = dst[(ty * 4 + i) * (kFT + 1) + qr];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          dv[i][c] += p * dov[c];
          dk[i][c] += ds * qv[c];
        }
      }
    }
  }
  float* dkp = static_cast<float*>(a.dk);
  float* dvp = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    if (r >= a.skv) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 32 * c;
      if (col < D) {
        dkp[row_off(a, kDK, b, hk, r) + col] = dk[i][c];
        dvp[row_off(a, kDV, b, hk, r) + col] = dv[i][c];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kT) bwd_dq_f32_kernel(BwdArgs a) {
  constexpr int NC = (D + 31) / 32;
  const int bh = blockIdx.y, b = bh / a.hq, h = bh % a.hq;
  const int hk = h / (a.hq / a.hkv);
  const int q0 = blockIdx.x * kFT;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;

  extern __shared__ float fsm[];
  float* qs = fsm;
  float* dos = qs + kFT * (D + 1);
  float* ks = dos + kFT * (D + 1);
  float* vs = ks + kFT * (D + 1);
  float* dss = vs + kFT * (D + 1);            // dS [query][key]
  float* lse_s = dss + 2 * kFT * (kFT + 1);
  float* dl_s = lse_s + kFT;

  int kv_lo, kv_hi;
  kv_range(a, q0, kFT, &kv_lo, &kv_hi);
  const int k_first = (kv_lo / kFT) * kFT;

  float dq[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dq[i][c] = 0.f;
  load_f32<D>(qs, a, a.q, kQ, b, h, q0, a.sq);
  load_f32<D>(dos, a, a.dout, kDO, b, h, q0, a.sq);
  if (threadIdx.x < kFT) {
    const int i = q0 + threadIdx.x;
    const int64_t r = static_cast<int64_t>(bh) * a.sq + i;
    lse_s[threadIdx.x] = i < a.sq ? a.lse[r] : 0.f;
    dl_s[threadIdx.x] = i < a.sq ? a.delta[r] : 0.f;
  }
  for (int k0 = k_first; k0 < kv_hi; k0 += kFT) {
    __syncthreads();
    load_f32<D>(ks, a, a.k, kK, b, hk, k0, a.skv);
    load_f32<D>(vs, a, a.v, kV, b, hk, k0, a.skv);
    __syncthreads();
    // S, dP: queries ty * 4 + i, key tx
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty * 4 + i;
      float s = 0.f, dp = 0.f;
      for (int c = 0; c < D; ++c) {
        s += qs[qr * (D + 1) + c] * ks[tx * (D + 1) + c];
        dp += dos[qr * (D + 1) + c] * vs[tx * (D + 1) + c];
      }
      const bool ok = visible(a, q0 + qr, k0 + tx);
      const float p = ok ? expf(s * a.scale - lse_s[qr]) : 0.f;
      dss[qr * (kFT + 1) + tx] = p * (dp - dl_s[qr]) * a.scale;
    }
    __syncthreads();
    // dQ += dS K: queries ty * 4 + i, columns tx + 32 c
    for (int kr = 0; kr < kFT; ++kr) {
      float kv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int col = tx + 32 * c;
        kv[c] = col < D ? ks[kr * (D + 1) + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dss[(ty * 4 + i) * (kFT + 1) + kr];
#pragma unroll
        for (int c = 0; c < NC; ++c) dq[i][c] += ds * kv[c];
      }
    }
  }
  float* dqp = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r >= a.sq) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx + 32 * c;
      if (col < D) dqp[row_off(a, kDQ, b, h, r) + col] = dq[i][c];
    }
  }
}

// ---------------------------------------------------------------------------

template <int D>
int launch(const BwdArgs& a, int batch, int dtype, cudaStream_t st) {
  if (dtype != kF32) return launch_wgmma<D>(a, batch, st);
  const int rows = batch * a.hq * a.sq;
  const int per = kT / 32;
  bwd_delta_kernel<float, D><<<(rows + per - 1) / per, kT, 0, st>>>(a, rows);
  const int smem = f32_smem_floats<D>() * 4;
  static unsigned set_kv = 0, set_q = 0;
  cudaError_t err = set_smem_once(bwd_dkdv_f32_kernel<D>, smem, &set_kv);
  if (err == cudaSuccess)
    err = set_smem_once(bwd_dq_f32_kernel<D>, smem, &set_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_f32_kernel<D><<<dim3((a.skv + kFT - 1) / kFT, batch * a.hkv), kT,
                           smem, st>>>(a);
  bwd_dq_f32_kernel<D><<<dim3((a.sq + kFT - 1) / kFT, batch * a.hq), kT,
                         smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out/dout/dq (B, Hq, Sq, d), k/v/dk/dv (B, Hkv, Skv, d), given through
// `strides`: (b, h, s) element strides of q, k, v, out, dout, dq, dk, dv
// (24 int64, last dims contiguous).  lse (B, Hq, Sq) f32 from the forward;
// delta an f32 workspace of B * Hq * 256 * ceil(Sq / 128) floats,
// 16-byte aligned.  window <= 0: no sliding window.  Query row i sits at
// position q_offset + i (q_offset >= 0), keys at 0, 1, ...
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout,
                                   const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, const int64_t* strides,
                                   int batch, int hq, int hkv, int sq, int skv,
                                   int d, float scale, int causal, int window,
                                   int q_offset, int dtype, void* stream) {
  using namespace repro;
  if (hq % hkv != 0 || q_offset < 0 || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.o = out; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) a.st[t][i] = strides[3 * t + i];
  a.hq = hq; a.hkv = hkv; a.sq = sq; a.skv = skv;
  a.scale = scale; a.causal = causal; a.window = window; a.qoff = q_offset;
  auto st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 32: return launch<32>(a, batch, dtype, st);
    case 64: return launch<64>(a, batch, dtype, st);
    case 128: return launch<128>(a, batch, dtype, st);
    case 240: return launch<240>(a, batch, dtype, st);
    case 256: return launch<256>(a, batch, dtype, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
