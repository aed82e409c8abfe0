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
// and queries past the lengths masked) and head dims (32, 64, 128, 240,
// 256).  It never materialises an (Sq, Skv) matrix.
//
// Bound on this card: operations.  Five products of 2 * Sq * Skv_live * d
// per (b, q head) against q, k, v, o, dO, lse read once and dq, dk, dv
// written once: at Gemma-3's S 4096, d 240 the causal half does ~1000
// operations a byte, far past the bf16 ridge (~295).
//
// Design (simple and deterministic; no atomics, so the bits do not depend
// on the order CTAs finish in).  Three launches on the caller's stream:
// 1. delta: one warp a query row, D = rowsum(dO * O) in f32.
// 2. dK/dV: one CTA per (b, KV head, KV tile of BKV rows).  Its K and V
//    tiles stay in shared memory; it walks the g query heads of its KV
//    head and, for each, every Q tile that the masks leave live (from the
//    causal diagonal to the window's last query), Q / dO tiles and their
//    lse / D through a 2-stage cp.async ring.  Per Q tile:
//      S^T = K Q^T and dP^T = V dO^T (BKV x 64, full head-dim contraction),
//      P^T and dS^T in f32 registers, rounded to bf16 into shared memory;
//      dV += P^T dO and dK += dS^T Q into f32 registers dealt out over the
//      8 warps (64 a thread at every head dim).
// 3. dQ: one CTA per (b, q head, Q tile of 64 rows): Q, dO, lse and D
//    stay in shared memory, K / V tiles of 64 rows of the live range
//    stream through a 2-stage ring, S = Q K^T and dP = dO V^T give dS
//    (bf16 into shared memory), dQ += dS K in registers.
// Tiles the causal or window mask empties are never visited: at S 4096
// with window 1024 about a quarter of the (Q tile, KV tile) pairs live.
//
// bf16: tensor cores, mma.sync m16n8k16 with f32 accumulators, operands
// from XOR-swizzled shared memory by ldmatrix (.trans where the
// contraction runs down the rows: dO and Q in phase 2 of kernel 2, K in
// phase 2 of kernel 3).  BKV is 64 at head dims up to 128 and 32 at
// 240 / 256, so that K, V, the Q / dO ring and P, dS fit the 227 KB one
// block may use (115 KB at d 128, 172 KB at d 256); kernel 3 holds 200 KB
// at d 256.  Head dims 240 and 32 run on tiles 256 and 64 wide whose
// columns past d are zero (never loaded), as in the forward.
// exp2 with log2(e) folded into the scale and the lse.
//
// f32 (exact, CUDA cores, no TF32): the same three launches with 32 x 32
// tiles in f32 shared memory (rows padded to d + 1 floats), each thread 4
// scores of a tile and 4 x ceil(d / 32) accumulators; expf as in JAX.
//
// Inputs and outputs are read and written through (b, h, s) element
// strides with a contiguous last dim (the model hands over (B, S, H, d)
// tensors as transposed views); bf16 needs strides that are multiples of
// 8 elements and 16-byte-aligned bases (the wrapper checks both).
//
// Making it fast (TMA, wgmma, warp specialisation, overlapping the two
// phases) is later work.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

constexpr int kT = 256;            // threads a CTA, every kernel
constexpr float kLog2e = 1.4426950408889634f;

struct BwdArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                // (B, Hq, Sq) contiguous
  float* delta;                    // (B, Hq, Sq) contiguous, written by 1.
  void* dq;
  void* dk;
  void* dv;
  int64_t st[8][3];                // (b, h, s) strides: q k v o dout dq dk dv
  int hq, hkv, sq, skv;
  float scale;
  int causal, window;
};

enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV };

__device__ __forceinline__ int64_t row_off(const BwdArgs& a, int t, int b,
                                           int h, int s) {
  return b * a.st[t][0] + h * a.st[t][1] + s * a.st[t][2];
}

__device__ __forceinline__ bool visible(const BwdArgs& a, int i, int j) {
  bool ok = i < a.sq && j < a.skv;
  if (a.causal) ok = ok && j <= i;
  if (a.window > 0) ok = ok && j > i - a.window;
  return ok;
}

// the live query rows [lo, hi) of keys [k0, k0 + rows)
__device__ __forceinline__ void q_range(const BwdArgs& a, int k0, int rows,
                                        int* lo, int* hi) {
  *lo = a.causal ? k0 : 0;
  *hi = a.window > 0 ? min(a.sq, k0 + rows - 1 + a.window) : a.sq;
}

// the live keys [lo, hi) of query rows [q0, q0 + rows)
__device__ __forceinline__ void kv_range(const BwdArgs& a, int q0, int rows,
                                         int* lo, int* hi) {
  *lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  *hi = a.causal ? min(a.skv, q0 + rows) : a.skv;
}

// every (query, key) pair of the tile visible: no per-element mask
__device__ __forceinline__ bool whole_tile(const BwdArgs& a, int q0, int nq,
                                           int k0, int nk) {
  return q0 + nq <= a.sq && k0 + nk <= a.skv &&
         (!a.causal || k0 + nk - 1 <= q0) &&
         (a.window <= 0 || k0 > q0 + nq - 1 - a.window);
}

// ---------------------------------------------------------------------------
// 1. delta = rowsum(dO * O), one warp a row

template <typename T, int D>
__global__ void __launch_bounds__(kT) bwd_delta_kernel(BwdArgs a, int rows) {
  const int row = blockIdx.x * (kT / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const int bh = row / a.sq, i = row % a.sq;
  const int b = bh / a.hq, h = bh % a.hq;
  const T* o = static_cast<const T*>(a.o) + row_off(a, kO, b, h, i);
  const T* d = static_cast<const T*>(a.dout) + row_off(a, kDO, b, h, i);
  float s = 0.f;
  for (int c = lane; c < D; c += 32) s += to_f(d[c]) * to_f(o[c]);
#pragma unroll
  for (int x = 16; x > 0; x >>= 1) s += __shfl_xor_sync(0xffffffffu, s, x);
  if (lane == 0) a.delta[row] = s;
}

// ---------------------------------------------------------------------------
// bf16: mma.sync

template <int D>
struct BwdCfg {
  static constexpr int kDT = (D + 63) / 64 * 64;   // tile width
  static constexpr int kCh = kDT / 8;              // 16-byte chunks a row
  static constexpr int kChD = D / 8;               // of them loaded
  static constexpr int kBQ = 64;                   // query rows a tile
  static constexpr int kBKV = kDT > 128 ? 32 : 64; // kernel 2's key rows
  static constexpr int kBKVQ = 64;                 // kernel 3's key rows
  static_assert(D % 16 == 0, "whole k16 steps");
  // kernel 2: K, V, a ring of 2 x (Q, dO), P^T, dS^T (bf16), 2 x (lse, D)
  static constexpr int kSmemKV =
      (2 * kBKV * kDT + 4 * kBQ * kDT + 2 * kBKV * kBQ) * 2 + 4 * kBQ * 4;
  // kernel 3: Q, dO, a ring of 2 x (K, V), dS (bf16), lse, D
  static constexpr int kSmemQ =
      (2 * kBQ * kDT + 4 * kBKVQ * kDT + kBQ * kBKVQ) * 2 + 2 * kBQ * 4;
};

// rows [r0, r0 + n) of tensor t, head h, into a rows x kDT swizzled tile:
// cp.async for the d real columns of rows < limit, zeros elsewhere
template <int D>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const BwdArgs& a,
                                          const void* src, int t, int b, int h,
                                          int r0, int n, int limit) {
  using C = BwdCfg<D>;
  const __nv_bfloat16* base = static_cast<const __nv_bfloat16*>(src);
  for (int i = threadIdx.x; i < n * C::kCh; i += kT) {
    const int r = i / C::kCh, c = i % C::kCh;
    __nv_bfloat16* p = dst + swz(r, c, C::kDT);
    if (r0 + r < limit && c < C::kChD)
      cp_async16(p, base + row_off(a, t, b, h, r0 + r) + c * 8);
    else
      *reinterpret_cast<uint4*>(p) = make_uint4(0, 0, 0, 0);
  }
}

// lse (times log2 e) and D of query rows [q0, q0 + kBQ) of head bh
__device__ __forceinline__ void load_rows(float* lse_s, float* dl_s,
                                          const BwdArgs& a, int bh, int q0,
                                          int n) {
  for (int r = threadIdx.x; r < n; r += kT) {
    const bool ok = q0 + r < a.sq;
    const int64_t i = static_cast<int64_t>(bh) * a.sq + q0 + r;
    lse_s[r] = ok ? a.lse[i] * kLog2e : 0.f;
    dl_s[r] = ok ? a.delta[i] : 0.f;
  }
}

// acc[j] (+)= A (16 rows at a_rows, k = ksteps * 16, row-major [m][k]
// tile of a_cols) x B for n-tiles nt0 .. nt0 + NJ - 1, B read [n][k]
// (b_trans false: n rows, k along the row) or [k][n] (b_trans true)
template <int NJ, bool BTrans>
__device__ __forceinline__ void mma_rows(float (&acc)[NJ][4],
                                         const __nv_bfloat16* at, int a_cols,
                                         int a_row0, const __nv_bfloat16* bt,
                                         int b_cols, int nt0, int ksteps) {
  const int lane = threadIdx.x % 32;
  for (int ks = 0; ks < ksteps; ++ks) {
    uint32_t af[4];
    ldsm_x4(af, at + swz(a_row0 + (lane & 15), ks * 2 + (lane >> 4), a_cols));
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t bf[4];
      const int nt = nt0 + j;
      if constexpr (BTrans)
        ldsm_x4_t(bf, bt + swz(ks * 16 + (lane & 15), nt + (lane >> 4),
                               b_cols));
      else
        ldsm_x4(bf, bt + swz(nt * 8 + (lane & 7) + ((lane >> 4) << 3),
                             ks * 2 + ((lane >> 3) & 1), b_cols));
      mma_bf16(acc[j], af, bf[0], bf[1]);
      mma_bf16(acc[j + 1], af, bf[2], bf[3]);
    }
  }
}

template <int NJ>
__device__ __forceinline__ void zero(float (&acc)[NJ][4]) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// write a warp's (16 x 8 NJ) f32 block, rows row0 + ... of tensor t
template <int D, int NJ>
__device__ __forceinline__ void store_rows(const BwdArgs& a, void* dst, int t,
                                           int b, int h, int row0, int limit,
                                           int nt0, const float (&acc)[NJ][4]) {
  const int lane = threadIdx.x % 32, gq = lane >> 2, tq = lane & 3;
  __nv_bfloat16* base = static_cast<__nv_bfloat16*>(dst);
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = row0 + gq + 8 * hf, c = (nt0 + j) * 8 + 2 * tq;
      if (r < limit && c < D)
        *reinterpret_cast<__nv_bfloat162*>(base + row_off(a, t, b, h, r) + c) =
            __floats2bfloat162_rn(acc[j][2 * hf], acc[j][2 * hf + 1]);
    }
}

// 2. dK / dV
template <int D>
__global__ void __launch_bounds__(kT, 1) bwd_dkdv_mma_kernel(BwdArgs a) {
  using C = BwdCfg<D>;
  constexpr int kDT = C::kDT, kBQ = C::kBQ, kBKV = C::kBKV;
  constexpr int kMT = kBKV / 16;              // key m-tiles: 4 or 2
  constexpr int kWN = 8 / kMT;                // warps along n
  constexpr int kNJ1 = (kBQ / 8) / kWN;       // phase 1 n-tiles a warp
  constexpr int kNJ2 = (kDT / 8) / kWN;       // phase 2 n-tiles a warp
  static_assert(kNJ1 % 2 == 0 && kNJ2 % 2 == 0, "n-tile pairs");
  const int b = blockIdx.y / a.hkv, hk = blockIdx.y % a.hkv;
  const int g = a.hq / a.hkv;
  const int k0 = blockIdx.x * kBKV;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int mt = warp % kMT, wn = warp / kMT;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kBKV * kDT;
  __nv_bfloat16* ring = vs + kBKV * kDT;      // [stage][Q, dO][kBQ][kDT]
  __nv_bfloat16* pts = ring + 4 * kBQ * kDT;  // P^T [kBKV][kBQ]
  __nv_bfloat16* dsts = pts + kBKV * kBQ;     // dS^T
  float* rows_s = reinterpret_cast<float*>(dsts + kBKV * kBQ);  // [st][lse, D]

  int q_lo, q_hi;
  q_range(a, k0, kBKV, &q_lo, &q_hi);
  const int t_lo = q_lo / kBQ;
  const int n_qt = q_hi > q_lo ? (q_hi + kBQ - 1) / kBQ - t_lo : 0;
  const int n_it = g * n_qt;

  float dk[kNJ2][4], dv[kNJ2][4];
  zero(dk);
  zero(dv);
  const float sl2 = a.scale * kLog2e;

  auto issue = [&](int it, int st) {
    const int h = hk * g + it / n_qt, q0 = (t_lo + it % n_qt) * kBQ;
    __nv_bfloat16* qd = ring + st * 2 * kBQ * kDT;
    load_tile<D>(qd, a, a.q, kQ, b, h, q0, kBQ, a.sq);
    load_tile<D>(qd + kBQ * kDT, a, a.dout, kDO, b, h, q0, kBQ, a.sq);
    load_rows(rows_s + st * 2 * kBQ, rows_s + st * 2 * kBQ + kBQ, a,
              b * a.hq + h, q0, kBQ);
  };

  if (n_it > 0) {
    load_tile<D>(ks, a, a.k, kK, b, hk, k0, kBKV, a.skv);
    load_tile<D>(vs, a, a.v, kV, b, hk, k0, kBKV, a.skv);
    issue(0, 0);
  }
  cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();                   // tile it landed; tile it - 1 consumed
    if (it + 1 < n_it) issue(it + 1, (it + 1) % 2);
    cp_async_commit();
    const int st = it % 2;
    const __nv_bfloat16* qt = ring + st * 2 * kBQ * kDT;
    const __nv_bfloat16* dot = qt + kBQ * kDT;
    const float* lse_s = rows_s + st * 2 * kBQ;
    const float* dl_s = lse_s + kBQ;
    const int q0 = (t_lo + it % n_qt) * kBQ;

    // phase 1: S^T = K Q^T, dP^T = V dO^T for key m-tile mt, query
    // n-tiles wn * kNJ1 ...
    float s[kNJ1][4], dp[kNJ1][4];
    zero(s);
    zero(dp);
    mma_rows<kNJ1, false>(s, ks, kDT, mt * 16, qt, kDT, wn * kNJ1, D / 16);
    mma_rows<kNJ1, false>(dp, vs, kDT, mt * 16, dot, kDT, wn * kNJ1, D / 16);
    const bool whole = whole_tile(a, q0, kBQ, k0, kBKV);
#pragma unroll
    for (int j = 0; j < kNJ1; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = mt * 16 + gq + 8 * hf;             // key row
        const int c = (wn * kNJ1 + j) * 8 + 2 * tq;      // query column
        float p[2], ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = whole || visible(a, q0 + c + e, k0 + r);
          p[e] = ok ? exp2f(s[j][2 * hf + e] * sl2 - lse_s[c + e]) : 0.f;
          ds[e] = p[e] * (dp[j][2 * hf + e] - dl_s[c + e]) * a.scale;
        }
        const int off = swz(r, c >> 3, kBQ) + (c & 7);
        *reinterpret_cast<__nv_bfloat162*>(pts + off) =
            __floats2bfloat162_rn(p[0], p[1]);
        *reinterpret_cast<__nv_bfloat162*>(dsts + off) =
            __floats2bfloat162_rn(ds[0], ds[1]);
      }
    __syncthreads();                   // P^T, dS^T of this tile

    // phase 2: dV += P^T dO, dK += dS^T Q (contraction over the query rows)
    mma_rows<kNJ2, true>(dv, pts, kBQ, mt * 16, dot, kDT, wn * kNJ2,
                         kBQ / 16);
    mma_rows<kNJ2, true>(dk, dsts, kBQ, mt * 16, qt, kDT, wn * kNJ2,
                         kBQ / 16);
  }
  cp_async_wait<0>();
  store_rows<D, kNJ2>(a, a.dv, kDV, b, hk, k0 + mt * 16, a.skv, wn * kNJ2, dv);
  store_rows<D, kNJ2>(a, a.dk, kDK, b, hk, k0 + mt * 16, a.skv, wn * kNJ2, dk);
}

// 3. dQ
template <int D>
__global__ void __launch_bounds__(kT, 1) bwd_dq_mma_kernel(BwdArgs a) {
  using C = BwdCfg<D>;
  constexpr int kDT = C::kDT, kBQ = C::kBQ, kBKV = C::kBKVQ;
  constexpr int kNJ1 = (kBKV / 8) / 2;        // 4 m-tiles x 2 warps along n
  constexpr int kNJ2 = (kDT / 8) / 2;
  const int bh = blockIdx.y, b = bh / a.hq, h = bh % a.hq;
  const int hk = h / (a.hq / a.hkv);
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gq = lane >> 2, tq = lane & 3;
  const int mt = warp % 4, wn = warp / 4;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* dos = qs + kBQ * kDT;
  __nv_bfloat16* ring = dos + kBQ * kDT;      // [stage][K, V][kBKV][kDT]
  __nv_bfloat16* dss = ring + 4 * kBKV * kDT; // dS [kBQ][kBKV]
  float* lse_s = reinterpret_cast<float*>(dss + kBQ * kBKV);
  float* dl_s = lse_s + kBQ;

  int kv_lo, kv_hi;
  kv_range(a, q0, kBQ, &kv_lo, &kv_hi);
  const int k_first = (kv_lo / kBKV) * kBKV;
  const int n_it = kv_hi > k_first ? (kv_hi - k_first + kBKV - 1) / kBKV : 0;

  float dq[kNJ2][4];
  zero(dq);
  const float sl2 = a.scale * kLog2e;

  auto issue = [&](int it, int st) {
    __nv_bfloat16* kd = ring + st * 2 * kBKV * kDT;
    const int k0 = k_first + it * kBKV;
    load_tile<D>(kd, a, a.k, kK, b, hk, k0, kBKV, a.skv);
    load_tile<D>(kd + kBKV * kDT, a, a.v, kV, b, hk, k0, kBKV, a.skv);
  };

  if (n_it > 0) {
    load_tile<D>(qs, a, a.q, kQ, b, h, q0, kBQ, a.sq);
    load_tile<D>(dos, a, a.dout, kDO, b, h, q0, kBQ, a.sq);
    load_rows(lse_s, dl_s, a, bh, q0, kBQ);
    issue(0, 0);
  }
  cp_async_commit();
  for (int it = 0; it < n_it; ++it) {
    cp_async_wait<0>();
    __syncthreads();
    if (it + 1 < n_it) issue(it + 1, (it + 1) % 2);
    cp_async_commit();
    const __nv_bfloat16* kt = ring + (it % 2) * 2 * kBKV * kDT;
    const __nv_bfloat16* vt = kt + kBKV * kDT;
    const int k0 = k_first + it * kBKV;

    // phase 1: S = Q K^T, dP = dO V^T for query m-tile mt
    float s[kNJ1][4], dp[kNJ1][4];
    zero(s);
    zero(dp);
    mma_rows<kNJ1, false>(s, qs, kDT, mt * 16, kt, kDT, wn * kNJ1, D / 16);
    mma_rows<kNJ1, false>(dp, dos, kDT, mt * 16, vt, kDT, wn * kNJ1, D / 16);
    const bool whole = whole_tile(a, q0, kBQ, k0, kBKV);
#pragma unroll
    for (int j = 0; j < kNJ1; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int r = mt * 16 + gq + 8 * hf;             // query row
        const int c = (wn * kNJ1 + j) * 8 + 2 * tq;      // key column
        float ds[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool ok = whole || visible(a, q0 + r, k0 + c + e);
          const float p = ok ? exp2f(s[j][2 * hf + e] * sl2 - lse_s[r]) : 0.f;
          ds[e] = p * (dp[j][2 * hf + e] - dl_s[r]) * a.scale;
        }
        *reinterpret_cast<__nv_bfloat162*>(dss + swz(r, c >> 3, kBKV) +
                                           (c & 7)) =
            __floats2bfloat162_rn(ds[0], ds[1]);
      }
    __syncthreads();

    // phase 2: dQ += dS K (contraction over the keys)
    mma_rows<kNJ2, true>(dq, dss, kBKV, mt * 16, kt, kDT, wn * kNJ2,
                         kBKV / 16);
  }
  cp_async_wait<0>();
  store_rows<D, kNJ2>(a, a.dq, kDQ, b, h, q0 + mt * 16, a.sq, wn * kNJ2, dq);
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
  const int rows = batch * a.hq * a.sq;
  const int per = kT / 32;
  cudaError_t err;
  if (dtype == kF32) {
    bwd_delta_kernel<float, D><<<(rows + per - 1) / per, kT, 0, st>>>(a, rows);
    const int smem = f32_smem_floats<D>() * 4;
    static unsigned set_kv = 0, set_q = 0;
    err = set_smem_once(bwd_dkdv_f32_kernel<D>, smem, &set_kv);
    if (err == cudaSuccess)
      err = set_smem_once(bwd_dq_f32_kernel<D>, smem, &set_q);
    if (err != cudaSuccess) return static_cast<int>(err);
    bwd_dkdv_f32_kernel<D><<<dim3((a.skv + kFT - 1) / kFT, batch * a.hkv), kT,
                             smem, st>>>(a);
    bwd_dq_f32_kernel<D><<<dim3((a.sq + kFT - 1) / kFT, batch * a.hq), kT,
                           smem, st>>>(a);
    return static_cast<int>(cudaGetLastError());
  }
  using C = BwdCfg<D>;
  bwd_delta_kernel<__nv_bfloat16, D><<<(rows + per - 1) / per, kT, 0, st>>>(
      a, rows);
  static unsigned set_kv = 0, set_q = 0;
  err = set_smem_once(bwd_dkdv_mma_kernel<D>, C::kSmemKV, &set_kv);
  if (err == cudaSuccess)
    err = set_smem_once(bwd_dq_mma_kernel<D>, C::kSmemQ, &set_q);
  if (err != cudaSuccess) return static_cast<int>(err);
  bwd_dkdv_mma_kernel<D><<<dim3((a.skv + C::kBKV - 1) / C::kBKV,
                                batch * a.hkv), kT, C::kSmemKV, st>>>(a);
  bwd_dq_mma_kernel<D><<<dim3((a.sq + C::kBQ - 1) / C::kBQ, batch * a.hq), kT,
                         C::kSmemQ, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q/out/dout/dq (B, Hq, Sq, d), k/v/dk/dv (B, Hkv, Skv, d), given through
// `strides`: (b, h, s) element strides of q, k, v, out, dout, dq, dk, dv
// (24 int64, last dims contiguous).  lse (B, Hq, Sq) f32 from the forward;
// delta a (B, Hq, Sq) f32 workspace.  window <= 0: no sliding window.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v,
                                   const void* out, const void* dout,
                                   const void* lse, void* delta, void* dq,
                                   void* dk, void* dv, const int64_t* strides,
                                   int batch, int hq, int hkv, int sq, int skv,
                                   int d, float scale, int causal, int window,
                                   int dtype, void* stream) {
  using namespace repro;
  if (hq % hkv != 0 || (dtype != kF32 && dtype != kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.q = q; a.k = k; a.v = v; a.o = out; a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<float*>(delta);
  a.dq = dq; a.dk = dk; a.dv = dv;
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) a.st[t][i] = strides[3 * t + i];
  a.hq = hq; a.hkv = hkv; a.sq = sq; a.skv = skv;
  a.scale = scale; a.causal = causal; a.window = window;
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
