// Backward of the RWKV-6 WKV recurrence for Hopper (sm_90a).
//
// No TPU kernel has this function: the JAX package differentiates its
// scan (src/repro/models/rwkv.py:145-162), which it runs in
// jax.checkpoint segments of _pick_segment(s) steps, so that autodiff
// keeps only the state at segment boundaries and re-forms the rest.  The
// forward it differentiates is csrc/wkv6.cu's (the counterpart of
// src/repro/kernels/wkv6.py::wkv6): per (sequence, head), with the
// (hd, hd) f32 state S,
//   y_t = r_t (S_{t-1} + diag(u) k_t v_t^T),  S_t = diag(w_t) S_{t-1} + k_t v_t^T.
// With G_t the gradient of S_t (G_S = ds_fin, zero without one):
//   G_{t-1} = diag(w_t) G_t + r_t dy_t^T
//   dr_t = (S_{t-1} + diag(u) k_t v_t^T) dy_t
//   dk_t = G_t v_t + u * r_t (v_t . dy_t)
//   dv_t = G_t^T k_t + (r_t . (u * k_t)) dy_t
//   dw_t = rowsum(G_t * S_{t-1}),  du = sum_t r_t * k_t (v_t . dy_t),
//   ds0 = G_0
// (kernels/ref.py::wkv6_bwd_ref is the plain version).
//
// Bound on this card: bytes and operations about equally.  At RWKV-6-7B's
// training shape (B 2, H 64, S 4096, hd 64) the function reads r, k, v,
// w, dy (0.67 GB) and writes dr, dk, dv, dw (0.54 GB), ~0.36 ms at 3.35
// TB/s; it does ~12 f32 operations an entry of S and step (the four
// gradient products and G's update, one FMA each, and S re-formed once),
// ~26 GFLOP, ~0.39 ms at 67 TFLOP/s outside the tensor cores.
//
// Head sizes 64 and 128: the chunked form, the backward of csrc/wkv6.cu's
// chunked forward.  Time is cut into chunks of kL = 16 steps.  In a
// chunk with S_in the state before it and G_out the gradient of the
// state after it, per channel i (all inside the chunk, no division):
//   P_t = prod_{tau<t} w_tau,  Q'_t = prod_{tau>t} w_tau,  tot = prod w,
//   D_ts = prod_{s<tau<t} w_tau (s < t),  E_ts = prod_{t<tau<s} w_tau (s > t),
// S_{t-1} = P_t S_in + sum_{s<t} D_ts k_s v_s^T and G_t = Q'_t G_out +
// sum_{s>t} E_ts r_s dy_s^T, so with B[s][t] = v_s . dy_t,
// alpha_s = D_ts k_s, beta_s = E_ts r_s, gamma_x = sum_s alpha_s B[s][x]:
//   dr_t = P_t (S_in dy_t) + gamma_t + u k_t B[t][t]
//   dk_t = Q'_t (G_out v_t) + sum_s beta_s B[t][s] + u r_t B[t][t]
//   dw_t = P_t Q'_t rowsum(G_out * S_in) + Q'_t sum_s alpha_s (G_out v_s)
//          + P_t sum_s beta_s (S_in dy_s) + sum_s beta_s gamma_s
//   dv_t = G_out^T (k_t Q'_t) + sum_{s>=t} A[s][t] dy_s,
//          A[s][t] = sum_i r_s alpha_t (s > t), A[t][t] = sum_i r_t u k_t
//   du  += r_t k_t B[t][t],  G_in = tot G_out + (r P)^T dY.
// dw_t = rowsum(G_t * S_{t-1}) is formed without either matrix: its
// four terms are products the chunk has anyway and the O(16^2) sums
// over steps per channel (alpha, beta, gamma), run on the CUDA cores in
// parallel over (step, channel).  Every decay factor is a running
// product of w's in [0, 1], so w == 0 gives exact zeros and nothing
// overflows.
//
// One CTA of 512 threads owns a slab of SLAB columns of S and G for one
// (b, h) (S's column j needs only v_j, G's only dy_j): at hd 64 two
// slabs of 32 while they fit in one wave of the card's SMs (B * H up to
// 66), else the whole head (128 CTAs at the training shape; a slab does
// the per-(step, channel) sums of the whole head, so a second wave
// costs more than the slab saves); hd 128 always 4 slabs of 32.  Pass 1
// walks the chunks forward, S <- tot S + (k Q)^T V (Q_s = prod_{s<tau}
// w_tau), with the slab of S in registers as mma accumulators, and
// writes S_in of every chunk to a scratch buffer (B H, n_chunks, hd,
// SLAB) f32 in device memory; pass 2 walks them in reverse with G in
// shared memory.  Per chunk: S_in dy, G v and B as 3xTF32 mma.sync
// products over the slab (about f32's accuracy, csrc/mma_tf32.cuh: each
// 8-deep step's three products go into a zeroed accumulator, added to
// C in f32: the tensor cores' round-toward-zero sums straight into the
// carried S and G gave up to 20x the serial kernel's error); the
// per-(step, channel) sums above, warp t owning step t (16 warps); dv
// and G's update as products again.  An operand that several products read (v, dy, r P, k Q') is
// split into TF32's (big, small) once a chunk, in shared memory.
// cp.async brings the next chunk's r, k, w, v, dy and checkpoint while
// one is computed; a ragged last chunk pads its steps with r = k = v =
// dy = 0 and w = 1, which leave S and G as they are.
// (On an H100 at the training shape a 256-thread CTA with two steps a
// warp took 3.56 ms, this layout 2.86.)
//
// Reductions, all in a fixed order (no atomics; the bits do not depend
// on the order in which CTAs run): A's rows over a warp's lanes by a
// transpose-reduce; rowsum(G * S_in) in kCThreads / hd partials added in
// order; dr, dk, dw of several slabs as partials that a second kernel
// adds in order; du over the chunks in the channel's thread, then over
// the batch (and slabs) in order by a last kernel.
//
// Head size 32 (the training launcher's reduced config): the serial
// kernel.  Both recurrences are separable by entry: S_t[i,j] needs only
// w_t[i], k_t[i], v_t[j]; G_{t-1}[i,j] only w_t[i], r_t[i], dy_t[j].  One
// CTA of 8 x 32 threads owns a (b, head); thread (row ir = tid % 32,
// column group c = tid / 32) holds the entries (ir, 4 c .. 4 c + 4) of S
// and of G in registers.  S_{t-1} is re-formed forward from checkpoints,
// as JAX's segments do: pass A writes the state at every kSeg-th step to
// a scratch buffer (B, H, ceil(S/kSeg), hd, hd) f32; pass B walks the
// segments in reverse, writes the state at every kSub-th step into
// shared memory, then re-forms each sub-segment's kSub per-step states in
// registers and runs the reverse recurrence over them (kSub 16, kSeg
// 128).  dr, dk, dw sum each thread's columns, then the 8 column groups
// in order in shared memory; dv is a reduce-scatter by shuffles over the
// warp's 32 rows.
//
// Inputs r/k/v/w (and the outputs dr/dk/dv/dw) are addressed through
// one set of (batch, head, step) strides and dy through its own, each
// with a contiguous last dimension, so the model's transposed
// (B, S, H, hd) views are read and written without copies.
#include "common.cuh"
#include "hopper.cuh"
#include "mma_tf32.cuh"

namespace {

constexpr int kGroups = 8;              // column groups

// the serial kernel's shape (head size 32)
template <int HD>
struct Cfg {
  static constexpr int kRows = HD;                    // rows a CTA owns
  static constexpr int kThreads = kGroups * kRows;
  static constexpr int kHalves = kRows / 32;          // warps a group
  static constexpr int kCols = HD / kGroups;          // columns a thread
  static constexpr int kSub = 64 / kCols;             // register states
  static constexpr int kNSub = 8;                     // sub-checkpoints
  static constexpr int kSeg = kSub * kNSub;           // checkpoint spacing
  static constexpr int kPitch = HD + 4;               // padded smem row
  // shared memory, in floats
  static constexpr int kSubck = kNSub * kRows * kPitch;
  static constexpr int kStage = 5 * kSub * HD;        // r, k, w, v, dy
  static constexpr int kRowbuf = kSub * 3 * kGroups * kRows;
  static constexpr int kDvbuf = kSub * kHalves * HD;
  static constexpr int kFloats = kSubck + kStage + 2 * kSub + HD + kRowbuf
                                 + kDvbuf;
  static constexpr size_t kSmemBytes = sizeof(float) * kFloats;
};

struct Args {
  const float* r;
  const float* k;
  const float* v;
  const float* w;
  const float* u;
  const float* s0;
  const float* dy;
  const float* ds_fin;      // may be null: zero
  float* dr;
  float* dk;
  float* dv;
  float* dw;
  float* du_part;           // (B, H, slabs, hd)
  float* ds0;
  float* ckpt;              // serial: (B, H, n_seg, hd, hd); chunked:
                            // (B H slabs, n_chunks, hd, slab)
  float* part;              // chunked, several slabs: (slabs, 3, B, H, S, hd)
  int n_heads, seq, n_seg;
  long long sb, sh, ss;     // r/k/v/w and dr/dk/dv/dw
  long long yb, yh, ys;     // dy
};

// Reduce-scatter over a warp: v[N] per lane in, and on return v[0] holds
// the sum over the 32 lanes of entry ``base`` of the lanes' arrays.
template <int N, int OFF>
__device__ __forceinline__ void xreduce(float* v, int lane, int& base) {
  if constexpr (OFF >= 1) {
    if constexpr (N > 1) {
      constexpr int H = N / 2;
      const bool up = (lane & OFF) != 0;
#pragma unroll
      for (int q = 0; q < H; ++q) {
        const float send = up ? v[q] : v[q + H];
        const float keep = up ? v[q + H] : v[q];
        v[q] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
      }
      if (up) base += H;
      xreduce<H, OFF / 2>(v, lane, base);
    } else {
      v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
      xreduce<1, OFF / 2>(v, lane, base);
    }
  }
}

template <int N>
__device__ __forceinline__ void load_row(const float* p, float (&o)[N]) {
#pragma unroll
  for (int q = 0; q < N; q += 4) {
    const float4 a = *reinterpret_cast<const float4*>(p + q);
    o[q] = a.x; o[q + 1] = a.y; o[q + 2] = a.z; o[q + 3] = a.w;
  }
}
template <int N>
__device__ __forceinline__ void store_row(float* p, const float (&o)[N]) {
#pragma unroll
  for (int q = 0; q < N; q += 4)
    *reinterpret_cast<float4*>(p + q) = make_float4(o[q], o[q + 1],
                                                    o[q + 2], o[q + 3]);
}

template <int HD>
struct Smem {
  using C = Cfg<HD>;
  float* subck;     // [kNSub][kRows][kPitch]
  float* rs;        // [kSub][HD] each
  float* ks;
  float* ws;
  float* vs;
  float* dys;
  float* qv;        // [kSub]: v_t . dy_t
  float* pv;        // [kSub]: r_t . (u * k_t)
  float* us;        // [HD]
  float* rowbuf;    // [kSub][3][kGroups][kRows]
  float* dvbuf;     // [kSub][kHalves][HD]
  __device__ explicit Smem(float* base) {
    subck = base;
    rs = subck + C::kSubck;
    ks = rs + C::kSub * HD;
    ws = ks + C::kSub * HD;
    vs = ws + C::kSub * HD;
    dys = vs + C::kSub * HD;
    qv = dys + C::kSub * HD;
    pv = qv + C::kSub;
    us = pv + C::kSub;
    rowbuf = us + HD;
    dvbuf = rowbuf + C::kRowbuf;
  }
};

// Stage the kSub steps from t0 (steps past the sequence read as r = k = v
// = dy = 0 and w = 1, which leave S and G as they are and add nothing).
// kFull also stages r and dy and forms each step's two dot products.
template <int HD, bool kFull>
__device__ __forceinline__ void stage(const Args& a, const Smem<HD>& sm,
                                      size_t in0, size_t y0, int t0) {
  using C = Cfg<HD>;
  __syncthreads();                 // the previous stage's readers are done
  for (int e = threadIdx.x; e < C::kSub * HD; e += C::kThreads) {
    const int m = e / HD, j = e % HD, t = t0 + m;
    const bool live = t < a.seq;
    const size_t off = in0 + static_cast<size_t>(t) * a.ss + j;
    sm.ks[e] = live ? a.k[off] : 0.f;
    sm.ws[e] = live ? a.w[off] : 1.f;
    sm.vs[e] = live ? a.v[off] : 0.f;
    if constexpr (kFull) {
      sm.rs[e] = live ? a.r[off] : 0.f;
      sm.dys[e] = live ? a.dy[y0 + static_cast<size_t>(t) * a.ys + j] : 0.f;
    }
  }
  __syncthreads();
  if constexpr (kFull) {
    const int lane = threadIdx.x % 32;
    for (int m = threadIdx.x / 32; m < C::kSub; m += C::kThreads / 32) {
      const float* vr = sm.vs + m * HD;
      const float* dr = sm.dys + m * HD;
      const float* rr = sm.rs + m * HD;
      const float* kr = sm.ks + m * HD;
      float q = 0.f, p = 0.f;
      for (int j = lane; j < HD; j += 32) {
        q = fmaf(vr[j], dr[j], q);
        p = fmaf(rr[j], sm.us[j] * kr[j], p);
      }
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) {
        q += __shfl_xor_sync(0xffffffffu, q, off);
        p += __shfl_xor_sync(0xffffffffu, p, off);
      }
      if (lane == 0) {
        sm.qv[m] = q;
        sm.pv[m] = p;
      }
    }
    __syncthreads();
  }
}

// S <- diag(w_m) S + k_m v_m^T over this thread's entries, step m of the
// stage.
template <int HD, int N>
__device__ __forceinline__ void advance(const Smem<HD>& sm, int m, int i,
                                       int j0, const float (&s)[N],
                                       float (&out)[N]) {
  const float kk = sm.ks[m * HD + i], ww = sm.ws[m * HD + i];
#pragma unroll
  for (int e = 0; e < N; ++e)
    out[e] = fmaf(ww, s[e], kk * sm.vs[m * HD + j0 + e]);
}

template <int HD>
__global__ void __launch_bounds__(Cfg<HD>::kThreads, 1)
    wkv6_bwd_kernel(Args a) {
  using C = Cfg<HD>;
  constexpr int CPT = C::kCols, SUB = C::kSub, SEG = C::kSeg;
  constexpr int kRows = C::kRows, kThreads = C::kThreads;
  extern __shared__ __align__(16) float smem[];
  const Smem<HD> sm(smem);
  const int bh = blockIdx.x, b = bh / a.n_heads, h = bh % a.n_heads;
  const int tid = threadIdx.x, ir = tid % kRows, cg = tid / kRows;
  const int i = ir, j0 = cg * CPT;
  const int lane = tid % 32, half = (tid / 32) % C::kHalves;
  const size_t in0 = static_cast<size_t>(b) * a.sb
                     + static_cast<size_t>(h) * a.sh;
  const size_t y0 = static_cast<size_t>(b) * a.yb
                    + static_cast<size_t>(h) * a.yh;
  const size_t state0 = static_cast<size_t>(bh) * HD * HD
                        + static_cast<size_t>(i) * HD + j0;
  auto ckpt_at = [&](int n) {
    return a.ckpt + (static_cast<size_t>(bh) * a.n_seg + n) * HD * HD
           + static_cast<size_t>(i) * HD + j0;
  };
  for (int e = tid; e < HD; e += kThreads) sm.us[e] = a.u[h * HD + e];

  // pass A: forward from s0, a checkpoint every SEG steps
  float S[CPT];
  load_row<CPT>(a.s0 + state0, S);
  for (int t0 = 0; t0 < a.seq; t0 += SUB) {
    if (t0 % SEG == 0) store_row<CPT>(ckpt_at(t0 / SEG), S);
    stage<HD, false>(a, sm, in0, y0, t0);
#pragma unroll
    for (int m = 0; m < SUB; ++m) advance<HD, CPT>(sm, m, i, j0, S, S);
  }

  // pass B: the segments in reverse
  float G[CPT];
  if (a.ds_fin != nullptr) {
    load_row<CPT>(a.ds_fin + state0, G);
  } else {
#pragma unroll
    for (int e = 0; e < CPT; ++e) G[e] = 0.f;
  }
  float du = 0.f;
  for (int n = a.n_seg - 1; n >= 0; --n) {
    const int tb = n * SEG, te = min(a.seq, tb + SEG);
    const int n_sub = (te - tb + SUB - 1) / SUB;
    load_row<CPT>(ckpt_at(n), S);
    for (int ms = 0; ms < n_sub; ++ms) {
      store_row<CPT>(sm.subck + (ms * kRows + ir) * C::kPitch + j0, S);
      if (ms + 1 < n_sub) {
        stage<HD, false>(a, sm, in0, y0, tb + ms * SUB);
#pragma unroll
        for (int m = 0; m < SUB; ++m) advance<HD, CPT>(sm, m, i, j0, S, S);
      }
    }
    for (int ms = n_sub - 1; ms >= 0; --ms) {
      const int ts = tb + ms * SUB;
      stage<HD, true>(a, sm, in0, y0, ts);
      float Sb[SUB][CPT];       // the state before each step of the stage
      load_row<CPT>(sm.subck + (ms * kRows + ir) * C::kPitch + j0, Sb[0]);
#pragma unroll
      for (int m = 1; m < SUB; ++m)
        advance<HD, CPT>(sm, m - 1, i, j0, Sb[m - 1], Sb[m]);
#pragma unroll
      for (int m = SUB - 1; m >= 0; --m) {
        const float rr = sm.rs[m * HD + i], kk = sm.ks[m * HD + i];
        const float ww = sm.ws[m * HD + i];
        const float* vr = sm.vs + m * HD + j0;
        const float* dyr = sm.dys + m * HD + j0;
        float dr = 0.f, dk = 0.f, dw = 0.f, dvc[CPT];
#pragma unroll
        for (int e = 0; e < CPT; ++e) {
          dr = fmaf(dyr[e], Sb[m][e], dr);
          dk = fmaf(G[e], vr[e], dk);
          dw = fmaf(G[e], Sb[m][e], dw);
          dvc[e] = kk * G[e];
          G[e] = fmaf(ww, G[e], rr * dyr[e]);
        }
        float* rb = sm.rowbuf + (m * 3 * kGroups + cg) * kRows + ir;
        rb[0] = dr;
        rb[kGroups * kRows] = dk;
        rb[2 * kGroups * kRows] = dw;
        if (cg == 0) du = fmaf(rr * kk, sm.qv[m], du);
        int col = 0;
        xreduce<CPT, 16>(dvc, lane, col);
        if ((lane & (32 / CPT - 1)) == 0)
          sm.dvbuf[(m * C::kHalves + half) * HD + j0 + col] = dvc[0];
      }
      __syncthreads();
      // the sub-segment's rows: dr, dk, dw with their u terms
      for (int e = tid; e < SUB * kRows; e += kThreads) {
        const int m = e / kRows, r2 = e % kRows, t = ts + m;
        if (t >= a.seq) continue;
        const int i2 = r2;
        float s3[3];
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          const float* p = sm.rowbuf + ((m * 3 + q) * kGroups) * kRows + r2;
          float acc = p[0];
#pragma unroll
          for (int g = 1; g < kGroups; ++g) acc += p[g * kRows];
          s3[q] = acc;
        }
        const float uq = sm.us[i2] * sm.qv[m];
        const size_t off = in0 + static_cast<size_t>(t) * a.ss + i2;
        a.dr[off] = fmaf(uq, sm.ks[m * HD + i2], s3[0]);
        a.dk[off] = fmaf(uq, sm.rs[m * HD + i2], s3[1]);
        a.dw[off] = s3[2];
      }
      // ... and its columns: dv
      for (int e = tid; e < SUB * HD; e += kThreads) {
        const int m = e / HD, j = e % HD, t = ts + m;
        if (t >= a.seq) continue;
        float acc = sm.dvbuf[m * C::kHalves * HD + j];
#pragma unroll
        for (int hf = 1; hf < C::kHalves; ++hf)
          acc += sm.dvbuf[(m * C::kHalves + hf) * HD + j];
        acc = fmaf(sm.pv[m], sm.dys[m * HD + j], acc);
        a.dv[in0 + static_cast<size_t>(t) * a.ss + j] = acc;
      }
    }
  }
  store_row<CPT>(a.ds0 + state0, G);
  if (cg == 0) a.du_part[static_cast<size_t>(bh) * HD + i] = du;
}

// ---------------------------------------------------------------------------
// Chunked kernel (head sizes 64 and 128; see the note at the top)

constexpr int kL = 16;                  // steps a chunk
constexpr int kCThreads = 512;          // 16 warps: one a step in S2
constexpr int kCWarps = kCThreads / 32;

template <int HD_, int SLAB_>
struct CCfg {
  static constexpr int HD = HD_, SLAB = SLAB_;
  static constexpr int kLd = HD + 4, kLs = SLAB + 4;   // padded smem rows
  static constexpr int kParts = kCThreads / HD;        // rowdot partials
  // 16 x 8 tiles of the state (HD x SLAB) a warp holds side by side (S
  // in pass 1, G's update in pass 2)
  static constexpr int kStateTiles = HD / 16 * (SLAB / 8) / kCWarps;
  static_assert(HD % 32 == 0 && SLAB % 8 == 0 && HD % SLAB == 0, "shape");
  static_assert(kStateTiles * kCWarps == HD / 16 * (SLAB / 8)
                && (SLAB / 8) % kStateTiles == 0, "tiles");
};

template <class C>
struct CSmem {
  struct In {
    float rkw[3][kL][C::kLd];     // r, k, w of the chunk
    float vd[2][kL][C::kLs];      // v, dy: the slab's columns
    float sin[C::HD][C::kLs];     // the state before the chunk (pass 2)
  } in[2];
  float g[C::HD][C::kLs];         // G: gradient of the state after the chunk
  float sdy[kL][C::kLd];          // (S_in dy_t)_i over the slab
  float gv[kL][C::kLd];           // (G v_t)_i over the slab
  // operands of several products, split once into 3xTF32's (big, small)
  float2 dy2[kL][C::kLs];         // dy
  float2 v2[kL][C::kLs];          // v (both passes)
  float2 rp2[kL][C::kLd];         // r_t P_t
  float2 kq2[kL][C::kLd];         // k_t Q'_t (pass 1: k_s Q_s)
  float bm[kL][kL + 4];           // B[s][t] = v_s . dy_t over the slab
  float bmt[kL][kL + 4];          // its transpose
  float am[kL][kL + 1];           // A[t][s], s <= t
  float dup[kL][C::HD];           // r_t k_t B[t][t]
  float rdp[C::kParts][C::HD];    // partials of G_i . S_in_i
  float tot[2][C::HD];            // the chunk's decay (pass 1: two chunks)
  float u[C::HD];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   repro::smem_u32(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copies of chunk c into buffer ``in`` (pass 1: k, w, v; pass 2
// also r, dy and the chunk's checkpoint).  Steps past the sequence are
// stored directly: r = k = v = dy = 0 and w = 1, which leave S and G as
// they are and add nothing.
template <class C, bool kFull>
__device__ __forceinline__ void load_chunk(const Args& a,
                                           typename CSmem<C>::In& in, int c,
                                           size_t in0, size_t y0, int j0,
                                           const float* ck) {
  constexpr int HD = C::HD, SLAB = C::SLAB;
  for (int e = threadIdx.x; e < 3 * kL * HD / 4; e += kCThreads) {
    const int q = e / (kL * HD / 4), m = e / (HD / 4) % kL;
    const int col = 4 * (e % (HD / 4)), t = c * kL + m;
    if (!kFull && q == 0) continue;
    float* dst = &in.rkw[q][m][col];
    const float* src = q == 0 ? a.r : q == 1 ? a.k : a.w;
    if (t < a.seq) {
      cp_async16(dst, src + in0 + static_cast<size_t>(t) * a.ss + col);
    } else {
      const float f = q == 2 ? 1.f : 0.f;
      *reinterpret_cast<float4*>(dst) = make_float4(f, f, f, f);
    }
  }
  for (int e = threadIdx.x; e < 2 * kL * SLAB / 4; e += kCThreads) {
    const int q = e / (kL * SLAB / 4), m = e / (SLAB / 4) % kL;
    const int col = 4 * (e % (SLAB / 4)), t = c * kL + m;
    if (!kFull && q == 1) continue;
    float* dst = &in.vd[q][m][col];
    if (t < a.seq) {
      const float* src = q == 0
          ? a.v + in0 + static_cast<size_t>(t) * a.ss + j0 + col
          : a.dy + y0 + static_cast<size_t>(t) * a.ys + j0 + col;
      cp_async16(dst, src);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  if constexpr (kFull) {
    for (int e = threadIdx.x; e < HD * SLAB / 4; e += kCThreads) {
      const int i = e / (SLAB / 4), col = 4 * (e % (SLAB / 4));
      cp_async16(&in.sin[i][col], ck + i * SLAB + col);
    }
  }
  cp_async_commit();
}

// C (16 x 8 NT) += A (16 x K) B (K x 8 NT) in 3xTF32 as NT 16 x 8 tiles
// that share A's fragments, A(m, k) = fa(m, k), B(k, n) = fb(k, n); C
// takes each 8-deep step rounded to nearest.
template <int K, int NT, class FA, class FB>
__device__ __forceinline__ void mma_tiles(float (&c)[NT][4], const FA& fa,
                                          const FB& fb) {
  const int lane = threadIdx.x % 32, g = lane / 4, t4 = lane % 4;
#pragma unroll 2
  for (int k0 = 0; k0 < K; k0 += 8) {
    repro::Frag a;
    a.set(fa(g, k0 + t4), fa(g + 8, k0 + t4), fa(g, k0 + t4 + 4),
          fa(g + 8, k0 + t4 + 4));
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      repro::FragB b;
      b.set(fb(k0 + t4, 8 * nt + g), fb(k0 + t4 + 4, 8 * nt + g));
      repro::mma_3xtf32_rn(c[nt], a, b);
    }
  }
}

// One CTA: columns [j0, j0 + SLAB) of S and G for one (b, h), every chunk.
template <class C>
__global__ void __launch_bounds__(kCThreads, 1)
    wkv6_bwd_chunked_kernel(Args a) {
  constexpr int HD = C::HD, SLAB = C::SLAB, kSlabs = HD / SLAB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  CSmem<C>& sm = *reinterpret_cast<CSmem<C>*>(smem_raw);
  const int slab = blockIdx.x % kSlabs, bh = blockIdx.x / kSlabs;
  const int b = bh / a.n_heads, h = bh % a.n_heads, j0 = slab * SLAB;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n_ch = (a.seq + kL - 1) / kL;
  const size_t in0 = static_cast<size_t>(b) * a.sb
                     + static_cast<size_t>(h) * a.sh;
  const size_t y0 = static_cast<size_t>(b) * a.yb
                    + static_cast<size_t>(h) * a.yh;
  // this CTA's checkpoints: (n_ch, HD, SLAB)
  float* ck0 = a.ckpt + static_cast<size_t>(blockIdx.x) * n_ch * HD * SLAB;
  const auto ck = [&](int c) {
    return ck0 + static_cast<size_t>(c) * HD * SLAB;
  };
  const size_t state0 = static_cast<size_t>(bh) * HD * HD + j0;
  for (int i = tid; i < HD; i += kCThreads) sm.u[i] = a.u[h * HD + i];

  // pass 1: the state before every chunk, S <- tot S + (k Q)^T V.  Warp
  // w carries kStateTiles 16 x 8 tiles of the slab of S side by side:
  // rows i0 .. i0 + 16, columns j1 .. j1 + 8 kStateTiles (so do S4's
  // tiles of G).
  constexpr int kNT = C::kStateTiles, kWarpsARow = SLAB / 8 / kNT;
  const int i0w = 16 * (warp / kWarpsARow);
  const int j1w = 8 * kNT * (warp % kWarpsARow);
  float st[kNT][4];
#pragma unroll
  for (int q = 0; q < kNT; ++q) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[q][e] = a.s0[state0 + (i0w + g + 8 * (e / 2)) * HD + j1w + 8 * q
                      + 2 * t4 + e % 2];
  }
  // k_s Q_s and v of chunk data ``in`` split into buffer b (kq2 / rp2,
  // v2 / dy2: pass 2's arrays), and the chunk's decay into tot[b].  The
  // four threads of a quad take a channel's four 4-step quarters, each
  // its suffix products, then the products of the later quarters from
  // its neighbours.
  const auto prep = [&](const typename CSmem<C>::In& in, int buf) {
    float2(*kqb)[C::kLd] = buf ? sm.rp2 : sm.kq2;
    float2(*vb)[C::kLs] = buf ? sm.dy2 : sm.v2;
    for (int e = tid; e < 4 * HD; e += kCThreads) {   // whole warps
      const int i = e / 4, qq = e % 4;
      float qv = 1.f, kq[4];
#pragma unroll
      for (int m = 3; m >= 0; --m) {
        kq[m] = in.rkw[1][4 * qq + m][i] * qv;
        qv *= in.rkw[2][4 * qq + m][i];
      }
      float later = 1.f;
#pragma unroll
      for (int d = 1; d < 4; ++d) {
        const float tq = __shfl_sync(0xffffffffu, qv,
                                     (lane & ~3) | min(qq + d, 3));
        if (qq + d < 4) later *= tq;
      }
#pragma unroll
      for (int m = 0; m < 4; ++m)
        kqb[4 * qq + m][i] = repro::tf32_pair(kq[m] * later);
      if (qq == 0) sm.tot[buf][i] = qv * later;
    }
    for (int e = tid; e < kL * SLAB; e += kCThreads)
      vb[e / SLAB][e % SLAB] = repro::tf32_pair(in.vd[0][e / SLAB][e % SLAB]);
  };
  // One barrier a chunk: chunk c's product and chunk c + 1's decays in
  // one phase, chunk c + 2 loading meanwhile.
  load_chunk<C, false>(a, sm.in[0], 0, in0, y0, j0, nullptr);
  cp_async_wait<0>();
  __syncthreads();
  prep(sm.in[0], 0);
  if (n_ch > 1) load_chunk<C, false>(a, sm.in[1], 1, in0, y0, j0, nullptr);
  for (int c = 0; c < n_ch; ++c) {
#pragma unroll
    for (int q = 0; q < kNT; ++q) {
#pragma unroll
      for (int e = 0; e < 4; e += 2)
        *reinterpret_cast<float2*>(
            ck(c) + (i0w + g + 4 * e) * SLAB + j1w + 8 * q + 2 * t4) =
            make_float2(st[q][e], st[q][e + 1]);
    }
    if (c + 1 < n_ch) cp_async_wait<0>();
    __syncthreads();
    if (c + 2 < n_ch)
      load_chunk<C, false>(a, sm.in[c & 1], c + 2, in0, y0, j0, nullptr);
    const int b = c & 1;
    const float2(*kqb)[C::kLd] = b ? sm.rp2 : sm.kq2;
    const float2(*vb)[C::kLs] = b ? sm.dy2 : sm.v2;
#pragma unroll
    for (int q = 0; q < kNT; ++q) {
#pragma unroll
      for (int e = 0; e < 4; ++e) st[q][e] *= sm.tot[b][i0w + g + 8 * (e / 2)];
    }
    mma_tiles<kL, kNT>(st, [&](int m, int s) { return kqb[s][i0w + m]; },
                       [&](int s, int n) { return vb[s][j1w + n]; });
    if (c + 1 < n_ch) prep(sm.in[(c + 1) & 1], b ^ 1);
  }
  __syncthreads();

  // pass 2: the chunks in reverse
  for (int e = tid; e < HD * SLAB; e += kCThreads) {
    const int i = e / SLAB, j = e % SLAB;
    sm.g[i][j] = a.ds_fin ? a.ds_fin[state0 + i * HD + j] : 0.f;
  }
  float du = 0.f;                   // thread i < HD: channel i's du
  load_chunk<C, true>(a, sm.in[0], n_ch - 1, in0, y0, j0, ck(n_ch - 1));
  for (int c = n_ch - 1; c >= 0; --c) {
    const int buf = (n_ch - 1 - c) & 1, t0 = c * kL;
    typename CSmem<C>::In& in = sm.in[buf];
    if (c > 0) {
      load_chunk<C, true>(a, sm.in[buf ^ 1], c - 1, in0, y0, j0, ck(c - 1));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float(*r)[C::kLd] = in.rkw[0];
    const float(*k)[C::kLd] = in.rkw[1];
    const float(*w)[C::kLd] = in.rkw[2];
    for (int e = tid; e < kL * SLAB; e += kCThreads) {
      const int m = e / SLAB, j = e % SLAB;
      sm.v2[m][j] = repro::tf32_pair(in.vd[0][m][j]);
      sm.dy2[m][j] = repro::tf32_pair(in.vd[1][m][j]);
    }
    __syncthreads();

    // S1: S_in dy_t, G v_t (t x HD) and B (16 x 16), products over the
    // slab; G_i . S_in_i on the CUDA cores
    {
      // warps 0-7 S_in dy_t, 8-15 G v_t: HD / 64 tiles each; warps 0
      // and 8 also a tile of B
      constexpr int kNw = HD / 64;
      const int i0 = (warp % 8) * 8 * kNw;
      float acc[kNw][4] = {};
      if (warp < 8)
        mma_tiles<SLAB, kNw>(acc, [&](int m, int j) { return sm.dy2[m][j]; },
                             [&](int j, int n) { return in.sin[i0 + n][j]; });
      else
        mma_tiles<SLAB, kNw>(acc, [&](int m, int j) { return sm.v2[m][j]; },
                             [&](int j, int n) { return sm.g[i0 + n][j]; });
      float(*out)[C::kLd] = warp < 8 ? sm.sdy : sm.gv;
#pragma unroll
      for (int nt = 0; nt < kNw; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          out[g + 8 * (e / 2)][i0 + 8 * nt + 2 * t4 + e % 2] = acc[nt][e];
      }
      if (warp % 8 == 0) {             // B's columns 8 (warp / 8) ..
        const int s0 = warp;
        float bacc[1][4] = {};
        mma_tiles<SLAB, 1>(bacc, [&](int m, int j) { return sm.v2[m][j]; },
                           [&](int j, int n) { return sm.dy2[s0 + n][j]; });
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int sx = g + 8 * (e / 2), tx = s0 + 2 * t4 + e % 2;
          sm.bm[sx][tx] = bacc[0][e];
          sm.bmt[tx][sx] = bacc[0][e];
        }
      }
    }
    {
      const int i = tid % HD, part = tid / HD;
      constexpr int kCols = SLAB / C::kParts;
      float acc = 0.f;
#pragma unroll 8
      for (int j = part * kCols; j < (part + 1) * kCols; ++j)
        acc = fmaf(sm.g[i][j], in.sin[i][j], acc);
      sm.rdp[part][i] = acc;
    }
    __syncthreads();

    // S2: per step t and channel i, the decays inside the chunk by
    // running products (D_ts = prod_{s<tau<t} w, E_ts = prod_{t<tau<s} w),
    //   alpha_s = D_ts k_s (s < t),  beta_s = E_ts r_s (s > t),
    //   gamma_x = sum_s alpha_s B[s][x];
    //   dr = P_t (S_in dy_t) + gamma_t + u k_t B[t][t]
    //   dk = Q'_t (G v_t) + sum_s beta_s B[t][s] + u r_t B[t][t]
    //   dw = P_t Q'_t (G . S_in) + Q'_t sum_s alpha_s (G v_s)
    //        + P_t sum_s beta_s (S_in dy_s) + sum_s beta_s gamma_s
    //   A[t][s] = sum_i r_t alpha_s (s < t), A[t][t] = sum_i r_t u k_t.
    // Warp t owns step t, lane channels lane + 32 q.
    const int t = warp;
    float pa[kL];                   // A's row t, summed over the channels
#pragma unroll
    for (int s = 0; s < kL; ++s) pa[s] = 0.f;
#pragma unroll 1
    for (int q = 0; q < HD / 32; ++q) {
      const int i = lane + 32 * q;
      float rowdot = sm.rdp[0][i];
#pragma unroll
      for (int pq = 1; pq < C::kParts; ++pq) rowdot += sm.rdp[pq][i];
      const float ui = sm.u[i];
      {
        float alpha[kL], beta[kL], gam[kL];
        float dd = 1.f, ee = 1.f;
#pragma unroll
        for (int s = kL - 1; s >= 0; --s) {
          alpha[s] = s < t ? dd * k[s][i] : 0.f;
          if (s < t) dd *= w[s][i];
        }
#pragma unroll
        for (int s = 0; s < kL; ++s) {
          beta[s] = s > t ? ee * r[s][i] : 0.f;
          if (s > t) ee *= w[s][i];
        }
#pragma unroll
        for (int x = 0; x < kL; ++x) gam[x] = 0.f;
#pragma unroll
        for (int s = 0; s < kL - 1; ++s) {
          if (s < t) {                // warp-uniform, as below
#pragma unroll
            for (int x = 0; x < kL; x += 4) {
              if (x + 3 <= t) continue;      // gamma_x is read for x > t
              const float4 bq = *reinterpret_cast<const float4*>(&sm.bm[s][x]);
              gam[x] = fmaf(alpha[s], bq.x, gam[x]);
              gam[x + 1] = fmaf(alpha[s], bq.y, gam[x + 1]);
              gam[x + 2] = fmaf(alpha[s], bq.z, gam[x + 2]);
              gam[x + 3] = fmaf(alpha[s], bq.w, gam[x + 3]);
            }
          }
        }
        float dri = 0.f, dki = 0.f, w_a = 0.f, w_b = 0.f, w_g = 0.f;
        const float rt = r[t][i], kt = k[t][i];
#pragma unroll
        for (int s = 0; s < kL; s += 4) {
          const float4 bc = *reinterpret_cast<const float4*>(&sm.bmt[t][s]);
          const float4 br = *reinterpret_cast<const float4*>(&sm.bm[t][s]);
          const float bcs[4] = {bc.x, bc.y, bc.z, bc.w};
          const float brs[4] = {br.x, br.y, br.z, br.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int x = s + e;
            dri = fmaf(alpha[x], bcs[e], dri);
            dki = fmaf(beta[x], brs[e], dki);
            w_a = fmaf(alpha[x], sm.gv[x][i], w_a);
            w_b = fmaf(beta[x], sm.sdy[x][i], w_b);
            w_g = fmaf(beta[x], gam[x], w_g);
          }
        }
#pragma unroll
        for (int x = 0; x < kL; ++x)
          pa[x] = fmaf(rt, x == t ? ui * kt : alpha[x], pa[x]);
        const float btt = sm.bm[t][t], uq = ui * btt;
        const float drv = fmaf(dd, sm.sdy[t][i], dri) + uq * kt;
        const float dkv = fmaf(ee, sm.gv[t][i], dki) + uq * rt;
        const float dwv = dd * ee * rowdot + ee * w_a + dd * w_b + w_g;
        sm.rp2[t][i] = repro::tf32_pair(rt * dd);
        sm.kq2[t][i] = repro::tf32_pair(kt * ee);
        sm.dup[t][i] = rt * kt * btt;
        if (t == kL - 1) sm.tot[0][i] = dd * w[t][i];
        if (t0 + t < a.seq) {
          if constexpr (kSlabs == 1) {
            const size_t off = in0 + static_cast<size_t>(t0 + t) * a.ss + i;
            a.dr[off] = drv;
            a.dk[off] = dkv;
            a.dw[off] = dwv;
          } else {
            const size_t n = static_cast<size_t>(gridDim.x / kSlabs) * a.seq
                             * HD;
            float* pp = a.part + slab * 3 * n
                        + (static_cast<size_t>(bh) * a.seq + t0 + t) * HD + i;
            pp[0] = drv;
            pp[n] = dkv;
            pp[2 * n] = dwv;
          }
        }
      }
    }
    repro::halve<8>(pa, 16, lane);
    repro::halve<4>(pa, 8, lane);
    repro::halve<2>(pa, 4, lane);
    repro::halve<1>(pa, 2, lane);
    pa[0] += __shfl_xor_sync(0xffffffffu, pa[0], 1);
    if (lane % 2 == 0) sm.am[t][lane / 2] = pa[0];
    __syncthreads();

    // S3: dv (16 x SLAB) = (k Q') G + A^T dy, complete within the slab;
    // du's steps added in order
    for (int q = warp; q < SLAB / 8; q += kCWarps) {
      const int jt = 8 * q;
      float acc[1][4] = {};
      mma_tiles<HD, 1>(acc, [&](int m, int i) { return sm.kq2[m][i]; },
                       [&](int i, int n) { return sm.g[i][jt + n]; });
      mma_tiles<kL, 1>(acc, [&](int m, int s) { return sm.am[s][m]; },
                       [&](int s, int n) { return sm.dy2[s][jt + n]; });
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int t = t0 + g + 4 * e;
        if (t < a.seq)
          *reinterpret_cast<float2*>(
              a.dv + in0 + static_cast<size_t>(t) * a.ss + j0 + jt + 2 * t4) =
              make_float2(acc[0][e], acc[0][e + 1]);
      }
    }
    for (int i = tid; i < HD; i += kCThreads) {
#pragma unroll
      for (int t = 0; t < kL; ++t) du += sm.dup[t][i];
    }
    __syncthreads();

    // S4: G <- tot G + (r P)^T dy, each element by the thread that holds
    // it in the product
    {
      float acc[kNT][4];
#pragma unroll
      for (int q = 0; q < kNT; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = i0w + g + 8 * (e / 2);
          acc[q][e] = sm.tot[0][i] * sm.g[i][j1w + 8 * q + 2 * t4 + e % 2];
        }
      }
      mma_tiles<kL, kNT>(
          acc, [&](int m, int s) { return sm.rp2[s][i0w + m]; },
          [&](int s, int n) { return sm.dy2[s][j1w + n]; });
#pragma unroll
      for (int q = 0; q < kNT; ++q) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sm.g[i0w + g + 8 * (e / 2)][j1w + 8 * q + 2 * t4 + e % 2] =
              acc[q][e];
      }
    }
    __syncthreads();
  }
  for (int e = tid; e < HD * SLAB; e += kCThreads) {
    const int i = e / SLAB, j = e % SLAB;
    a.ds0[state0 + i * HD + j] = sm.g[i][j];
  }
  for (int i = tid; i < HD; i += kCThreads)
    a.du_part[static_cast<size_t>(blockIdx.x) * HD + i] = du;
}

// dr, dk, dw = the slabs' partials added in order, written through r's
// strides
__global__ void wkv6_bwd_slab_sum_kernel(const float* __restrict__ part,
                                         float* dr, float* dk, float* dw,
                                         int n_heads, int seq, int hd,
                                         int slabs, long long sb,
                                         long long sh, long long ss) {
  const size_t n = static_cast<size_t>(gridDim.y) * seq * hd;  // one output
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x;
  if (e >= static_cast<size_t>(seq) * hd) return;
  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int t = static_cast<int>(e / hd), i = static_cast<int>(e % hd);
  const size_t src = static_cast<size_t>(bh) * seq * hd + e;
  const size_t dst = static_cast<size_t>(b) * sb + static_cast<size_t>(h) * sh
                     + static_cast<size_t>(t) * ss + i;
  float* outs[3] = {dr, dk, dw};
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    float acc = part[q * n + src];
    for (int s = 1; s < slabs; ++s) acc += part[(s * 3 + q) * n + src];
    outs[q][dst] = acc;
  }
}

template <class C>
int launch_chunked(Args a, int batch, cudaStream_t st) {
  constexpr int kSlabs = C::HD / C::SLAB;
  const size_t smem = sizeof(CSmem<C>);
  auto kern = wkv6_bwd_chunked_kernel<C>;
  static unsigned smem_set = 0;
  cudaError_t err = repro::set_smem_once(kern, static_cast<int>(smem),
                                         &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bh = batch * a.n_heads;
  kern<<<bh * kSlabs, kCThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || kSlabs == 1) return static_cast<int>(err);
  const dim3 grid((a.seq * C::HD + 255) / 256, bh);
  wkv6_bwd_slab_sum_kernel<<<grid, 256, 0, st>>>(
      a.part, a.dr, a.dk, a.dw, a.n_heads, a.seq, C::HD, kSlabs, a.sb, a.sh,
      a.ss);
  return static_cast<int>(cudaGetLastError());
}

// du (H, hd) = the partials (B, H, slabs, hd), added in order
__global__ void wkv6_bwd_du_kernel(const float* __restrict__ part,
                                   float* __restrict__ du, int batch,
                                   int n_heads, int slabs, int hd) {
  const int h = blockIdx.x, i = threadIdx.x;
  float acc = 0.f;
  for (int b = 0; b < batch; ++b) {
    for (int s = 0; s < slabs; ++s)
      acc += part[((static_cast<size_t>(b) * n_heads + h) * slabs + s) * hd
                  + i];
  }
  du[h * hd + i] = acc;
}

template <int HD>
int launch_serial(Args a, int batch, cudaStream_t st) {
  using C = Cfg<HD>;
  const size_t smem = C::kSmemBytes;
  static unsigned smem_set = 0;
  cudaError_t err = repro::set_smem_once(wkv6_bwd_kernel<HD>,
                                         static_cast<int>(smem), &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv6_bwd_kernel<HD><<<batch * a.n_heads, C::kThreads, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The spacing of the checkpoints at head size hd (0 for a head size the
// kernels do not take): the serial kernel's kSeg, or a chunk.  The caller
// sizes the checkpoint scratch by it.
extern "C" int wkv6_bwd_seg(int hd) {
  return hd == 32 ? Cfg<32>::kSeg : hd == 64 || hd == 128 ? kL : 0;
}

// r/k/v/w (B, H, S, hd) f32 through strides (sb, sh, ss) with a
// contiguous last dim, 16-byte aligned with strides that are multiples
// of 4 at hd 64 and 128 (the wrapper checks); dy through (yb, yh, ys);
// u (H, hd); s0 and ds_fin (B, H, hd, hd) contiguous, ds_fin may be null.
// dr/dk/dv/dw are written through r's strides; du (H, hd), ds0 (B, H,
// hd, hd).  slab: the columns of S a CTA owns (hd 32: 32; hd 64: 64 or
// 32; hd 128: 32).  Scratch: ckpt of B * H * n_seg * hd * hd f32 with
// n_seg = ceil(S / wkv6_bwd_seg(hd)) (another n_seg is refused), du_part
// (B, H, hd / slab, hd) f32, and with more than one slab part (hd / slab,
// 3, B, H, S, hd) f32 (else null).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        const void* dy, const void* ds_fin, void* dr,
                        void* dk, void* dv, void* dw, void* du, void* ds0,
                        void* ckpt, void* du_part, void* part, int batch,
                        int n_heads, int seq, int hd, int slab, int n_seg,
                        long long sb, long long sh, long long ss,
                        long long yb, long long yh, long long ys,
                        void* stream) {
  if (batch <= 0 || n_heads <= 0 || seq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int seg = wkv6_bwd_seg(hd);
  if (seg == 0 || n_seg != (seq + seg - 1) / seg || hd % slab != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (hd / slab > 1 && part == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{};
  a.r = static_cast<const float*>(r);
  a.k = static_cast<const float*>(k);
  a.v = static_cast<const float*>(v);
  a.w = static_cast<const float*>(w);
  a.u = static_cast<const float*>(u);
  a.s0 = static_cast<const float*>(s0);
  a.dy = static_cast<const float*>(dy);
  a.ds_fin = static_cast<const float*>(ds_fin);
  a.dr = static_cast<float*>(dr);
  a.dk = static_cast<float*>(dk);
  a.dv = static_cast<float*>(dv);
  a.dw = static_cast<float*>(dw);
  a.du_part = static_cast<float*>(du_part);
  a.ds0 = static_cast<float*>(ds0);
  a.ckpt = static_cast<float*>(ckpt);
  a.part = static_cast<float*>(part);
  a.n_heads = n_heads;
  a.seq = seq;
  a.n_seg = n_seg;
  a.sb = sb; a.sh = sh; a.ss = ss;
  a.yb = yb; a.yh = yh; a.ys = ys;
  auto st = static_cast<cudaStream_t>(stream);
  int rc;
  if (hd == 32 && slab == 32)
    rc = launch_serial<32>(a, batch, st);
  else if (hd == 64 && slab == 64)
    rc = launch_chunked<CCfg<64, 64>>(a, batch, st);
  else if (hd == 64 && slab == 32)
    rc = launch_chunked<CCfg<64, 32>>(a, batch, st);
  else if (hd == 128 && slab == 32)
    rc = launch_chunked<CCfg<128, 32>>(a, batch, st);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  wkv6_bwd_du_kernel<<<n_heads, hd, 0, st>>>(
      static_cast<const float*>(du_part), static_cast<float*>(du), batch,
      n_heads, hd / slab, hd);
  return static_cast<int>(cudaGetLastError());
}
