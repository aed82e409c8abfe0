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
// ~26 GFLOP, ~0.39 ms at 67 TFLOP/s outside the tensor cores.  This
// kernel is serial in time on the CUDA cores (a later redesign can take
// the chunked form of the forward onto the tensor cores).
//
// Both recurrences are separable by entry: S_t[i,j] needs only w_t[i],
// k_t[i], v_t[j]; G_{t-1}[i,j] only w_t[i], r_t[i], dy_t[j].  So a CTA of
// 8 x kRows threads owns kRows = min(64, hd) rows of one (b, head) and
// all hd columns (the whole head at hd 64: B*H = 128 CTAs at the
// training shape; two row slabs at hd 128), with no reduction across
// CTAs for dr, dk, dw, du.  Thread (row ir = tid % kRows, column group
// c = tid / kRows) holds the entries (ir, c*CPT .. c*CPT + CPT) of S and
// of G in registers (CPT = hd / 8).
//
// S_{t-1} is never rebuilt from S_t by dividing by w_t (a decay can be
// 0, or underflow).  States are re-formed forward from checkpoints, as
// JAX's segments do, on three levels:
//   pass A walks the sequence forward from s0 and writes the state at
//     every kSeg-th step to a scratch buffer (B, H, ceil(S/kSeg), hd, hd)
//     f32 in device memory (each thread reads back only what it wrote);
//   pass B walks the segments in reverse: from a segment's checkpoint it
//     writes the state at every kSub-th step into shared memory (kSeg /
//     kSub sub-checkpoints, rows padded by 4 floats so that the float4
//     reads of a warp's 32 rows hit distinct banks), then walks the
//     sub-segments in reverse, re-forms each one's kSub per-step states
//     in registers (CPT x kSub = 64 floats a thread) and runs the
//     reverse recurrence over them.
// hd 64: CPT 8, kSub 8, kSeg 64 (8 sub-checkpoints of 17 KB);
// hd 128: CPT 16, kSub 4, kSeg 16 (4 of 33 KB).  ~200 / ~175 KB of shared
// memory, one CTA an SM.  (hd 32, the training launcher's reduced
// config: 256 threads, CPT 4, kSub 16, kSeg 128.)
//
// Reductions, all in a fixed order (no atomics; the bits do not depend
// on the order in which CTAs run):
// - over j (dr, dk, dw): each thread sums its CPT columns, writes the
//   partial to shared memory, and after the sub-segment the 8 column
//   groups are added in order; the u terms need v_t . dy_t, which one
//   warp a step forms while the step's inputs are staged;
// - over i (dv): a reduce-scatter by shuffles over the warp's 32 rows
//   (CPT values in, each lane out with one column's sum), then the two
//   warps of a column group (kRows / 32 of them) added in shared memory, plus
//   (r_t . (u * k_t)) dy_t (again one warp's dot product a step); at hd
//   128 each row slab writes its partial and a second kernel adds the
//   two in order;
// - du: the column-group-0 thread of each row sums r k (v . dy) over the
//   steps; a last kernel adds the batch in order.
//
// Inputs r/k/v/w (and the outputs dr/dk/dv/dw) are addressed through
// one set of (batch, head, step) strides and dy through its own, each
// with a contiguous last dimension, so the model's transposed
// (B, S, H, hd) views are read and written without copies.
#include "common.cuh"

namespace {

constexpr int kGroups = 8;              // column groups

template <int HD>
struct Cfg {
  static constexpr int kRows = HD < 64 ? HD : 64;     // rows a CTA owns
  static constexpr int kThreads = kGroups * kRows;
  static constexpr int kHalves = kRows / 32;          // warps a group
  static constexpr int kCols = HD / kGroups;          // columns a thread
  static constexpr int kSub = 64 / kCols;             // register states
  static constexpr int kNSub = HD == 128 ? 4 : 8;     // sub-checkpoints
  static constexpr int kSeg = kSub * kNSub;           // checkpoint spacing
  static constexpr int kSlabs = HD / kRows;
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
  float* dv;                // hd 64: dv itself; hd 128: per-slab partials
  float* dw;
  float* du_part;           // (B, H, hd)
  float* ds0;
  float* ckpt;              // (B, H, n_seg, hd, hd)
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
  const int bh = blockIdx.x / C::kSlabs, slab = blockIdx.x % C::kSlabs;
  const int b = bh / a.n_heads, h = bh % a.n_heads;
  const int tid = threadIdx.x, ir = tid % kRows, cg = tid / kRows;
  const int i = slab * kRows + ir, j0 = cg * CPT;
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
        const int i2 = slab * kRows + r2;
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
      // ... and its columns: dv (at hd 128 this slab's partial)
      for (int e = tid; e < SUB * HD; e += kThreads) {
        const int m = e / HD, j = e % HD, t = ts + m;
        if (t >= a.seq) continue;
        float acc = sm.dvbuf[m * C::kHalves * HD + j];
#pragma unroll
        for (int hf = 1; hf < C::kHalves; ++hf)
          acc += sm.dvbuf[(m * C::kHalves + hf) * HD + j];
        if (slab == 0) acc = fmaf(sm.pv[m], sm.dys[m * HD + j], acc);
        if constexpr (C::kSlabs == 1) {
          a.dv[in0 + static_cast<size_t>(t) * a.ss + j] = acc;
        } else {
          a.dv[((static_cast<size_t>(slab) * gridDim.x / C::kSlabs + bh)
                * a.seq + t) * HD + j] = acc;
        }
      }
    }
  }
  store_row<CPT>(a.ds0 + state0, G);
  if (cg == 0) a.du_part[static_cast<size_t>(bh) * HD + i] = du;
}

// hd 128: dv = the two row slabs' partials, added in order
__global__ void wkv6_bwd_dv_kernel(const float* __restrict__ part,
                                   float* __restrict__ dv, int n_heads,
                                   int seq, int hd, int slabs,
                                   long long sb, long long sh,
                                   long long ss) {
  const size_t n = static_cast<size_t>(gridDim.y) * seq * hd;  // one slab
  const size_t e = static_cast<size_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x;
  const size_t per_bh = static_cast<size_t>(seq) * hd;
  if (e >= per_bh) return;
  const int bh = blockIdx.y, b = bh / n_heads, h = bh % n_heads;
  const int t = static_cast<int>(e / hd), j = static_cast<int>(e % hd);
  float acc = part[bh * per_bh + e];
  for (int s = 1; s < slabs; ++s) acc += part[s * n + bh * per_bh + e];
  dv[static_cast<size_t>(b) * sb + static_cast<size_t>(h) * sh
     + static_cast<size_t>(t) * ss + j] = acc;
}

// du (H, hd) = the batch's partials (B, H, hd), added in order
__global__ void wkv6_bwd_du_kernel(const float* __restrict__ part,
                                   float* __restrict__ du, int batch,
                                   int n_heads, int hd) {
  const int h = blockIdx.x, i = threadIdx.x;
  float acc = 0.f;
  for (int b = 0; b < batch; ++b)
    acc += part[(static_cast<size_t>(b) * n_heads + h) * hd + i];
  du[h * hd + i] = acc;
}

template <int HD>
int launch(Args a, float* du, float* dv_out, int batch, cudaStream_t st) {
  using C = Cfg<HD>;
  const size_t smem = C::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_bwd_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int bh = batch * a.n_heads;
  wkv6_bwd_kernel<HD><<<bh * C::kSlabs, C::kThreads, smem, st>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if constexpr (C::kSlabs > 1) {
    const dim3 grid((a.seq * HD + 255) / 256, bh);
    wkv6_bwd_dv_kernel<<<grid, 256, 0, st>>>(a.dv, dv_out, a.n_heads, a.seq,
                                            HD, C::kSlabs, a.sb, a.sh, a.ss);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  wkv6_bwd_du_kernel<<<a.n_heads, HD, 0, st>>>(a.du_part, du, batch,
                                               a.n_heads, HD);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// r/k/v/w (B, H, S, hd) f32 through strides (sb, sh, ss) with a
// contiguous last dim; dy through (yb, yh, ys); u (H, hd); s0 and ds_fin
// (B, H, hd, hd) contiguous, ds_fin may be null.  dr/dk/dv/dw are written
// through r's strides; du (H, hd), ds0 (B, H, hd, hd).  Scratch: ckpt
// (B, H, n_seg, hd, hd) f32 with n_seg = ceil(S / kSeg) (kSeg as
// wkv6_bwd_seg reports it; another n_seg is refused), du_part (B, H, hd) f32, and at
// hd 128 dv_part (2, B, H, S, hd) f32 (null at hd 32 and 64).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v,
                        const void* w, const void* u, const void* s0,
                        const void* dy, const void* ds_fin, void* dr,
                        void* dk, void* dv, void* dw, void* du, void* ds0,
                        void* ckpt, void* du_part, void* dv_part, int batch,
                        int n_heads, int seq, int hd, int n_seg, long long sb,
                        long long sh, long long ss, long long yb,
                        long long yh, long long ys, void* stream) {
  if (batch <= 0 || n_heads <= 0 || seq <= 0)
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
  a.dw = static_cast<float*>(dw);
  a.du_part = static_cast<float*>(du_part);
  a.ds0 = static_cast<float*>(ds0);
  a.ckpt = static_cast<float*>(ckpt);
  a.n_heads = n_heads;
  a.seq = seq;
  a.n_seg = n_seg;
  a.sb = sb; a.sh = sh; a.ss = ss;
  a.yb = yb; a.yh = yh; a.ys = ys;
  auto st = static_cast<cudaStream_t>(stream);
  if (hd == 32) {
    if (n_seg != (seq + Cfg<32>::kSeg - 1) / Cfg<32>::kSeg)
      return static_cast<int>(cudaErrorInvalidValue);
    a.dv = static_cast<float*>(dv);
    return launch<32>(a, static_cast<float*>(du), nullptr, batch, st);
  }
  if (hd == 64) {
    if (n_seg != (seq + Cfg<64>::kSeg - 1) / Cfg<64>::kSeg)
      return static_cast<int>(cudaErrorInvalidValue);
    a.dv = static_cast<float*>(dv);
    return launch<64>(a, static_cast<float*>(du), nullptr, batch, st);
  }
  if (hd == 128) {
    if (dv_part == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    if (n_seg != (seq + Cfg<128>::kSeg - 1) / Cfg<128>::kSeg)
      return static_cast<int>(cudaErrorInvalidValue);
    a.dv = static_cast<float*>(dv_part);
    return launch<128>(a, static_cast<float*>(du), static_cast<float*>(dv),
                       batch, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// kSeg at head size hd (0 for a head size the kernel does not take): the
// caller sizes the checkpoint scratch by it.
extern "C" int wkv6_bwd_seg(int hd) {
  return hd == 32 ? Cfg<32>::kSeg : hd == 64 ? Cfg<64>::kSeg
                                  : hd == 128 ? Cfg<128>::kSeg : 0;
}
