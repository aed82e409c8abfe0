// Backward of the RG-LRU with its gates for Hopper (sm_90a).
//
// No TPU kernel has this function: the JAX package differentiates its
// lax.scan and the gates around it (src/repro/models/rglru.py:88-116).
// The forward is rglru_scan.cu's fused entry rglru_gated_scan (the
// counterpart of src/repro/kernels/rglru_scan.py::rglru_scan with the
// gates of rglru.py:97-103): from xa = x @ w_a, xi = x @ w_i (f32), the
// conv output x (f32 or bf16) and b_a, b_i, a_param (W,) f32,
//   r = sigmoid(xa + b_a),  i = sigmoid(xi + b_i),
//   log a = c r with c = -8 softplus(a_param),  a = exp(log a),
//   g = sqrt(clip(1 - exp(2 log a), 1e-6, 1)) (i x),
//   h_t = a_t h_{t-1} + g_t.
// Given dh = dL/dh_all (B, S, W), the state's gradient runs backwards,
//   dH_t = dh_t + a_{t+1} dH_{t+1},
// and with h_{-1} = h0, per element
//   dlog a_t = dH_t h_{t-1} a_t - 2 exp(2 log a_t) dm_t,
//   dm_t = [1e-6 <= 1 - exp(2 log a_t) <= 1] dH_t i_t x_t / (2 sqrt(m_t)),
//   dxa = dlog a c r (1 - r),  dxi = dH sqrt(m) x i (1 - i),
//   dx = dH sqrt(m) i  (in x's dtype),  dh0 = a_0 dH_0,
// and per channel the sums over (B, S) of dxa (db_a), dxi (db_i) and
// dlog a r, which times -8 sigmoid(a_param) is da_param
// (kernels/ref.py::rglru_gated_scan_bwd_ref is the plain version).
//
// Bound on this card: bytes.  Each element reads xa, xi, x, h_all and dh
// and writes dxa, dxi and dx: ~0.6 GB at RecurrentGemma-2B's training
// shape (B 2, S 4096, W 2560), ~0.19 ms at 3.35 TB/s, against some 40
// f32 operations an element (the gates again, their derivatives, the
// scan's FMA).
//
// The reverse scan is the forward's linear recurrence run backwards with
// the decay shifted by one step, so it reuses the forward's
// time-parallel body (rglru.cuh's layout): a CTA owns kQuads x V
// channels (V = 4: 16-byte loads along W) of one sequence and walks its
// tiles of kTile = 512 steps from the last to the first; in a tile,
// segment 0 is the latest kSegSteps = 4 steps and segment kSegs - 1 the
// earliest.  Each thread composes its segment, walked backwards, into
// (prod a, dH from 0); a shuffle scan composes the segments of a warp,
// the warps' totals meet in shared memory, and each thread re-walks its
// segment from its carry, so dH_t is one FMA from dH_{t+1} as in a
// serial walk.  The earliest segment's dH carries into the tile before.
// A thread forms the decay a_{t+1} of the step after each of its steps
// itself (one extra xa load a segment).  It then recomputes the gates of
// each step and writes the three per-element gradients.
//
// The (W,) sums, without atomics and in a fixed order: each thread adds
// its steps' terms over every tile; the CTA adds its 128 segment
// threads (warp shuffles, then the warps in order in shared memory) into
// one partial a (sequence, channel); rglru_bwd_sum_kernel then adds the
// batch in order and applies softplus' derivative.
#include <type_traits>

#include "common.cuh"
#include "rglru.cuh"

namespace {

struct Args {
  const float* xa;
  const float* xi;
  const void* x;
  const float* b_a;
  const float* b_i;
  const float* a_param;
  const float* h0;
  const float* h_all;
  const float* dh;
  float* dxa;
  float* dxi;
  void* dx;
  float* dh0;
  float* part;              // (B, 3, W): db_a, db_i, d(c) partials
};

template <int V, bool kBF16>
__global__ void __launch_bounds__(kPThreads) rglru_bwd_kernel(
    Args p, int seq, int width) {
  using XT = typename std::conditional<kBF16, __nv_bfloat16, float>::type;
  __shared__ float carry[2][kQuads][V];             // by tile parity
  __shared__ float warp_a[kWarps][kQuads][V], warp_h[kWarps][kQuads][V];
  __shared__ float warp_sum[kWarps][kQuads][3][V];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int q = tid % kQuads, seg = tid / kQuads;
  const int lane = tid % 32, warp = tid / 32, sw = lane / kQuads;
  const int c = (blockIdx.x * kQuads + q) * V;
  const bool live = c < width;          // the wrapper makes W % V == 0
  const int cc = live ? c : 0;
  const XT* x = static_cast<const XT*>(p.x);
  XT* dx = static_cast<XT*>(p.dx);
  float ba[V], bi[V], ca[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    ba[v] = p.b_a[cc + v];
    bi[v] = p.b_i[cc + v];
    ca[v] = -8.f * softplus(p.a_param[cc + v]);
  }
  if (seg == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) carry[0][q][v] = 0.f;
  }
  __syncthreads();

  const size_t base = static_cast<size_t>(b) * seq * width + c;
  auto at = [&](int t) { return base + static_cast<size_t>(t) * width; };
  float acc_ba[V], acc_bi[V], acc_c[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc_ba[v] = acc_bi[v] = acc_c[v] = 0.f;

  const int n_tiles = (seq + kTile - 1) / kTile;
  for (int k = 0; k < n_tiles; ++k) {
    const int tile = n_tiles - 1 - k;
    const int t_seg = tile * kTile + (kSegs - 1 - seg) * kSegSteps;
    // step s of the segment: dH_t = A[s] dH_{t+1} + D[s], A[s] = a_{t+1}
    // (1 from the last step on, where dH_{t+1} is 0)
    float A[kSegSteps][V], D[kSegSteps][V];
#pragma unroll
    for (int s = 0; s < kSegSteps; ++s) {
      const int t = t_seg + s;
      if (live && t + 1 < seq) {
        float xa[V];
        load_vec<V>(p.xa + at(t + 1), xa);
#pragma unroll
        for (int v = 0; v < V; ++v)
          A[s][v] = expf(ca[v] * sigmoid(xa[v] + ba[v]));
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) A[s][v] = 1.f;
      }
      if (live && t < seq) {
        load_vec<V>(p.dh + at(t), D[s]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) D[s][v] = 0.f;
      }
    }
    // the segment alone, last step first: dH_first = Ap dH_in + Hs
    float Ap[V], Hs[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      Ap[v] = 1.f;
      Hs[v] = 0.f;
#pragma unroll
      for (int s = kSegSteps - 1; s >= 0; --s) {
        Hs[v] = fmaf(A[s][v], Hs[v], D[s][v]);
        Ap[v] *= A[s][v];
      }
    }
    // inclusive scan over the warp's segments (later ones first)
#pragma unroll
    for (int d = 1; d < kSegsPerWarp; d *= 2) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float Apr = __shfl_up_sync(0xffffffffu, Ap[v], d * kQuads);
        const float Hpr = __shfl_up_sync(0xffffffffu, Hs[v], d * kQuads);
        if (sw >= d) {
          Hs[v] = fmaf(Ap[v], Hpr, Hs[v]);
          Ap[v] *= Apr;
        }
      }
    }
    if (sw == kSegsPerWarp - 1) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        warp_a[warp][q][v] = Ap[v];
        warp_h[warp][q][v] = Hs[v];
      }
    }
    __syncthreads();
    // dH after this segment's last step: the carry through the earlier
    // warps, then the earlier segments of this warp
    float X[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      X[v] = carry[k & 1][q][v];
      for (int w = 0; w < warp; ++w)
        X[v] = fmaf(warp_a[w][q][v], X[v], warp_h[w][q][v]);
      const float Ae = __shfl_up_sync(0xffffffffu, Ap[v], kQuads);
      const float He = __shfl_up_sync(0xffffffffu, Hs[v], kQuads);
      if (sw > 0) X[v] = fmaf(Ae, X[v], He);
    }
#pragma unroll
    for (int s = kSegSteps - 1; s >= 0; --s) {
#pragma unroll
      for (int v = 0; v < V; ++v) X[v] = fmaf(A[s][v], X[v], D[s][v]);
      const int t = t_seg + s;
      if (!live || t >= seq) continue;
      float xa[V], xi[V], xv[V], hp[V];
      load_vec<V>(p.xa + at(t), xa);
      load_vec<V>(p.xi + at(t), xi);
      load_vec<V>(x + at(t), xv);
      if (t > 0) {
        load_vec<V>(p.h_all + at(t - 1), hp);
      } else {
        load_vec<V>(p.h0 + static_cast<size_t>(b) * width + c, hp);
      }
      float gxa[V], gxi[V], gx[V], a0[V];
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float r = sigmoid(xa[v] + ba[v]);
        const float i = sigmoid(xi[v] + bi[v]);
        const float log_a = ca[v] * r;
        const float a = expf(log_a);
        const float e2 = expf(2.f * log_a);
        const float m = 1.f - e2;
        const float sq = sqrtf(fminf(fmaxf(m, 1e-6f), 1.f));
        const float dH = X[v];
        gx[v] = dH * sq * i;
        gxi[v] = dH * sq * xv[v] * i * (1.f - i);
        const float dm = (m >= 1e-6f && m <= 1.f)
                             ? dH * i * xv[v] / (2.f * sq) : 0.f;
        const float dlog = dH * hp[v] * a - 2.f * e2 * dm;
        gxa[v] = dlog * ca[v] * r * (1.f - r);
        acc_ba[v] += gxa[v];
        acc_bi[v] += gxi[v];
        acc_c[v] = fmaf(dlog, r, acc_c[v]);
        a0[v] = a * dH;
      }
      store_vec<V>(p.dxa + at(t), gxa);
      store_vec<V>(p.dxi + at(t), gxi);
      store_vec<V>(dx + at(t), gx);
      if (t == 0) store_vec<V>(p.dh0 + static_cast<size_t>(b) * width + c, a0);
    }
    if (seg == kSegs - 1) {
#pragma unroll
      for (int v = 0; v < V; ++v) carry[(k + 1) & 1][q][v] = X[v];
    }
    __syncthreads();
  }

  // the CTA's per-channel sums: the warp's 16 segments, then the warps
  auto warp_total = [&](const float (&acc)[V], int j) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float s = acc[v];
#pragma unroll
      for (int off = kQuads; off < 32; off *= 2)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if (sw == 0) warp_sum[warp][q][j][v] = s;
    }
  };
  warp_total(acc_ba, 0);
  warp_total(acc_bi, 1);
  warp_total(acc_c, 2);
  __syncthreads();
  if (seg == 0 && live) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        float s = warp_sum[0][q][j][v];
        for (int w = 1; w < kWarps; ++w) s += warp_sum[w][q][j][v];
        p.part[(static_cast<size_t>(b) * 3 + j) * width + c + v] = s;
      }
    }
  }
}

// db_a, db_i, da_param (W,): the sequences' partials added in order
__global__ void rglru_bwd_sum_kernel(const float* __restrict__ part,
                                     const float* __restrict__ a_param,
                                     float* __restrict__ db_a,
                                     float* __restrict__ db_i,
                                     float* __restrict__ da_param,
                                     int batch, int width) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  float s[3] = {0.f, 0.f, 0.f};
  for (int b = 0; b < batch; ++b) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      s[j] += part[(static_cast<size_t>(b) * 3 + j) * width + c];
  }
  db_a[c] = s[0];
  db_i[c] = s[1];
  da_param[c] = s[2] * -8.f * sigmoid(a_param[c]);
}

template <bool kBF16>
int launch(const Args& args, float* db_a, float* db_i, float* da_param,
           int batch, int seq, int width, int vec, cudaStream_t st) {
  if (vec == 4) {
    const dim3 grid((width + 4 * kQuads - 1) / (4 * kQuads), batch);
    rglru_bwd_kernel<4, kBF16><<<grid, kPThreads, 0, st>>>(args, seq, width);
  } else {
    const dim3 grid((width + kQuads - 1) / kQuads, batch);
    rglru_bwd_kernel<1, kBF16><<<grid, kPThreads, 0, st>>>(args, seq, width);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rglru_bwd_sum_kernel<<<(width + 255) / 256, 256, 0, st>>>(
      args.part, args.a_param, db_a, db_i, da_param, batch, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xa, xi, h_all, dh (B, S, W) f32; x (B, S, W) of ``x_dtype`` (repro::kF32
// or repro::kBF16); b_a, b_i, a_param (W,) f32; h0 (B, W) f32; all
// contiguous.  Writes dxa, dxi (f32) and dx (x's dtype) (B, S, W), dh0
// (B, W), db_a, db_i, da_param (W,); part is (B, 3, W) f32 scratch.
// ``vec`` 4 needs W % 4 == 0 and every tensor 4-element aligned.
extern "C" int rglru_gated_scan_bwd(
    const void* xa, const void* xi, const void* x, const void* b_a,
    const void* b_i, const void* a_param, const void* h0, const void* h_all,
    const void* dh, void* dxa, void* dxi, void* dx, void* dh0, void* db_a,
    void* db_i, void* da_param, void* part, int batch, int seq, int width,
    int x_dtype, int vec, void* stream) {
  if (batch <= 0 || seq <= 0 || width <= 0 || (vec != 1 && vec != 4)
      || width % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args args{};
  args.xa = static_cast<const float*>(xa);
  args.xi = static_cast<const float*>(xi);
  args.x = x;
  args.b_a = static_cast<const float*>(b_a);
  args.b_i = static_cast<const float*>(b_i);
  args.a_param = static_cast<const float*>(a_param);
  args.h0 = static_cast<const float*>(h0);
  args.h_all = static_cast<const float*>(h_all);
  args.dh = static_cast<const float*>(dh);
  args.dxa = static_cast<float*>(dxa);
  args.dxi = static_cast<float*>(dxi);
  args.dx = dx;
  args.dh0 = static_cast<float*>(dh0);
  args.part = static_cast<float*>(part);
  auto st = static_cast<cudaStream_t>(stream);
  auto f = [](void* q) { return static_cast<float*>(q); };
  switch (x_dtype) {
    case repro::kF32:
      return launch<false>(args, f(db_a), f(db_i), f(da_param), batch, seq,
                           width, vec, st);
    case repro::kBF16:
      return launch<true>(args, f(db_a), f(db_i), f(da_param), batch, seq,
                          width, vec, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
