// RG-LRU time recurrence for Hopper (sm_90a), alone or with its gates.
//
// Replaces the TPU kernel src/repro/kernels/rglru_scan.py::rglru_scan
// (pallas_call at line 49, body _kernel at lines 21-31): over a/g
// (B, S, W) f32 and h0 (B, W) f32, h_t = a_t * h_{t-1} + g_t elementwise
// over the W channels, returning every state h_all (B, S, W) f32 (the
// state stack that speculative rollback selects from).
//
// The fused entry also computes the gates that the JAX package leaves to
// XLA around the scan (src/repro/models/rglru.py:97-103), from the two
// products xa = x @ w_a and xi = x @ w_i (f32, cuBLAS), the conv output
// x (f32 or bf16), the f32 biases and a_param:
//   r = sigmoid(xa + b_a),  i = sigmoid(xi + b_i),
//   log a = -8 softplus(a_param) r,  a = exp(log a),
//   g = sqrt(clip(1 - exp(2 log a), 1e-6, 1)) (i x),
// in registers, so a and g never reach memory and some 14 elementwise
// launches a layer and call become one.
//
// Bound on this card: bytes.  Each element is read twice (a, g; the fused
// entry: xa, xi, x), written once (h) and costs one fused multiply-add
// (with the gates 22 operations: 2 bias adds, 2 sigmoids of 4 (negate,
// exp, add, divide), 4 multiplies, 2 exps, a subtract, a clamp of 2, a
// sqrt and the FMA as 2): far under the ~20 operations per byte the H100 needs in f32 to be
// compute-bound.  The dependence is only along time.
//
// Two kernels, chosen by the wrapper from the step count alone:
// - Serial (verify and decode, S <= 16): one thread per (b, channel)
//   walks the steps with h in a register, the gates of kPrefetch steps
//   formed before their chain of FMAs so the loads overlap.  A verify
//   thus rounds step by step as the S = 1 decode does.
// - Time-parallel (prefill, S > 16): a serial walk at batch 1 puts 2560
//   threads on the card, each waiting out 512 dependent steps.  Here a
//   CTA owns kQuads x V channels (V = 4: 16-byte loads along W) and a
//   tile of kTile = 512 steps cut into kSegs = 128 segments of 4 steps,
//   one thread a (segment, channel group), kQuads = 2 groups a CTA.
//   Each thread forms its segment's gates and composes
//   the segment into (prod a, h from 0); a shuffle scan composes the
//   segments of a warp, the warps' totals meet in shared memory, and each
//   thread re-walks its segment from its carry, h = a h + g, so every
//   stored state is one FMA from the last as in the serial kernel.  The
//   last segment's state carries into the next tile.  prod a may
//   underflow to 0, which is exact enough: nothing divides by it.  At
//   batch 1 and W = 2560 that is 320 CTAs of 256 threads.
#include "common.cuh"
#include "rglru.cuh"

namespace {

constexpr int kThreads = 128;       // serial kernel
constexpr int kPrefetch = 8;

// What a step reads: a and g as given (the TPU kernel's inputs), or the
// gates' inputs with the conv output x in f32 or bf16.  The kernels take
// the kind as a template argument, so -Xptxas -v names each instantiation.
enum Input { kGiven = 0, kGatesF32 = 1, kGatesBF16 = 2 };

struct Inputs {
  const float* a;
  const float* g;
  const float* xa;
  const float* xi;
  const void* x;
  const float* b_a;
  const float* b_i;
  const float* a_param;
};

// (a, g) of V channels at element offset ``off``; per-channel constants
// are read once, when a thread takes its channels.
template <int V, int IN>
struct Step {
  Inputs p;
  float ba[V], bi[V], ca[V];
  __device__ Step(const Inputs& in, int c) : p(in) {
    if constexpr (IN != kGiven) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        ba[v] = p.b_a[c + v];
        bi[v] = p.b_i[c + v];
        ca[v] = -8.f * softplus(p.a_param[c + v]);
      }
    }
  }
  __device__ void operator()(size_t off, float (&a)[V], float (&g)[V]) const {
    if constexpr (IN == kGiven) {
      load_vec<V>(p.a + off, a);
      load_vec<V>(p.g + off, g);
    } else {
      float xa[V], xi[V], x[V];
      load_vec<V>(p.xa + off, xa);
      load_vec<V>(p.xi + off, xi);
      if constexpr (IN == kGatesBF16)
        load_vec<V>(static_cast<const __nv_bfloat16*>(p.x) + off, x);
      else
        load_vec<V>(static_cast<const float*>(p.x) + off, x);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float r = sigmoid(xa[v] + ba[v]);
        const float i = sigmoid(xi[v] + bi[v]);
        const float log_a = ca[v] * r;
        a[v] = expf(log_a);
        const float gate = fminf(fmaxf(1.f - expf(2.f * log_a), 1e-6f), 1.f);
        g[v] = sqrtf(gate) * (i * x[v]);
      }
    }
  }
};

template <int IN>
__global__ void __launch_bounds__(kThreads) rglru_serial_kernel(
    Inputs args, const float* __restrict__ h0,
    float* __restrict__ out, int seq, int width) {
  const int b = blockIdx.y;
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= width) return;
  const Step<1, IN> step(args, c);
  const size_t base = static_cast<size_t>(b) * seq * width + c;
  float h = h0[static_cast<size_t>(b) * width + c];
  for (int t0 = 0; t0 < seq; t0 += kPrefetch) {
    float av[kPrefetch][1], gv[kPrefetch][1];
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      if (t0 + i < seq) {
        step(base + static_cast<size_t>(t0 + i) * width, av[i], gv[i]);
      } else {
        av[i][0] = 1.f;
        gv[i][0] = 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < kPrefetch; ++i) {
      if (t0 + i < seq) {
        h = fmaf(av[i][0], h, gv[i][0]);
        out[base + static_cast<size_t>(t0 + i) * width] = h;
      }
    }
  }
}

template <int V, int IN>
__global__ void __launch_bounds__(kPThreads) rglru_parallel_kernel(
    Inputs args, const float* __restrict__ h0,
    float* __restrict__ out, int seq, int width) {
  __shared__ float carry[2][kQuads][V];             // by tile parity
  __shared__ float warp_a[kWarps][kQuads][V], warp_h[kWarps][kQuads][V];
  const int b = blockIdx.y, tid = threadIdx.x;
  const int q = tid % kQuads, seg = tid / kQuads;
  const int lane = tid % 32, warp = tid / 32, sw = lane / kQuads;
  const int c = (blockIdx.x * kQuads + q) * V;
  const bool live = c < width;          // the wrapper makes W % V == 0
  const Step<V, IN> step(args, live ? c : 0);
  if (seg == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v)
      carry[0][q][v] = live ? h0[static_cast<size_t>(b) * width + c + v] : 0.f;
  }
  __syncthreads();

  const size_t base = static_cast<size_t>(b) * seq * width + c;
  const int n_tiles = (seq + kTile - 1) / kTile;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t_seg = tile * kTile + seg * kSegSteps;
    float a[kSegSteps][V], g[kSegSteps][V];
#pragma unroll
    for (int k = 0; k < kSegSteps; ++k) {
      if (live && t_seg + k < seq) {
        step(base + static_cast<size_t>(t_seg + k) * width, a[k], g[k]);
      } else {
#pragma unroll
        for (int v = 0; v < V; ++v) { a[k][v] = 1.f; g[k][v] = 0.f; }
      }
    }
    // the segment alone: h = A h_in + H
    float A[V], H[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      A[v] = 1.f;
      H[v] = 0.f;
#pragma unroll
      for (int k = 0; k < kSegSteps; ++k) {
        H[v] = fmaf(a[k][v], H[v], g[k][v]);
        A[v] *= a[k][v];
      }
    }
    // inclusive scan over the warp's segments (lanes kQuads apart)
#pragma unroll
    for (int d = 1; d < kSegsPerWarp; d *= 2) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float Ap = __shfl_up_sync(0xffffffffu, A[v], d * kQuads);
        const float Hp = __shfl_up_sync(0xffffffffu, H[v], d * kQuads);
        if (sw >= d) {
          H[v] = fmaf(A[v], Hp, H[v]);
          A[v] *= Ap;
        }
      }
    }
    if (sw == kSegsPerWarp - 1) {
#pragma unroll
      for (int v = 0; v < V; ++v) {
        warp_a[warp][q][v] = A[v];
        warp_h[warp][q][v] = H[v];
      }
    }
    __syncthreads();
    // this segment's incoming state: the tile's carry through the earlier
    // warps, then the earlier segments of this warp
    float h[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
      h[v] = carry[tile & 1][q][v];
      for (int w = 0; w < warp; ++w)
        h[v] = fmaf(warp_a[w][q][v], h[v], warp_h[w][q][v]);
      const float Ae = __shfl_up_sync(0xffffffffu, A[v], kQuads);
      const float He = __shfl_up_sync(0xffffffffu, H[v], kQuads);
      if (sw > 0) h[v] = fmaf(Ae, h[v], He);
    }
#pragma unroll
    for (int k = 0; k < kSegSteps; ++k) {
#pragma unroll
      for (int v = 0; v < V; ++v) h[v] = fmaf(a[k][v], h[v], g[k][v]);
      if (live && t_seg + k < seq)
        store_vec<V>(out + base + static_cast<size_t>(t_seg + k) * width, h);
    }
    if (seg == kSegs - 1) {
#pragma unroll
      for (int v = 0; v < V; ++v) carry[(tile + 1) & 1][q][v] = h[v];
    }
    __syncthreads();
  }
}

template <int IN>
int launch(const Inputs& args, const void* h0, void* out, int batch, int seq,
           int width, int parallel, int vec, cudaStream_t stream) {
  if (batch <= 0 || seq <= 0 || width <= 0 || (vec != 1 && vec != 4)
      || width % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* h0p = static_cast<const float*>(h0);
  float* outp = static_cast<float*>(out);
  if (!parallel) {
    const dim3 grid((width + kThreads - 1) / kThreads, batch);
    rglru_serial_kernel<IN><<<grid, kThreads, 0, stream>>>(args, h0p, outp,
                                                           seq, width);
  } else if (vec == 4) {
    const dim3 grid((width + 4 * kQuads - 1) / (4 * kQuads), batch);
    rglru_parallel_kernel<4, IN><<<grid, kPThreads, 0, stream>>>(
        args, h0p, outp, seq, width);
  } else {
    const dim3 grid((width + kQuads - 1) / kQuads, batch);
    rglru_parallel_kernel<1, IN><<<grid, kPThreads, 0, stream>>>(
        args, h0p, outp, seq, width);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The TPU kernel's counterpart: a, g (B, S, W) f32.  ``parallel`` picks
// the time-parallel kernel (the wrapper sets it for S > 16), ``vec`` its
// channels a thread (4 needs W % 4 == 0 and 16-byte aligned tensors).
extern "C" int rglru_scan(const void* a, const void* g, const void* h0,
                          void* out, int batch, int seq, int width,
                          int parallel, int vec, void* stream) {
  Inputs args{};
  args.a = static_cast<const float*>(a);
  args.g = static_cast<const float*>(g);
  return launch<kGiven>(args, h0, out, batch, seq, width, parallel, vec,
                        static_cast<cudaStream_t>(stream));
}

// The gates fused in: xa, xi (B, S, W) f32; x (B, S, W) of ``x_dtype``
// (repro::kF32 or repro::kBF16); b_a, b_i, a_param (W,) f32.
extern "C" int rglru_gated_scan(const void* xa, const void* xi,
                                const void* x, const void* b_a,
                                const void* b_i, const void* a_param,
                                const void* h0, void* out, int batch,
                                int seq, int width, int x_dtype,
                                int parallel, int vec, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  Inputs args{};
  args.xa = static_cast<const float*>(xa);
  args.xi = static_cast<const float*>(xi);
  args.x = x;
  args.b_a = static_cast<const float*>(b_a);
  args.b_i = static_cast<const float*>(b_i);
  args.a_param = static_cast<const float*>(a_param);
  switch (x_dtype) {
    case repro::kF32:
      return launch<kGatesF32>(args, h0, out, batch, seq, width, parallel,
                               vec, st);
    case repro::kBF16:
      return launch<kGatesBF16>(args, h0, out, batch, seq, width, parallel,
                                vec, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
