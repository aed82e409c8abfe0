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
// and writes dxa, dxi and dx: 28 bytes with x in bf16, 0.59 GB at
// RecurrentGemma-2B's training shape (B 2, S 4096, W 2560), 0.175 ms at
// 3.35 TB/s, against 52 f32 operations an element on the chunked route
// (counted from the source below, an exp, an expm1, a sqrt, a reciprocal
// or a division as one: the decay of the next step and the composition
// of the scan, 9; the second walk's step, both gates, their derivatives
// and the three sums, 43), 1.1 GFLOP, 0.016 ms at 67 TFLOP/s.
//
// The chunked route (rglru_bwd_chunked_kernel; every width whose rows
// are a multiple of 16 bytes, so that TMA can load them).  Time is cut
// into chunks of T = kChunkSteps steps (88 with x in bf16, 64 in f32:
// the fastest of the lengths 64-128 timed at RecurrentGemma-2B's
// training shape, within a few percent of the next) and the channels
// into slabs of kSlab = 32: one 128-byte row of f32 a step.  A CTA of 8
// warps takes one (sequence, slab, chunk); lane = channel, warp w the
// w-th run of T / 8 steps.
//  1. An atomic ticket hands out the work in reverse time order, chunk
//     major: the latest chunk of every (sequence, slab) first.  A CTA
//     then only ever waits on a chunk whose CTA took an earlier ticket,
//     so it is running or done: no deadlock, whatever order the card
//     starts CTAs in.  The ticket decides placement, never a value.  The
//     CTA that draws the last ticket zeroes it for the next call.
//  2. One thread stages the chunk's tiles in shared memory by TMA from
//     3-D tensor maps over (W, S, B): xa (T + 1 rows: the next chunk's
//     first row gives the decay of the chunk's last step) and dh on one
//     mbarrier, xi, x and h_{t-1} on a second.  Rows past S load as
//     zeros, and a zero xa is no decay of 1, so steps past the end are
//     masked to A = 1, D = 0.  The tiles stay resident through the wait
//     below, so xa crosses the link once.  The bytes in flight come from
//     the CTAs an SM holds (kChunkBlocks: 4 of 52 KB at T 88 with x in
//     bf16, 5 of 42 KB at T 64 in f32), one CTA's copies running under
//     the others' arithmetic; longer chunks (3 CTAs of 74 KB at T 128)
//     or a persistent CTA that prefetches its next chunk into a second
//     stage (T 64) were slower.
//  3. Each warp composes its run, last step first, into (prod A, dH from
//     0) as soon as xa and dh have landed; warp 0 composes the 8 runs
//     into the chunk's (prod A, dH from 0), waits for the inclusive
//     carry dH_{t0 + T} of the chunk after it in time (ld.acquire.gpu on
//     a 64-bit word that holds the value and its flag), and at once
//     publishes its own, dH_{t0} (st.relaxed.gpu of the same kind of
//     word: value and flag cannot be seen apart).  The carry into a
//     chunk depends only on the chunk after it, so the bits are the
//     same from call to call.  Each word is written once and read once,
//     and its reader zeroes it, so the state is zero again after every
//     call and one buffer serves a stream's calls with no memset.
//  4. Each warp composes the runs after its own onto the carry, then
//     re-walks its run from there (dH_t one FMA from dH_{t+1}, as in a
//     serial walk), recomputes the gates of each step from the tiles and
//     writes dxa, dxi, dx: a warp stores whole 128-byte rows (64 bytes
//     of bf16 dx, two whole sectors).
//  5. The (W,) sums, without float atomics and in a fixed order: each
//     thread adds its run's terms, the 8 warps are added in order into
//     one partial a (sequence, chunk, channel); the slab's last CTA to
//     finish (an integer count, after a fence) adds the B x n_chunks
//     partials in a fixed order and applies softplus' derivative, so
//     the route is one launch.  dh0 comes from the chunk that holds
//     t = 0.  The gates take the fast exponential and reciprocal.
//
// The sequence route (rglru_bwd_kernel; widths whose rows TMA cannot
// take, such as 102, chosen by the wrapper from the shape): the
// forward's time-parallel layout (rglru.cuh) run in reverse.  A CTA owns
// kQuads x V channels (V = 4: 16-byte loads along W, where W % 4 == 0)
// of one sequence and walks its tiles of kTile = 512 steps from the
// last to the first; in a tile, segment 0 is the latest kSegSteps = 4
// steps.  Each thread composes its segment, walked backwards, into
// (prod a, dH from 0); a shuffle scan composes the segments of a warp,
// the warps' totals meet in shared memory, and each thread re-walks its
// segment from its carry.  The earliest segment's dH carries into the
// tile before.  The sums as above, with one partial a sequence.
#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
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
  float* db_a;
  float* db_i;
  float* da_param;
  float* part;              // (rows, 3, W): db_a, db_i, d(c) partials
  unsigned long long* sync; // chunked route: zero between calls (below)
};

// ---------------------------------------------------------------------------
// the chunked route

constexpr int kSlab = 32;                 // channels a CTA: lane = channel
constexpr int kCWarps = 8;                // runs of T / 8 steps
constexpr int kCThreads = 32 * kCWarps;
// T, the steps of a chunk, by x's dtype (the wrapper's BWD_CHUNK mirrors
// it to size the scratch; keep the two in step)
template <bool kBF16>
constexpr int kChunkSteps = kBF16 ? 88 : 64;

// xa, dh, xi, h_all and x as (W, S, B) tensor maps (innermost first): one
// copy brings a chunk's rows of one slab
struct ChunkMaps {
  CUtensorMap xa, dh, xi, h, x;
};

template <int T, bool kBF16>
struct ChunkSmem {
  using XT = typename std::conditional<kBF16, __nv_bfloat16, float>::type;
  float xa[T + 1][kSlab];   // steps t0 .. t0 + T
  float dh[T][kSlab];       // steps t0 .. (the warps' sums at the end)
  float xi[T][kSlab];
  float h[T][kSlab];        // h_all from step max(t0 - 1, 0)
  XT x[T][kSlab];
  float run_a[kCWarps][kSlab], run_h[kCWarps][kSlab];   // (prod A, dH)
  float carry[kSlab];       // dH_{t0 + T}
  uint64_t bar[2];          // xa + dh; xi + h + x
  int item, last;
};

// CTAs an SM: as many as its 228 KB of shared memory hold (1 KB of each
// reserved), at most 5 (51 registers a thread)
template <int T, bool kBF16>
constexpr int kChunkFit = (228 * 1024) / (sizeof(ChunkSmem<T, kBF16>) + 1024);
template <int T, bool kBF16>
constexpr int kChunkBlocks = kChunkFit<T, kBF16> < 5 ? kChunkFit<T, kBF16> : 5;

// The gates' sigmoid and exponential on the fast paths (ex2.approx with a
// multiply, a rounded reciprocal): a relative error of a few 1e-7 at the
// gates' arguments, against 1e-4 of each output's largest magnitude
// allowed.
__device__ __forceinline__ float fast_sigmoid(float z) {
  return __frcp_rn(1.f + __expf(-z));
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// The carry a chunk waits for: a word whose high half flags the value in
// its low half.  A carry that never comes (a broken ticket order) traps
// after 5 s instead of holding the card.
__device__ __forceinline__ float wait_carry(const unsigned long long* p) {
  unsigned long long w;
  const uint64_t t0 = global_ns();
  for (;;) {
    asm volatile("ld.acquire.gpu.global.b64 %0, [%1];\n"
                 : "=l"(w) : "l"(p) : "memory");
    if (w >> 32) break;
    if (global_ns() - t0 > 5000000000ull) __trap();
  }
  return __uint_as_float(static_cast<unsigned>(w));
}

// The value and its flag travel in one aligned 64-bit word, which a
// gpu-scope access reads or writes whole, and the word is all the reader
// takes from the writer: a relaxed store suffices, and no release fence
// waits on the writer's earlier accesses.
__device__ __forceinline__ void publish_carry(unsigned long long* p,
                                              float v) {
  const unsigned long long w = (1ull << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.b64 [%0], %1;\n" ::"l"(p), "l"(w)
               : "memory");
}

template <int T, bool kBF16>
__global__ void __launch_bounds__(kCThreads, kChunkBlocks<T, kBF16>)
rglru_bwd_chunked_kernel(
    const __grid_constant__ ChunkMaps maps, Args p, int batch, int seq,
    int width) {
  using Smem = ChunkSmem<T, kBF16>;
  using XT = typename Smem::XT;
  constexpr int L = T / kCWarps;          // steps a run
  static_assert(T % kCWarps == 0 && T + 1 <= 256, "TMA box rows");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_slabs = (width + kSlab - 1) / kSlab;
  const int n_chunks = (seq + T - 1) / T;
  const int per_chunk = batch * n_slabs;
  const int rows = batch * n_chunks;       // partials a slab
  unsigned* ticket = reinterpret_cast<unsigned*>(p.sync);
  unsigned long long* done = p.sync + 1;   // CTAs of each slab finished
  unsigned long long* words = p.sync + 1 + n_slabs;
  if (tid == 0) {
    sm.item = static_cast<int>(atomicAdd(ticket, 1u));
    // every ticket is drawn: zero for the next call
    if (sm.item == rows * n_slabs - 1) atomicExch(ticket, 0u);
    repro::bar_init(&sm.bar[0], 1);
    repro::bar_init(&sm.bar[1], 1);
    repro::bar_init_fence();
  }
  __syncthreads();
  const int item = sm.item;
  const int chunk = n_chunks - 1 - item / per_chunk;
  const int b = item % per_chunk / n_slabs, slab = item % n_slabs;
  const int t0 = chunk * T, c = slab * kSlab + lane;
  const int h_row0 = t0 > 0 ? t0 - 1 : 0;
  if (tid == 0) {
    repro::bar_expect_tx(&sm.bar[0], sizeof(sm.xa) + sizeof(sm.dh));
    repro::tma_load_3d(sm.xa, &maps.xa, &sm.bar[0], slab * kSlab, t0, b);
    repro::tma_load_3d(sm.dh, &maps.dh, &sm.bar[0], slab * kSlab, t0, b);
    repro::bar_expect_tx(&sm.bar[1],
                         sizeof(sm.xi) + sizeof(sm.h) + sizeof(sm.x));
    repro::tma_load_3d(sm.xi, &maps.xi, &sm.bar[1], slab * kSlab, t0, b);
    repro::tma_load_3d(sm.h, &maps.h, &sm.bar[1], slab * kSlab, h_row0, b);
    repro::tma_load_3d(sm.x, &maps.x, &sm.bar[1], slab * kSlab, t0, b);
  }
  const bool live = c < width;
  const float ba = live ? p.b_a[c] : 0.f;
  const float bi = live ? p.b_i[c] : 0.f;
  const float ca = live ? -8.f * softplus(p.a_param[c]) : 0.f;
  // the decay a_t of local step j (1 past the end)
  auto decay = [&](int j) {
    return t0 + j < seq ? __expf(ca * fast_sigmoid(sm.xa[j][lane] + ba))
                        : 1.f;
  };
  const int lo = warp * L, top = min(lo + L, seq - t0);   // steps [lo, top)

  // 3. this run alone, last step first: dH_lo = A_run dH_top + H_run
  repro::bar_wait(&sm.bar[0], 0);
  {
    float Ar = 1.f, Hr = 0.f;
    for (int j = top - 1; j >= lo; --j) {
      const float A = decay(j + 1);
      Hr = fmaf(A, Hr, sm.dh[j][lane]);
      Ar *= A;
    }
    sm.run_a[warp][lane] = Ar;
    sm.run_h[warp][lane] = Hr;
  }
  __syncthreads();
  if (warp == 0) {
    float Ac = 1.f, Hc = 0.f;
#pragma unroll
    for (int w = kCWarps - 1; w >= 0; --w) {
      Hc = fmaf(sm.run_a[w][lane], Hc, sm.run_h[w][lane]);
      Ac *= sm.run_a[w][lane];
    }
    // word (b, chunk, slab, lane); each is published once and read once,
    // and its reader zeroes it for the next call
    unsigned long long* mine =
        words + (static_cast<size_t>(b) * n_chunks * n_slabs + slab) * kSlab
        + lane;
    const size_t per_chunk_words = static_cast<size_t>(n_slabs) * kSlab;
    float in = 0.f;
    unsigned long long* next = mine + (chunk + 1) * per_chunk_words;
    if (chunk + 1 < n_chunks) in = wait_carry(next);
    if (chunk > 0)
      publish_carry(mine + chunk * per_chunk_words, fmaf(Ac, in, Hc));
    if (chunk + 1 < n_chunks) *next = 0ull;
    sm.carry[lane] = in;
  }
  __syncthreads();

  // 4. dH after this run's last step, then the run re-walked
  float X = sm.carry[lane];
  for (int w = kCWarps - 1; w > warp; --w)
    X = fmaf(sm.run_a[w][lane], X, sm.run_h[w][lane]);
  repro::bar_wait(&sm.bar[1], 0);
  const size_t base = static_cast<size_t>(b) * seq * width + c;
  XT* dx = static_cast<XT*>(p.dx);
  float A = decay(top);
  float acc_ba = 0.f, acc_bi = 0.f, acc_c = 0.f;
  for (int j = top - 1; j >= lo; --j) {
    const int t = t0 + j;
    X = fmaf(A, X, sm.dh[j][lane]);
    const float r = fast_sigmoid(sm.xa[j][lane] + ba);
    const float i = fast_sigmoid(sm.xi[j][lane] + bi);
    const float log_a = ca * r;
    const float a = __expf(log_a);
    // 1 - a^2 without the cancellation of 1 - exp(2 log a), which costs
    // its relative accuracy where a decay is near 1 and m small
    const float m = -expm1f(2.f * log_a);
    const float e2 = 1.f - m;
    const float sq = sqrtf(fminf(fmaxf(m, 1e-6f), 1.f));
    float xv;
    if constexpr (kBF16) {
      xv = __bfloat162float(sm.x[j][lane]);
    } else {
      xv = sm.x[j][lane];
    }
    const float hp = t > 0 ? sm.h[t - 1 - h_row0][lane]
                           : (live ? p.h0[static_cast<size_t>(b) * width + c]
                                   : 0.f);
    const float gx = X * sq * i;
    const float gxi = gx * xv * (1.f - i);
    const float dm = (m >= 1e-6f && m <= 1.f)
                         ? __fdividef(X * i * xv, 2.f * sq) : 0.f;
    const float dlog = X * hp * a - 2.f * e2 * dm;
    const float gxa = dlog * ca * r * (1.f - r);
    acc_ba += gxa;
    acc_bi += gxi;
    acc_c = fmaf(dlog, r, acc_c);
    if (live) {
      const size_t at = base + static_cast<size_t>(t) * width;
      p.dxa[at] = gxa;
      p.dxi[at] = gxi;
      if constexpr (kBF16) {
        dx[at] = __float2bfloat16(gx);
      } else {
        dx[at] = gx;
      }
      if (t == 0) p.dh0[static_cast<size_t>(b) * width + c] = a * X;
    }
    A = a;
  }

  // 5. the warps' sums in order, into this (sequence, chunk)'s partials
  __syncthreads();                        // every warp is done with dh
  float(*sums)[3][kSlab] = reinterpret_cast<float(*)[3][kSlab]>(sm.dh);
  sums[warp][0][lane] = acc_ba;
  sums[warp][1][lane] = acc_bi;
  sums[warp][2][lane] = acc_c;
  __syncthreads();
  if (warp < 3 && live) {
    float s = sums[0][warp][lane];
#pragma unroll
    for (int w = 1; w < kCWarps; ++w) s += sums[w][warp][lane];
    p.part[(static_cast<size_t>(b * n_chunks + chunk) * 3 + warp) * width
           + c] = s;
  }
  // the slab's last CTA to finish adds its rows partials, in order: warp
  // w the rows w, w + 8, ..., then the warps in order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    sm.last = atomicAdd(done + slab, 1ull) == static_cast<unsigned long long>(
        rows - 1);
    if (sm.last) done[slab] = 0ull;       // for the next call
  }
  __syncthreads();
  if (!sm.last) return;
  __threadfence();
  float tot[3] = {0.f, 0.f, 0.f};
  if (live) {
    for (int r = warp; r < rows; r += kCWarps) {
#pragma unroll
      for (int q = 0; q < 3; ++q)
        tot[q] += __ldcg(p.part + (static_cast<size_t>(r) * 3 + q) * width
                         + c);
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 3; ++q) sums[warp][q][lane] = tot[q];
  __syncthreads();
  if (warp < 3 && live) {
    float s = sums[0][warp][lane];
#pragma unroll
    for (int w = 1; w < kCWarps; ++w) s += sums[w][warp][lane];
    if (warp == 0) p.db_a[c] = s;
    if (warp == 1) p.db_i[c] = s;
    if (warp == 2) p.da_param[c] = s * -8.f * sigmoid(p.a_param[c]);
  }
}

// ---------------------------------------------------------------------------
// the sequence route

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

// the sequence route's db_a, db_i, da_param (W,): the partial rows added
// in order
__global__ void rglru_bwd_sum_kernel(const float* __restrict__ part,
                                     const float* __restrict__ a_param,
                                     float* __restrict__ db_a,
                                     float* __restrict__ db_i,
                                     float* __restrict__ da_param,
                                     int rows, int width) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= width) return;
  float s[3] = {0.f, 0.f, 0.f};
  for (int r = 0; r < rows; ++r) {
#pragma unroll
    for (int j = 0; j < 3; ++j)
      s[j] += part[(static_cast<size_t>(r) * 3 + j) * width + c];
  }
  db_a[c] = s[0];
  db_i[c] = s[1];
  da_param[c] = s[2] * -8.f * sigmoid(a_param[c]);
}

template <int T, bool kBF16>
int launch_chunked(const Args& args, int batch, int seq, int width,
                   cudaStream_t st) {
  // (W, S, B), innermost first; rows must be a multiple of 16 bytes
  const uint64_t dims[3] = {static_cast<uint64_t>(width),
                            static_cast<uint64_t>(seq),
                            static_cast<uint64_t>(batch)};
  const auto make = [&](CUtensorMap* map, const void* base, int rows,
                        bool bf16) {
    const uint64_t el = bf16 ? 2 : 4;
    const uint64_t strides[2] = {width * el, static_cast<uint64_t>(seq)
                                                 * width * el};
    const uint32_t box[3] = {kSlab, static_cast<uint32_t>(rows), 1};
    return repro::make_map(map, base, 3, dims, strides, box,
                           bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                           CU_TENSOR_MAP_SWIZZLE_NONE);
  };
  ChunkMaps maps;
  if (!make(&maps.xa, args.xa, T + 1, false) ||
      !make(&maps.dh, args.dh, T, false) ||
      !make(&maps.xi, args.xi, T, false) ||
      !make(&maps.h, args.h_all, T, false) ||
      !make(&maps.x, args.x, T, kBF16))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(ChunkSmem<T, kBF16>);
  auto kern = rglru_bwd_chunked_kernel<T, kBF16>;
  static unsigned smem_set = 0;
  const cudaError_t err = repro::set_smem_once(kern, static_cast<int>(smem),
                                               &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_slabs = (width + kSlab - 1) / kSlab;
  const int n_chunks = (seq + T - 1) / T;
  kern<<<n_chunks * batch * n_slabs, kCThreads, smem, st>>>(maps, args, batch,
                                                            seq, width);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBF16>
int launch(const Args& args, int batch, int seq, int width, int vec,
           int chunked, cudaStream_t st) {
  if (chunked)
    return launch_chunked<kChunkSteps<kBF16>, kBF16>(args, batch, seq, width,
                                                     st);
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
      args.part, args.a_param, args.db_a, args.db_i, args.da_param, batch,
      width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xa, xi, h_all, dh (B, S, W) f32; x (B, S, W) of ``x_dtype`` (repro::kF32
// or repro::kBF16); b_a, b_i, a_param (W,) f32; h0 (B, W) f32; all
// contiguous.  Writes dxa, dxi (f32) and dx (x's dtype) (B, S, W), dh0
// (B, W), db_a, db_i, da_param (W,).
// ``chunked`` 1 takes the chunked route, in chunks of T = kChunkSteps
// steps (88 with x in bf16, 64 in f32): xa, xi, x, h_all and dh 16-byte
// aligned with rows of a multiple of 16 bytes; ``part`` is
// (B ceil(S / T), 3, W) f32 scratch and ``sync`` at least
// 1 + n_slabs (1 + B ceil(S / T) 32) 64-bit words with
// n_slabs = ceil(W / 32), zero (the kernel leaves them zero again, so one
// buffer serves every call on a stream).  ``chunked`` 0 takes the
// sequence route: ``part`` is (B, 3, W), ``sync`` unused, and ``vec`` 4
// needs W % 4 == 0 and every tensor 4-element aligned.
extern "C" int rglru_gated_scan_bwd(
    const void* xa, const void* xi, const void* x, const void* b_a,
    const void* b_i, const void* a_param, const void* h0, const void* h_all,
    const void* dh, void* dxa, void* dxi, void* dx, void* dh0, void* db_a,
    void* db_i, void* da_param, void* part, void* sync, int batch, int seq,
    int width, int x_dtype, int vec, int chunked, void* stream) {
  if (batch <= 0 || seq <= 0 || width <= 0 || (vec != 1 && vec != 4)
      || width % vec != 0 || (chunked != 0 && chunked != 1)
      || (chunked && sync == nullptr))
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
  args.db_a = static_cast<float*>(db_a);
  args.db_i = static_cast<float*>(db_i);
  args.da_param = static_cast<float*>(da_param);
  args.part = static_cast<float*>(part);
  args.sync = static_cast<unsigned long long*>(sync);
  auto st = static_cast<cudaStream_t>(stream);
  switch (x_dtype) {
    case repro::kF32:
      return launch<false>(args, batch, seq, width, vec, chunked, st);
    case repro::kBF16:
      return launch<true>(args, batch, seq, width, vec, chunked, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
