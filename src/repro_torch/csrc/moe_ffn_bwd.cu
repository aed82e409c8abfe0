// Backward of the grouped expert FFN for Hopper (sm_90a).
//
// No TPU kernel has this function: the JAX package differentiates its
// three einsum products (src/repro/models/moe.py:160-167).  The forward
// it differentiates is csrc/moe_ffn.cu's (the counterpart of
// src/repro/kernels/moe_ffn.py::moe_ffn): per expert e, with X = buf[e]
// (C, D), Wg, Wu (D, F), Wd (F, D),
//   g = X Wg,  u = X Wu,  h = act(g) * u,  y = h Wd.
// From dY (C, D):
//   dh = dY Wd^T,  dg = dh * u * act'(g),  du = dh * act(g)
//   dX = dg Wg^T + du Wu^T,  dWg = X^T dg,  dWu = X^T du,  dWd = h^T dY
// (kernels/ref.py::moe_ffn_bwd_ref is the plain version).  act is silu
// (swiglu) or the tanh-approximate gelu (gelu/geglu).
//
// bf16, four launches of one persistent tensor-core kernel on the
// caller's stream (every product out (M x N) = sum over K of A (M x K)
// B (K x N) per expert, each operand read by TMA in its stored layout,
// K-major (K contiguous) or MN-major (M or N contiguous, which bf16
// wgmma takes transposed), so no operand is copied into another layout;
// every output is stored (M, N), rows of N):
//   1  dh    (C, F): M = C (dY K-major), N = F (Wd K-major), K = D, into
//              the caller's (E, C, F) workspace H;
//   2  g, u  (C, F): M = C (X K-major), N = F (Wg, Wu MN-major), K = D:
//              two accumulators from one read of X; the epilogue takes g
//              and u from them, reads dh and writes dg -> G, du -> U and
//              h -> H (over dh) in the workspaces;
//   3  dX    (C, D): M = C (dg, du K-major), N = D (Wg, Wu K-major), the
//              K loop over F running over (dg, Wg), then (du, Wu) into
//              one accumulator;
//   4  dWg, dWu (D, F): M = D (X MN-major), N = F (dg, du MN-major), and
//      dWd (F, D): M = F (h MN-major), N = D (dY MN-major), K = C: three
//              products in one launch.
// Rounding: every product accumulates in f32; dh is rounded to bf16 when
// stored, g and u are used from f32, dg, du and h are rounded once
// before the products that read them, and each output once.  (The
// elementwise step sits in launch 2, not in dh's epilogue: it reads one
// (E, C, F) tensor there, not two.)
//
// A launch is a list of output tiles over its products and experts,
// 128 x 256 (two m64n256k16 consumers; launch 2: 128 x 128, two
// accumulators of m64n128k16 each), and gridDim.x = min(SMs, tiles) CTAs
// walk it persistently: CTA b takes tiles b, b + gridDim.x, ...  Either
// tile loads 48 KB for each 64-deep K step, 87 operations a byte.
// Within a product and expert the tiles of the smaller operand's axis
// run fastest (tile_at), so the CTAs running at one time share it
// through L2 and each tile of the larger operand is read from memory
// about once: for dWg (M = D: 32 tiles, N = F: 56) a wave of 132 tiles
// covers all of D against 4 tiles of F, where a grid with N fastest
// streamed an expert's whole dg (59 MB, more than the 50 MB L2) again
// for every row tile of D; for dX (M = C: 17 tiles of dg, N = D: 16
// tiles of Wg) C runs fastest, though it has more tiles (5.54 against
// 9.51 ms on an H100 at Mixtral-8x7B's B 1 x S 4096).  A CTA is one producer warpgroup (one
// thread starts TMA loads, with the 128-byte swizzle, into a ring of
// four 48 KB stages against mbarriers and runs ahead into the CTA's next
// tile while the consumers finish this one) and two consumer warpgroups
// of 64 rows that run wgmma from the ring, keep one product group in
// flight and release each stage when its products are done; setmaxnreg
// moves the producer's registers to the accumulators.  The ring's phase
// runs on across tiles.  The epilogue stages each consumer's rows
// through 16 KB of shared memory and writes whole rows in 16-byte
// stores.  TMA zero-fills the ragged edges of C, D and F (so ragged K
// adds zeros), and the epilogue stores only rows < M.  No atomics and no
// split-K: every output element is written once by one thread, and its
// sum runs in one fixed order.
//
// Bound on this card: operations.  Eight products of 2 E C D F each
// (Mixtral-8x7B at B 1 x S 4096: C = 2049, 15.4 TFLOP a layer, ~15.6 ms
// at the bf16 tensor-core peak) against ~3.3 GB moved (~1 ms).
//
// f32 (the lossless path): the same products on the CUDA cores, no TF32,
// as eight launches through f32 workspaces: g, u and dh (a 64 x 64
// register-tiled grouped GEMM over arbitrary strides), the elementwise
// step in place (g -> dg, u -> du, dh -> h), then dX (both products in
// one accumulator), dWg, dWu, dWd.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

enum Act { kSilu = 1, kGelu = 2 };

// act(x) and act'(x)
__device__ __forceinline__ void act_grad(float x, int act, float* a,
                                         float* da) {
  if (act == kSilu) {
    const float s = 1.f / (1.f + expf(-x));
    *a = x * s;
    *da = s * (1.f + x * (1.f - s));
    return;
  }
  // tanh approximation, jax.nn.gelu's default
  const float c = 0.7978845608028654f, k = 0.044715f;
  const float t = tanhf(c * (x + k * x * x * x));
  *a = 0.5f * x * (1.f + t);
  *da = 0.5f * (1.f + t) + 0.5f * x * (1.f - t * t) * c * (1.f + 3.f * k * x * x);
}

// f32: g -> dg, u -> du, dh -> h, element by element.
__global__ void moe_bwd_act_kernel(float* __restrict__ g,
                                   float* __restrict__ u,
                                   float* __restrict__ dh, long long n,
                                   int act) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float a, da;
    act_grad(g[i], act, &a, &da);
    const float uv = u[i], dhv = dh[i];
    g[i] = dhv * uv * da;
    u[i] = dhv * a;
    dh[i] = a * uv;
  }
}

// A matrix per expert, row-major (rows, cols), experts contiguous.
struct Mat {
  const void* p;
  int rows, cols;
};

// out (M x N per expert) = sum over the pairs of A B.  ta: A is stored
// (K, M) (MN-major), else (M, K); tb: B is stored (K, N), else (N, K).
// out_mn: out is stored (M, N), else (N, M).
struct Gemm {
  Mat a[2], b[2];
  int pairs, ta, tb;
  void* out;
  int m, n, out_mn;
};

// ---------------------------------------------------------------------------
// bf16: one persistent wgmma kernel fed by TMA, four launches

constexpr int kWgThreads = 384;        // producer warpgroup + 2 consumers
constexpr int kBM = 128, kBK = 64;
constexpr int kBox = 64 * 64 * 2;      // one 64 x 64 bf16 box, 8 KB
constexpr int kStaging = 64 * 256;     // a consumer's 64 x 128 bf16 round

// What a launch's epilogue does with the accumulator(s).
enum Mode {
  kStore = 0,    // out0 = bf16(acc)
  kGated = 1     // two B operands, two accumulators g and u: with dh read
                 // from out2, out0 = dg, out1 = du, out2 = h (in place)
};

// A tile is 128 rows x kBN columns: 256 (m64n256k16 a consumer, 128
// accumulators), or 128 for kGated's two accumulators.  Either way a
// 64-deep K step loads 48 KB (A: two 64-row boxes; B: kBN columns in
// kBN / 64 boxes, K-major of 64 rows or MN-major of 64 columns; kGated a
// second B) for 4.2 MFLOP, 87 operations a byte loaded: a
// 128 x 128 tile's 64 left the products waiting on L2.
template <int MODE>
struct Ring {
  static constexpr int kBN = MODE == kGated ? 128 : 256;
  static constexpr int kStageBytes = 6 * kBox;
  static constexpr int kStages = 4;
  static constexpr int kSmem = kStages * kStageBytes + 2 * kStaging + 1024
                               + 2 * 8 * kStages;
};

// One product of a launch: out (M x N per expert) = sum over the pairs of
// A B, nk0 64-deep K steps of (a0, b0) then nk1 of (a1, b1); kGated
// reads b1 beside b0 at every step instead.
struct alignas(64) Job {
  CUtensorMap a0, b0, a1, b1;
  __nv_bfloat16* out[3];
  int m, n, mt, nt, nk0, nk1, tiles;    // tiles = experts * mt * nt
};

constexpr int kMaxJobs = 3;
struct Jobs {
  Job job[kMaxJobs];
  int n_jobs, total;
};

// Tile t of a launch -> (job, expert, row tile, column tile).  Jobs in
// order, then experts; within one, the row tiles fastest where M <= N
// (A, M x K, is the smaller operand), else the column tiles: the tiles in
// flight at one time sweep the smaller operand, which L2 holds, against
// a few tiles of the larger one, each read from memory about once.
// tests/test_torch_moe_bwd.py mirrors this order.
__device__ __forceinline__ const Job& tile_at(const Jobs& js, int t, int* e,
                                              int* m, int* n) {
  int j = 0;
  while (j + 1 < js.n_jobs && t >= js.job[j].tiles) t -= js.job[j++].tiles;
  const Job& jb = js.job[j];
  const int per = jb.mt * jb.nt, r = t % per;
  *e = t / per;
  if (jb.m <= jb.n) {
    *m = r % jb.mt;
    *n = r / jb.mt;
  } else {
    *n = r % jb.nt;
    *m = r / jb.nt;
  }
  return jb;
}

template <int N>
__device__ __forceinline__ void zero(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0.f;
}

// The producer thread: every K step of every tile of this CTA into the
// ring, running ahead of the consumers by up to the ring's depth.
template <int TA, int TB, int MODE>
__device__ __forceinline__ void produce(const Jobs& js, uint8_t* ring,
                                        uint64_t* full, uint64_t* empty) {
  using R = Ring<MODE>;
  constexpr int S = R::kStages, kBN = R::kBN;
  int it = 0;
  for (int t = blockIdx.x; t < js.total; t += gridDim.x) {
    int e, mi, ni;
    const Job& jb = tile_at(js, t, &e, &mi, &ni);
    const int m0 = mi * kBM, n0 = ni * kBN, nk = jb.nk0 + jb.nk1;
    for (int kk = 0; kk < nk; ++kk, ++it) {
      const int s = it % S;
      const bool second = MODE != kGated && kk >= jb.nk0;
      const CUtensorMap* ma = second ? &jb.a1 : &jb.a0;
      const CUtensorMap* mb = second ? &jb.b1 : &jb.b0;
      const int k0 = (second ? kk - jb.nk0 : kk) * kBK;
      uint8_t* st = ring + s * R::kStageBytes;
      bar_wait(&empty[s], ((it / S) & 1) ^ 1);
      bar_expect_tx(&full[s], R::kStageBytes);
      for (int w = 0; w < 2; ++w) {
        if (TA)
          tma_load_3d(st + w * kBox, ma, &full[s], m0 + 64 * w, k0, e);
        else
          tma_load_3d(st + w * kBox, ma, &full[s], k0, m0 + 64 * w, e);
      }
      for (int b = 0; b < (MODE == kGated ? 2 : 1); ++b) {
        const CUtensorMap* mbb = b ? &jb.b1 : mb;
        uint8_t* sb = st + (2 + kBN / 64 * b) * kBox;
        for (int q = 0; q < kBN / 64; ++q) {
          if (TB)
            tma_load_3d(sb + q * kBox, mbb, &full[s], n0 + 64 * q, k0, e);
          else
            tma_load_3d(sb + q * kBox, mbb, &full[s], k0, n0 + 64 * q, e);
        }
      }
    }
  }
}

// accumulator i of a thread: row 16 * warp + lane / 4 + 8 * ((i / 2) % 2),
// column 8 * (i / 4) + 2 * (lane % 4) + i % 2; i and i + 1 (i even) are
// adjacent columns of one row, stored together
__device__ __forceinline__ size_t frag_at(int m0, int n0, int w, int i,
                                          int n_valid, int* m, int* n) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x / 32) % 4;
  *m = m0 + w * 64 + warp * 16 + lane / 4 + 8 * ((i / 2) % 2);
  *n = n0 + 8 * (i / 4) + 2 * (lane % 4);
  return static_cast<size_t>(*m) * n_valid + *n;
}

// One consumer warpgroup (w): 64 rows of every tile of this CTA.
template <int TA, int TB, int MODE>
__device__ __forceinline__ void consume(const Jobs& js, const uint8_t* ring,
                                        uint64_t* full, uint64_t* empty,
                                        uint8_t* stage, int w, int act) {
  using R = Ring<MODE>;
  constexpr int S = R::kStages, kBN = R::kBN;
  // k16 step: 32 bytes along a K-major row; 16 rows of 128 bytes MN-major
  constexpr int kStepA = TA ? 128 : 2, kStepB = TB ? 128 : 2;
  float acc[kBN / 2], acc1[MODE == kGated ? kBN / 2 : 1];
  int it = 0;
  for (int t = blockIdx.x; t < js.total; t += gridDim.x) {
    int e, mi, ni;
    const Job& jb = tile_at(js, t, &e, &mi, &ni);
    const int m0 = mi * kBM, n0 = ni * kBN, nk = jb.nk0 + jb.nk1;
    const size_t eo = static_cast<size_t>(e) * jb.m * jb.n;
    // kGated: this tile's dh, loaded while the K loop runs
    uint32_t dhp[MODE == kGated ? kBN / 4 : 1];
    if constexpr (MODE == kGated) {
#pragma unroll
      for (int q = 0; q < kBN / 4; ++q) {
        int m, n;
        const size_t at = frag_at(m0, n0, w, 2 * q, jb.n, &m, &n) + eo;
        dhp[q] = m < jb.m && n < jb.n
                     ? *reinterpret_cast<const uint32_t*>(jb.out[2] + at)
                     : 0u;
      }
    }
    zero(acc);
    if constexpr (MODE == kGated) zero(acc1);
    for (int kk = 0; kk < nk; ++kk, ++it) {
      const int s = it % S;
      bar_wait(&full[s], (it / S) & 1);
      const uint8_t* st = ring + s * R::kStageBytes;
      // MN-major: 64-wide blocks kBox apart (lbo), 8-row groups 1 KB apart
      const uint64_t da = sw128_desc(st + w * kBox, TA ? kBox : 16, 1024);
      const uint64_t db = sw128_desc(st + 2 * kBox, TB ? kBox : 16, 1024);
      const uint64_t db1 =
          MODE == kGated ? sw128_desc(st + (2 + kBN / 64) * kBox,
                                      TB ? kBox : 16, 1024)
                         : 0;
      wgmma_fence();
#pragma unroll
      for (int q = 0; q < kBK / 16; ++q) {
        Wgmma<kBN>::template ss<TA, TB>(acc, da + q * kStepA,
                                        db + q * kStepB);
        if constexpr (MODE == kGated)
          Wgmma<kBN>::template ss<TA, TB>(acc1, da + q * kStepA,
                                          db1 + q * kStepB);
      }
      wgmma_commit();
      wgmma_wait<1>();               // the previous stage's products are done
      if (kk > 0) bar_arrive(&empty[(it - 1) % S]);
    }
    wgmma_wait<0>();
    bar_arrive(&empty[(it - 1) % S]);
    reg_fence(acc);
    if constexpr (MODE == kGated) reg_fence(acc1);

    // The epilogue goes through shared memory, 64 x 128 a round: each
    // accumulator pair into its row, 16-byte chunks XOR-swizzled by row
    // (no bank conflicts either way), then whole rows out in 16-byte
    // stores (the fragments' own layout wrote 16 bytes in 8 rows a warp
    // store, which held the tile's end up by microseconds).
    const int lane = threadIdx.x % 32, row0 = (threadIdx.x / 32) % 4 * 16;
    const auto put = [&](int i, uint32_t pair) {
      const int row = row0 + lane / 4 + 8 * ((i / 2) % 2), c = (i / 4) % 16;
      *reinterpret_cast<uint32_t*>(stage + row * 256 + ((c ^ (row % 8)) * 16)
                                   + (lane % 4) * 4) = pair;
    };
    const auto flush = [&](__nv_bfloat16* out, int c0) {
      named_bar_sync(1 + w, 128);
      for (int q = threadIdx.x % 128; q < 64 * 16; q += 128) {
        const int row = q / 16, c = q % 16;
        const int m = m0 + 64 * w + row, n = n0 + c0 + 8 * c;
        if (m < jb.m && n < jb.n)        // N is a multiple of 8
          *reinterpret_cast<uint4*>(out + eo + static_cast<size_t>(m) * jb.n
                                    + n) =
              *reinterpret_cast<const uint4*>(
                  stage + row * 256 + ((c ^ (row % 8)) * 16));
      }
      named_bar_sync(1 + w, 128);
    };
    if constexpr (MODE == kStore) {
#pragma unroll
      for (int h = 0; h < kBN / 128; ++h) {
#pragma unroll
        for (int i = 64 * h; i < 64 * h + 64; i += 2)
          put(i, pack_bf16(acc[i], acc[i + 1]));
        flush(jb.out[0], 128 * h);
      }
    } else {
      // in place: this tile alone reads and writes these elements; du and
      // h wait, rounded, in the registers dg's round frees
      uint32_t dup[kBN / 4], hp[kBN / 4];
#pragma unroll
      for (int i = 0; i < kBN / 2; i += 2) {
        const float2 dh2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&dhp[i / 2]));
        const float dh[2] = {dh2.x, dh2.y};
        float dg[2], du[2], h[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float a, da;
          act_grad(acc[i + c], act, &a, &da);
          const float uv = acc1[i + c];
          dg[c] = dh[c] * uv * da;
          du[c] = dh[c] * a;
          h[c] = a * uv;
        }
        put(i, pack_bf16(dg[0], dg[1]));
        dup[i / 2] = pack_bf16(du[0], du[1]);
        hp[i / 2] = pack_bf16(h[0], h[1]);
      }
      flush(jb.out[0], 0);
#pragma unroll
      for (int i = 0; i < kBN / 2; i += 2) put(i, dup[i / 2]);
      flush(jb.out[1], 0);
#pragma unroll
      for (int i = 0; i < kBN / 2; i += 2) put(i, hp[i / 2]);
      flush(jb.out[2], 0);
    }
  }
}

template <int TA, int TB, int MODE>
__global__ void __launch_bounds__(kWgThreads, 1) moe_bwd_wgmma_kernel(
    const __grid_constant__ Jobs js, int act) {
  using R = Ring<MODE>;
  constexpr int S = R::kStages;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* staging = ring + S * R::kStageBytes;     // 1 KB aligned
  uint64_t* full = reinterpret_cast<uint64_t*>(staging + 2 * kStaging);
  uint64_t* empty = full + S;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      bar_init(&full[s], 1);
      bar_init(&empty[s], 256);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {                                    // producer
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      for (int j = 0; j < js.n_jobs; ++j) {
        prefetch_map(&js.job[j].a0);
        prefetch_map(&js.job[j].b0);
        if (js.job[j].nk1 > 0 || MODE == kGated) prefetch_map(&js.job[j].b1);
        if (js.job[j].nk1 > 0) prefetch_map(&js.job[j].a1);
      }
      produce<TA, TB, MODE>(js, ring, full, empty);
    }
  } else {
    setmaxnreg_inc<232>();                          // consumers
    consume<TA, TB, MODE>(js, ring, full, empty,
                          staging + (wg - 1) * kStaging, wg - 1, act);
  }
}

// A (rows, cols) bf16 matrix per expert as a 3-D map loading boxes of 64
// columns x box_rows rows.
bool map3(CUtensorMap* m, const Mat& x, int e, int box_rows) {
  const uint64_t dims[3] = {static_cast<uint64_t>(x.cols),
                            static_cast<uint64_t>(x.rows),
                            static_cast<uint64_t>(e)};
  const uint64_t strides[2] = {static_cast<uint64_t>(x.cols) * 2,
                               static_cast<uint64_t>(x.rows) * x.cols * 2};
  const uint32_t box[3] = {64, static_cast<uint32_t>(box_rows), 1};
  return make_map(m, x.p, 3, dims, strides, box);
}

// One product: A operands (ta: stored (K, M), else (M, K)), B operands
// (tb: stored (K, N), else (N, K)), outputs, M and N.
struct Prod {
  Mat a[2], b[2];
  int pairs;
  void* out[3];
  int m, n;
};

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      n = 132;
  }
  return n;
}

template <int TA, int TB, int MODE>
int launch_wgmma(const Prod* ps, int n_prods, int e, int act,
                 cudaStream_t stream) {
  Jobs js{};
  js.n_jobs = n_prods;
  for (int j = 0; j < n_prods; ++j) {
    const Prod& p = ps[j];
    Job& jb = js.job[j];
    const int pairs = MODE == kGated ? 1 : p.pairs;
    int nk[2] = {0, 0};
    for (int q = 0; q < 2; ++q) {
      // kGated: b[1] is the second B operand of the same K steps
      const int qa = q < pairs ? q : 0;
      const int qb = MODE == kGated ? q : qa;
      if (!map3(q ? &jb.a1 : &jb.a0, p.a[qa], e, 64) ||
          !map3(q ? &jb.b1 : &jb.b0, p.b[qb], e, 64))
        return static_cast<int>(cudaErrorInvalidValue);
      if (q < pairs) {
        const int k = TA ? p.a[q].rows : p.a[q].cols;
        nk[q] = (k + kBK - 1) / kBK;
      }
    }
    for (int q = 0; q < 3; ++q)
      jb.out[q] = static_cast<__nv_bfloat16*>(p.out[q]);
    jb.m = p.m;
    jb.n = p.n;
    jb.mt = (p.m + kBM - 1) / kBM;
    jb.nt = (p.n + Ring<MODE>::kBN - 1) / Ring<MODE>::kBN;
    jb.nk0 = nk[0];
    jb.nk1 = nk[1];
    jb.tiles = e * jb.mt * jb.nt;
    js.total += jb.tiles;
  }
  static unsigned smem_set = 0;
  auto kern = moe_bwd_wgmma_kernel<TA, TB, MODE>;
  cudaError_t err = set_smem_once(kern, Ring<MODE>::kSmem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = js.total < sm_count() ? js.total : sm_count();
  kern<<<grid, kWgThreads, Ring<MODE>::kSmem, stream>>>(js, act);
  return static_cast<int>(cudaGetLastError());
}

int run_bf16(const void* buf, const void* w_gate, const void* w_up,
             const void* w_down, const void* dy, void* g, void* u, void* h,
             void* dbuf, void* dw_gate, void* dw_up, void* dw_down, int e,
             int c, int d, int f, int act, cudaStream_t st) {
  const Mat X{buf, c, d}, Wg{w_gate, d, f}, Wu{w_up, d, f}, Wd{w_down, f, d},
      dY{dy, c, d}, G{g, c, f}, U{u, c, f}, H{h, c, f};
  // Prod: {A pairs}, {B pairs}, pairs, {outputs}, M, N
  const Prod dh{{dY, dY}, {Wd, Wd}, 1, {h, nullptr, nullptr}, c, f};
  const Prod gu{{X, X}, {Wg, Wu}, 1, {g, u, h}, c, f};
  const Prod dx{{G, U}, {Wg, Wu}, 2, {dbuf, nullptr, nullptr}, c, d};
  const Prod dw[3] = {{{X, X}, {G, G}, 1, {dw_gate, nullptr, nullptr}, d, f},
                      {{X, X}, {U, U}, 1, {dw_up, nullptr, nullptr}, d, f},
                      {{H, H}, {dY, dY}, 1, {dw_down, nullptr, nullptr}, f, d}};
  int rc = launch_wgmma<0, 0, kStore>(&dh, 1, e, act, st);
  if (rc == 0) rc = launch_wgmma<0, 1, kGated>(&gu, 1, e, act, st);
  if (rc == 0) rc = launch_wgmma<0, 0, kStore>(&dx, 1, e, act, st);
  if (rc == 0) rc = launch_wgmma<1, 1, kStore>(dw, 3, e, act, st);
  return rc;
}

// ---------------------------------------------------------------------------
// f32: the exact CUDA-core kernel

constexpr int kThreads = 256;
constexpr int kFM = 64, kFN = 64, kFK = 16;

// Element (i, k) of a per-expert operand: p[e * se + i * si + k * sk].
struct Op {
  const float* p;
  long long se, si, sk;
};

__device__ __forceinline__ void load_tile(float (*t)[kFM + 4], const Op& x,
                                          int e, int i0, int k0, int n_i,
                                          int n_k) {
  // walk the operand's contiguous axis fastest
  const bool k_fast = x.sk == 1;
#pragma unroll
  for (int q = 0; q < kFM * kFK / kThreads; ++q) {
    const int idx = threadIdx.x + q * kThreads;
    const int r = k_fast ? idx / kFK : idx % kFM;
    const int c = k_fast ? idx % kFK : idx / kFM;
    const int gi = i0 + r, gk = k0 + c;
    t[c][r] = (gi < n_i && gk < n_k)
                  ? x.p[e * x.se + gi * x.si + gk * x.sk] : 0.f;
  }
}

// out[e * M * N + m * om + n * on] = sum over the pairs of A B.
__global__ void __launch_bounds__(kThreads) moe_bwd_f32_kernel(
    Op a0, Op b0, int k0_len, Op a1, Op b1, int k1_len, float* out, int M,
    int N, long long om, long long on) {
  __shared__ float as[kFK][kFM + 4];
  __shared__ float bs[kFK][kFN + 4];
  const int m0 = blockIdx.y * kFM, n0 = blockIdx.x * kFN, e = blockIdx.z;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int p = 0; p < 2; ++p) {
    const Op& a = p ? a1 : a0;
    const Op& b = p ? b1 : b0;
    const int kl = p ? k1_len : k0_len;
    for (int kb = 0; kb < kl; kb += kFK) {
      load_tile(as, a, e, m0, kb, M, kl);
      load_tile(bs, b, e, n0, kb, N, kl);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kFK; ++kk) {
        float x[4], y[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          x[i] = as[kk][ty * 4 + i];
          y[i] = bs[kk][tx * 4 + i];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] += x[i] * y[j];
      }
      __syncthreads();
    }
  }
  float* oe = out + static_cast<size_t>(e) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty * 4 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (m < M && n < N) oe[m * om + n * on] = acc[i][j];
    }
  }
}

// The operand of a Mat as (i, k) elements: i along M (A) or N (B).
Op as_op(const Mat& x, bool k_rows) {
  const long long cols = x.cols;
  Op o{static_cast<const float*>(x.p), static_cast<long long>(x.rows) * cols,
       k_rows ? 1 : cols, k_rows ? cols : 1};
  return o;
}

int run_f32(const Gemm& g, int e, cudaStream_t stream) {
  Op a[2], b[2];
  int kl[2] = {0, 0};
  for (int p = 0; p < 2; ++p) {
    const int q = p < g.pairs ? p : 0;
    a[p] = as_op(g.a[q], g.ta);
    b[p] = as_op(g.b[q], g.tb);
    if (p < g.pairs) kl[p] = g.ta ? g.a[p].rows : g.a[p].cols;
  }
  const long long om = g.out_mn ? g.n : 1, on = g.out_mn ? 1 : g.m;
  const dim3 grid((g.n + kFN - 1) / kFN, (g.m + kFM - 1) / kFM, e);
  moe_bwd_f32_kernel<<<grid, kThreads, 0, stream>>>(
      a[0], b[0], kl[0], a[1], b[1], kl[1], static_cast<float*>(g.out), g.m,
      g.n, om, on);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// buf and dy (E, C, D); w_gate, w_up (E, D, F); w_down (E, F, D); all
// contiguous, one dtype (f32 or bf16).  Writes dbuf (E, C, D), dw_gate,
// dw_up (E, D, F), dw_down (E, F, D) in that dtype.  g, u, dh: the
// caller's (E, C, F) workspaces in that dtype.  act: 1 = silu (swiglu),
// 2 = tanh-approximate gelu.  bf16 needs D and F multiples of 8 and
// 16-byte-aligned bases (TMA's strides and addresses); the wrapper
// checks.
extern "C" int moe_ffn_bwd(const void* buf, const void* w_gate,
                           const void* w_up, const void* w_down,
                           const void* dy, void* g, void* u, void* dh,
                           void* dbuf, void* dw_gate, void* dw_up,
                           void* dw_down, int e, int c, int d, int f,
                           int act, int dtype, void* stream) {
  auto st = static_cast<cudaStream_t>(stream);
  if ((act != kSilu && act != kGelu) || e < 1 || c < 1 || d < 1 || f < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == kBF16) {
    if (d % 8 != 0 || f % 8 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return run_bf16(buf, w_gate, w_up, w_down, dy, g, u, dh, dbuf, dw_gate,
                    dw_up, dw_down, e, c, d, f, act, st);
  }
  if (dtype != kF32) return static_cast<int>(cudaErrorInvalidValue);
  const Mat X{buf, c, d}, Wg{w_gate, d, f}, Wu{w_up, d, f}, Wd{w_down, f, d},
      dY{dy, c, d}, G{g, c, f}, U{u, c, f}, H{dh, c, f};
  // Gemm: {a pairs}, {b pairs}, pairs, ta, tb, out, M, N, out_mn
  const Gemm steps_before[3] = {
      {{Wg, Wg}, {X, X}, 1, 1, 0, g, f, c, 0},       // g  (C, F)
      {{Wu, Wu}, {X, X}, 1, 1, 0, u, f, c, 0},       // u  (C, F)
      {{Wd, Wd}, {dY, dY}, 1, 0, 0, dh, f, c, 0}};   // dh (C, F)
  // after the elementwise step G holds dg, U du and H h
  const Gemm steps_after[4] = {
      {{Wg, Wu}, {G, U}, 2, 0, 0, dbuf, d, c, 0},    // dX  (C, D)
      {{X, X}, {G, G}, 1, 1, 1, dw_gate, d, f, 1},   // dWg (D, F)
      {{X, X}, {U, U}, 1, 1, 1, dw_up, d, f, 1},     // dWu (D, F)
      {{H, H}, {dY, dY}, 1, 1, 1, dw_down, f, d, 1}};  // dWd (F, D)
  for (const Gemm& s : steps_before) {
    const int rc = run_f32(s, e, st);
    if (rc != 0) return rc;
  }
  const long long n = static_cast<long long>(e) * c * f;
  const int blocks = static_cast<int>(
      n / 256 + 1 < 132 * 16 ? n / 256 + 1 : 132 * 16);
  moe_bwd_act_kernel<<<blocks, 256, 0, st>>>(static_cast<float*>(g),
                                             static_cast<float*>(u),
                                             static_cast<float*>(dh), n, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  for (const Gemm& s : steps_after) {
    const int rc = run_f32(s, e, st);
    if (rc != 0) return rc;
  }
  return 0;
}
