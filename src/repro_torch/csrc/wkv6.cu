// RWKV-6 WKV recurrence for Hopper (sm_90a).
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
// Design: one CTA per (b, h) with hd threads.  Thread j owns column j of
// S, hd f32 in registers for the whole sequence, so the state never
// touches memory between steps (the TPU keeps it in VMEM scratch).  Per
// step r_t, k_t, w_t are staged in shared memory (double-buffered, one
// barrier a step), thread j holds v_j, and computes
//   y_j = sum_i r_i (S_ij + u_i k_i v_j),  S_ij <- w_i S_ij + k_i v_j.
// Stack rows are written with column j in thread j, so every store of a
// row is coalesced.  Inputs are read through (batch, head, step) strides
// with a contiguous last dimension, so the model passes its (B, S, H, hd)
// projections as a transposed view without a copy.
#include "common.cuh"

namespace {

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
