// Contiguous-cache verify attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// decode_attention (pallas_call at line 129, body _kernel at lines 31-84):
// skinny-q attention of the m new tokens of each sequence (already written
// at positions [len - m, len)) against its contiguous (B, Hkv, S, d) cache,
// with per-sequence lengths.  Causal over the last m positions, with an
// optional sliding window (slot index = logical position, k_pos > q_pos -
// window) or ancestor-bitmask masking of a speculation-tree buffer
// (anc_bits); f32 or bf16.
//
// Bound on this card: bytes.  As in the paged kernel, each KV row serves
// only the g*m query rows of its head: ~g*m/2 operations per byte (about
// 10 for Mixtral's g=4, m=5), far under the ~295 the H100 needs to be
// compute-bound.
//
// Design: the verify-attention body of common.cuh, shared with the paged
// kernel: one CTA per (sequence, KV head) holding the g*m query rows, so
// every KV row is read once, and an online softmax in f32.  The TPU grid
// pads the cache to a block multiple and visits every block; here the CTA
// walks only the tiles below min(len, S) (and from the window's first key
// when there is a window).  The cache is read through (batch, head, slot)
// strides, so the model passes its (B, S, Hkv, d) cache as a transposed
// view with no copy.  Split-KV, TMA and wgmma are later work.
#include "common.cuh"

namespace {

using namespace repro;

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeThreads) decode_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ lengths, const int* __restrict__ anc,
    T* __restrict__ out, int n_q_heads, int n_kv_heads, int m, int n_slots,
    long long sb, long long sh, long long ss, float scale, int window) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int len = lengths[b];
  const size_t base = static_cast<size_t>(b) * sb + static_cast<size_t>(h) * sh;
  auto row_of = [=](int pos) {
    const size_t off = base + static_cast<size_t>(pos) * ss;
    return KVRow<T>{k + off, v + off, 0};
  };
  decode_attention_body<T, T, D>(q, nullptr, nullptr, anc, out, b, h,
                                 n_q_heads, n_kv_heads, m, len,
                                 min(len, n_slots), window, scale, row_of);
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* lengths,
           const void* anc, void* out, int batch, int hq, int hkv, int m,
           int n_slots, long long sb, long long sh, long long ss, float scale,
           int window, cudaStream_t stream) {
  const size_t smem = decode_smem_floats<D>((hq / hkv) * m) * sizeof(float);
  auto kern = decode_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(batch, hkv), kDecodeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(lengths),
      static_cast<const int*>(anc), static_cast<T*>(out), hq, hkv, m, n_slots,
      sb, sh, ss, scale, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const void* lengths, const void* anc, void* out, int batch,
               int hq, int hkv, int m, int n_slots, long long sb, long long sh,
               long long ss, float scale, int window, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, lengths, anc, out, batch, hq, hkv, m,
                           n_slots, sb, sh, ss, scale, window, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, anc, out, batch, hq, hkv, m,
                            n_slots, sb, sh, ss, scale, window, stream);
    case 256:
      return launch<T, 256>(q, k, v, lengths, anc, out, batch, hq, hkv, m,
                            n_slots, sb, sh, ss, scale, window, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// k and v share the element strides (sb, sh, ss) of their (batch, head,
// slot) axes; their last dimension is contiguous.  window <= 0 means no
// sliding window; anc may be null.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, const void* anc,
                                void* out, int batch, int hq, int hkv, int m,
                                int d, int n_slots, long long sb, long long sh,
                                long long ss, float scale, int window,
                                int dtype, void* stream) {
  using namespace repro;
  if (hq % hkv != 0) return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32)
    return dispatch_d<float>(d, q, k, v, lengths, anc, out, batch, hq, hkv, m,
                             n_slots, sb, sh, ss, scale, window, st);
  if (dtype == kBF16)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, lengths, anc, out, batch, hq,
                                     hkv, m, n_slots, sb, sh, ss, scale,
                                     window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
