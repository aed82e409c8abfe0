// Paged verify attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py::
// paged_decode_attention (pallas_call at line 297, body _paged_kernel at
// lines 156-210): skinny-q attention of the m = n_cand+1 verify tokens of
// each sequence against its KV, read through a block table from a shared
// (NB, BS, Hkv, d) pool.  Causal over the last m positions, or
// ancestor-bitmask masking of a speculation-tree buffer (anc_bits);
// f32 / bf16 pools, or int8 pools with (NB, BS, Hkv, 1) f32 row scales.
//
// Bound on this card: bytes.  Each KV row is used by the g*m query rows
// of its head and nothing else, so the arithmetic intensity is ~g*m/2
// operations per byte (about 10 at g=4, m=5), far under the ~295 the
// H100 needs to be compute-bound.  At the serving path's ~600-token
// contexts the whole call moves ~10 MB and is bound by launch latency.
//
// Design: the verify-attention body of common.cuh (one CTA per
// (sequence, KV head) holding the g*m query rows of that head, online
// softmax in f32).  The TPU grid walks every logical block of the table
// in order (decode_attention.py:281); here the CTA walks only the
// ceil(len / 32) tiles of 32 rows that hold the sequence's tokens, with
// each row's physical block looked up in the table (entries <= 0 resolve
// to block 0).  Split-KV across CTAs, TMA and wgmma are later work.
#include "common.cuh"

namespace {

using namespace repro;

constexpr int kMaxRows = 128;      // g * m query rows per CTA

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kDecodeThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pool,
    const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ lengths, const int* __restrict__ anc,
    QT* __restrict__ out, int n_q_heads, int n_kv_heads, int m,
    int block_size, int max_blocks, float scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int len = lengths[b];
  const int* table = tables + static_cast<size_t>(b) * max_blocks;
  // logical position -> pool row through the block table (entries <= 0
  // resolve to block 0)
  auto row_of = [=](int pos) {
    const int lb = min(pos / block_size, max_blocks - 1);
    const int blk = max(table[lb], 0);
    const size_t row = (static_cast<size_t>(blk) * block_size
                        + pos % block_size) * n_kv_heads + h;
    return KVRow<KT>{k_pool + row * D, v_pool + row * D, row};
  };
  decode_attention_body<QT, KT, D>(q, k_scale, v_scale, anc, out, b, h,
                                   n_q_heads, n_kv_heads, m, len, len, 0,
                                   scale, row_of);
}

template <typename QT, typename KT, int D>
int launch(const void* q, const void* kp, const void* vp, const void* ksc,
           const void* vsc, const void* tables, const void* lengths,
           const void* anc, void* out, int batch, int hq, int hkv, int m,
           int block_size, int max_blocks, float scale,
           cudaStream_t stream) {
  const int rows = (hq / hkv) * m;
  const size_t smem = decode_smem_floats<D>(rows) * sizeof(float);
  auto kern = paged_decode_kernel<QT, KT, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(batch, hkv), kDecodeThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), static_cast<const float*>(ksc),
      static_cast<const float*>(vsc), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<const int*>(anc),
      static_cast<QT*>(out), hq, hkv, m, block_size, max_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT, typename KT>
int dispatch_d(int d, const void* q, const void* kp, const void* vp,
               const void* ksc, const void* vsc, const void* tables,
               const void* lengths, const void* anc, void* out, int batch,
               int hq, int hkv, int m, int block_size, int max_blocks,
               float scale, cudaStream_t stream) {
  switch (d) {
    case 64:
      return launch<QT, KT, 64>(q, kp, vp, ksc, vsc, tables, lengths, anc,
                                out, batch, hq, hkv, m, block_size,
                                max_blocks, scale, stream);
    case 128:
      return launch<QT, KT, 128>(q, kp, vp, ksc, vsc, tables, lengths, anc,
                                 out, batch, hq, hkv, m, block_size,
                                 max_blocks, scale, stream);
    case 256:
      return launch<QT, KT, 256>(q, kp, vp, ksc, vsc, tables, lengths, anc,
                                 out, batch, hq, hkv, m, block_size,
                                 max_blocks, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, const void* anc, void* out, int batch, int hq,
    int hkv, int m, int d, int block_size, int max_blocks, float scale,
    int q_dtype, int kv_dtype, void* stream) {
  using namespace repro;
  if (hq % hkv != 0 || (hq / hkv) * m > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_PAGED(QT, KT)                                                  \
  return dispatch_d<QT, KT>(d, q, k_pool, v_pool, k_scale, v_scale, tables, \
                            lengths, anc, out, batch, hq, hkv, m,           \
                            block_size, max_blocks, scale, st)
  if (q_dtype == kF32 && kv_dtype == kF32) REPRO_PAGED(float, float);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    REPRO_PAGED(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == kF32 && kv_dtype == kI8) REPRO_PAGED(float, int8_t);
  if (q_dtype == kBF16 && kv_dtype == kI8) REPRO_PAGED(__nv_bfloat16, int8_t);
#undef REPRO_PAGED
  return static_cast<int>(cudaErrorInvalidValue);
}
