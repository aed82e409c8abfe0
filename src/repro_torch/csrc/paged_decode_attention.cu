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
// Design: the split-KV body of common.cuh (see its note).  The TPU grid
// walks every logical block of the table in order (decode_attention.py:
// 281); here a (B, Hkv x row groups, n_split) grid cuts each sequence's
// ceil(len / 64) key tiles into n_split chunks, one CTA each, and the
// last CTA of a (sequence, head, row group) merges the partials in split
// order.  Each row's
// physical block is looked up in the table (entries <= 0 resolve to block
// 0) as its 16-byte chunks are queued.  bf16 pools run the tensor-core
// body (mma.sync, 3-stage cp.async ring); f32 and int8 pools run the
// exact CUDA-core body, int8 dequantized to f32 as the TPU kernel does.
// Head dims: 64, 128, 240 and 256 on both bodies; 32 (the reduced configs
// of the examples) on the CUDA-core body only.
#include "common.cuh"
#include "hopper.cuh"

#include <type_traits>

namespace {

using namespace repro;

template <typename KT>
struct PagedKV {
  const KT* k_pool;
  const KT* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* tables;
  int block_size, max_blocks;
};

// logical position -> pool row through the block table (entries <= 0
// resolve to block 0)
template <typename KT>
__device__ __forceinline__ auto paged_rows(const PagedKV<KT>& kv, int b,
                                           int h, int n_kv_heads, int d) {
  const int* table = kv.tables + static_cast<size_t>(b) * kv.max_blocks;
  return [=](int pos) {
    const int lb = min(pos / kv.block_size, kv.max_blocks - 1);
    const int blk = max(table[lb], 0);
    const size_t row = (static_cast<size_t>(blk) * kv.block_size
                        + pos % kv.block_size) * n_kv_heads + h;
    return KVRow<KT>{kv.k_pool + row * d, kv.v_pool + row * d, row};
  };
}

template <typename QT, typename KT, int D>
__global__ void __launch_bounds__(kDecodeThreads) paged_decode_kernel(
    DecodeArgs a, PagedKV<KT> kv) {
  const int b = blockIdx.x, h = blockIdx.y / a.n_groups,
            rg = blockIdx.y % a.n_groups, len = a.lengths[b];
  decode_core_body<QT, KT, D>(a, kv.k_scale, kv.v_scale, b, h, rg,
                              blockIdx.z,
                              len, len,
                              paged_rows(kv, b, h, a.n_kv_heads, D));
}

template <int D, int NTC>
__global__ void __launch_bounds__(MmaCfg<D, NTC>::kThreads,
                                  MmaCfg<D, NTC>::kMinBlocks)
    paged_decode_mma_kernel(DecodeArgs a, PagedKV<__nv_bfloat16> kv) {
  const int b = blockIdx.x, h = blockIdx.y / a.n_groups,
            rg = blockIdx.y % a.n_groups, len = a.lengths[b];
  decode_mma_body<D, NTC>(a, b, h, rg, blockIdx.z, len, len,
                          paged_rows(kv, b, h, a.n_kv_heads, D));
}

template <typename QT, typename KT, int D>
int launch_core(const DecodeArgs& a, const PagedKV<KT>& kv, int batch,
                cudaStream_t stream) {
  const size_t smem = decode_smem_floats<D>(a.group_rows) * sizeof(float);
  auto kern = paged_decode_kernel<QT, KT, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(batch, a.n_kv_heads * a.n_groups, a.n_split), kDecodeThreads, smem,
         stream>>>(a, kv);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int NTC>
int launch_mma(const DecodeArgs& a, const PagedKV<__nv_bfloat16>& kv,
               int batch, cudaStream_t stream) {
  using C = MmaCfg<D, NTC>;
  auto kern = paged_decode_mma_kernel<D, NTC>;
  static unsigned smem_set = 0;
  cudaError_t err = set_smem_once(kern, C::kSmem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(batch, a.n_kv_heads * a.n_groups, a.n_split), C::kThreads, C::kSmem,
         stream>>>(a, kv);
  return static_cast<int>(cudaGetLastError());
}

// the n-tile capacity of g*m rows (n_tile_cap in common.cuh)
template <int D>
int dispatch_mma(int rows, const DecodeArgs& a, const PagedKV<__nv_bfloat16>& kv, int batch,
                 cudaStream_t stream) {
  switch (n_tile_cap(rows, D)) {
    case 1: return launch_mma<D, 1>(a, kv, batch, stream);
    case 2: return launch_mma<D, 2>(a, kv, batch, stream);
    case 4: return launch_mma<D, 4>(a, kv, batch, stream);
    case 8: return launch_mma<D, 8>(a, kv, batch, stream);
    default: return launch_mma<D, (D > 128 ? 10 : 16)>(a, kv, batch, stream);
  }
}

template <typename QT, typename KT>
int dispatch_d(int d, const DecodeArgs& a, const PagedKV<KT>& kv, int batch,
               cudaStream_t stream) {
  const int rows = a.group_rows;           // the most rows a CTA holds
  if constexpr (std::is_same<QT, __nv_bfloat16>::value
                && std::is_same<KT, __nv_bfloat16>::value) {
    switch (d) {
      case 64: return dispatch_mma<64>(rows, a, kv, batch, stream);
      case 128: return dispatch_mma<128>(rows, a, kv, batch, stream);
      case 240: return dispatch_mma<240>(rows, a, kv, batch, stream);
      case 256: return dispatch_mma<256>(rows, a, kv, batch, stream);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  } else {
    switch (d) {
      case 32: return launch_core<QT, KT, 32>(a, kv, batch, stream);
      case 64: return launch_core<QT, KT, 64>(a, kv, batch, stream);
      case 128: return launch_core<QT, KT, 128>(a, kv, batch, stream);
      case 240: return launch_core<QT, KT, 240>(a, kv, batch, stream);
      case 256: return launch_core<QT, KT, 256>(a, kv, batch, stream);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
}

}  // namespace

// strides: the (batch, head, token) element strides of q, then of out.
// n_groups / group_rows: the row groups of each KV head's g*m query rows
// (DecodeArgs).  part_acc / part_ml: the f32 merge workspace, (B, Hkv,
// n_groups, n_split, group_rows, d) and (..., group_rows, 2), null when
// n_split is 1; counters: B*Hkv*n_groups int32, zero before the call and
// zero after it.
extern "C" int paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const void* k_scale, const void* v_scale, const void* tables,
    const void* lengths, const void* anc, void* out, void* part_acc,
    void* part_ml, void* counters, const long long* strides, int batch,
    int hq, int hkv, int m, int d, int block_size, int max_blocks,
    int n_split, int n_groups, int group_rows, float scale, int q_dtype,
    int kv_dtype, void* stream) {
  using namespace repro;
  if (hq % hkv != 0 || n_split < 1
      || !row_groups_valid(hq, hkv, m, d, n_groups, group_rows)
      || (n_split > 1 && (part_acc == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a{q, out, strides[0], strides[1], strides[2], strides[3],
               strides[4], strides[5], static_cast<const int*>(lengths),
               static_cast<const int*>(anc), static_cast<float*>(part_acc),
               static_cast<float2*>(part_ml), static_cast<int*>(counters),
               hq, hkv, m, n_split, 0, n_groups, group_rows, scale,
               0, nullptr};      // the whole sequence; no log-sum-exp
  auto st = static_cast<cudaStream_t>(stream);
#define REPRO_PAGED(QT, KT)                                                  \
  return dispatch_d<QT, KT>(                                                 \
      d, a,                                                                  \
      PagedKV<KT>{static_cast<const KT*>(k_pool),                            \
                  static_cast<const KT*>(v_pool),                            \
                  static_cast<const float*>(k_scale),                        \
                  static_cast<const float*>(v_scale),                        \
                  static_cast<const int*>(tables), block_size, max_blocks},  \
      batch, st)
  if (q_dtype == kF32 && kv_dtype == kF32) REPRO_PAGED(float, float);
  if (q_dtype == kBF16 && kv_dtype == kBF16)
    REPRO_PAGED(__nv_bfloat16, __nv_bfloat16);
  if (q_dtype == kF32 && kv_dtype == kI8) REPRO_PAGED(float, int8_t);
  if (q_dtype == kBF16 && kv_dtype == kI8) REPRO_PAGED(__nv_bfloat16, int8_t);
#undef REPRO_PAGED
  return static_cast<int>(cudaErrorInvalidValue);
}
