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
// Design: the split-KV body of common.cuh, shared with the paged kernel
// (see its note): a (B, Hkv x row groups, n_split) grid, each CTA one
// chunk of whole 64-key tiles of [first, min(len, S)) -- from the
// window's first key when there is a window -- and the last CTA of a
// (sequence, head, row group) merging the partials in split order.  The TPU grid pads the cache to a
// block multiple and visits every block; here only the tiles below
// min(len, S) are read.  bf16 runs the tensor-core body (mma.sync,
// 3-stage cp.async ring), f32 the exact CUDA-core body.  The cache is read
// through (batch, head, slot) strides, and q and the output through their
// own, so the model passes its (B, S, Hkv, d) cache and (B, S, H, d)
// queries as transposed views with no copy.  Head dims: 64, 128, 240 and
// 256 on both bodies; 32 (the reduced configs of the examples, f32) on
// the CUDA-core body only.
#include "common.cuh"
#include "hopper.cuh"

namespace {

using namespace repro;

template <typename T>
struct ContigKV {
  const T* k;
  const T* v;
  long long sb, sh, ss;
  int n_slots;
};

template <typename T>
__device__ __forceinline__ auto contig_rows(const ContigKV<T>& kv, int b,
                                            int h) {
  const size_t base = static_cast<size_t>(b) * kv.sb
                      + static_cast<size_t>(h) * kv.sh;
  return [=](int pos) {
    const size_t off = base + static_cast<size_t>(pos) * kv.ss;
    return KVRow<T>{kv.k + off, kv.v + off, 0};
  };
}

template <int D>
__global__ void __launch_bounds__(kDecodeThreads) decode_kernel(
    DecodeArgs a, ContigKV<float> kv) {
  const int b = blockIdx.x, h = blockIdx.y / a.n_groups,
            rg = blockIdx.y % a.n_groups, len = a.lengths[b];
  decode_core_body<float, float, D>(a, nullptr, nullptr, b, h, rg,
                                    blockIdx.z,
                                    len, min(len, kv.n_slots),
                                    contig_rows(kv, b, h));
}

template <int D, int NTC>
__global__ void __launch_bounds__(MmaCfg<D, NTC>::kThreads,
                                  MmaCfg<D, NTC>::kMinBlocks)
    decode_mma_kernel(DecodeArgs a, ContigKV<__nv_bfloat16> kv) {
  const int b = blockIdx.x, h = blockIdx.y / a.n_groups,
            rg = blockIdx.y % a.n_groups, len = a.lengths[b];
  decode_mma_body<D, NTC>(a, b, h, rg, blockIdx.z, len, min(len, kv.n_slots),
                          contig_rows(kv, b, h));
}

template <int D>
int launch_f32(const DecodeArgs& a, const ContigKV<float>& kv, int batch,
               cudaStream_t stream) {
  const size_t smem = decode_smem_floats<D>(a.group_rows) * sizeof(float);
  auto kern = decode_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(batch, a.n_kv_heads * a.n_groups, a.n_split), kDecodeThreads, smem,
         stream>>>(a, kv);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int NTC>
int launch_mma(const DecodeArgs& a, const ContigKV<__nv_bfloat16>& kv,
               int batch, cudaStream_t stream) {
  using C = MmaCfg<D, NTC>;
  auto kern = decode_mma_kernel<D, NTC>;
  static unsigned smem_set = 0;
  cudaError_t err = set_smem_once(kern, C::kSmem, &smem_set);
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<dim3(batch, a.n_kv_heads * a.n_groups, a.n_split), C::kThreads, C::kSmem,
         stream>>>(a, kv);
  return static_cast<int>(cudaGetLastError());
}

// the n-tile capacity of g*m rows (n_tile_cap in common.cuh)
template <int D>
int dispatch_mma(int rows, const DecodeArgs& a, const ContigKV<__nv_bfloat16>& kv, int batch,
                 cudaStream_t stream) {
  switch (n_tile_cap(rows, D)) {
    case 1: return launch_mma<D, 1>(a, kv, batch, stream);
    case 2: return launch_mma<D, 2>(a, kv, batch, stream);
    case 4: return launch_mma<D, 4>(a, kv, batch, stream);
    case 8: return launch_mma<D, 8>(a, kv, batch, stream);
    default: return launch_mma<D, (D > 128 ? 10 : 16)>(a, kv, batch, stream);
  }
}

}  // namespace

// strides: the (batch, head, token) element strides of q, of out, then the
// (batch, head, slot) strides that k and v share (their last dimension is
// contiguous).  n_groups / group_rows, part_acc / part_ml / counters: the
// row groups and the merge workspace, as for paged_decode_attention.
// window <= 0 means no sliding window; anc may be null.
extern "C" int decode_attention(const void* q, const void* k, const void* v,
                                const void* lengths, const void* anc,
                                void* out, void* part_acc, void* part_ml,
                                void* counters, const long long* strides,
                                int batch, int hq, int hkv, int m, int d,
                                int n_slots, int n_split, int n_groups,
                                int group_rows, float scale, int window,
                                int dtype, void* stream) {
  using namespace repro;
  if (hq % hkv != 0 || n_split < 1
      || !row_groups_valid(hq, hkv, m, d, n_groups, group_rows)
      || (n_split > 1 && (part_acc == nullptr || counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  DecodeArgs a{q, out, strides[0], strides[1], strides[2], strides[3],
               strides[4], strides[5], static_cast<const int*>(lengths),
               static_cast<const int*>(anc), static_cast<float*>(part_acc),
               static_cast<float2*>(part_ml), static_cast<int*>(counters),
               hq, hkv, m, n_split, window, n_groups, group_rows, scale};
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == kF32) {
    const ContigKV<float> kv{static_cast<const float*>(k),
                             static_cast<const float*>(v), strides[6],
                             strides[7], strides[8], n_slots};
    switch (d) {
      case 32: return launch_f32<32>(a, kv, batch, st);
      case 64: return launch_f32<64>(a, kv, batch, st);
      case 128: return launch_f32<128>(a, kv, batch, st);
      case 240: return launch_f32<240>(a, kv, batch, st);
      case 256: return launch_f32<256>(a, kv, batch, st);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dtype != kBF16) return static_cast<int>(cudaErrorInvalidValue);
  const ContigKV<__nv_bfloat16> kv{static_cast<const __nv_bfloat16*>(k),
                                   static_cast<const __nv_bfloat16*>(v),
                                   strides[6], strides[7], strides[8],
                                   n_slots};
  switch (d) {
    case 64: return dispatch_mma<64>(group_rows, a, kv, batch, st);
    case 128: return dispatch_mma<128>(group_rows, a, kv, batch, st);
    case 240: return dispatch_mma<240>(group_rows, a, kv, batch, st);
    case 256: return dispatch_mma<256>(group_rows, a, kv, batch, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
