// The flash kernels' strided tensor maps (flash_attention.cu and
// flash_attention_bwd.cu): a (B, H, S, d) bf16 tensor read through its
// (b, h, s) element strides with a contiguous last dim, so the model's
// (B, S, H, d) tensors are loaded through transposed views with no copy.
#pragma once

#include "hopper.cuh"

namespace repro {

struct QKVMap {
  CUtensorMap map;
  int heads_first;          // dims {d, h, s, b} instead of {d, s, h, b}
};

// (B, H, S, d) bf16 with strides sb, sh, ss (elements) and a contiguous
// last dim, loading 64 x rows boxes.  The two middle dims go in stride
// order.
inline bool make_qkv_map(QKVMap* m, const void* p, int b, int h, int s, int d,
                         int64_t sb, int64_t sh, int64_t ss, int rows) {
  m->heads_first = sh < ss;
  const uint64_t d0 = d, hh = h, sq = s, bb = b;
  const uint64_t dims[4] = {d0, m->heads_first ? hh : sq,
                            m->heads_first ? sq : hh, bb};
  const uint64_t strides[3] = {
      static_cast<uint64_t>(m->heads_first ? sh : ss) * 2,
      static_cast<uint64_t>(m->heads_first ? ss : sh) * 2,
      static_cast<uint64_t>(sb) * 2};
  const uint32_t box[4] = {64, m->heads_first ? 1u : static_cast<uint32_t>(rows),
                           m->heads_first ? static_cast<uint32_t>(rows) : 1u, 1};
  return make_map(&m->map, p, 4, dims, strides, box);
}

// rows [row, row + box rows) of head `head`, batch b, columns [col, col +
// 64) into dst (rows of 128 bytes, 128-byte swizzle); rows past S and
// columns past d load as zeros
__device__ __forceinline__ void tma_rows(void* dst, const CUtensorMap* map,
                                         int heads_first, uint64_t* bar,
                                         int col, int row, int head, int b) {
  if (heads_first)
    tma_load_4d(dst, map, bar, col, head, row, b);
  else
    tma_load_4d(dst, map, bar, col, row, head, b);
}

}  // namespace repro
