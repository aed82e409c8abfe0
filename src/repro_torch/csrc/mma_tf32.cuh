// 3xTF32 products on the tensor cores (mma.sync m16n8k8, about f32's
// accuracy) for the recurrences' chunked kernels (wkv6.cu, wkv6_bwd.cu),
// and the warp transpose-reduce their A matrices share.
//
// Fragments of one warp, lane = 4 g + t4: A (16 x 8) a0 = A[g][t4],
// a1 = A[g + 8][t4], a2 = A[g][t4 + 4], a3 = A[g + 8][t4 + 4]; B (8 x 8)
// b0 = B[t4][g], b1 = B[t4 + 4][g]; C (16 x 8) c0 = C[g][2 t4],
// c1 = C[g][2 t4 + 1], c2 = C[g + 8][2 t4], c3 = C[g + 8][2 t4 + 1].
#pragma once

#include <stdint.h>

namespace repro {

// x = big + small, both TF32, the rest below f32's rounding.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(x));
  const float rest = __fsub_rn(x, __uint_as_float(big));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// x as (big, small) in a float2, for an operand split once and read by
// several products
__device__ __forceinline__ float2 tf32_pair(float x) {
  uint32_t big, small;
  split_tf32(x, big, small);
  return make_float2(__uint_as_float(big), __uint_as_float(small));
}
struct Frag {
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2,
                                      float a3) {
    split_tf32(a0, big[0], small[0]);
    split_tf32(a1, big[1], small[1]);
    split_tf32(a2, big[2], small[2]);
    split_tf32(a3, big[3], small[3]);
  }
  __device__ __forceinline__ void set(float2 a0, float2 a1, float2 a2,
                                      float2 a3) {
    const float2 a[4] = {a0, a1, a2, a3};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      big[q] = __float_as_uint(a[q].x);
      small[q] = __float_as_uint(a[q].y);
    }
  }
};
struct FragB {
  uint32_t big[2], small[2];
  __device__ __forceinline__ void set(float b0, float b1) {
    split_tf32(b0, big[0], small[0]);
    split_tf32(b1, big[1], small[1]);
  }
  __device__ __forceinline__ void set(float2 b0, float2 b1) {
    big[0] = __float_as_uint(b0.x);
    small[0] = __float_as_uint(b0.y);
    big[1] = __float_as_uint(b1.x);
    small[1] = __float_as_uint(b1.y);
  }
};
// d += a b at about f32's accuracy: the two cross products, then big*big
// (the small*small product is below f32's rounding)
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const Frag& a,
                                           const FragB& b) {
  mma_tf32(d, a.small, b.big);
  mma_tf32(d, a.big, b.small);
  mma_tf32(d, a.big, b.big);
}
// The same, with d's own sum rounded to nearest: the tensor cores add
// with round-toward-zero, whose bias grows with every product added into
// a large d (a state carried over many chunks), so the three products
// go into a zeroed accumulator and d takes it by one f32 add.
__device__ __forceinline__ void mma_3xtf32_rn(float (&d)[4], const Frag& a,
                                              const FragB& b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, a.small, b.big);
  mma_tf32(t, a.big, b.small);
  mma_tf32(t, a.big, b.big);
#pragma unroll
  for (int q = 0; q < 4; ++q) d[q] += t[q];
}

// One exchange of a transpose-reduce over a warp: a lane keeps the half
// of its first 2 M values that bit ``o`` of its lane selects and adds
// its partner's copy of that half.  halve<8>(v, 16), <4>(v, 8), <2>(v,
// 4), <1>(v, 2), then v[0] plus its partner's at offset 1 leaves lanes
// 2 s and 2 s + 1 with the warp's sum of v[s] (16 values), in a fixed
// order.
template <int M, int N>
__device__ __forceinline__ void halve(float (&pa)[N], int o, int lane) {
  const bool upper = lane & o;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    const float send = upper ? pa[q] : pa[q + M];
    const float keep = upper ? pa[q + M] : pa[q];
    pa[q] = keep + __shfl_xor_sync(0xffffffffu, send, o);
  }
}

}  // namespace repro
