"""Write ``wgmma.cuh``: the bf16 ``wgmma.mma_async`` wrappers the Hopper
kernels use, one specialisation per instruction width N.

    python src/repro_torch/csrc/gen_wgmma.py > src/repro_torch/csrc/wgmma.cuh

An instruction of width N names its N / 2 f32 accumulator registers one
by one in the PTX, so each width is spelled out; scale-d is a template
argument (1 by default).  ``SS_WIDTHS`` are the widths with both
operands in shared memory (``moe_ffn.cu``'s token tiles, the flash
kernels' key and query tiles, ``moe_ffn_bwd.cu``'s 128- and 256-wide
tiles); ``RS_WIDTHS`` those with A in registers
(the P V product of ``flash_attention.cu`` and the dV / dK / dQ
products of ``flash_attention_bwd.cu``, N = head dim).
tests/test_torch_kernel_precision.py checks that the committed header
is this script's output.
"""
import sys

SS_WIDTHS = (8, 16, 24, 32, 40, 48, 64, 80, 96, 128, 136, 152, 256)
RS_WIDTHS = (64, 128, 256)

HEAD = """\
// Generated by gen_wgmma.py: do not edit.
//
// bf16 x bf16 -> f32 warpgroup products of Hopper (sm_90a), m64 x N x k16:
// Wgmma<N>::ss(d, desc_a, desc_b) with A and B in shared memory,
// Wgmma<N>::rs(d, a, desc_b) with A as four bf16x2 registers.  d holds
// the N / 2 accumulators of the calling thread, accumulated into (scale-d
// SD = 1, the default) or overwritten (SD = 0: a product's first k16 step,
// with no zeroing of d before it).  TA / TB pick the transposed (MN-major)
// layout of A / B in shared memory.
#pragma once

#include <stdint.h>

namespace repro {

template <int N> struct Wgmma;
"""


def _regs(n):
    return ", ".join(f"%{i}" for i in range(n))


def _outs(n):
    return ", ".join(f'"+f"(d[{i}])' for i in range(n))


def spec(n: int) -> str:
    r = n // 2
    lines = [f"template <> struct Wgmma<{n}> {{"]
    if n in SS_WIDTHS:
        lines += [
            "  template <int TA, int TB, int SD = 1>",
            f"  __device__ __forceinline__ static void ss(float (&d)[{r}], "
            "uint64_t da, uint64_t db) {",
            "    asm volatile(",
            f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "',
            f'        "{{{_regs(r)}}}, %{r}, %{r + 1}, %{r + 4}, 1, 1, %{r + 2}, '
            f'%{r + 3};\\n"',
            f"        : {_outs(r)}",
            '        : "l"(da), "l"(db), "n"(TA), "n"(TB), "n"(SD));',
            "  }",
        ]
    if n in RS_WIDTHS:
        lines += [
            "  template <int TB, int SD = 1>",
            f"  __device__ __forceinline__ static void rs(float (&d)[{r}], "
            "const uint32_t (&a)[4], uint64_t db) {",
            "    asm volatile(",
            f'        "wgmma.mma_async.sync.aligned.m64n{n}k16.f32.bf16.bf16 "',
            f'        "{{{_regs(r)}}}, {{%{r}, %{r + 1}, %{r + 2}, %{r + 3}}}, '
            f'%{r + 4}, %{r + 6}, 1, 1, %{r + 5};\\n"',
            f"        : {_outs(r)}",
            '        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), '
            '"n"(TB), "n"(SD));',
            "  }",
        ]
    lines.append("};")
    return "\n".join(lines) + "\n"


def header() -> str:
    widths = sorted(set(SS_WIDTHS) | set(RS_WIDTHS))
    return (HEAD + "\n" + "\n".join(spec(n) for n in widths)
            + "\n}  // namespace repro\n")


if __name__ == "__main__":
    sys.stdout.write(header())
