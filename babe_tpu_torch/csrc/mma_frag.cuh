// Warp-level tensor-core fragments shared by the bf16 stage tile of K1 and
// K2 (conv5x3_mma.cuh), K3's tile (fused_stage_int8.cu), K4's mma tile
// (dilated_conv.cu) and the weight-gradient GEMM (conv_dw.cu).
//
// Operands are staged in shared memory as rows of 32 bytes of the
// contraction (32 int8 or 16 bf16 values), padded to 48 bytes (kW = 12
// words) so that one warp's fragment loads touch 32 distinct banks.  A row
// is one output position of A (an implicit-im2col pixel or a GEMM row) or
// one output channel of B.  In 32-bit words the fragments of
// mma.m16n8k32 (int8, int32 accumulate) and mma.m16n8k16 (bf16, fp32
// accumulate) are laid out alike: A register 0 is word q of position g, 1
// word q of position g+8, 2 and 3 the same at word q+4; B register 0 is
// word q of channel g, 1 word q+4.  So one warp tile serves both types,
// and the accumulator type picks the instruction.
//
// A block of 8 warps computes 128 positions x 64 channels; the warps form
// a 4 (positions) x 2 (channels) grid of 32 x 32 tiles (2 x 4 mma tiles).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace babe {
namespace frag {

constexpr int kW = 12;          // 32-bit words per staged row (8 + pad)
constexpr int kRowWords = 8;    // words of data per staged row
constexpr int kThreads = 256;
constexpr int kMB = 128;        // output positions per block
constexpr int kNB = 64;         // output channels per block

__device__ __forceinline__ void mma(int (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One 32-byte k-step of a warp's 32 x 32 tile: acc[i][j] += A_i * B_j.
// a0, a1 point at word q of the staged row of position g of m-tile 0 and
// 1 (the next positions follow kW words apart); b points at word q of the
// staged row of the warp's first output channel + g (channels kW apart).
template <typename Acc>
__device__ __forceinline__ void warp_mma(Acc (&acc)[2][4][4],
                                         const uint32_t* a0,
                                         const uint32_t* a1,
                                         const uint32_t* b) {
  uint32_t af[2][4];
  const uint32_t* pa[2] = {a0, a1};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    af[i][0] = pa[i][0];
    af[i][1] = pa[i][8 * kW];
    af[i][2] = pa[i][4];
    af[i][3] = pa[i][8 * kW + 4];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t* pb = b + j * 8 * kW;
    const uint32_t b0 = pb[0], b1 = pb[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) mma(acc[i][j], af[i], b0, b1);
  }
}

// Four bytes from src, the bytes at and past `valid` zero-filled; one
// 32-bit load when all four are valid and src is aligned.
__device__ __forceinline__ uint32_t load_word(const void* src, int valid,
                                              bool aligned) {
  if (valid >= 4 && aligned) return *static_cast<const uint32_t*>(src);
  const uint8_t* s = static_cast<const uint8_t*>(src);
  uint32_t v = 0;
  for (int i = 0; i < 4 && i < valid; ++i) v |= (uint32_t)s[i] << (8 * i);
  return v;
}

template <typename Acc>
__device__ __forceinline__ void zero(Acc (&acc)[2][4][4]) {
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

}  // namespace frag
}  // namespace babe
