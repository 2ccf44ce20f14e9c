// P1 on Hopper: out = A (M, K) @ Bt (N, K)^T, bf16 in with an fp32
// accumulator and bf16 out, or int8 in with an int32 accumulator and out,
// the whole product repeated `reps` times in one launch.
//
// Replaces tools/probe_pallas_int8.py::make_gemm (a one-tile Pallas GEMM);
// plain version tools/probe_int8.probe_gemm_ref.  The probe exists to say
// what int8 buys K3's core over bf16, so the two types run the
// instructions of the stage engine (stage_mma_sm90.cuh): wgmma m64nNk16
// bf16 and m64nNk32 s8, each reading 32-byte K-slices.
//
// Design.  A block owns 64 output rows (one warpgroup's m64) x BN columns,
// BN = 32 or 64 chosen by the launcher (kernels.probe_gemm_plan) so that
// the grid is about one wave of the card's SMs at both probe shapes.  Warp
// 4 is the producer: one lane walks every (repetition, K-stage) and asks
// the TMA for the stage's two boxes, 64 rows of A and BN rows of Bt, 128
// bytes of K each (64 bf16 or 128 int8), swizzled 128B; a ring of kStages
// slots with a full and an empty mbarrier each keeps kStages - 1 stages in
// flight.  Warpgroup 0 waits on a slot's full barrier, issues four
// wgmma (32 bytes of K each) reading both operands from the slot by matrix
// descriptors (K-major, 128B swizzle: 8-row core groups 1024 bytes apart,
// a K step adds 32 bytes to the start address), commits, waits for the
// previous stage's products and frees that stage's slot.  Between the
// fence and the wait nothing touches the accumulator, so ptxas keeps the
// products in flight.  The ring's two sides are device functions
// (produce, consume) that K4's TMA route (dilated_conv.cu) runs too.  The
// TMA zero-fills rows past M or N and columns past K, so ragged M and N
// cost nothing; K is a whole number of 32-byte slices.
//
// Repetitions: each one streams its operands from device memory (L2)
// through the ring again and runs the whole product; its accumulator
// starts at (the previous repetition's first accumulator) * dep.  The
// caller passes dep = 0, so the result is one product, while neither the
// compiler nor the hardware can drop a repetition.
//
// Bound on the H100: at the probe shapes the bytes of one product (A, B
// read once, out written once) over 3.35 TB/s; each repetition rereads its
// operands from L2, so the L2's rate is what holds the kernel in practice.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the
                   // runtime's driver entry point, no driver library link
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_frag.cuh"

namespace babe {
namespace gemm90 {

using namespace babe::sm90;

constexpr int kBM = 64;       // output rows per block
constexpr int kBK = 128;      // bytes of K per ring stage (one swizzle row)
constexpr int kStages = 8;    // ring slots
constexpr int kThreads = 160;  // warpgroup 0 computes, warp 4 loads

// K-major operand with 128-byte swizzle: start address, LBO (unused for
// this layout, 1), SBO 1024 bytes between 8-row core groups, layout type 1
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// wgmma with both operands in shared memory, one function per width BN:
// wgmma_ss m64nBNk16 bf16 -> fp32 (32 and 64 for P1, 64, 96, 128 and 256
// for K4's TMA route), wgmma_ss_s8 m64nBNk32 s8 -> s32 (32 and 64 for P1,
// 64, 96, 128 and 256 for C8's TMA route, conv_int8.cu); the operand
// lists follow wgmma_rs.cuh's pattern (accumulator, A and B descriptors,
// the accumulate predicate's source)
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b);
template <int N>
__device__ void wgmma_ss_s8(int32_t (&d)[N / 2], uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<96>(float (&d)[48], uint64_t a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      " %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float (&d)[128], uint64_t a,
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14,"
      " %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27,"
      " %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40,"
      " %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53,"
      " %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66,"
      " %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      " %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92,"
      " %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104,"
      " %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115,"
      " %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126,"
      " %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]),
        "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]),
        "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]),
        "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]),
        "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]),
        "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]),
        "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]),
        "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]),
        "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_s8<32>(int32_t (&d)[16], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15"
      "}, %16, %17, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_s8<64>(int32_t (&d)[32], uint64_t a,
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_s8<96>(int32_t (&d)[48], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, %48, %49, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_s8<128>(int32_t (&d)[64], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63"
      "}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss_s8<256>(int32_t (&d)[128], uint64_t a,
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13,"
      " %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25,"
      " %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37,"
      " %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49,"
      " %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61,"
      " %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73,"
      " %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85,"
      " %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97,"
      " %98, %99, %100, %101, %102, %103, %104, %105, %106, %107,"
      " %108, %109, %110, %111, %112, %113, %114, %115, %116, %117,"
      " %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]),
        "+r"(d[104]), "+r"(d[105]), "+r"(d[106]), "+r"(d[107]),
        "+r"(d[108]), "+r"(d[109]), "+r"(d[110]), "+r"(d[111]),
        "+r"(d[112]), "+r"(d[113]), "+r"(d[114]), "+r"(d[115]),
        "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]),
        "+r"(d[124]), "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(1));
}

template <int N>
__device__ __forceinline__ void mma(float (&d)[N / 2], uint64_t a,
                                    uint64_t b) {
  wgmma_ss<N>(d, a, b);
}
template <int N>
__device__ __forceinline__ void mma(int32_t (&d)[N / 2], uint64_t a,
                                    uint64_t b) {
  wgmma_ss_s8<N>(d, a, b);
}

// The TMA ring's two sides, which P1 (gemm_tma below) and K4's TMA route
// (dilated_conv.cu) share.  Slot s of kStages holds one ring stage of
// stage_bytes at ring + s * stage_bytes; its full barrier completes when
// the stage's copies have landed (the producer's arrival and the TMA's tx
// bytes), its empty barrier when every consumer warpgroup has freed it
// (initialised with one arrival per consumer warpgroup).

// the producer: one thread walks ring stages 0 .. total - 1, waits for
// each stage's slot to be free, announces tx bytes on its full barrier and
// calls load(it, slot address, full barrier) to issue the stage's copies
template <int kStages, typename Load>
__device__ __forceinline__ void produce(int total, uint32_t ring,
                                        int stage_bytes, uint32_t tx,
                                        uint64_t* full, uint64_t* empty,
                                        Load&& load) {
  for (int it = 0; it < total; ++it) {
    const int s = it % kStages;
    const uint32_t bar = smem_u32(&full[s]);
    mbar_wait(smem_u32(&empty[s]), ((it / kStages) & 1) ^ 1);
    mbar_expect_tx(bar, tx);
    load(it, ring + s * stage_bytes, bar);
  }
}

// a consumer warpgroup's pass over ring stages it0 .. it0 + n - 1: it
// waits for each stage's copies, calls issue(slot address) to issue the
// stage's products and commits them; they stay in flight through the next
// stage's wait, and the stage is freed (one arrival, by the `leader`
// thread) once they are done.  Between the fence and the wait nothing
// touches the accumulator, so ptxas keeps the products in flight.  Returns
// with every product done and every stage of the pass freed.
template <int kStages, typename Acc, int K, typename Issue>
__device__ __forceinline__ void consume(int it0, int n, uint32_t ring,
                                        int stage_bytes, uint64_t* full,
                                        uint64_t* empty, bool leader,
                                        Acc (&acc)[K], Issue&& issue) {
  for (int k = 0; k < n; ++k) {
    const int it = it0 + k, s = it % kStages;
    mbar_wait(smem_u32(&full[s]), (it / kStages) & 1);
    fence_acc(acc);
    wg_fence();
    issue(ring + s * stage_bytes);
    wg_commit();
    wg_wait<1>();  // the previous stage's products are done
    fence_acc(acc);
    if (k > 0 && leader) mbar_arrive(smem_u32(&empty[(it - 1) % kStages]));
  }
  wg_wait<0>();
  fence_acc(acc);
  if (n > 0 && leader)
    mbar_arrive(smem_u32(&empty[(it0 + n - 1) % kStages]));
}

template <int BN>
__host__ __device__ constexpr int stage_bytes() {
  return (kBM + BN) * kBK;
}
template <int BN>
__host__ __device__ constexpr int smem_bytes() {  // ring + alignment slack
  return kStages * stage_bytes<BN>() + 1024;
}

template <typename E, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_tma(const __grid_constant__ CUtensorMap ta,
             const __grid_constant__ CUtensorMap tb, void* out, int M, int N,
             int nk, int reps, int dep) {
  using Acc =
      typename std::conditional<std::is_same<E, int8_t>::value, int32_t,
                                float>::type;
  constexpr int kA = kBM * kBK, kStage = stage_bytes<BN>();
  constexpr int kElems = kBK / (int)sizeof(E);  // K values per stage
  extern __shared__ __align__(1024) unsigned char smem_gemm[];
  __shared__ __align__(8) uint64_t full[kStages], empty[kStages];
  const uint32_t ring = (smem_u32(smem_gemm) + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * BN;
  const int total = reps * nk;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 1);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 128) {  // the producer warp: one lane issues every copy
    const CUtensorMap *pa = &ta, *pb = &tb;
    if (tid == 128)
      produce<kStages>(total, ring, kStage, kStage, full, empty,
                       [&](int it, uint32_t dst, uint32_t bar) {
                         const int kc = (it % nk) * kElems;
                         tma_load_2d(dst, pa, kc, m0, bar);
                         tma_load_2d(dst + kA, pb, kc, n0, bar);
                       });
    return;
  }

  Acc acc[BN / 2], carry = 0;
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = carry;
    consume<kStages>(rep * nk, nk, ring, kStage, full, empty, tid == 0, acc,
                     [&](uint32_t sa) {
                       const uint32_t sb = sa + kA;
#pragma unroll
                       for (int k = 0; k < kBK / 32; ++k)
                         mma<BN>(acc, desc_sw128(sa + 32 * k),
                                 desc_sw128(sb + 32 * k));
                     });
    carry = acc[0] * (Acc)dep;
  }

  // accumulator register 4 j + 2 hr + e: row 16 warp + g + 8 hr, column
  // 8 j + 2 q + e of the block's tile
  const int warp = tid >> 5, g = (tid & 31) >> 2, q = tid & 3;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + warp * 16 + g + 8 * hr;
        const int n = n0 + 8 * j + 2 * q + e;
        if (m < M && n < N) {
          const Acc v = acc[4 * j + 2 * hr + e];
          if constexpr (std::is_same<Acc, int32_t>::value)
            static_cast<int32_t*>(out)[(size_t)m * N + n] = v;
          else
            static_cast<__nv_bfloat16*>(out)[(size_t)m * N + n] =
                __float2bfloat16(v);
        }
      }
}

// cuTensorMapEncodeTiled through the runtime's driver entry point (null
// when the driver does not provide it)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// the tensor map of a row-major tensor of `elem`-byte values (bf16 or
// 8-bit) of `rank` dimensions `dims` (innermost first; `strides` the
// bytes between consecutive indices of dimensions 1 .. rank - 1), boxes of
// `box` values with an innermost side of kBK bytes, 128B swizzle; the TMA
// fills every element outside the tensor, negative coordinates included,
// with zero
inline bool tiled_map(CUtensorMap* map, const void* ptr, int rank,
                      const cuuint64_t* dims, const cuuint64_t* strides,
                      const cuuint32_t* box, int elem) {
  EncodeTiled fn = encoder();
  if (fn == nullptr || rank < 1 || rank > 5) return false;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return fn(map,
            elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                      : CU_TENSOR_MAP_DATA_TYPE_UINT8,
            (cuuint32_t)rank, const_cast<void*>(ptr), dims, strides, box,
            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// the tensor map of a (rows, K) row-major operand, boxes of box_rows rows
// x kBK bytes
inline bool operand_map(CUtensorMap* map, const void* ptr, int rows, int K,
                        int elem, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)K, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)K * elem};
  const cuuint32_t box[2] = {(cuuint32_t)(kBK / elem), (cuuint32_t)box_rows};
  return tiled_map(map, ptr, 2, dims, strides, box, elem);
}

template <typename E, int BN>
int launch(const void* a, const void* bt, void* out, int M, int K, int N,
           int reps, int dep, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        gemm_tma<E, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes<BN>());
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  constexpr int elem = (int)sizeof(E);
  CUtensorMap ta, tb;
  if (!operand_map(&ta, a, M, K, elem, kBM) ||
      !operand_map(&tb, bt, N, K, elem, BN))
    return (int)cudaErrorInvalidValue;
  const int nk = (K * elem + kBK - 1) / kBK;
  const dim3 grid((M + kBM - 1) / kBM, (N + BN - 1) / BN);
  gemm_tma<E, BN><<<grid, kThreads, smem_bytes<BN>(), st>>>(ta, tb, out, M,
                                                            N, nk, reps, dep);
  return (int)cudaGetLastError();
}

}  // namespace gemm90
}  // namespace babe
