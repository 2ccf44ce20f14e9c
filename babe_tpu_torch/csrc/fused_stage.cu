// K2: one ResnetBlock dilation stage in a single pass over x.
//
//   h   = gelu(x * a)                       a: (B, C) fp32, cast to x's type
//   y   = (x + conv5x3_d(h, w) * s) / sqrt2  s: (B, C) fp32, cast to x's type
//   mom = per-(B, C) [sum y, sum y^2] in fp32 of the rounded y
//
// Replaces the TPU kernel babe_tpu/ops/conv_kernels.py::_build_fused_call
// (entry fused_stage_padded; oracle _dil_stage_ref).  Only the math and the
// moments output carry over: the TPU's chained padded layout, output
// aliasing and kt3/kf5 variants were TPU DMA and lane artifacts.  Casts
// follow the reference's order: x*a, the gelu result, conv, conv*s, the
// residual sum and the division are each rounded to x's type.
//
// Optionally (c_out != NULL) the rounded conv output is written too: the
// backward needs it for the gate gradient ds, and one extra write is cheaper
// than recomputing the conv.
//
// Two routes, chosen and cut by the host (kernels.stage_fwd_route,
// stage_plan) and passed in as a StagePlan:
//   * bf16 at the engine's shapes (C a multiple of 32 in 64..256, T >= 16:
//     every flagship stage at any batch): babe_stage_fwd_operand forms
//     h = round(gelu(round(x * round(a)))) once per element (16-byte loads
//     and stores), then the sm_90a engine of stage_mma_sm90.cuh (kModeFwd)
//     runs the conv on h with the gate, residual, 1/sqrt2 and moments in
//     its epilogue.
//   * fp32 and every other shape: the kFwd tile of conv5x3_mma.cuh /
//     conv5x3_tile.cuh, which computes the gelu while it stages the halo
//     window (once per staged copy: 5 kernel rows x C/64 channel tiles).
//
// The backward (babe_fused_stage_bwd) runs, in bf16 at the engine's shapes
// (kernels.stage_bwd_route; every flagship stage), the sm_90a engine of
// stage_mma_sm90.cuh, and otherwise the same tile in its kBwd mode: the
// conv transpose (flipped, io-swapped kernel) of one stage with the
// elementwise chain of the reference's vjp fused around it.  The prologue
// folds the moments' cotangent into y's (g = g_y + g_m0 + 2 y g_m1),
// divides by sqrt2 and applies the gate s; the epilogue multiplies by
// gelu'(x*a), forms dx = g_pre + du*a and sums ds = sum g_pre*c and
// da = sum du*x per (B, C) with the same atomics as the moments.  It
// replaces the XLA backward of the TPU kernel (_fused_bwd, the vjp of
// _dil_stage_ref), which the plain version dil_stage_bwd_ref mirrors.
//
// Bound on the H100: operation-bound like K1 (15*C multiply-adds per output
// element) from C = 128 in bf16 (w HWIO for the CUDA-core tile, wt
// tap-major (15, C, C) for the tile's tensor-core form, wpk packed for the
// engine).  The epilogue reads x once more for the residual and emits the
// moments, so the next stage's group-norm needs no pass over y.  The
// cross-block moment reduction uses fp32 atomics (block-level partial sums
// in shared memory, then one global atomic per channel and block), so the
// summation order, and the last bits of the moments, vary from run to run.
#include <algorithm>

#include "conv5x3_mma.cuh"
#include "stage_mma_sm90.cuh"

namespace babe {
namespace fwd {

using bf16 = __nv_bfloat16;

// h = round(gelu(round(x * round(a)))) of K2, 8 channels per step
__global__ void __launch_bounds__(256) stage_h(const bf16* __restrict__ x,
                                               const float* __restrict__ a,
                                               bf16* __restrict__ h, int C,
                                               size_t per_b, size_t n) {
  for (size_t e = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 8;
       e < n; e += (size_t)gridDim.x * blockDim.x * 8) {
    const int b = (int)(e / per_b), c0 = (int)(e % C);
    __align__(16) bf16 xv[8], hv[8];
    *reinterpret_cast<uint4*>(xv) = *reinterpret_cast<const uint4*>(x + e);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float ab = Elem<bf16>::round(a[b * C + c0 + k]);
      hv[k] = __float2bfloat16(
          gelu_poly(Elem<bf16>::round(__bfloat162float(xv[k]) * ab)));
    }
    *reinterpret_cast<uint4*>(h + e) = *reinterpret_cast<const uint4*>(hv);
  }
}

}  // namespace fwd
}  // namespace babe

// K2's engine input h = gelu(x*a), (B, F, T, C) bf16 with C a multiple of
// 8, rounded in K2's order (plain version ops/conv_kernels.stage_gelu_ref)
extern "C" int babe_stage_fwd_operand(const void* x, const void* a, void* h,
                                      int B, int F, int T, int C,
                                      void* stream) {
  if (C % 8 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || F <= 0 || T <= 0 || C <= 0) return 0;
  const size_t per_b = (size_t)F * T * C, n = per_b * B;
  const int blocks = (int)std::min<size_t>((n / 8 + 255) / 256, 132 * 16);
  babe::fwd::stage_h<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
      static_cast<__nv_bfloat16*>(h), C, per_b, n);
  return (int)cudaGetLastError();
}

// route 1: the sm_90a engine (stage_mma_sm90.cuh) with the cut in meta (a
// StagePlan), the packed weights wpk and its input h (babe_stage_fwd_operand
// on x and a; a is then read only through h); route 0: the kFwd tile with
// w (HWIO) and wt (tap-major)
extern "C" int babe_fused_stage(const void* x, const void* a, const void* s,
                                const void* w, const void* wt,
                                const void* wpk, const void* h, void* y,
                                void* mom, void* c_out, int B, int F, int T,
                                int C, int d, int dtype, const int* meta,
                                int n_meta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  babe::sm90::StagePlan plan;
  if (!babe::sm90::read_plan(plan, meta, n_meta, B, F, T, C, d))
    return (int)cudaErrorInvalidValue;
  if (plan.route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    using bf = __nv_bfloat16;
    babe::sm90::StageArgs g{};
    g.src = h;
    g.wpk = wpk;
    g.x = static_cast<const bf*>(x);
    g.v0 = static_cast<const float*>(s);
    g.out = static_cast<bf*>(y);
    g.c_out = static_cast<bf*>(c_out);
    g.sums = static_cast<float*>(mom);
    return babe::sm90::launch_stage<babe::sm90::kModeFwd>(plan, g, st);
  }
  babe::ConvParams p{};
  p.x = x;
  p.w = w;
  p.y = y;
  p.a = static_cast<const float*>(a);
  p.s = static_cast<const float*>(s);
  p.mom = static_cast<float*>(mom);
  p.c_out = c_out;
  p.B = B;
  p.F = F;
  p.T = T;
  p.C = C;
  p.N = C;
  p.d = d;
  if (dtype == 0) return babe::launch_conv5x3<float, babe::kFwd>(p, wt, st);
  if (dtype == 1)
    return babe::launch_conv5x3<__nv_bfloat16, babe::kFwd>(p, wt, st);
  return (int)cudaErrorInvalidValue;
}

// route 1: the sm_90a engine (stage_mma_sm90.cuh) with the cut in meta (a
// StagePlan), the packed weights wpk and its input gc = g_pre * s (s is
// then read only through gc); route 0: the kBwd tile with w_t
// (the flipped, io-swapped kernel, HWIO) and w_tt (it tap-major)
extern "C" int babe_fused_stage_bwd(const void* g_y, const void* g_mom,
                                    const void* y, const void* x,
                                    const void* c, const void* a,
                                    const void* s, const void* w_t,
                                    const void* w_tt, const void* wpk,
                                    const void* gc, void* dx, void* dsda,
                                    int B, int F, int T,
                                    int C, int d, int dtype, const int* meta,
                                    int n_meta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  babe::sm90::StagePlan plan;
  if (!babe::sm90::read_plan(plan, meta, n_meta, B, F, T, C, d))
    return (int)cudaErrorInvalidValue;
  if (plan.route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    using bf = __nv_bfloat16;
    const float* gm = static_cast<const float*>(g_mom);
    babe::sm90::StageArgs g{};
    g.src = gc;
    g.wpk = wpk;
    g.x = static_cast<const bf*>(x);
    g.v0 = gm;
    g.v1 = gm + (size_t)B * C;
    g.v2 = static_cast<const float*>(a);
    g.gy = static_cast<const bf*>(g_y);
    g.y = static_cast<const bf*>(y);
    g.c = static_cast<const bf*>(c);
    g.out = static_cast<bf*>(dx);
    g.sums = static_cast<float*>(dsda);
    return babe::sm90::launch_stage<babe::sm90::kModeBwd>(plan, g, st);
  }
  babe::ConvParams p{};
  p.x = g_y;
  p.w = w_t;
  p.y = dx;
  p.a = static_cast<const float*>(a);
  p.s = static_cast<const float*>(s);
  p.mom = static_cast<float*>(dsda);
  p.y_st = y;
  p.x_st = x;
  p.c_st = c;
  p.gmom = static_cast<const float*>(g_mom);
  p.B = B;
  p.F = F;
  p.T = T;
  p.C = C;
  p.N = C;
  p.d = d;
  if (dtype == 0) return babe::launch_conv5x3<float, babe::kBwd>(p, w_tt, st);
  if (dtype == 1)
    return babe::launch_conv5x3<__nv_bfloat16, babe::kBwd>(p, w_tt, st);
  return (int)cudaErrorInvalidValue;
}
