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
// element); bf16 runs on the tensor cores as K1 does (w HWIO for the
// CUDA-core tile, wt tap-major (15, C, C) for the tensor-core tile).  The
// prologue keeps h out of device memory (computed while the halo window is
// staged in shared memory) and the epilogue reads x once more for the
// residual and emits the moments, so the next stage's group-norm needs no
// pass over y.  The cross-block moment reduction uses fp32 atomics
// (block-level partial sums in shared memory, then one global atomic per
// channel and block), so the summation order, and the last bits of the
// moments, vary from run to run.
#include <string.h>

#include "conv5x3_mma.cuh"
#include "stage_mma_sm90.cuh"

extern "C" int babe_fused_stage(const void* x, const void* a, const void* s,
                                const void* w, const void* wt, void* y,
                                void* mom, void* c_out, int B, int F, int T,
                                int C, int d, int dtype, void* stream) {
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
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
  if (n_meta != (int)(sizeof(babe::sm90::StagePlan) / sizeof(int)))
    return (int)cudaErrorInvalidValue;
  babe::sm90::StagePlan plan;
  memcpy(&plan, meta, sizeof(plan));
  if (plan.route == 1) {
    if (dtype != 1 || plan.B != B || plan.F != F || plan.T != T ||
        plan.C != C || plan.d != d)
      return (int)cudaErrorInvalidValue;
    if (B <= 0 || F <= 0 || T <= 0) return 0;
    using bf = __nv_bfloat16;
    babe::sm90::StageArgs g{
        static_cast<const bf*>(gc), static_cast<const bf*>(g_y),
        static_cast<const float*>(g_mom), static_cast<const bf*>(y),
        static_cast<const bf*>(x), static_cast<const bf*>(c),
        static_cast<const float*>(a), static_cast<const bf*>(wpk),
        static_cast<bf*>(dx), static_cast<float*>(dsda)};
    return babe::sm90::launch_stage_bwd(plan, g, st);
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
