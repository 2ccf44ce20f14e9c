// K1: 'SAME' channels-last conv with a (5,3) kernel and dilation (d,1).
//
// Replaces the TPU kernel babe_tpu/ops/conv_kernels.py::_build_call (the
// implicit-GEMM Pallas conv5x3 behind conv5x3_dilated).  Same function:
// y[b,f,t,n] = sum_{kf,kt,c} x[b, f+(kf-2)d, t+kt-1, c] * w[kf,kt,c,n] with
// zero padding, fp32 accumulation, output rounded to the input type.  None
// of the TPU layout rules carry over: C and N are not padded to 128 lanes
// and T needs no alignment (the pyramid convs have C = 2).
//
// Also serves as the input gradient of every (5,3) stride-1 'SAME' conv:
// dx = conv5x3(g, w flipped in (kf,kt) with in/out channels swapped).
//
// Routes (kernels.conv5x3_route, passed down in the plan): bf16 with C <= 8
// or N <= 8, the flagship's pyramid convs (C = 2) and their input
// gradients (N = 2), take conv5x3_narrow.cuh, bound by the bytes of their
// wide side; every other shape takes the tiles below.
//
// Bound on the H100: at the model's widths (C,N in 64..256) the conv is
// operation-bound (15*C multiply-adds per output element against 2-4 bytes
// moved), so the roofline is the tensor-core rate.  bf16 runs on the tensor
// cores (mma.sync, conv5x3_mma.cuh) whenever the rows hold at least 16
// positions; fp32 and shorter rows run the CUDA-core tile
// (conv5x3_tile.cuh).  Both keep the halo window in shared memory so each
// input element is read from device memory about once per 64 output
// channels.  w is HWIO (5, 3, C, N) for the CUDA-core tile, wt the same
// kernel tap-major (15, N, C) for the tensor-core tile.
#include <string.h>

#include "conv5x3_mma.cuh"
#include "conv5x3_narrow.cuh"

// route 0: the tiles above (wt tap-major for the tensor-core tile);
// routes 1 and 2: conv5x3_narrow.cuh with the cut in meta (a K1Plan)
extern "C" int babe_conv5x3(const void* x, const void* w, const void* wt,
                            void* y, int B, int F, int T, int C, int N, int d,
                            int dtype, const int* meta, int n_meta,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_meta != (int)(sizeof(babe::k1n::K1Plan) / sizeof(int)))
    return (int)cudaErrorInvalidValue;
  babe::k1n::K1Plan plan;
  memcpy(&plan, meta, sizeof(plan));
  if (plan.route != 0) {
    if (dtype != 1 || plan.B != B || plan.F != F || plan.T != T ||
        plan.C != C || plan.N != N || plan.d != d)
      return (int)cudaErrorInvalidValue;
    if (B <= 0 || F <= 0 || T <= 0) return 0;
    return babe::k1n::launch_narrow(
        plan, static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<const __nv_bfloat16*>(wt), static_cast<__nv_bfloat16*>(y),
        st);
  }
  babe::ConvParams p{};
  p.x = x;
  p.w = w;
  p.y = y;
  p.B = B;
  p.F = F;
  p.T = T;
  p.C = C;
  p.N = N;
  p.d = d;
  if (dtype == 0) return babe::launch_conv5x3<float, babe::kPlain>(p, wt, st);
  if (dtype == 1)
    return babe::launch_conv5x3<__nv_bfloat16, babe::kPlain>(p, wt, st);
  return (int)cudaErrorInvalidValue;
}
