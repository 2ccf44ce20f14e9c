// The int8 probe's kernels: what int8 products buy over bf16 on this card
// at the fused stage's GEMM shapes.
//
//   P1 babe_probe_gemm:  out = A (M, K) @ B (K, N), B given as Bt (N, K);
//      bf16 in, fp32 accumulate, bf16 out (wgmma m64nNk16), or int8 in,
//      int32 out (wgmma m64nNk32 s8), repeated `reps` times in one launch
//      (the TPU probe chains 16 calls in a scan for the same reason: one
//      product is shorter than the cost of dispatching it).  The Hopper
//      GEMM of probe_gemm_sm90.cuh: a TMA ring and the stage engine's
//      instruction pair, so its int8:bf16 rate ratio is that of the
//      tensor-core core K2 and K3 run.  Replaces
//      tools/probe_pallas_int8.py::make_gemm (a one-tile Pallas GEMM).
//   P2 babe_probe_stage: K3's core without its prologue and epilogue.
//      Staged rows h (BF + 4d, BT + 16, C) -> out (BF*BT, C) with
//      out[f*BT + t, n] = sum_{kf, kt, c} h[f + kf*d, 7 + kt + t, c] *
//      wt[kf*3 + kt, n, c]: the 5 dilated rows of each output row and the
//      3 shifted columns are the 15 patches of the implicit GEMM.  Replaces
//      tools/probe_pallas_int8.py::make_stage, whose repetitions feed the
//      accumulator back into the staged rows.
//
// P2 runs the stage engine's own main loop (stage_mma_sm90.cuh,
// conv_loop): its conv evaluated on the interior window of an input of
// (F, T) = (BF + 4d, BT + 16).  h[f + kf*d, 7 + kt + t] is the input at
// row (f + 2d) + (kf - 2)d and column (t + 8) + (kt - 1), so the output
// window starts at (2d, 8) and is BF x BT; no read reaches the padding.
// The cp.async ring, ldmatrix A, one wgmma m64nNTk16 bf16 or m64nNTk32 s8
// per tap from the engine's weight pack (kernels.stage_tap_weights):
// K3's core, so the probe's int8:bf16 ratio is the engine's.  The cut
// (kernels.probe_stage_plan) is one warpgroup of 64 positions per block
// and NT = 32 or 64 output channels, about a wave of the card's SMs at
// both probe shapes.  Each repetition streams its operands through the
// ring again, its accumulator starting at (the previous repetition's
// first accumulator) * dep; the caller passes dep = 0, so the result is
// one product while no repetition can be dropped.  The epilogue stores the
// raw accumulator: fp32 for bf16 products, int32 for int8.
//
// Bound: operations (2*15*C operations per output element and repetition
// against a few bytes); P1's, bytes (probe_gemm_sm90.cuh).
#include "probe_gemm_sm90.cuh"
#include "stage_mma_sm90.cuh"

namespace babe {
namespace probe {

using sm90::StagePlan;

__device__ __forceinline__ void store_pair(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}
__device__ __forceinline__ void store_pair(int32_t* o, int32_t a,
                                           int32_t b) {
  *reinterpret_cast<int2*>(o) = make_int2(a, b);
}

// P2: block (gx, gy, z) owns window positions (gy*TF + q / TT, gx*TT + q %
// TT), q < 64, and output channels z*NT .. z*NT + NT
template <int NT, typename E>
__global__ void __launch_bounds__(128, 1)
    stage_probe(const StagePlan p, const void* h, const void* wpk,
                void* out, int BF, int BT, int reps, int dep) {
  using Acc =
      typename std::conditional<std::is_same<E, int8_t>::value, int32_t,
                                float>::type;
  extern __shared__ __align__(128) unsigned char smem_probe[];
  const int n0 = blockIdx.z * NT;
  const int fb = blockIdx.y * p.TF, tb = blockIdx.x * p.TT;
  Acc acc[NT / 2], carry = 0;
  for (int rep = 0; rep < reps; ++rep) {
#pragma unroll
    for (int i = 0; i < NT / 2; ++i) acc[i] = carry;
    sm90::conv_loop<NT, (int)sizeof(E), false, 1, Acc>(
        p, static_cast<const unsigned char*>(h),
        static_cast<const unsigned char*>(wpk), 0, 2 * p.d + fb, 8 + tb, n0,
        sm90::smem_u32(smem_probe), acc);
    carry = acc[0] * (Acc)dep;
  }
  // accumulator register n8*4 + hr*2 + e: position w4*16 + gq + 8hr,
  // channel n0 + 8 n8 + 2q + e
  const int lane = threadIdx.x & 31, w4 = threadIdx.x >> 5;
  const int gq = lane >> 2, q = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int pos = w4 * 16 + gq + 8 * hr;
    const int f = fb + (pos >> p.tt_log2), t = tb + (pos & (p.TT - 1));
    if (f >= BF || t >= BT) continue;
    Acc* o = static_cast<Acc*>(out) + ((size_t)f * BT + t) * p.C + n0 + 2 * q;
#pragma unroll
    for (int n8 = 0; n8 < NT / 8; ++n8)
      store_pair(o + 8 * n8, acc[n8 * 4 + hr * 2], acc[n8 * 4 + hr * 2 + 1]);
  }
}

template <int NT, typename E>
int launch_stage(const StagePlan& p, const void* h, const void* wpk,
                 void* out, int BF, int BT, int reps, int dep,
                 cudaStream_t st) {
  static bool configured = false;
  if (p.ring_bytes != sm90::kStages * p.stage_bytes || p.smem < p.ring_bytes)
    return (int)cudaErrorInvalidValue;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        stage_probe<NT, E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        232448);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  stage_probe<NT, E><<<dim3(p.gx, p.gy, p.gz), 128, p.smem, st>>>(
      p, h, wpk, out, BF, BT, reps, dep);
  return (int)cudaGetLastError();
}

}  // namespace probe
}  // namespace babe

// dtype: 1 = bf16, 2 = int8; bn: the block's output columns (32 or 64,
// kernels.probe_gemm_plan).  K a whole number of 32-byte slices, both
// operands 16-byte aligned.
extern "C" int babe_probe_gemm(const void* a, const void* bt, void* out,
                               int M, int K, int N, int reps, int dep,
                               int dtype, int bn, void* stream) {
  using namespace babe::gemm90;
  if (M <= 0 || N <= 0 || K <= 0 || reps <= 0) return 0;
  const int elem = dtype == 1 ? 2 : 1;
  if ((dtype != 1 && dtype != 2) || (bn != 32 && bn != 64) ||
      (K * elem) % 32 != 0 || reinterpret_cast<uintptr_t>(a) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(bt) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return bn == 32 ? launch<__nv_bfloat16, 32>(a, bt, out, M, K, N, reps,
                                                dep, st)
                    : launch<__nv_bfloat16, 64>(a, bt, out, M, K, N, reps,
                                                dep, st);
  return bn == 32 ? launch<int8_t, 32>(a, bt, out, M, K, N, reps, dep, st)
                  : launch<int8_t, 64>(a, bt, out, M, K, N, reps, dep, st);
}

// P2 with its cut `meta` (kernels.probe_stage_plan: a StagePlan of mode
// kModeProbe), checked against the shape; wpk is the engine's pack of the
// tap-major wt (kernels.stage_tap_weights).  dtype: 1 = bf16, 2 = int8.
extern "C" int babe_probe_stage(const void* h, const void* wpk, void* out,
                                const int* meta, int n_meta, int nrows,
                                int BTw, int C, int BF, int BT, int d,
                                int reps, int dep, int dtype, void* stream) {
  using namespace babe::probe;
  using babe::sm90::kModeProbe;
  StagePlan p;
  if (!babe::sm90::read_plan(p, meta, n_meta, 1, nrows, BTw, C, d) ||
      p.route != 1 || p.mode != kModeProbe || nrows < BF + 4 * d ||
      BTw != BT + 16 || (dtype != 1 && dtype != 2) ||
      p.n_it != 5 * C * (dtype == 1 ? 2 : 1) / 32 || p.splits < 1 ||
      p.gz != p.splits || (long)p.gx * p.TT < BT || (long)p.gy * p.TF < BF)
    return (int)cudaErrorInvalidValue;
  if (BF <= 0 || BT <= 0 || reps <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int NT = C / p.splits;
  if (NT * p.splits != C) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (NT == 32)
      return launch_stage<32, __nv_bfloat16>(p, h, wpk, out, BF, BT, reps,
                                             dep, st);
    if (NT == 64)
      return launch_stage<64, __nv_bfloat16>(p, h, wpk, out, BF, BT, reps,
                                             dep, st);
  } else {
    if (NT == 32)
      return launch_stage<32, int8_t>(p, h, wpk, out, BF, BT, reps, dep, st);
    if (NT == 64)
      return launch_stage<64, int8_t>(p, h, wpk, out, BF, BT, reps, dep, st);
  }
  return (int)cudaErrorInvalidValue;
}
