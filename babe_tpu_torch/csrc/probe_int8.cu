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
//      3 shifted columns are the 15 patches of the implicit GEMM, staged in
//      shared memory, then 5 x 3 mma k-steps per 32-byte chunk.  The whole
//      product is repeated `reps` times; each repetition's staging adds
//      (first accumulator of the block) * dep to every staged value, so it
//      depends on the previous repetition's result and the compiler can
//      hoist neither the staging nor the products.  The caller passes
//      dep = 0, so every repetition computes the same product.  Replaces
//      tools/probe_pallas_int8.py::make_stage, whose repetitions feed the
//      accumulator back into the staged rows in the same way.
//
// P2 keeps the mma.sync warp tile of mma_frag.cuh (128 positions x 64
// channels per block of 8 warps), which the main path's stages no longer
// run (K2 and K3 run wgmma on stage_mma_sm90.cuh): its ratio is that of
// the older tile.  Bound: operations (2*15*C*reps operations per
// output element against a few bytes); P1's, bytes (probe_gemm_sm90.cuh).
#include "mma_frag.cuh"
#include "probe_gemm_sm90.cuh"

namespace babe {
namespace probe {

using frag::kMB;
using frag::kNB;
using frag::kThreads;
using frag::kW;

// P2's output: fp32 (bf16 products) or int32 (int8 products)
__device__ __forceinline__ void store_out(void* out, size_t i, float v) {
  static_cast<float*>(out)[i] = v;
}

__device__ __forceinline__ void store_out(void* out, size_t i, int v) {
  static_cast<int*>(out)[i] = v;
}

// each staged byte (int8) or half-word (bf16) plus `carry`
__device__ __forceinline__ uint32_t add_carry(uint32_t w, int carry, int8_t) {
  uint32_t o = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    o |= (uint32_t)(uint8_t)(int8_t)((int8_t)(w >> (8 * k)) + carry)
         << (8 * k);
  return o;
}

__device__ __forceinline__ uint32_t add_carry(uint32_t w, int carry,
                                              __nv_bfloat16) {
  __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&w);
  v.x = __float2bfloat16(__bfloat162float(v.x) + (float)carry);
  v.y = __float2bfloat16(__bfloat162float(v.y) + (float)carry);
  return *reinterpret_cast<const uint32_t*>(&v);
}

struct StageParams {
  const void* h;   // (nrows, BTw, C)
  const void* wt;  // (15, C, C) tap-major
  void* out;       // (BF*BT, C)
  int nrows, BTw, C, BF, BT, d, reps, dep;
  int TT, TF, vec;
};

inline size_t stage_smem(int TT) {
  const int TF = kMB / TT;
  return (size_t)(TF * 5 * (TT + 2) + 15 * kNB) * kW * 4;
}

// P2: 128 output positions (TF rows x TT columns) x 64 channels per block
template <typename E, typename Acc>
__global__ void __launch_bounds__(kThreads) stage(StageParams p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int carry;
  const int TT = p.TT, TF = p.TF, TW = TT + 2, nrow = TF * 5, C = p.C;
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem);  // [nrow][TW][kW]
  uint32_t* ws = xs + nrow * TW * kW;                 // [15][kNB][kW]
  const E* h = static_cast<const E*>(p.h);
  const E* wt = static_cast<const E*>(p.wt);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3, wm = warp & 3, wn = warp >> 2;
  const int t0 = blockIdx.x * TT, f0 = blockIdx.y * TF, n0 = blockIdx.z * kNB;
  constexpr int kPer = 4 / sizeof(E);
  int fi[2], tl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = wm * 32 + i * 16;
    fi[i] = m / TT;
    tl[i] = m % TT;
  }
  if (tid == 0) carry = 0;
  __syncthreads();

  Acc acc[2][4][4];
  for (int rep = 0; rep < p.reps; ++rep) {
    frag::zero(acc);
    const int cr = carry;
    for (int c0 = 0; c0 < C; c0 += 8 * kPer) {
      // the 15 patches: staged row r = fr*5 + kf is h row f0+fr + kf*d,
      // column col is h column t0 + 7 + col
      for (int u = tid; u < nrow * TW * 8; u += kThreads) {
        const int hw = u & 7;
        const int col = (u >> 3) % TW;
        const int r = (u >> 3) / TW;
        const int f = f0 + r / 5;
        const int hrow = f + (r % 5) * p.d;
        const int hcol = t0 + 7 + col;
        const int cb = c0 + hw * kPer;
        uint32_t v = 0;
        if (f < p.BF && hrow < p.nrows && hcol < p.BTw && cb < C)
          v = add_carry(
              frag::load_word(h + ((size_t)hrow * p.BTw + hcol) * C + cb,
                              (C - cb) * (int)sizeof(E), p.vec != 0),
              cr, E());
        xs[(r * TW + col) * kW + hw] = v;
      }
      for (int u = tid; u < 15 * kNB * 8; u += kThreads) {
        const int hw = u & 7;
        const int n = (u >> 3) % kNB;
        const int tap = (u >> 3) / kNB;
        const int nn = n0 + n, cb = c0 + hw * kPer;
        uint32_t v = 0;
        if (nn < C && cb < C)
          v = frag::load_word(wt + ((size_t)tap * C + nn) * C + cb,
                              (C - cb) * (int)sizeof(E), p.vec != 0);
        ws[(tap * kNB + n) * kW + hw] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kf = 0; kf < 5; ++kf)
#pragma unroll
        for (int kt = 0; kt < 3; ++kt)
          frag::warp_mma(
              acc, xs + ((fi[0] * 5 + kf) * TW + tl[0] + g + kt) * kW + q,
              xs + ((fi[1] * 5 + kf) * TW + tl[1] + g + kt) * kW + q,
              ws + ((kf * 3 + kt) * kNB + wn * 32 + g) * kW + q);
      __syncthreads();
    }
    if (tid == 0) carry = (int)acc[0][0][0] * p.dep;
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = f0 + fi[i];
          const int t = t0 + tl[i] + g + 8 * hr;
          const int n = n0 + wn * 32 + j * 8 + 2 * q + e;
          if (f < p.BF && t < p.BT && n < C)
            store_out(p.out, ((size_t)f * p.BT + t) * C + n,
                      acc[i][j][hr * 2 + e]);
        }
}

template <typename E, typename Acc>
int launch_stage(StageParams p, cudaStream_t stream) {
  if (p.BF <= 0 || p.BT <= 0 || p.C <= 0) return 0;
  int TT = 16;
  while (TT < p.BT && TT < kMB) TT <<= 1;
  p.TT = TT;
  p.TF = kMB / TT;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        stage<E, Acc>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)stage_smem(16));
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((p.BT + TT - 1) / TT, (p.BF + p.TF - 1) / p.TF,
            (p.C + kNB - 1) / kNB);
  stage<E, Acc><<<grid, kThreads, stage_smem(TT), stream>>>(p);
  return (int)cudaGetLastError();
}

inline bool aligned4(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 4 == 0;
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

extern "C" int babe_probe_stage(const void* h, const void* wt, void* out,
                                int nrows, int BTw, int C, int BF, int BT,
                                int d, int reps, int dep, int dtype,
                                void* stream) {
  using namespace babe::probe;
  StageParams p{};
  p.h = h;
  p.wt = wt;
  p.out = out;
  p.nrows = nrows;
  p.BTw = BTw;
  p.C = C;
  p.BF = BF;
  p.BT = BT;
  p.d = d;
  p.reps = reps;
  p.dep = dep;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    p.vec = C % 2 == 0 && aligned4(h) && aligned4(wt);
    return launch_stage<__nv_bfloat16, float>(p, st);
  }
  if (dtype == 2) {
    p.vec = C % 4 == 0 && aligned4(h) && aligned4(wt);
    return launch_stage<int8_t, int>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}
