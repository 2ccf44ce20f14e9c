// K3: one ResnetBlock dilation stage with the conv in int8.
//
//   q    = clip(round(gelu6(float(x) * a) * iv), +-127)   int8 conv input
//   acc  = conv5x3_d(q, qw)                               int8 x int8 -> int32
//   y3   = float(x) * (1/sqrt2) + float(acc) * post        fp32
//   y    = y3 in x's type
//   mom  = per-(B, C) [sum y3, sum y3^2, max |y3|]         fp32
//
// a (B, C), iv (B,) = 127/bound and post (B, C) = bound/127 * sw * s /
// sqrt2 are fp32; qw is the per-output-channel int8 kernel, tap-major
// (15, C, C).  Replaces the TPU kernel
// babe_tpu/ops/conv_kernels.py::_build_fused_int8_call (entry
// fused_stage_int8, oracle _dil_stage_int8_ref); the plain version is
// babe_tpu_torch/ops/conv_kernels.py::dil_stage_int8_ref.  The TPU's chained
// padded layout, its sequential tile loop and its output aliasing do not
// carry over: this kernel reads and writes unpadded (B, F, T, C) tensors,
// and its blocks run in any order.
//
// Two routes, chosen and cut by the host (kernels.stage_int8_route,
// stage_plan) and passed in as a StagePlan:
//   * bf16 x at the engine's shapes (C a multiple of 32 in 96..256, T >=
//     16: every int8 flagship stage at any batch): babe_stage_int8_operand
//     quantizes q once per element (16 values per step: 32 bytes of x
//     read, 16 bytes of q written), then the sm_90a engine of
//     stage_mma_sm90.cuh (kModeI8) runs the int8 conv on q with wgmma
//     m64nCk32 s8 x s8 -> s32 and the epilogue below through shared memory.
//   * fp32 x and every other shape (C = 100 in the checks): the tile below.
//
// Prologue (the operand pass, and the tile's staging): x * a in fp32 (not
// rounded to x's type), the degree-6 erf gelu, * iv, round half to even,
// clip.  Every step is one rounded fp32 operation (__fmul_rn / __fadd_rn
// forbid FMA contraction) in the plain version's order, so the int8
// values agree with it bit for bit.  Taps outside F or T and channels past
// C stage as 0 (gelu(0) = 0).
//
// The tile (conv5x3_mma.cuh's, in int8): while the 5 input rows at
// dilation d (and the T halo) of a 32-channel chunk are staged into shared
// memory, each value is quantized as above; mma.sync m16n8k32 s8 x s8 ->
// s32 over 15 taps x C/32 chunks.  |acc| <= 15 * 256 * 127^2 < 2^31 on
// either route.
//
// Epilogue (both routes): y3 in fp32 in the plain version's order; y is
// stored in x's type, and the moments come from the fp32 y3: per block in
// shared memory, then one fp32 atomicAdd per sum and one atomicMax on the
// bits of the non-negative max per channel and block into a zeroed (3, B,
// C).  Atomic order makes the sums' last bits vary from run to run.
//
// Bound on the H100: at the model's widths the int8 products (2*15*C
// operations per output element at 1979 Tops/s) outweigh the bytes (x
// read, y written, 2-4 bytes each, and q written and read once).  The
// tile recomputes the fp32 gelu for every staged copy of an element (5
// rows x C/64 channel tiles), which cost it more than its mma; the
// engine's operand pass computes it once.
#include <algorithm>

#include "mma_frag.cuh"
#include "stage_mma_sm90.cuh"

namespace babe {
namespace k3 {

using frag::kMB;
using frag::kNB;
using frag::kThreads;
using frag::kW;

struct Params {
  const void* x;        // (B, F, T, C) in T
  const int8_t* wq;     // (15, C, C) tap-major int8 kernel
  void* y;              // (B, F, T, C) in T
  const float* a;       // (B, C)
  const float* iv;      // (B,)
  const float* post;    // (B, C)
  float* mom;           // (3, B, C), zeroed by the caller
  int8_t* q_out;        // optional (B, F, T, C): the quantized conv input
  int B, F, T, C, d;
  int TT, TF, n_tiles;
  int vec;              // 4-channel vector loads are aligned
};

template <typename T> struct IO;

template <> struct IO<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
    const float4 r = *reinterpret_cast<const float4*>(p);
    v[0] = r.x; v[1] = r.y; v[2] = r.z; v[3] = r.w;
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};

template <> struct IO<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                               float (&v)[4]) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&r);
#pragma unroll
    for (int k = 0; k < 4; ++k) v[k] = __bfloat162float(e[k]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);  // round to nearest even, as torch does
  }
};

// gelu with the degree-6 erf fit (the JAX package's _gelu_cheap_impl):
// 0.5 x (1 + z P(z^2)), z = clip(x / sqrt2, +-3.2).  The constants are the
// double literals rounded to float, as the plain version's scalars are.
__device__ __forceinline__ float gelu6(float x) {
  const float z = fminf(fmaxf(__fmul_rn(x, (float)0.7071067811865475),
                              (float)-3.2), (float)3.2);
  const float v = __fmul_rn(z, z);
  float p = __fadd_rn(__fmul_rn(v, (float)2.8324000000e-06),
                      (float)-1.1349870000e-04);
  p = __fadd_rn(__fmul_rn(p, v), (float)1.8964682000e-03);
  p = __fadd_rn(__fmul_rn(p, v), (float)-1.7389500700e-02);
  p = __fadd_rn(__fmul_rn(p, v), (float)9.7881790600e-02);
  p = __fadd_rn(__fmul_rn(p, v), (float)-3.6561742760e-01);
  p = __fadd_rn(__fmul_rn(p, v), (float)1.1264247159e+00);
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, __fmul_rn(z, p)));
}

__device__ __forceinline__ int quant(float h, float iv) {
  const int q = __float2int_rn(__fmul_rn(h, iv));  // half to even
  return max(-127, min(127, q));
}

inline size_t smem_bytes(int TT) {
  const int TF = kMB / TT;
  return (size_t)(TF * 5 * (TT + 2) + 15 * kNB) * kW * 4 + 3 * kNB * 4;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) stage_int8(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TT = p.TT, TF = p.TF, TW = TT + 2, nrow = TF * 5, C = p.C;
  uint32_t* xs = reinterpret_cast<uint32_t*>(smem);          // [nrow][TW][kW]
  uint32_t* ws = xs + nrow * TW * kW;                         // [15][kNB][kW]
  float* red = reinterpret_cast<float*>(ws + 15 * kNB * kW);  // [3][kNB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int b = blockIdx.z / p.n_tiles;
  const int nt = blockIdx.z % p.n_tiles, n0 = nt * kNB;
  const int t0 = blockIdx.x * TT, f0 = blockIdx.y * TF;
  const T* x = static_cast<const T*>(p.x);
  const size_t xb = (size_t)b * p.F * p.T * C;
  const float ivb = p.iv[b];
  const float* ab = p.a + (size_t)b * C;
  const bool want_q = p.q_out != nullptr && nt == 0;

  if (tid < 3 * kNB) red[tid] = 0.f;

  int acc[2][4][4];
  frag::zero(acc);
  int fi[2], tl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = wm * 32 + i * 16;
    fi[i] = m / TT;
    tl[i] = m % TT;
  }

  for (int c0 = 0; c0 < C; c0 += 32) {
    // prologue: stage and quantize the input window, 4 channels per unit;
    // row r = fr*5 + kf, column col <-> t0-1+col
    for (int u = tid; u < nrow * TW * 8; u += kThreads) {
      const int h = u & 7;
      const int col = (u >> 3) % TW;
      const int r = (u >> 3) / TW;
      const int kf = r % 5;
      const int f = f0 + r / 5 + (kf - 2) * p.d;
      const int t = t0 - 1 + col;
      const int cb = c0 + h * 4;
      uint32_t packed = 0;
      if (f >= 0 && f < p.F && t >= 0 && t < p.T && cb < C) {
        const size_t idx = xb + ((size_t)f * p.T + t) * C + cb;
        float v[4];
        if (p.vec && cb + 4 <= C) {
          IO<T>::load4(x + idx, v);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            v[e] = cb + e < C ? IO<T>::load(x + idx + e) : 0.f;
        }
        const bool keep = want_q && kf == 2 && col >= 1 && col <= TT;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (cb + e >= C) continue;
          const int qv = quant(gelu6(__fmul_rn(v[e], ab[cb + e])), ivb);
          packed |= (uint32_t)(uint8_t)(int8_t)qv << (8 * e);
          if (keep) p.q_out[idx + e] = (int8_t)qv;
        }
      }
      xs[(r * TW + col) * kW + h] = packed;
    }
    // stage the weights: (tap, n) rows of 32 input channels
    for (int u = tid; u < 15 * kNB * 8; u += kThreads) {
      const int h = u & 7;
      const int n = (u >> 3) % kNB;
      const int tap = (u >> 3) / kNB;
      const int nn = n0 + n, cb = c0 + h * 4;
      uint32_t v = 0;
      if (nn < C && cb < C)
        v = frag::load_word(p.wq + ((size_t)tap * C + nn) * C + cb, C - cb,
                            p.vec != 0);
      ws[(tap * kNB + n) * kW + h] = v;
    }
    __syncthreads();

#pragma unroll
    for (int kf = 0; kf < 5; ++kf) {
#pragma unroll
      for (int kt = 0; kt < 3; ++kt) {
        // A[m][k]: position m (row fi, column tl + m), channel k
        frag::warp_mma(
            acc, xs + ((fi[0] * 5 + kf) * TW + tl[0] + g + kt) * kW + q,
            xs + ((fi[1] * 5 + kf) * TW + tl[1] + g + kt) * kW + q,
            ws + ((kf * 3 + kt) * kNB + wn * 32 + g) * kW + q);
      }
    }
    __syncthreads();
  }

  // epilogue: accumulator element (i, j, hr*2 + e) is position
  // wm*32 + i*16 + g + 8*hr, output channel n0 + wn*32 + j*8 + 2q + e
  T* y = static_cast<T*>(p.y);
  float m1[4][2], m2[4][2], mx[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) m1[j][e] = m2[j][e] = mx[j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int f = f0 + fi[i];
      const int t = t0 + tl[i] + g + 8 * hr;
      if (f >= p.F || t >= p.T) continue;
      const size_t base = (((size_t)b * p.F + f) * p.T + t) * C;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nn = n0 + wn * 32 + j * 8 + 2 * q + e;
          if (nn >= C) continue;
          const float xv = IO<T>::load(x + base + nn);
          const float y3 = __fadd_rn(
              __fmul_rn(xv, (float)0.7071067811865475),
              __fmul_rn(__int2float_rn(acc[i][j][hr * 2 + e]),
                        p.post[(size_t)b * C + nn]));
          IO<T>::store(y + base + nn, y3);
          m1[j][e] += y3;
          m2[j][e] = fmaf(y3, y3, m2[j][e]);
          mx[j][e] = fmaxf(mx[j][e], fabsf(y3));
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int nl = wn * 32 + j * 8 + 2 * q + e;
      atomicAdd(&red[nl], m1[j][e]);
      atomicAdd(&red[kNB + nl], m2[j][e]);
      // non-negative floats order as their bit patterns do
      atomicMax(reinterpret_cast<int*>(&red[2 * kNB + nl]),
                __float_as_int(mx[j][e]));
    }
  __syncthreads();
  if (tid < kNB && n0 + tid < C) {
    const size_t o = (size_t)b * C + n0 + tid, bc = (size_t)p.B * C;
    atomicAdd(p.mom + o, red[tid]);
    atomicAdd(p.mom + bc + o, red[kNB + tid]);
    atomicMax(reinterpret_cast<int*>(p.mom + 2 * bc + o),
              __float_as_int(red[2 * kNB + tid]));
  }
}

// q = clip(rint(gelu6(float(x) * a) * iv), +-127) of K3, 16 channels per
// step
__global__ void __launch_bounds__(256) stage_q(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ iv, int8_t* __restrict__ q, int C,
    size_t per_b, size_t n) {
  for (size_t e = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * 16;
       e < n; e += (size_t)gridDim.x * blockDim.x * 16) {
    const int b = (int)(e / per_b), c0 = (int)(e % C);
    const float ivb = iv[b];
    const float* ab = a + (size_t)b * C + c0;
    __align__(16) __nv_bfloat16 xv[16];
    __align__(16) int8_t qv[16];
    *reinterpret_cast<uint4*>(xv) = *reinterpret_cast<const uint4*>(x + e);
    *reinterpret_cast<uint4*>(xv + 8) =
        *reinterpret_cast<const uint4*>(x + e + 8);
#pragma unroll
    for (int k = 0; k < 16; ++k)
      qv[k] = (int8_t)quant(
          gelu6(__fmul_rn(__bfloat162float(xv[k]), ab[k])), ivb);
    *reinterpret_cast<uint4*>(q + e) = *reinterpret_cast<const uint4*>(qv);
  }
}

template <typename T>
int launch(Params p, cudaStream_t stream) {
  if (p.B <= 0 || p.F <= 0 || p.T <= 0 || p.C <= 0) return 0;
  int TT = 16;  // a power of two >= 16: each 16-position mma tile in one row
  while (TT < p.T && TT < kMB) TT <<= 1;
  p.TT = TT;
  p.TF = kMB / TT;
  p.n_tiles = (p.C + kNB - 1) / kNB;
  p.vec = (p.C % 4 == 0) &&
          (reinterpret_cast<uintptr_t>(p.x) % (4 * sizeof(T)) == 0) &&
          (reinterpret_cast<uintptr_t>(p.wq) % 4 == 0);
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        stage_int8<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem_bytes(16));  // the largest of the TT choices
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((p.T + TT - 1) / TT, (p.F + p.TF - 1) / p.TF, p.B * p.n_tiles);
  stage_int8<T><<<grid, kThreads, smem_bytes(TT), stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace k3
}  // namespace babe

// K3's engine input q, (B, F, T, C) int8 from bf16 x with C a multiple of
// 16 (plain version ops/conv_kernels.stage_quant_ref)
extern "C" int babe_stage_int8_operand(const void* x, const void* a,
                                       const void* iv, void* q, int B, int F,
                                       int T, int C, void* stream) {
  if (C % 16 != 0) return (int)cudaErrorInvalidValue;
  if (B <= 0 || F <= 0 || T <= 0 || C <= 0) return 0;
  const size_t per_b = (size_t)F * T * C, n = per_b * B;
  const int blocks = (int)std::min<size_t>((n / 16 + 255) / 256, 132 * 16);
  babe::k3::stage_q<<<blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
      static_cast<const float*>(iv), static_cast<int8_t*>(q), C, per_b, n);
  return (int)cudaGetLastError();
}

// route 1: the sm_90a engine (stage_mma_sm90.cuh) with the cut in meta (a
// StagePlan), the packed int8 weights wpk and its input q
// (babe_stage_int8_operand on x, a and iv; they are then read only through
// q); route 0: the tile with wq tap-major, q_out (optional) receiving its
// quantized input
extern "C" int babe_fused_stage_int8(const void* x, const void* a,
                                     const void* iv, const void* post,
                                     const void* wq, const void* wpk,
                                     const void* q, void* y, void* mom,
                                     void* q_out, int B, int F, int T, int C,
                                     int d, int dtype, const int* meta,
                                     int n_meta, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  babe::sm90::StagePlan plan;
  if (!babe::sm90::read_plan(plan, meta, n_meta, B, F, T, C, d))
    return (int)cudaErrorInvalidValue;
  if (plan.route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    babe::sm90::StageArgs g{};
    g.src = q;
    g.wpk = wpk;
    g.x = static_cast<const __nv_bfloat16*>(x);
    g.v0 = static_cast<const float*>(post);
    g.out = static_cast<__nv_bfloat16*>(y);
    g.sums = static_cast<float*>(mom);
    return babe::sm90::launch_stage<babe::sm90::kModeI8>(plan, g, st);
  }
  babe::k3::Params p{};
  p.x = x;
  p.wq = static_cast<const int8_t*>(wq);
  p.y = y;
  p.a = static_cast<const float*>(a);
  p.iv = static_cast<const float*>(iv);
  p.post = static_cast<const float*>(post);
  p.mom = static_cast<float*>(mom);
  p.q_out = static_cast<int8_t*>(q_out);
  p.B = B;
  p.F = F;
  p.T = T;
  p.C = C;
  p.d = d;
  if (dtype == 0) return babe::k3::launch<float>(p, st);
  if (dtype == 1) return babe::k3::launch<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}
