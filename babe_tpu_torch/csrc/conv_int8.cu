// C8: the int8 'SAME' (5,3) conv at dilation (d,1) of the unfused int8
// path, with its rescale.
//
//   acc = conv5x3_d(q, qw)               int8 x int8 -> int32
//   out = float(acc) * scale[b, n]       in the output's type (bf16, fp32)
//
// q (B, F, T, C) int8 is the quantized activation (Q8, quant_int8.cu),
// qw the per-output-channel int8 kernel, tap-major (15, N, C), and scale
// (B, N) fp32 = s_x[b] * s_w[n], formed by the launcher as the plain
// version forms it.  It stands for XLA's int8 convolution in
// babe_tpu/ops/conv_kernels.py::_conv_int8_impl and _conv_int8_hinted_impl
// (conv_general_dilated with preferred_element_type int32, then the
// rescale); no Pallas kernel.  Plain version:
// babe_tpu_torch/ops/conv_kernels.py::conv_int8_acc_ref (the conv in float64
// on the int values, exact) and int8_rescale_ref.  The int32 sums are exact
// on every route, so the accumulator agrees with the plain version bit for
// bit, and out too (one rounded fp32 product, then one rounding to the
// output's type, as the plain version rounds).
//
// Two routes, chosen and cut by the host (kernels.conv_int8_route,
// stage_plan) and passed in as a StagePlan:
//   * C = N in {96, 128, 256} with T >= 16 (every flagship int8 stage and
//     its int8 input gradient): the stage engine's int8 main loop
//     (stage_mma_sm90.cuh, conv_loop: cp.async ring, ldmatrix A, wgmma
//     m64nNTk32 s8 from the engine's weight pack), then this file's
//     epilogue: the int32 accumulators through shared memory, 8 channels a
//     thread, one fp32 product each, 16-byte stores.
//   * every other shape (the tiny network's 16 and 32 channels, T < 16,
//     C != N): a tile of 32 positions of one row x 32 output channels per
//     block, 64 input channels a stage in shared memory, __dp4a over 4
//     channels a word.
//
// acc_out, when given, receives the int32 accumulator (the checks' view).
//
// Bound on the H100: 2*15*C*N operations per position at 1979 Tops/s
// against C bytes read and N * 2-4 bytes written: operations from C = 96.
#include <cuda_bf16.h>
#include <stdint.h>

#include "stage_mma_sm90.cuh"

namespace babe {
namespace c8 {

using sm90::StagePlan;

template <typename T> struct Out;
template <> struct Out<float> {
  static __device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};
template <> struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ void store8(__nv_bfloat16* p,
                                                const float (&v)[8]) {
    __align__(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(v[e]);  // RNE
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(o);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);
  }
};

// ---------------------------------------------------------------- engine

// block (gx, gy, z): positions f0 + q / TT, t0 + q % TT (q < 128) of item
// z / splits, output channels n0 .. n0 + NT (n0 = (z % splits) * NT)
template <int NT, typename T>
__global__ void __launch_bounds__(256, NT <= 128 ? 2 : 1)
    c8_engine(const StagePlan p, const int8_t* q, const void* wpk,
              const float* scale, T* out, int32_t* acc_out) {
  extern __shared__ __align__(128) unsigned char smem_c8[];
  unsigned char* smem = smem_c8;
  float* sc = reinterpret_cast<float*>(smem + p.ring_bytes);  // NT scales
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w4 = warp & 3;
  const int b = blockIdx.z / p.splits, n0 = (blockIdx.z % p.splits) * NT;
  const int t0 = blockIdx.x * p.TT, f0 = blockIdx.y * p.TF;
  const int C = p.C, F = p.F, T_ = p.T;
  const size_t bbase = (size_t)b * F * T_ * C;
  for (int n = tid; n < NT; n += 256) sc[n] = scale[(size_t)b * C + n0 + n];

  int32_t acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0;
  sm90::conv_loop<NT, 1, false, 2>(
      p, reinterpret_cast<const unsigned char*>(q),
      static_cast<const unsigned char*>(wpk), bbase, f0, t0, n0,
      sm90::smem_u32(smem), acc);

  // the ring becomes an int32 tile: register n8*4 + hr*2 + e is warp row
  // gq + 8hr, column 8 n8 + 2q + e
  constexpr int NP = NT + 4;
  int32_t* tile = reinterpret_cast<int32_t*>(smem);
  {
    const int gq = lane >> 2, qq = lane & 3;
    const int r0 = wg * 64 + w4 * 16 + gq;
#pragma unroll
    for (int n8 = 0; n8 < NT / 8; ++n8)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<int2*>(tile + (r0 + 8 * hr) * NP + n8 * 8 +
                                 2 * qq) =
            make_int2(acc[n8 * 4 + hr * 2], acc[n8 * 4 + hr * 2 + 1]);
  }
  __syncthreads();

  // 8 channels a thread: R threads a position, P positions a pass
  constexpr int R = NT / 8;
  constexpr int P = 256 / R;
  const int cg = tid % R, p0 = tid / R;
  if (p0 >= P) return;
  float s8[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) s8[e] = sc[cg * 8 + e];
  for (int qp = p0; qp < sm90::kPos; qp += P) {
    const int f = f0 + (qp >> p.tt_log2), t = t0 + (qp & (p.TT - 1));
    if (f >= F || t >= T_) continue;
    const int32_t* row = tile + qp * NP + cg * 8;
    const int4 a0 = *reinterpret_cast<const int4*>(row);
    const int4 a1 = *reinterpret_cast<const int4*>(row + 4);
    const int32_t av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(__int2float_rn(av[e]), s8[e]);
    const size_t idx = bbase + ((size_t)f * T_ + t) * C + n0 + cg * 8;
    Out<T>::store8(out + idx, v);
    if (acc_out != nullptr) {
      *reinterpret_cast<int4*>(acc_out + idx) = a0;
      *reinterpret_cast<int4*>(acc_out + idx + 4) = a1;
    }
  }
}

template <int NT, typename T>
int launch_engine(const StagePlan& p, const int8_t* q, const void* wpk,
                  const float* scale, T* out, int32_t* acc_out,
                  cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        c8_engine<NT, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        232448);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  c8_engine<NT, T><<<dim3(p.gx, p.gy, p.gz), 256, p.smem, st>>>(
      p, q, wpk, scale, out, acc_out);
  return (int)cudaGetLastError();
}

template <typename T>
int engine(const StagePlan& p, const int8_t* q, const void* wpk,
           const float* scale, T* out, int32_t* acc_out, cudaStream_t st) {
  if (p.splits < 1 || p.C % p.splits != 0) return (int)cudaErrorInvalidValue;
  switch (p.C / p.splits) {
    case 96: return launch_engine<96, T>(p, q, wpk, scale, out, acc_out, st);
    case 128:
      return launch_engine<128, T>(p, q, wpk, scale, out, acc_out, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ------------------------------------------------------------------ tile

constexpr int kTP = 32;   // positions per block (one row of F)
constexpr int kTN = 32;   // output channels per block
constexpr int kTC = 64;   // input channels per shared-memory stage
constexpr int kTW = kTP + 2;

// block (x, f, b * nN + nt): positions (f, x*32 .. x*32 + 31), output
// channels nt*32 .. nt*32 + 31; thread (tx, ty) = (tid % 32, tid / 32):
// position tx, output channels ty*4 .. ty*4 + 3
template <typename T>
__global__ void __launch_bounds__(256)
    c8_tile(const int8_t* __restrict__ q, const int8_t* __restrict__ wq,
            const float* __restrict__ scale, T* __restrict__ out,
            int32_t* __restrict__ acc_out, int B, int F, int T_, int C,
            int N, int d) {
  __shared__ __align__(16) int8_t xs[5][kTW][kTC];
  __shared__ __align__(16) int8_t ws[15][kTN][kTC];
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int nN = (N + kTN - 1) / kTN;
  const int b = blockIdx.z / nN, n0 = (blockIdx.z % nN) * kTN;
  const int f = blockIdx.y, t0 = blockIdx.x * kTP;
  const size_t qb = (size_t)b * F * T_ * C;
  int acc[4] = {0, 0, 0, 0};
  for (int c0 = 0; c0 < C; c0 += kTC) {
    for (int u = tid; u < 5 * kTW * kTC; u += 256) {
      const int c = u % kTC, j = (u / kTC) % kTW, kf = u / (kTC * kTW);
      const int ff = f + (kf - 2) * d, t = t0 - 1 + j, cc = c0 + c;
      int8_t v = 0;
      if (ff >= 0 && ff < F && t >= 0 && t < T_ && cc < C)
        v = q[qb + ((size_t)ff * T_ + t) * C + cc];
      xs[kf][j][c] = v;
    }
    for (int u = tid; u < 15 * kTN * kTC; u += 256) {
      const int c = u % kTC, n = (u / kTC) % kTN, tap = u / (kTC * kTN);
      const int nn = n0 + n, cc = c0 + c;
      ws[tap][n][c] =
          (nn < N && cc < C) ? wq[((size_t)tap * N + nn) * C + cc] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kf = 0; kf < 5; ++kf)
#pragma unroll
      for (int kt = 0; kt < 3; ++kt) {
        const int* a = reinterpret_cast<const int*>(&xs[kf][tx + kt][0]);
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const int* w =
              reinterpret_cast<const int*>(&ws[kf * 3 + kt][ty * 4 + o][0]);
#pragma unroll
          for (int k = 0; k < kTC / 4; ++k) acc[o] = __dp4a(a[k], w[k], acc[o]);
        }
      }
    __syncthreads();
  }
  const int t = t0 + tx;
  if (t >= T_) return;
  const size_t ob = ((size_t)b * F * T_ + (size_t)f * T_ + t) * N;
#pragma unroll
  for (int o = 0; o < 4; ++o) {
    const int n = n0 + ty * 4 + o;
    if (n >= N) continue;
    Out<T>::store(out + ob + n, __fmul_rn(__int2float_rn(acc[o]),
                                          scale[(size_t)b * N + n]));
    if (acc_out != nullptr) acc_out[ob + n] = acc[o];
  }
}

template <typename T>
int tile(const int8_t* q, const int8_t* wq, const float* scale, T* out,
         int32_t* acc_out, int B, int F, int T_, int C, int N, int d,
         cudaStream_t st) {
  const int nN = (N + kTN - 1) / kTN;
  dim3 grid((T_ + kTP - 1) / kTP, F, B * nN);
  c8_tile<T><<<grid, 256, 0, st>>>(q, wq, scale, out, acc_out, B, F, T_, C,
                                    N, d);
  return (int)cudaGetLastError();
}

}  // namespace c8
}  // namespace babe

// route 1 (the engine, C = N): the cut in meta (a StagePlan), the packed
// weights wpk; route 0 (the tile): the tap-major kernel wq (15, N, C).
// dtype of out: 0 fp32, 1 bf16.  acc_out (optional): the int32 accumulator.
extern "C" int babe_conv_int8(const void* q, const void* wq, const void* wpk,
                              const void* scale, void* out, void* acc_out,
                              int B, int F, int T, int C, int N, int d,
                              int dtype, const int* meta, int n_meta,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || F <= 0 || T <= 0 || C <= 0 || N <= 0) return 0;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int8_t* qi = static_cast<const int8_t*>(q);
  const float* sc = static_cast<const float*>(scale);
  int32_t* ao = static_cast<int32_t*>(acc_out);
  babe::sm90::StagePlan plan;
  if (!babe::sm90::read_plan(plan, meta, n_meta, B, F, T, C, d))
    return (int)cudaErrorInvalidValue;
  if (plan.route == 1) {
    if (C != N) return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return babe::c8::engine<float>(plan, qi, wpk, sc,
                                     static_cast<float*>(out), ao, st);
    return babe::c8::engine<__nv_bfloat16>(
        plan, qi, wpk, sc, static_cast<__nv_bfloat16*>(out), ao, st);
  }
  const int8_t* w = static_cast<const int8_t*>(wq);
  if (dtype == 0)
    return babe::c8::tile<float>(qi, w, sc, static_cast<float*>(out), ao, B,
                                 F, T, C, N, d, st);
  return babe::c8::tile<__nv_bfloat16>(
      qi, w, sc, static_cast<__nv_bfloat16*>(out), ao, B, F, T, C, N, d, st);
}
