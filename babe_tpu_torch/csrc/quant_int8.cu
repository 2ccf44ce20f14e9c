// Q8: the per-item int8 quantizers of the unfused int8 path, and the
// rescale of an int32 product.
//
//   babe_act_amax     amax[b] = max |x[b, ...]|                (B,) fp32
//   babe_act_quant    a = max(amax[b], 1e-20), s[b] = a / 127,
//                     q = clip(rint(float(x) * (127 / a)), +-127)  int8
//   babe_act_rescale  out = float(acc) * scale[b, n]  in the output type
//
// x is fp32 or bf16, (B, per_b) with per_b = F*T*C; acc is int32 (B,
// rows, N) with scale (B, N) fp32 = s_x[b] * s_w[n].  They stand for the
// XLA fusions of babe_tpu/ops/conv_kernels.py::_quant_act_per_item (the
// amax reduction and the quantize), _quant_act_with_scale (the quantize
// with a given amax: the hinted stage input) and the rescale after the
// int8 1x1 einsum of _dot1x1_int8_impl; no Pallas kernel.  Plain versions:
// babe_tpu_torch/ops/conv_kernels.py::quant_act_per_item,
// quant_act_with_scale and int8_rescale_ref.  Each rounds as the plain
// version does: the divisions are IEEE (__fdiv_rn), x * (127 / a) one
// rounded fp32 product, the rounding to int half to even, so q and s agree
// with the plain versions bit for bit; the amax is a max, exact in any
// order.
//
// Bound on the H100: bytes (a read of x for the amax; a read of x and a
// write of q for the quantize; the int32 read and the output's write for
// the rescale).
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace babe {
namespace q8 {

template <typename T> struct In;
template <> struct In<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
};
template <> struct In<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
};

template <typename T> struct Out;
template <> struct Out<float> {
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
};
template <> struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);  // round to nearest even, as torch does
  }
};

// grid (blocks per item, B): each block's max over its share of item b,
// then one atomicMax on the bits of the non-negative float (they order as
// the floats do) into amax, zeroed by the caller
template <typename T>
__global__ void __launch_bounds__(256)
    act_amax(const T* __restrict__ x, float* __restrict__ amax,
             size_t per_b) {
  __shared__ float red[8];
  const int b = blockIdx.y;
  const T* xb = x + (size_t)b * per_b;
  float m = 0.f;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < per_b;
       i += (size_t)gridDim.x * blockDim.x)
    m = fmaxf(m, fabsf(In<T>::load(xb + i)));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) m = fmaxf(m, red[w]);
    atomicMax(reinterpret_cast<int*>(amax + b), __float_as_int(m));
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    act_quant(const T* __restrict__ x, const float* __restrict__ amax,
              int8_t* __restrict__ q, float* __restrict__ s, int B,
              size_t per_b, size_t n) {
  const size_t i0 = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i0 < (size_t)B) s[i0] = __fdiv_rn(fmaxf(amax[i0], 1e-20f), 127.0f);
  for (size_t e = i0; e < n; e += (size_t)gridDim.x * blockDim.x) {
    const float a = fmaxf(amax[e / per_b], 1e-20f);
    const float iv = __fdiv_rn(127.0f, a);
    const int v = __float2int_rn(__fmul_rn(In<T>::load(x + e), iv));
    q[e] = (int8_t)max(-127, min(127, v));
  }
}

template <typename T>
__global__ void __launch_bounds__(256)
    act_rescale(const int32_t* __restrict__ acc,
                const float* __restrict__ scale, T* __restrict__ out,
                size_t per_b, int N, size_t n) {
  for (size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x; e < n;
       e += (size_t)gridDim.x * blockDim.x) {
    const size_t b = e / per_b;
    const int c = (int)(e % (size_t)N);
    Out<T>::store(out + e, __fmul_rn(__int2float_rn(acc[e]),
                                     scale[b * N + c]));
  }
}

inline int blocks_for(size_t n) {
  return (int)std::max<size_t>(1, std::min<size_t>((n + 255) / 256,
                                                   132 * 16));
}

}  // namespace q8
}  // namespace babe

// x (B, per_b) of dtype 0 fp32 / 1 bf16 -> amax (B,), zeroed by the caller
extern "C" int babe_act_amax(const void* x, void* amax, int B, long long per_b,
                             int dtype, void* stream) {
  if (B <= 0 || per_b <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int per_item = (int)std::max<long long>(
      1, std::min<long long>((per_b + 255) / 256, (132 * 8 + B - 1) / B));
  dim3 grid(per_item, B);
  if (dtype == 0)
    babe::q8::act_amax<float><<<grid, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<float*>(amax), per_b);
  else if (dtype == 1)
    babe::q8::act_amax<__nv_bfloat16><<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<float*>(amax),
        per_b);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// x (B, per_b) with the per-item amax (B,) -> q (B, per_b) int8, s (B,)
extern "C" int babe_act_quant(const void* x, const void* amax, void* q,
                              void* s, int B, long long per_b, int dtype,
                              void* stream) {
  if (B <= 0 || per_b <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)B * per_b;
  const int blocks = babe::q8::blocks_for(n);
  if (dtype == 0)
    babe::q8::act_quant<float><<<blocks, 256, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(amax),
        static_cast<int8_t*>(q), static_cast<float*>(s), B, per_b, n);
  else if (dtype == 1)
    babe::q8::act_quant<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(amax),
        static_cast<int8_t*>(q), static_cast<float*>(s), B, per_b, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// acc (B, per_b / N, N) int32 with scale (B, N) -> out of dtype 0 fp32 /
// 1 bf16
extern "C" int babe_act_rescale(const void* acc, const void* scale,
                                void* out, int B, long long per_b, int N,
                                int dtype, void* stream) {
  if (B <= 0 || per_b <= 0 || N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t n = (size_t)B * per_b;
  const int blocks = babe::q8::blocks_for(n);
  if (dtype == 0)
    babe::q8::act_rescale<float><<<blocks, 256, 0, st>>>(
        static_cast<const int32_t*>(acc), static_cast<const float*>(scale),
        static_cast<float*>(out), per_b, N, n);
  else if (dtype == 1)
    babe::q8::act_rescale<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<const int32_t*>(acc), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), per_b, N, n);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
