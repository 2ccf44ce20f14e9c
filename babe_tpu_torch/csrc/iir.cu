// lfilter: the IIR recursion of the informed-BWE degradations (cheby1, the
// RBJ biquad), one row per thread.
//
// Replaces babe_tpu/ops/iir.py::lfilter, a lax.scan over time (XLA on the
// TPU; no Pallas kernel).  Same function, the transposed direct form II
// along the last axis with a zero initial state:
//   y[t]   = b0 x[t] + s0
//   s_i    = (b[i+1] x[t] - a[i+1] y[t]) + s_{i+1}     i = 0 .. n-2
// with s_{n-1} = 0 and the coefficients already divided by a[0] (on the
// device, by the caller, as the plain loop divides them).  Every product
// and sum is rounded on its own (__fmul_rn, __fsub_rn, __fadd_rn: never
// contracted into an fma), in the plain loop's order, so the kernel gives
// the plain version's result bit for bit.
//
// The recursion is sequential in t: each row is one thread.  The critical
// path per sample is y's add, then a[1]*y, the subtraction and the add
// into s0 (four dependent fp32 operations); x is read a chunk of kChunk
// samples ahead into registers, and each chunk's outputs are stored after
// its recursion.  The n-1
// states live in registers for n <= 16 (a template on n); above
// that a generic loop keeps them in a scratch row of device memory.
// ``reverse`` reads and writes the row back to front: the filter of the
// time-reversed row, itself reversed, which is the transpose of the
// filter matrix (the input gradient), with no copies.
//
// Bound: latency.  Per row about 4 x 4 cycles a sample on the critical
// path; the bytes (8 a sample) are far below the memory rate.  On an H100
// it runs some 36 SM cycles a sample (PERF.md).
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 32;

struct Row {
  const float* __restrict__ x;
  float* __restrict__ y;
  long long L;
  int reverse;
  __device__ __forceinline__ long long at(long long i) const {
    return reverse ? L - 1 - i : i;
  }
};

// one sample through NS states held in registers
template <int NS>
__device__ __forceinline__ float step(float xt, float (&s)[NS],
                                      const float (&b)[NS + 1],
                                      const float (&a)[NS + 1]) {
  const float yt = __fadd_rn(__fmul_rn(b[0], xt), s[0]);
#pragma unroll
  for (int i = 0; i + 1 < NS; ++i)
    s[i] = __fadd_rn(__fsub_rn(__fmul_rn(b[i + 1], xt),
                               __fmul_rn(a[i + 1], yt)),
                     s[i + 1]);
  s[NS - 1] = __fadd_rn(__fsub_rn(__fmul_rn(b[NS], xt),
                                  __fmul_rn(a[NS], yt)),
                        0.0f);
  return yt;
}

template <int NS>
__global__ void __launch_bounds__(32)
    lfilter_reg(const float* __restrict__ x, float* __restrict__ y,
                const float* __restrict__ coef, int R, long long L,
                int reverse) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  float b[NS + 1], a[NS + 1], s[NS];
#pragma unroll
  for (int i = 0; i <= NS; ++i) {
    b[i] = coef[i];
    a[i] = coef[NS + 1 + i];
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) s[i] = 0.0f;
  const Row row{x + (long long)r * L, y + (long long)r * L, L, reverse};
  const long long full = L / kChunk * kChunk;
  float cur[kChunk], nxt[kChunk];
  if (full > 0) {
#pragma unroll
    for (int k = 0; k < kChunk; ++k) cur[k] = row.x[row.at(k)];
  }
  for (long long c0 = 0; c0 < full; c0 += kChunk) {
    const long long n0 = c0 + kChunk;
    if (n0 < full) {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) nxt[k] = row.x[row.at(n0 + k)];
    }
    // the chunk's outputs stored together after its recursion: stores
    // between the steps cost a quarter more time a sample
    float yb[kChunk];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) yb[k] = step<NS>(cur[k], s, b, a);
#pragma unroll
    for (int k = 0; k < kChunk; ++k) row.y[row.at(c0 + k)] = yb[k];
#pragma unroll
    for (int k = 0; k < kChunk; ++k) cur[k] = nxt[k];
  }
  for (long long t = full; t < L; ++t)
    row.y[row.at(t)] = step<NS>(row.x[row.at(t)], s, b, a);
}

// n > 16: the states in a scratch row (R x (n-1), zeroed here)
__global__ void __launch_bounds__(32)
    lfilter_any(const float* __restrict__ x, float* __restrict__ y,
                const float* __restrict__ coef, float* __restrict__ scratch,
                int R, long long L, int n, int reverse) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const int ns = n - 1;
  const float* b = coef;
  const float* a = coef + n;
  float* s = scratch + (long long)r * ns;
  for (int i = 0; i < ns; ++i) s[i] = 0.0f;
  const Row row{x + (long long)r * L, y + (long long)r * L, L, reverse};
  for (long long t = 0; t < L; ++t) {
    const float xt = row.x[row.at(t)];
    const float yt = __fadd_rn(__fmul_rn(b[0], xt), s[0]);
    for (int i = 0; i + 1 < ns; ++i)
      s[i] = __fadd_rn(__fsub_rn(__fmul_rn(b[i + 1], xt),
                                 __fmul_rn(a[i + 1], yt)),
                       s[i + 1]);
    s[ns - 1] = __fadd_rn(__fsub_rn(__fmul_rn(b[ns], xt),
                                    __fmul_rn(a[ns], yt)),
                          0.0f);
    row.y[row.at(t)] = yt;
  }
}

template <int NS>
int launch_reg(const float* x, float* y, const float* coef, int R,
               long long L, int reverse, cudaStream_t st) {
  lfilter_reg<NS><<<(R + 31) / 32, 32, 0, st>>>(x, y, coef, R, L, reverse);
  return (int)cudaGetLastError();
}

}  // namespace

// x, y: (R, L) fp32 rows; coef: 2n fp32 on the device, b then a, both
// divided by a[0]; scratch: R*(n-1) fp32 when n > 16 (else unused)
extern "C" int babe_lfilter(const void* x, void* y, const void* coef,
                            void* scratch, int R, long long L, int n,
                            int reverse, void* stream) {
  if (R < 0 || L < 0 || n < 2) return (int)cudaErrorInvalidValue;
  if (R == 0 || L == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* yf = static_cast<float*>(y);
  const float* cf = static_cast<const float*>(coef);
  switch (n) {
    case 2: return launch_reg<1>(xf, yf, cf, R, L, reverse, st);
    case 3: return launch_reg<2>(xf, yf, cf, R, L, reverse, st);
    case 4: return launch_reg<3>(xf, yf, cf, R, L, reverse, st);
    case 5: return launch_reg<4>(xf, yf, cf, R, L, reverse, st);
    case 6: return launch_reg<5>(xf, yf, cf, R, L, reverse, st);
    case 7: return launch_reg<6>(xf, yf, cf, R, L, reverse, st);
    case 8: return launch_reg<7>(xf, yf, cf, R, L, reverse, st);
    case 9: return launch_reg<8>(xf, yf, cf, R, L, reverse, st);
    case 10: return launch_reg<9>(xf, yf, cf, R, L, reverse, st);
    case 11: return launch_reg<10>(xf, yf, cf, R, L, reverse, st);
    case 12: return launch_reg<11>(xf, yf, cf, R, L, reverse, st);
    case 13: return launch_reg<12>(xf, yf, cf, R, L, reverse, st);
    case 14: return launch_reg<13>(xf, yf, cf, R, L, reverse, st);
    case 15: return launch_reg<14>(xf, yf, cf, R, L, reverse, st);
    case 16: return launch_reg<15>(xf, yf, cf, R, L, reverse, st);
    default: break;
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  lfilter_any<<<(R + 31) / 32, 32, 0, st>>>(
      xf, yf, cf, static_cast<float*>(scratch), R, L, n, reverse);
  return (int)cudaGetLastError();
}
