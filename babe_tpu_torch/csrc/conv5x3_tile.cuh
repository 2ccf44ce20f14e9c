// Shared implicit-GEMM tile for the (5,3) 'SAME' dilated convolution on
// channels-last (B, F, T, C) activations with an HWIO (5, 3, C, N) kernel.
//
// One template, three modes (each source builds its own shared library):
//   kPlain  conv5x3.cu       (K1) plain conv, also the dx of the pyramid convs
//   kFwd    fused_stage.cu   (K2) gelu(x*a) prologue + gated residual and
//                            moments epilogue around the conv
//   kBwd    fused_stage.cu   (K2's backward) the conv transpose of one stage
//                            with the cotangent fold/gate in the prologue and
//                            the gelu derivative, dx, da and ds in the
//                            epilogue
//
// Tile: one block of 256 threads computes 128 output positions (TF rows of
// F x TT columns of T, TT*TF == 128, TT a power of two >= 8 picked by the
// host so short T rows do not waste threads) x 64 output channels.  The
// contraction runs over input channels in chunks of CK=4: each chunk stages
// the 5 dilated input rows of every output row (plus the 1-column T halo on
// both sides) and the 15 taps' weights in shared memory, in fp32.  Each
// thread accumulates an 8 (t) x 4 (n) micro-tile in fp32 registers; the
// 3 kt taps reuse one 10-wide register window along T.
//
// This is a plain SIMT (CUDA-core fp32 FMA) kernel: right first.  The
// tensor-core (wgmma/TMA) design is later work.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace babe {

constexpr int kCK = 4;        // input channels per shared-memory stage
constexpr int kNN = 64;       // output channels per block
constexpr int kMT = 128;      // output positions per block
constexpr int kThreads = 256;
constexpr int kMaxTF = kMT / 8;
constexpr int kPlain = 0, kFwd = 1, kBwd = 2;

template <typename T> struct Elem;

template <> struct Elem<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  static __device__ __forceinline__ float round(float v) { return v; }
};

template <> struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);  // round to nearest even, like torch and XLA
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16(v));
  }
};

// gelu with the degree-10 erf polynomial of the JAX package's _gelu_impl:
// erf(z) ~ z * P(z^2) on the argument clamped to |z| <= 3.2; fp32 inside.
// Every step is one rounded fp32 operation in the plain version's order
// (__fmul_rn / __fadd_rn forbid FMA contraction; the constants are the
// double literals rounded to float, as the plain version's scalars are),
// so the result agrees with ops/conv_kernels._gelu_impl bit for bit: for
// x below about -2 the sum 1 + erf cancels, and a contracted FMA there
// moves the fp32 gelu by many ulps.
__device__ __forceinline__ float gelu_poly(float x) {
  const float z = fminf(fmaxf(__fmul_rn(x, (float)0.7071067811865475),
                              (float)-3.2), (float)3.2);
  const float v = __fmul_rn(z, z);
  float p = (float)2.3633496703e-10;
  p = __fadd_rn(__fmul_rn(p, v), (float)-1.4950546990e-08);
  p = __fadd_rn(__fmul_rn(p, v), (float)4.2725490474e-07);
  p = __fadd_rn(__fmul_rn(p, v), (float)-7.3661495009e-06);
  p = __fadd_rn(__fmul_rn(p, v), (float)8.6683659408e-05);
  p = __fadd_rn(__fmul_rn(p, v), (float)-7.4968982878e-04);
  p = __fadd_rn(__fmul_rn(p, v), (float)5.0087573199e-03);
  p = __fadd_rn(__fmul_rn(p, v), (float)-2.6595735634e-02);
  p = __fadd_rn(__fmul_rn(p, v), (float)1.1265245796e-01);
  p = __fadd_rn(__fmul_rn(p, v), (float)-3.7607088364e-01);
  p = __fadd_rn(__fmul_rn(p, v), (float)1.1283750399e+00);
  return __fmul_rn(__fmul_rn(0.5f, x), __fadd_rn(1.0f, __fmul_rn(z, p)));
}

// gelu'(x) = 0.5 (1 + erf(x/sqrt2)) + x phi(x), the same clamped erf
// polynomial as the forward (the JAX package's _gelu_deriv); fp32
__device__ __forceinline__ float gelu_poly_deriv(float x) {
  float z = fminf(fmaxf(x * 0.7071067811865475f, -3.2f), 3.2f);
  float v = z * z;
  float p = 2.3633496703e-10f;
  p = p * v + -1.4950546990e-08f;
  p = p * v + 4.2725490474e-07f;
  p = p * v + -7.3661495009e-06f;
  p = p * v + 8.6683659408e-05f;
  p = p * v + -7.4968982878e-04f;
  p = p * v + 5.0087573199e-03f;
  p = p * v + -2.6595735634e-02f;
  p = p * v + 1.1265245796e-01f;
  p = p * v + -3.7607088364e-01f;
  p = p * v + 1.1283750399e+00f;
  return 0.5f * (1.0f + z * p) + x * (0.3989422804014327f *
                                      expf(-0.5f * x * x));
}

struct ConvParams {
  const void* x;      // (B, F, T, C) in T; kBwd: the cotangent g_y of y
  const void* w;      // (5, 3, C, N) in T; kBwd: flipped, io-swapped
  void* y;            // (B, F, T, N) in T; kBwd: dx
  const float* a;     // kFwd, kBwd: (B, C) prologue multiplier
  const float* s;     // kFwd, kBwd: (B, C) gate scale
  float* mom;         // kFwd: (2, B, C) [sum y, sum y^2]; kBwd: [ds, da];
                      // zeroed by the caller
  void* c_out;        // kFwd, optional: (B, F, T, C) conv output in T
  const void* y_st;   // kBwd: the stage's output y
  const void* x_st;   // kBwd: the stage's input x
  const void* c_st;   // kBwd: the stage's conv output c
  const float* gmom;  // kBwd: (2, B, C) cotangent of the moments
  int B, F, T, C, N, d;
  int TT, TF, n_tiles;
};

// kBwd: the cotangent reaching the stage's pre-scale sum u = x + c*s,
// with the moments' cotangent folded in (d sum y = 1, d sum y^2 = 2y) and
// every step rounded to T as the reference's autodiff does
template <typename T>
__device__ __forceinline__ float stage_gpre(const ConvParams& p, size_t idx,
                                           int b, int c, float sq2) {
  const float gy = Elem<T>::load(static_cast<const T*>(p.x) + idx);
  const float yv = Elem<T>::load(static_cast<const T*>(p.y_st) + idx);
  const float r = Elem<T>::round(p.gmom[b * p.C + c] +
                                 2.0f * yv * p.gmom[(p.B + b) * p.C + c]);
  return Elem<T>::round(Elem<T>::round(gy + r) / sq2);
}

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) conv5x3_tile(ConvParams p) {
  constexpr bool FUSED = MODE != kPlain;
  __shared__ __align__(16) float ws[15 * kCK * kNN];
  __shared__ __align__(16) float xs[5 * kCK * (kMT + 2 * kMaxTF)];
  __shared__ float red[2 * kNN];

  const int TT = p.TT, TF = p.TF, TW = TT + 2;
  const int tid = threadIdx.x;
  const int tn = tid & 15;   // 4 output channels: n0 + 4*tn ...
  const int tm = tid >> 4;   // 8 output positions
  const int b = blockIdx.z / p.n_tiles;
  const int n0 = (blockIdx.z % p.n_tiles) * kNN;
  const int t0 = blockIdx.x * TT;
  const int f0 = blockIdx.y * TF;
  const int fi = (tm * 8) / TT;
  const int tb = (tm * 8) % TT;
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  const size_t xb = (size_t)b * p.F * p.T * p.C;
  const float sq2 = Elem<T>::round(1.41421356237309515f);

  if (FUSED && tid < 2 * kNN) red[tid] = 0.f;

  float acc[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int c0 = 0; c0 < p.C; c0 += kCK) {
    // stage the input window: row r = fr*5 + kf, column col <-> t0-1+col
    const int nx = TF * 5 * TW * kCK;
    for (int e = tid; e < nx; e += kThreads) {
      const int c = e % kCK;
      int r = e / kCK;
      const int col = r % TW;
      r /= TW;
      const int kf = r % 5;
      const int fr = r / 5;
      const int f = f0 + fr + (kf - 2) * p.d;
      const int t = t0 - 1 + col;
      const int cc = c0 + c;
      float v = 0.f;
      if (f >= 0 && f < p.F && t >= 0 && t < p.T && cc < p.C) {
        const size_t idx = xb + ((size_t)f * p.T + t) * p.C + cc;
        if (MODE == kFwd) {
          // h = gelu(x * a) with the reference's casts: a rounded to T,
          // the product rounded to T, gelu in fp32 rounded to T
          const float ab = Elem<T>::round(p.a[b * p.C + cc]);
          v = Elem<T>::round(gelu_poly(Elem<T>::round(
              Elem<T>::load(x + idx) * ab)));
        } else if (MODE == kBwd) {
          // the conv transpose's input: g_pre * s, rounded to T
          v = Elem<T>::round(stage_gpre<T>(p, idx, b, cc, sq2) *
                             Elem<T>::round(p.s[b * p.C + cc]));
        } else {
          v = Elem<T>::load(x + idx);
        }
      }
      xs[(r * kCK + c) * TW + col] = v;
    }
    // stage the weights: (tap, c, n) with n fastest
    for (int e = tid; e < 15 * kCK * kNN; e += kThreads) {
      const int n = e % kNN;
      const int r = e / kNN;
      const int c = r % kCK;
      const int tap = r / kCK;
      const int cc = c0 + c, nn = n0 + n;
      float v = 0.f;
      if (cc < p.C && nn < p.N)
        v = Elem<T>::load(w + ((size_t)tap * p.C + cc) * p.N + nn);
      ws[e] = v;
    }
    __syncthreads();

    // the chunk's 15 x kCK terms go into a fresh partial that is then
    // added to the sum: two levels of short sums keep the fp32 error at
    // the plain version's (per-tap sums of C terms); one running sum of
    // 15*C terms has about 3x it
    float part[8][4];
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) part[m][j] = 0.f;
#pragma unroll
    for (int kf = 0; kf < 5; ++kf) {
#pragma unroll
      for (int c = 0; c < kCK; ++c) {
        const float* xr = xs + ((fi * 5 + kf) * kCK + c) * TW + tb;
        float av[10];
#pragma unroll
        for (int j = 0; j < 10; ++j) av[j] = xr[j];
#pragma unroll
        for (int kt = 0; kt < 3; ++kt) {
          const float4 bv = *reinterpret_cast<const float4*>(
              ws + ((kf * 3 + kt) * kCK + c) * kNN + tn * 4);
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            part[m][0] = fmaf(av[m + kt], bv.x, part[m][0]);
            part[m][1] = fmaf(av[m + kt], bv.y, part[m][1]);
            part[m][2] = fmaf(av[m + kt], bv.z, part[m][2]);
            part[m][3] = fmaf(av[m + kt], bv.w, part[m][3]);
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 8; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] += part[m][j];
    __syncthreads();
  }

  const int f = f0 + fi;
  T* y = static_cast<T*>(p.y);
  if (!FUSED) {
    if (f < p.F) {
#pragma unroll
      for (int m = 0; m < 8; ++m) {
        const int t = t0 + tb + m;
        if (t >= p.T) continue;
        const size_t base = (((size_t)b * p.F + f) * p.T + t) * p.N;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int nn = n0 + tn * 4 + j;
          if (nn < p.N) Elem<T>::store(y + base + nn, acc[m][j]);
        }
      }
    }
    return;
  }

  // fused epilogues (N == C), each product and sum rounded to T as the
  // reference does, with two per-(B, C) fp32 sums m1, m2:
  //   kFwd: c = conv; y = (x + c*s) / sqrt2; m1, m2 = sum y, sum y^2
  //   kBwd: dh = conv transpose; du = dh * gelu'(x*a); dx = g_pre + du*a;
  //         m1, m2 = ds = sum g_pre*c, da = sum du*x
  T* cout = static_cast<T*>(p.c_out);
  float m1[4] = {0.f, 0.f, 0.f, 0.f};
  float m2[4] = {0.f, 0.f, 0.f, 0.f};
  if (f < p.F) {
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const int t = t0 + tb + m;
      if (t >= p.T) continue;
      const size_t base = (((size_t)b * p.F + f) * p.T + t) * p.C;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int nn = n0 + tn * 4 + j;
        if (nn >= p.C) continue;
        const float cr = Elem<T>::round(acc[m][j]);
        if (MODE == kFwd) {
          if (cout != nullptr) Elem<T>::store(cout + base + nn, cr);
          const float sb = Elem<T>::round(p.s[b * p.C + nn]);
          const float t1 = Elem<T>::round(cr * sb);
          const float xv = Elem<T>::load(x + base + nn);
          const float u = Elem<T>::round(xv + t1);
          const float yv = Elem<T>::round(u / sq2);
          Elem<T>::store(y + base + nn, yv);
          m1[j] += yv;
          m2[j] = fmaf(yv, yv, m2[j]);
        } else {
          const float gp = stage_gpre<T>(p, base + nn, b, nn, sq2);
          const float xv =
              Elem<T>::load(static_cast<const T*>(p.x_st) + base + nn);
          const float ab = Elem<T>::round(p.a[b * p.C + nn]);
          const float du = Elem<T>::round(
              cr * gelu_poly_deriv(Elem<T>::round(xv * ab)));
          Elem<T>::store(y + base + nn,
                         Elem<T>::round(gp + Elem<T>::round(du * ab)));
          const float cv =
              Elem<T>::load(static_cast<const T*>(p.c_st) + base + nn);
          m1[j] = fmaf(gp, cv, m1[j]);
          m2[j] = fmaf(du, xv, m2[j]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    atomicAdd(&red[tn * 4 + j], m1[j]);
    atomicAdd(&red[kNN + tn * 4 + j], m2[j]);
  }
  __syncthreads();
  if (tid < kNN && n0 + tid < p.C) {
    atomicAdd(p.mom + (size_t)b * p.C + n0 + tid, red[tid]);
    atomicAdd(p.mom + ((size_t)p.B + b) * p.C + n0 + tid, red[kNN + tid]);
  }
}

// Pick the tile shape for this T, launch, and report the launch status.
template <typename T, int MODE>
int launch_conv5x3_tile(ConvParams p, cudaStream_t stream) {
  if (p.B <= 0 || p.F <= 0 || p.T <= 0 || p.N <= 0) return 0;
  int TT = 8;
  while (TT < p.T && TT < kMT) TT <<= 1;
  p.TT = TT;
  p.TF = kMT / TT;
  p.n_tiles = (p.N + kNN - 1) / kNN;
  dim3 grid((p.T + TT - 1) / TT, (p.F + p.TF - 1) / p.TF, p.B * p.n_tiles);
  conv5x3_tile<T, MODE><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace babe
