// Tensor-core (bf16 mma.sync m16n8k16, fp32 accumulate) version of the
// (5,3) dilated-conv tile in conv5x3_tile.cuh, with the same three modes
// (kPlain, kFwd, kBwd) and the same prologue/epilogue arithmetic.
//
// Tile: one block of 8 warps computes 128 output positions (TF rows of F x
// TT columns of T, TT a power of two >= 16 so every 16-position mma tile
// lies in one row) x 64 output channels; warps form a 4 (positions) x 2
// (channels) grid of 32 x 32 warp tiles (2 x 4 mma tiles).  The
// contraction runs over input channels in chunks of 16 (one mma k-step per
// tap): each chunk stages the 5 dilated input rows of every output row
// (plus the T halo), after the mode's prologue, and the 15 taps' weights
// in shared memory as bf16; a 16-position slice of a staged row is directly
// an mma A fragment for each of the 3 kt shifts (an implicit im2col).
// Shared rows are padded to 24 bf16 so the fragment loads are free of bank
// conflicts.  The weights come tap-major, (15, N, C), so each (tap, n)
// row of 16 channels is one contiguous 32-byte copy.
//
// Bound: at these widths the conv is operation-bound; this kernel moves
// the multiply-adds onto the tensor cores.  Staging is synchronous (no
// cp.async/TMA double buffering) — later work.
#pragma once

#include "conv5x3_tile.cuh"

namespace babe {
namespace tc {

constexpr int kCK = 16;    // input channels per k-step
constexpr int kPix = 24;   // bf16 per staged pixel / weight row (16 + pad)
constexpr int kNB = 64;    // output channels per block
constexpr int kMB = 128;   // output positions per block
constexpr int kThreads = 256;

using bf16 = __nv_bfloat16;

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the staged (conv input) value of element idx = (b, f, t, cc)
template <int MODE>
__device__ __forceinline__ float stage_value(const ConvParams& p, size_t idx,
                                             int b, int cc, float sq2) {
  const bf16* x = static_cast<const bf16*>(p.x);
  if (MODE == kFwd) {
    const float ab = Elem<bf16>::round(p.a[b * p.C + cc]);
    return Elem<bf16>::round(
        gelu_poly(Elem<bf16>::round(Elem<bf16>::load(x + idx) * ab)));
  }
  if (MODE == kBwd)
    return Elem<bf16>::round(stage_gpre<bf16>(p, idx, b, cc, sq2) *
                             Elem<bf16>::round(p.s[b * p.C + cc]));
  return Elem<bf16>::load(x + idx);
}

inline size_t smem_bytes(int TT) {
  const int TF = kMB / TT;
  return (size_t)(TF * 5 * (TT + 2) + 15 * kNB) * kPix * sizeof(bf16) +
         2 * kNB * sizeof(float);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
    conv5x3_mma(ConvParams p, const bf16* __restrict__ wt) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int TT = p.TT, TF = p.TF, TW = TT + 2, nrow = TF * 5;
  bf16* xs = reinterpret_cast<bf16*>(smem);       // [nrow][TW][kPix]
  bf16* ws = xs + nrow * TW * kPix;               // [15][kNB][kPix]
  float* red = reinterpret_cast<float*>(ws + 15 * kNB * kPix);  // [2][kNB]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int b = blockIdx.z / p.n_tiles;
  const int n0 = (blockIdx.z % p.n_tiles) * kNB;
  const int t0 = blockIdx.x * TT, f0 = blockIdx.y * TF;
  const size_t xb = (size_t)b * p.F * p.T * p.C;
  const float sq2 = Elem<bf16>::round(1.41421356237309515f);
  const bf16* x = static_cast<const bf16*>(p.x);
  const bool vec = (p.C % 8) == 0;

  if (MODE != kPlain && tid < 2 * kNB) red[tid] = 0.f;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  int fi[2], tl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = wm * 32 + i * 16;
    fi[i] = m / TT;
    tl[i] = m % TT;
  }

  for (int c0 = 0; c0 < p.C; c0 += kCK) {
    // stage the input window, 8 channels per unit: row r = fr*5 + kf,
    // column col <-> t0-1+col
    for (int u = tid; u < nrow * TW * 2; u += kThreads) {
      const int h = u & 1;
      const int col = (u >> 1) % TW;
      const int r = (u >> 1) / TW;
      const int f = f0 + r / 5 + (r % 5 - 2) * p.d;
      const int t = t0 - 1 + col;
      const int cb = c0 + h * 8;
      const bool inb = f >= 0 && f < p.F && t >= 0 && t < p.T;
      __align__(16) bf16 v[8];
      if (vec && inb && cb + 8 <= p.C) {
        // 16-byte loads of 8 channels, then the mode's prologue
        const size_t idx = xb + ((size_t)f * p.T + t) * p.C + cb;
        *reinterpret_cast<uint4*>(v) =
            *reinterpret_cast<const uint4*>(x + idx);
        if (MODE == kFwd) {
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float ab = Elem<bf16>::round(p.a[b * p.C + cb + e]);
            v[e] = __float2bfloat16(gelu_poly(
                Elem<bf16>::round(__bfloat162float(v[e]) * ab)));
          }
        } else if (MODE == kBwd) {
          __align__(16) bf16 yv[8];
          *reinterpret_cast<uint4*>(yv) = *reinterpret_cast<const uint4*>(
              static_cast<const bf16*>(p.y_st) + idx);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int cc = cb + e;
            const float r = Elem<bf16>::round(
                p.gmom[b * p.C + cc] +
                2.0f * __bfloat162float(yv[e]) *
                    p.gmom[(p.B + b) * p.C + cc]);
            const float gp = Elem<bf16>::round(
                Elem<bf16>::round(__bfloat162float(v[e]) + r) / sq2);
            v[e] = __float2bfloat16(
                gp * Elem<bf16>::round(p.s[b * p.C + cc]));
          }
        }
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          float val = 0.f;
          if (inb && cb + e < p.C)
            val = stage_value<MODE>(
                p, xb + ((size_t)f * p.T + t) * p.C + cb + e, b, cb + e,
                sq2);
          v[e] = __float2bfloat16(val);
        }
      }
      *reinterpret_cast<uint4*>(xs + (r * TW + col) * kPix + h * 8) =
          *reinterpret_cast<const uint4*>(v);
    }
    // stage the weights: (tap, n) rows of 16 input channels
    for (int u = tid; u < 15 * kNB * 2; u += kThreads) {
      const int h = u & 1;
      const int n = (u >> 1) % kNB;
      const int tap = (u >> 1) / kNB;
      const int nn = n0 + n, cb = c0 + h * 8;
      __align__(16) bf16 v[8];
      if (vec && nn < p.N && cb + 8 <= p.C) {
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(
            wt + ((size_t)tap * p.N + nn) * p.C + cb);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (nn < p.N && cb + e < p.C)
                     ? wt[((size_t)tap * p.N + nn) * p.C + cb + e]
                     : __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(ws + (tap * kNB + n) * kPix + h * 8) =
          *reinterpret_cast<const uint4*>(v);
    }
    __syncthreads();

    const uint32_t* xs32 = reinterpret_cast<const uint32_t*>(xs);
    const uint32_t* ws32 = reinterpret_cast<const uint32_t*>(ws);
#pragma unroll
    for (int kf = 0; kf < 5; ++kf) {
#pragma unroll
      for (int kt = 0; kt < 3; ++kt) {
        uint32_t af[2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // A[m][k]: position m (row fi, column tl + m), channel k
          const uint32_t* pa =
              xs32 + ((fi[i] * 5 + kf) * TW + tl[i] + g + kt) * (kPix / 2) +
              q;
          af[i][0] = pa[0];
          af[i][1] = pa[8 * (kPix / 2)];
          af[i][2] = pa[4];
          af[i][3] = pa[8 * (kPix / 2) + 4];
        }
        const int tap = kf * 3 + kt;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // B[k][n]: channel k, output channel n
          const uint32_t* pb =
              ws32 + (tap * kNB + wn * 32 + j * 8 + g) * (kPix / 2) + q;
          const uint32_t b0 = pb[0], b1 = pb[4];
#pragma unroll
          for (int i = 0; i < 2; ++i) mma16816(acc[i][j], af[i], b0, b1);
        }
      }
    }
    __syncthreads();
  }

  // epilogue: accumulator element (i, j, hr*2 + e) is position
  // wm*32 + i*16 + g + 8*hr, output channel wn*32 + j*8 + 2q + e
  bf16* y = static_cast<bf16*>(p.y);
  bf16* cout = static_cast<bf16*>(p.c_out);
  float m1[4][2], m2[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) m1[j][e] = m2[j][e] = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int f = f0 + fi[i];
      const int t = t0 + tl[i] + g + 8 * hr;
      if (f >= p.F || t >= p.T) continue;
      const size_t base = (((size_t)b * p.F + f) * p.T + t) * p.N;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nn = n0 + wn * 32 + j * 8 + 2 * q + e;
          if (nn >= p.N) continue;
          const float cr = Elem<bf16>::round(acc[i][j][hr * 2 + e]);
          if (MODE == kPlain) {
            Elem<bf16>::store(y + base + nn, cr);
          } else if (MODE == kFwd) {
            if (cout != nullptr) Elem<bf16>::store(cout + base + nn, cr);
            const float sb = Elem<bf16>::round(p.s[b * p.C + nn]);
            const float t1 = Elem<bf16>::round(cr * sb);
            const float xv = Elem<bf16>::load(x + base + nn);
            const float uu = Elem<bf16>::round(xv + t1);
            const float yv = Elem<bf16>::round(uu / sq2);
            Elem<bf16>::store(y + base + nn, yv);
            m1[j][e] += yv;
            m2[j][e] = fmaf(yv, yv, m2[j][e]);
          } else {
            const float gp = stage_gpre<bf16>(p, base + nn, b, nn, sq2);
            const float xv =
                Elem<bf16>::load(static_cast<const bf16*>(p.x_st) + base + nn);
            const float ab = Elem<bf16>::round(p.a[b * p.C + nn]);
            const float du = Elem<bf16>::round(
                cr * gelu_poly_deriv(Elem<bf16>::round(xv * ab)));
            Elem<bf16>::store(
                y + base + nn,
                Elem<bf16>::round(gp + Elem<bf16>::round(du * ab)));
            const float cv =
                Elem<bf16>::load(static_cast<const bf16*>(p.c_st) + base + nn);
            m1[j][e] = fmaf(gp, cv, m1[j][e]);
            m2[j][e] = fmaf(du, xv, m2[j][e]);
          }
        }
      }
    }
  }
  if (MODE == kPlain) return;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int nl = wn * 32 + j * 8 + 2 * q + e;
      atomicAdd(&red[nl], m1[j][e]);
      atomicAdd(&red[kNB + nl], m2[j][e]);
    }
  __syncthreads();
  if (tid < kNB && n0 + tid < p.C) {
    atomicAdd(p.mom + (size_t)b * p.C + n0 + tid, red[tid]);
    atomicAdd(p.mom + ((size_t)p.B + b) * p.C + n0 + tid, red[kNB + tid]);
  }
}

template <int MODE>
int launch(ConvParams p, const bf16* wt, cudaStream_t stream) {
  int TT = 16;
  while (TT < p.T && TT < kMB) TT <<= 1;
  p.TT = TT;
  p.TF = kMB / TT;
  p.n_tiles = (p.N + kNB - 1) / kNB;
  const size_t smem = smem_bytes(16);  // the largest of the TT choices
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        conv5x3_mma<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  dim3 grid((p.T + TT - 1) / TT, (p.F + p.TF - 1) / p.TF, p.B * p.n_tiles);
  conv5x3_mma<MODE><<<grid, kThreads, smem_bytes(TT), stream>>>(p, wt);
  return (int)cudaGetLastError();
}

}  // namespace tc

// bf16 with rows of at least 16 positions and at least 16 input channels
// takes the tensor cores; fp32, shorter rows and the 2-channel pyramid
// inputs (a k-step of 16 would be 7/8 padding) take the CUDA-core tile
template <typename T, int MODE>
int launch_conv5x3(ConvParams p, const void* wt, cudaStream_t stream) {
  if (p.B <= 0 || p.F <= 0 || p.T <= 0 || p.N <= 0) return 0;
  if (sizeof(T) == 2 && p.T >= 16 && p.C >= 16)
    return tc::launch<MODE>(p, static_cast<const __nv_bfloat16*>(wt), stream);
  return launch_conv5x3_tile<T, MODE>(p, stream);
}

}  // namespace babe
