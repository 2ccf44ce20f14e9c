// K1's two narrow-side routes (bf16, tensor cores), for the shapes the
// flagship's pyramid convs give it: the C = 2 forward (narrow in) and its
// input gradient with N = 2 (narrow out).  Both compute K1's function,
// y[b,f,t,n] = sum_{kf,kt,c} x[b, f+(kf-2)d, t+kt-1, c] w[kf,kt,c,n], with
// fp32 accumulation and one rounding of the output; the host
// (kernels.conv5x3_route / conv5x3_plan) picks the route and the cut.
//
// Bound on the H100: bytes.  At C = 2 a position's 30 products per output
// channel are 15 flops per byte written; at N = 2, 30 per byte read.  The
// wide side has to cross device memory once and little else may.
//
//   narrow in (C <= 8, N <= 256): a block of 128 positions (TF rows x TT
//     columns) gathers its implicit im2col, 128 x 15C values padded to
//     16C, and the (15C x N) weights, read straight from HWIO w, in shared
//     memory.  Warps take (16 positions x 32 channels) items: C k-steps of
//     mma.sync m16n8k16 from ldmatrix fragments.  The rounded outputs go
//     through shared memory so every store is 16 bytes along N.
//   narrow out (N <= 8, C a multiple of 8): a block of 128 positions walks
//     the input channels in chunks of 16 through a 3-stage cp.async ring;
//     a stage holds the chunk's halo window for all five kernel rows and
//     the 15 taps' weights (tap-major (15, N, C), rows n >= N zero-filled).
//     Each warp owns 16 positions and runs 15 mma.sync (N padded to 8) per
//     chunk, its A fragments read by ldmatrix at any tap shift.
#pragma once

#include "sm90_frag.cuh"

namespace babe {
namespace k1n {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kThreads = 256;
constexpr int kPos = 128;       // positions per block (both routes)
constexpr int kPx = 24;         // bf16 per staged pixel or weight row
constexpr int kRing = 3;        // narrow out's cp.async ring
constexpr int kOutUnits = 7;    // narrow out's window units per thread
constexpr int kIn = 1, kOut = 2;

// The cut of one call, made by the host (kernels.conv5x3_plan): these
// fields, all ints, in this order.
struct K1Plan {
  int route, B, F, T, C, N, d;
  int tt_log2, TT, TF, ng, kp, op, a_bytes, b_bytes, nch, win_px,
      stage_bytes, smem, gx, gy, gz;
};

__global__ void __launch_bounds__(kThreads)
    conv_narrow_in(const K1Plan p, const bf16* __restrict__ x,
                   const bf16* __restrict__ w, bf16* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char smem_k1n[];
  const int K16 = p.kp - 8, KP = p.kp, OP = p.op, NW = p.ng * 32;
  bf16* As = reinterpret_cast<bf16*>(smem_k1n);                   // [128][KP]
  bf16* Bs = reinterpret_cast<bf16*>(smem_k1n + p.a_bytes);       // [NW][KP]
  bf16* Os = reinterpret_cast<bf16*>(smem_k1n + p.a_bytes + p.b_bytes);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, t0 = blockIdx.x * p.TT, f0 = blockIdx.y * p.TF;
  const int C = p.C, N = p.N, F = p.F, T = p.T;
  const bf16* xb = x + (size_t)b * F * T * C;
  const bf16 zero = __float2bfloat16(0.f);

  // im2col row q: position (f0 + q / TT, t0 + q % TT); column k = tap*C + c
  for (int e = tid; e < kPos * K16; e += kThreads) {
    const int q = e / K16, k = e - q * K16;
    bf16 v = zero;
    const int fo = f0 + (q >> p.tt_log2);
    if (k < 15 * C && fo < F) {
      const int tap = k / C, c = k - tap * C;
      const int kf = tap / 3, kt = tap - kf * 3;
      const int f = fo + (kf - 2) * p.d;
      const int t = t0 + (q & (p.TT - 1)) + kt - 1;
      if (f >= 0 && f < F && t >= 0 && t < T)
        v = xb[((size_t)f * T + t) * C + c];
    }
    As[q * KP + k] = v;
  }
  // B[n][k] = w[k*N + n]: HWIO (5, 3, C, N) is (15C, N) row-major
  for (int e = tid; e < NW * K16; e += kThreads) {
    const int k = e / NW, n = e - k * NW;
    Bs[n * KP + k] = (k < 15 * C && n < N) ? w[(size_t)k * N + n] : zero;
  }
  __syncthreads();

  const int gq = lane >> 2, qq = lane & 3;
  for (int item = warp; item < 8 * p.ng; item += kThreads / 32) {
    const int mt = item / p.ng, gi = item - mt * p.ng;
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    const uint32_t a_addr =
        smem_u32(As + (mt * 16 + (lane & 15)) * KP + (lane >> 4) * 8);
    const uint32_t b_addr = smem_u32(
        Bs + (gi * 32 + (lane & 7)) * KP + ((lane >> 3) & 1) * 8);
    for (int ks = 0; ks < K16 / 16; ++ks) {
      uint32_t a[4];
      ldsm_x4(a, a_addr + ks * 32);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t bb[2];
        ldsm_x2(bb, b_addr + j * 8 * KP * 2 + ks * 32);
        mma_bf16(acc[j], a, bb[0], bb[1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<__nv_bfloat162*>(
            Os + (mt * 16 + gq + 8 * hr) * OP + gi * 32 + j * 8 + 2 * qq) =
            __floats2bfloat162_rn(acc[j][hr * 2], acc[j][hr * 2 + 1]);
  }
  __syncthreads();

  bf16* yb = y + (size_t)b * F * T * N;
  if (N % 8 == 0) {
    const int R = N / 8;
    for (int u = tid; u < kPos * R; u += kThreads) {
      const int q = u / R, cg = u - q * R;
      const int f = f0 + (q >> p.tt_log2), t = t0 + (q & (p.TT - 1));
      if (f < F && t < T)
        *reinterpret_cast<uint4*>(yb + ((size_t)f * T + t) * N + cg * 8) =
            *reinterpret_cast<const uint4*>(Os + q * OP + cg * 8);
    }
  } else {
    for (int u = tid; u < kPos * N; u += kThreads) {
      const int q = u / N, n = u - q * N;
      const int f = f0 + (q >> p.tt_log2), t = t0 + (q & (p.TT - 1));
      if (f < F && t < T) yb[((size_t)f * T + t) * N + n] = Os[q * OP + n];
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    conv_narrow_out(const K1Plan p, const bf16* __restrict__ x,
                    const bf16* __restrict__ wt, bf16* __restrict__ y) {
  extern __shared__ __align__(128) unsigned char smem_k1n[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.z, t0 = blockIdx.x * p.TT, f0 = blockIdx.y * p.TF;
  const int C = p.C, N = p.N, F = p.F, T = p.T, TW = p.TT + 2;
  const bf16* xb = x + (size_t)b * F * T * C;
  const uint32_t sbase = smem_u32(smem_k1n);
  constexpr int kWBytes = 15 * 8 * kPx * 2;  // a stage's weights

  // this thread's window units (pixel u / 2 of row r = fr*5 + kf, channel
  // half u % 2): shared offset, and source element in the batch (-1: zero)
  int dst[kOutUnits], src[kOutUnits], half[kOutUnits];
#pragma unroll
  for (int k = 0; k < kOutUnits; ++k) {
    const int u = tid + k * kThreads;
    dst[k] = -1;
    src[k] = -1;
    half[k] = (u & 1) * 8;
    if (u < p.win_px * 2) {
      const int px = u >> 1, r = px / TW, col = px - r * TW;
      const int fr = r / 5, kf = r - fr * 5;
      const int f = f0 + fr + (kf - 2) * p.d, t = t0 - 1 + col;
      dst[k] = kWBytes + px * kPx * 2 + (u & 1) * 16;
      if (f0 + fr < F && f >= 0 && f < F && t >= 0 && t < T)
        src[k] = (f * T + t) * C + half[k];
    }
  }

  auto issue = [&](int ch) {
    const uint32_t st = sbase + (ch % kRing) * p.stage_bytes;
    const int c0 = ch * 16;
    for (int u = tid; u < 15 * 8 * 2; u += kThreads) {
      const int tap = u >> 4, n = (u >> 1) & 7, h = u & 1;
      const bool ok = n < N && c0 + h * 8 < C;
      cp16(st + (tap * 8 + n) * kPx * 2 + h * 16,
           ok ? wt + ((size_t)tap * N + n) * C + c0 + h * 8 : wt, ok);
    }
#pragma unroll
    for (int k = 0; k < kOutUnits; ++k) {
      if (dst[k] >= 0) {
        const bool ok = src[k] >= 0 && c0 + half[k] < C;
        cp16(st + dst[k], ok ? xb + src[k] + c0 : xb, ok);
      }
    }
  };

  const int pos = warp * 16 + (lane & 15);
  const int a_row = (pos >> p.tt_log2) * 5, a_col = pos & (p.TT - 1);
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) {
    if (s < p.nch) issue(s);
    cp_commit();
  }
  for (int ch = 0; ch < p.nch; ++ch) {
    cp_wait<kRing - 2>();
    __syncthreads();  // chunk ch landed everywhere; chunk ch-1 consumed
    if (ch + kRing - 1 < p.nch) issue(ch + kRing - 1);
    cp_commit();
    const uint32_t st = sbase + (ch % kRing) * p.stage_bytes;
#pragma unroll
    for (int kf = 0; kf < 5; ++kf) {
#pragma unroll
      for (int kt = 0; kt < 3; ++kt) {
        uint32_t a[4], bb[2];
        ldsm_x4(a, st + kWBytes +
                       (((a_row + kf) * TW + a_col + kt) * kPx +
                        (lane >> 4) * 8) * 2);
        ldsm_x2(bb, st + (((kf * 3 + kt) * 8 + (lane & 7)) * kPx +
                          ((lane >> 3) & 1) * 8) * 2);
        mma_bf16(acc, a, bb[0], bb[1]);
      }
    }
  }
  cp_wait<0>();

  bf16* yb = y + (size_t)b * F * T * N;
  const int gq = lane >> 2, qq = lane & 3;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int q = warp * 16 + gq + 8 * hr;
    const int f = f0 + (q >> p.tt_log2), t = t0 + (q & (p.TT - 1));
    if (f >= F || t >= T) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = 2 * qq + e;
      if (n < N)
        yb[((size_t)f * T + t) * N + n] = __float2bfloat16(acc[hr * 2 + e]);
    }
  }
}

inline int launch_narrow(const K1Plan& p, const bf16* x, const bf16* w,
                         const bf16* wt, bf16* y, cudaStream_t st) {
  if (p.route == kIn) {
    static bool configured = false;
    if (!configured) {
      cudaError_t err = cudaFuncSetAttribute(
          conv_narrow_in, cudaFuncAttributeMaxDynamicSharedMemorySize,
          232448);
      if (err != cudaSuccess) return (int)err;
      configured = true;
    }
    conv_narrow_in<<<dim3(p.gx, p.gy, p.gz), kThreads, p.smem, st>>>(p, x, w,
                                                                     y);
  } else if (p.route == kOut) {
    static bool configured = false;
    if (!configured) {
      cudaError_t err = cudaFuncSetAttribute(
          conv_narrow_out, cudaFuncAttributeMaxDynamicSharedMemorySize,
          232448);
      if (err != cudaSuccess) return (int)err;
      configured = true;
    }
    conv_narrow_out<<<dim3(p.gx, p.gy, p.gz), kThreads, p.smem, st>>>(
        p, x, wt, y);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace k1n
}  // namespace babe
