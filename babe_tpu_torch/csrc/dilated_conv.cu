// K4: 'SAME' channels-last conv with any odd kernel (KF, KT) up to 7 and
// dilation (df, dt):
//   y[b,f,t,n] = sum_{i,j,c} x[b, f+(i-PF)df, t+(j-PT)dt, c] * w[i,j,c,n]
// with PF = (KF-1)/2, PT = (KT-1)/2, zero padding, fp32 accumulation and
// the output rounded to the input type.
//
// Replaces the TPU kernel babe_tpu/ops/pallas_conv.py::_pallas_forward
// (entry dilated_conv_nhwc): an in-VMEM im2col with tap pairs giving
// K = 2C contractions.  What carries over is the function; the TPU's tiling
// limits (F a multiple of 8..64, C and T multiples of 8, dt = 1) do not:
// any F, T and C run here, and the input gradient is this kernel again on
// the cotangent with the kernel flipped and its in/out channels swapped.
//
// Three routes, chosen by the host (kernels.dilated_conv_route, passed in
// the plan; a route that cannot take the call refuses it, none falls back
// to another):
//
//   tma   bf16 with C and N multiples of 8 (every level shape of the TPU
//         kernel's table, and its dx): an implicit GEMM on the TMA ring of
//         probe_gemm_sm90.cuh (its producer and consumer functions, its
//         128B-swizzled wgmma SS).  The contraction is (tap, 64-channel
//         chunk).  For each k-step the producer warp asks the TMA for two
//         A boxes, 64 channels x TT columns x TF rows x 1 item, from a 4-D
//         tensor map over x (C, T, F, B) at (c0, t0 + (kt-PT)dt, f0 +
//         (kf-PF)df, b) and (.., f0 + TF + (kf-PF)df, b), and one B box,
//         64 channels x BN outputs, from a 3-D map over the tap-major pack
//         (C, N, KF*KT) at (c0, n0, tap).  The TMA zero-fills whatever lies
//         outside the tensor, negative coordinates included: that is the
//         'SAME' padding, with no padded copy.  T, F and B are separate
//         dimensions of the map, so a shift never bleeds into the next row
//         or item.  Two consumer warpgroups each run four wgmma
//         m64nBNk16 per k-step on their own A box and the shared B box.
//         A box holds TT*TF <= 64 positions (kernels.dilated_conv_plan
//         picks TT, TF to cover F x T with the fewest blocks): rows past
//         TT*TF of a warpgroup's 64 hold stale bits, whose products land
//         only in their own accumulator rows, which are never stored.  The
//         epilogue rounds the fp32 sums once to bf16 in a shared-memory
//         tile and writes 16 bytes along N, masking ragged F, T and N.
//         At C = 96 the second chunk is half zero fill (a quarter of that
//         level's products are wasted).
//   mma   the older bf16 tensor-core tile (K1's, conv5x3_tile.cuh and
//         conv5x3_mma.cuh, mma.sync m16n8k16 through mma_frag.cuh, weights
//         tap-major (KF*KT, N, C)) with the taps made general: the staged
//         halo window is KF dilated rows per output row and TT + (KT-1)*dt
//         columns, each kt shift reading it kt*dt columns on.  bf16 with C
//         or N not a multiple of 8, rows of at least 16 and 16 channels.
//   simt  the CUDA-core tile (weights HWIO): fp32, and bf16 that neither
//         tensor-core route takes.
//
// Bound on the H100: operation-bound at the model's widths (KF*KT*C
// multiply-adds per output element against a few bytes moved), like K1.
// The tma route rereads each input chunk once per tap from L2 (its box
// cannot be shifted inside shared memory: a swizzled A descriptor moves in
// 8-row groups), and each block reads all the weights of its BN outputs.
#include <string.h>

#include "conv5x3_tile.cuh"
#include "mma_frag.cuh"
#include "probe_gemm_sm90.cuh"

namespace babe {
namespace dconv {

using bf16 = __nv_bfloat16;
constexpr int kMaxSmem = 232448;  // what one block may use on sm_90

struct Params {
  const void* x;   // (B, F, T, C)
  const void* w;   // (KF, KT, C, N) HWIO
  const bf16* wt;  // (KF*KT, N, C) tap-major, bf16 path only
  void* y;         // (B, F, T, N)
  int B, F, T, C, N, KF, KT, df, dt;
  int TT, TF, n_tiles;
};

// The cut of one call, made by the host (kernels.dilated_conv_plan):
// these fields, all ints, in this order.  The tma route's block (gx, gy,
// z) owns outputs n0 = (z % n_tiles) * bn .. n0 + bn of item z / n_tiles
// at the TT x 2TF positions from (f0, t0) = (gy * 2TF, gx * TT), the
// first TF rows warpgroup 0's, the next TF warpgroup 1's; it walks n_k =
// KF * KT * nch ring stages (tap outer, 64-channel chunk inner).
struct Plan {
  int route, B, F, T, C, N, KF, KT, df, dt;
  int TT, TF, bn, n_tiles, nch, n_k, stages, stage_bytes, smem, gx, gy, gz;
};
constexpr int kRouteSimt = 0, kRouteMma = 1, kRouteTma = 2;

// ------------------------------------------------------- CUDA-core tile

constexpr int kCK = 4, kNN = 64, kMT = 128, kThreads = 256;

inline size_t simt_smem(const Params& p, int TT) {
  const int TF = kMT / TT, TW = TT + (p.KT - 1) * p.dt;
  return (size_t)(p.KF * p.KT * kCK * kNN + TF * p.KF * kCK * TW) *
         sizeof(float);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) dconv_simt(Params p) {
  extern __shared__ __align__(16) float sm[];
  const int KF = p.KF, KT = p.KT, TT = p.TT, TF = p.TF;
  const int TW = TT + (KT - 1) * p.dt;
  const int PF = (KF - 1) / 2, PT = (KT - 1) / 2;
  float* ws = sm;                        // [tap][kCK][kNN]
  float* xs = sm + KF * KT * kCK * kNN;  // [fr*KF + i][kCK][TW]

  const int tid = threadIdx.x, tn = tid & 15, tm = tid >> 4;
  const int b = blockIdx.z / p.n_tiles;
  const int n0 = (blockIdx.z % p.n_tiles) * kNN;
  const int t0 = blockIdx.x * TT, f0 = blockIdx.y * TF;
  const int fi = (tm * 8) / TT, tb = (tm * 8) % TT;
  const T* x = static_cast<const T*>(p.x);
  const T* w = static_cast<const T*>(p.w);
  const size_t xb = (size_t)b * p.F * p.T * p.C;

  float acc[8][4];
#pragma unroll
  for (int m = 0; m < 8; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  for (int c0 = 0; c0 < p.C; c0 += kCK) {
    const int nx = TF * KF * TW * kCK;
    for (int e = tid; e < nx; e += kThreads) {
      const int c = e % kCK;
      int r = e / kCK;
      const int col = r % TW;
      r /= TW;
      const int i = r % KF, fr = r / KF;
      const int f = f0 + fr + (i - PF) * p.df;
      const int t = t0 - PT * p.dt + col;
      const int cc = c0 + c;
      float v = 0.f;
      if (f >= 0 && f < p.F && t >= 0 && t < p.T && cc < p.C)
        v = Elem<T>::load(x + xb + ((size_t)f * p.T + t) * p.C + cc);
      xs[(r * kCK + c) * TW + col] = v;
    }
    for (int e = tid; e < KF * KT * kCK * kNN; e += kThreads) {
      const int n = e % kNN, r = e / kNN;
      const int c = r % kCK, tap = r / kCK;
      const int cc = c0 + c, nn = n0 + n;
      ws[e] = (cc < p.C && nn < p.N)
                  ? Elem<T>::load(w + ((size_t)tap * p.C + cc) * p.N + nn)
                  : 0.f;
    }
    __syncthreads();
    for (int i = 0; i < KF; ++i) {
#pragma unroll
      for (int c = 0; c < kCK; ++c) {
        const float* xr = xs + ((fi * KF + i) * kCK + c) * TW + tb;
        for (int j = 0; j < KT; ++j) {
          const float4 bv = *reinterpret_cast<const float4*>(
              ws + ((i * KT + j) * kCK + c) * kNN + tn * 4);
          const float* xj = xr + j * p.dt;
#pragma unroll
          for (int m = 0; m < 8; ++m) {
            const float av = xj[m];
            acc[m][0] = fmaf(av, bv.x, acc[m][0]);
            acc[m][1] = fmaf(av, bv.y, acc[m][1]);
            acc[m][2] = fmaf(av, bv.z, acc[m][2]);
            acc[m][3] = fmaf(av, bv.w, acc[m][3]);
          }
        }
      }
    }
    __syncthreads();
  }

  const int f = f0 + fi;
  if (f >= p.F) return;
  T* y = static_cast<T*>(p.y);
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

// ---------------------------------------------------- tensor-core tile

using frag::kMB;
using frag::kNB;
using frag::kW;
constexpr int kCKT = 16;       // input channels per k-step
constexpr int kPix = 2 * kW;   // bf16 per staged pixel / weight row

inline size_t mma_smem(const Params& p, int TT) {
  const int TF = kMB / TT, TW = TT + (p.KT - 1) * p.dt;
  return (size_t)(TF * p.KF * TW + p.KF * p.KT * kNB) * kPix * sizeof(bf16);
}

__global__ void __launch_bounds__(frag::kThreads) dconv_mma(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int KF = p.KF, KT = p.KT, TT = p.TT, TF = p.TF;
  const int TW = TT + (KT - 1) * p.dt, nrow = TF * KF;
  const int PF = (KF - 1) / 2, PT = (KT - 1) / 2;
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [nrow][TW][kPix]
  bf16* ws = xs + nrow * TW * kPix;          // [KF*KT][kNB][kPix]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;
  const int b = blockIdx.z / p.n_tiles;
  const int n0 = (blockIdx.z % p.n_tiles) * kNB;
  const int t0 = blockIdx.x * TT, f0 = blockIdx.y * TF;
  const size_t xb = (size_t)b * p.F * p.T * p.C;
  const bf16* x = static_cast<const bf16*>(p.x);
  const bool vec = (p.C % 8) == 0;

  float acc[2][4][4];
  frag::zero(acc);
  int fi[2], tl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = wm * 32 + i * 16;
    fi[i] = m / TT;
    tl[i] = m % TT;
  }

  for (int c0 = 0; c0 < p.C; c0 += kCKT) {
    // the input window, 8 channels per unit: row r = fr*KF + i, column
    // col <-> t0 - PT*dt + col
    for (int u = tid; u < nrow * TW * 2; u += frag::kThreads) {
      const int h = u & 1;
      const int col = (u >> 1) % TW, r = (u >> 1) / TW;
      const int f = f0 + r / KF + (r % KF - PF) * p.df;
      const int t = t0 - PT * p.dt + col;
      const int cb = c0 + h * 8;
      const bool inb = f >= 0 && f < p.F && t >= 0 && t < p.T;
      __align__(16) bf16 v[8];
      const size_t idx = xb + ((size_t)f * p.T + t) * p.C + cb;
      if (vec && inb && cb + 8 <= p.C) {
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(x + idx);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (inb && cb + e < p.C) ? x[idx + e] : __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(xs + (r * TW + col) * kPix + h * 8) =
          *reinterpret_cast<const uint4*>(v);
    }
    // the weights: (tap, n) rows of 16 input channels
    for (int u = tid; u < KF * KT * kNB * 2; u += frag::kThreads) {
      const int h = u & 1;
      const int n = (u >> 1) % kNB, tap = (u >> 1) / kNB;
      const int nn = n0 + n, cb = c0 + h * 8;
      __align__(16) bf16 v[8];
      const size_t idx = ((size_t)tap * p.N + nn) * p.C + cb;
      if (vec && nn < p.N && cb + 8 <= p.C) {
        *reinterpret_cast<uint4*>(v) =
            *reinterpret_cast<const uint4*>(p.wt + idx);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = (nn < p.N && cb + e < p.C) ? p.wt[idx + e]
                                            : __float2bfloat16(0.f);
      }
      *reinterpret_cast<uint4*>(ws + (tap * kNB + n) * kPix + h * 8) =
          *reinterpret_cast<const uint4*>(v);
    }
    __syncthreads();

    const uint32_t* xs32 = reinterpret_cast<const uint32_t*>(xs);
    const uint32_t* ws32 = reinterpret_cast<const uint32_t*>(ws);
    for (int i = 0; i < KF; ++i) {
      for (int j = 0; j < KT; ++j) {
        const int sh = j * p.dt;
        frag::warp_mma(
            acc, xs32 + ((fi[0] * KF + i) * TW + tl[0] + g + sh) * kW + q,
            xs32 + ((fi[1] * KF + i) * TW + tl[1] + g + sh) * kW + q,
            ws32 + ((i * KT + j) * kNB + wn * 32 + g) * kW + q);
      }
    }
    __syncthreads();
  }

  // accumulator element (i, j, hr*2 + e) is position wm*32 + i*16 + g +
  // 8*hr, output channel wn*32 + j*8 + 2q + e
  bf16* y = static_cast<bf16*>(p.y);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int f = f0 + fi[i];
      const int t = t0 + tl[i] + g + 8 * hr;
      if (f >= p.F || t >= p.T) continue;
      const size_t base = (((size_t)b * p.F + f) * p.T + t) * p.N;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nn = n0 + wn * 32 + j * 8 + 2 * q + e;
          if (nn < p.N) Elem<bf16>::store(y + base + nn, acc[i][j][hr * 2 + e]);
        }
    }
  }
}

// ---------------------------------------------------- the TMA route

constexpr int kTmaThreads = 288;   // two consumer warpgroups, a producer warp
constexpr int kABox = 64 * 128;    // one warpgroup's A slot: 64 x 128 bytes

// up to 128 outputs a block, two blocks share an SM (a short contraction,
// as at 64 channels, leaves one block's prologue and epilogue exposed):
// the ring takes half of the SM's shared memory
template <int BN>
__host__ __device__ constexpr int tma_blocks() {
  return BN <= 128 ? 2 : 1;
}
template <int BN>
__host__ __device__ constexpr int tma_stage_bytes() {
  return 2 * kABox + BN * 128;
}
template <int BN>
__host__ __device__ constexpr int tma_stages() {
  return 196608 / tma_blocks<BN>() / tma_stage_bytes<BN>() < 8
             ? 196608 / tma_blocks<BN>() / tma_stage_bytes<BN>()
             : 8;
}
template <int BN>
__host__ __device__ constexpr int tma_smem() {  // ring + alignment slack
  return tma_stages<BN>() * tma_stage_bytes<BN>() + 1024;
}

template <int BN>
__global__ void __launch_bounds__(kTmaThreads, tma_blocks<BN>())
    dconv_tma(const __grid_constant__ CUtensorMap tx,
              const __grid_constant__ CUtensorMap tw, bf16* y,
              const Plan p) {
  using namespace babe::sm90;
  constexpr int kS = tma_stages<BN>(), kStage = tma_stage_bytes<BN>();
  extern __shared__ __align__(1024) unsigned char smem_dconv[];
  __shared__ __align__(8) uint64_t full[kS], empty[kS];
  const uint32_t base = smem_u32(smem_dconv);
  const uint32_t ring = (base + 1023u) & ~1023u;
  const int tid = threadIdx.x;
  const int b = blockIdx.z / p.n_tiles, n0 = (blockIdx.z % p.n_tiles) * BN;
  const int t0 = blockIdx.x * p.TT, f0 = blockIdx.y * 2 * p.TF;
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kS; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 2);  // one arrival per warpgroup
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (tid >= 256) {  // the producer warp: one lane issues every copy
    if (tid == 256) {
      const CUtensorMap *px = &tx, *pw = &tw;
      const int PF = (p.KF - 1) / 2, PT = (p.KT - 1) / 2;
      const uint32_t tx_bytes = 2 * p.TT * p.TF * 128 + BN * 128;
      gemm90::produce<kS>(
          p.n_k, ring, kStage, tx_bytes, full, empty,
          [&](int it, uint32_t dst, uint32_t bar) {
            const int tap = it / p.nch, c0 = (it - tap * p.nch) * 64;
            const int kf = tap / p.KT, kt = tap - kf * p.KT;
            const int t = t0 + (kt - PT) * p.dt, f = f0 + (kf - PF) * p.df;
            tma_load_4d(dst, px, c0, t, f, b, bar);
            tma_load_4d(dst + kABox, px, c0, t, f + p.TF, b, bar);
            tma_load_3d(dst + 2 * kABox, pw, c0, n0, tap, bar);
          });
    }
    return;
  }

  const int wg = tid >> 7;
  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;
  gemm90::consume<kS>(0, p.n_k, ring, kStage, full, empty, (tid & 127) == 0,
                      acc, [&](uint32_t slot) {
                        const uint32_t sa = slot + wg * kABox;
                        const uint32_t sb = slot + 2 * kABox;
#pragma unroll
                        for (int k = 0; k < 4; ++k)
                          gemm90::mma<BN>(acc, gemm90::desc_sw128(sa + 32 * k),
                                          gemm90::desc_sw128(sb + 32 * k));
                      });
  bar_sync(1, 256);  // both warpgroups' products are done: the ring is free

  // accumulator register n8*4 + hr*2 + e (warp row gq + 8hr, column 8 n8 +
  // 2q + e) -> a bf16 tile of 128 rows (warpgroup w's from 64w) x BN
  constexpr int NP = BN + 8;  // values per tile row
  bf16* tile = reinterpret_cast<bf16*>(smem_dconv + (ring - base));
  {
    const int lane = tid & 31, w4 = (tid >> 5) & 3;
    const int gq = lane >> 2, q = lane & 3;
    const int r0 = wg * 64 + w4 * 16 + gq;
#pragma unroll
    for (int n8 = 0; n8 < BN / 8; ++n8)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<__nv_bfloat162*>(tile + (r0 + 8 * hr) * NP +
                                           n8 * 8 + 2 * q) =
            __floats2bfloat162_rn(acc[n8 * 4 + hr * 2],
                                  acc[n8 * 4 + hr * 2 + 1]);
  }
  bar_sync(1, 256);
  // 16-byte units (tile row, 8 outputs); row r of warpgroup r / 64 is
  // position (f0 + (r / 64) TF + (r % 64) / TT, t0 + (r % 64) % TT) when r
  // % 64 < TT * TF
  constexpr int R = BN / 8;
  const int live = p.TT * p.TF;
  for (int u = tid; u < 128 * R; u += 256) {
    const int row = u / R, cg = u - row * R;
    const int rr = row & 63, n = n0 + cg * 8;
    if (rr >= live || n >= p.N) continue;
    const int f = f0 + (row >> 6) * p.TF + rr / p.TT, t = t0 + rr % p.TT;
    if (f >= p.F || t >= p.T) continue;
    *reinterpret_cast<uint4*>(y + (((size_t)b * p.F + f) * p.T + t) * p.N +
                              n) =
        *reinterpret_cast<const uint4*>(tile + row * NP + cg * 8);
  }
}

// let a kernel take up to kMaxSmem of dynamic shared memory (once per
// kernel: each caller keeps its own flag)
template <typename K>
int allow_smem(K kernel, bool& done) {
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

template <typename T>
int launch_simt(Params p, cudaStream_t st) {
  int TT = 8;
  while (TT < p.T && TT < kMT) TT <<= 1;
  p.TT = TT;
  p.TF = kMT / TT;
  p.n_tiles = (p.N + kNN - 1) / kNN;
  const size_t smem = simt_smem(p, TT);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
  static bool configured = false;
  if (int rc = allow_smem(dconv_simt<T>, configured)) return rc;
  dim3 grid((p.T + TT - 1) / TT, (p.F + p.TF - 1) / p.TF, p.B * p.n_tiles);
  dconv_simt<T><<<grid, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

int launch_mma(Params p, cudaStream_t st) {
  if (p.T < 16 || p.C < 16 || mma_smem(p, 16) > (size_t)kMaxSmem)
    return (int)cudaErrorInvalidConfiguration;
  int TT = 16;
  while (TT < p.T && TT < kMB) TT <<= 1;
  p.TT = TT;
  p.TF = kMB / TT;
  p.n_tiles = (p.N + kNB - 1) / kNB;
  static bool configured = false;
  if (int rc = allow_smem(dconv_mma, configured)) return rc;
  dim3 grid((p.T + TT - 1) / TT, (p.F + p.TF - 1) / p.TF, p.B * p.n_tiles);
  dconv_mma<<<grid, frag::kThreads, mma_smem(p, TT), st>>>(p);
  return (int)cudaGetLastError();
}

// the tensor maps are encoded per call on the host and passed as
// __grid_constant__ parameters, so a CUDA graph can capture the launch
template <int BN>
int launch_tma(const Params& p, const Plan& k, cudaStream_t st) {
  if (k.stages != tma_stages<BN>() || k.smem != tma_smem<BN>() ||
      k.stage_bytes != tma_stage_bytes<BN>())
    return (int)cudaErrorInvalidValue;
  static bool configured = false;  // its barriers are static: ask for
  if (!configured) {                // only the dynamic bytes it takes
    const cudaError_t err = cudaFuncSetAttribute(
        dconv_tma<BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tma_smem<BN>());
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const cuuint64_t xd[4] = {(cuuint64_t)p.C, (cuuint64_t)p.T,
                            (cuuint64_t)p.F, (cuuint64_t)p.B};
  const cuuint64_t xs[3] = {(cuuint64_t)p.C * 2, (cuuint64_t)p.T * p.C * 2,
                            (cuuint64_t)p.F * p.T * p.C * 2};
  const cuuint32_t xb[4] = {64, (cuuint32_t)k.TT, (cuuint32_t)k.TF, 1};
  const cuuint64_t wd[3] = {(cuuint64_t)p.C, (cuuint64_t)p.N,
                            (cuuint64_t)p.KF * p.KT};
  const cuuint64_t ws[2] = {(cuuint64_t)p.C * 2, (cuuint64_t)p.N * p.C * 2};
  const cuuint32_t wb[3] = {64, (cuuint32_t)BN, 1};
  CUtensorMap tx, tw;
  if (!gemm90::tiled_map(&tx, p.x, 4, xd, xs, xb, 2) ||
      !gemm90::tiled_map(&tw, p.wt, 3, wd, ws, wb, 2))
    return (int)cudaErrorInvalidValue;
  dconv_tma<BN><<<dim3(k.gx, k.gy, k.gz), kTmaThreads, k.smem, st>>>(
      tx, tw, static_cast<bf16*>(p.y), k);
  return (int)cudaGetLastError();
}

int launch_tma_route(const Params& p, const Plan& k, cudaStream_t st) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(p.x) |
                      reinterpret_cast<uintptr_t>(p.wt) |
                      reinterpret_cast<uintptr_t>(p.y);
  if (p.C % 8 != 0 || p.N % 8 != 0 || a % 16 != 0 || k.TT < 1 || k.TF < 1 ||
      k.TT * k.TF > 64 || k.nch != (p.C + 63) / 64 ||
      k.n_k != p.KF * p.KT * k.nch || k.n_tiles != (p.N + k.bn - 1) / k.bn ||
      k.gz != p.B * k.n_tiles || (long)k.gx * k.TT < p.T ||
      (long)k.gy * 2 * k.TF < p.F)
    return (int)cudaErrorInvalidValue;
  switch (k.bn) {
    case 64: return launch_tma<64>(p, k, st);
    case 96: return launch_tma<96>(p, k, st);
    case 128: return launch_tma<128>(p, k, st);
    case 256: return launch_tma<256>(p, k, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace dconv
}  // namespace babe

// dtype 0 = fp32, 1 = bf16; meta the call's Plan (kernels.dilated_conv_plan),
// whose route the call takes.  Returns the launch status (cudaSuccess = 0):
// cudaErrorInvalidValue for a kernel extent, type, plan or alignment the
// route does not take, cudaErrorInvalidConfiguration for a window too large
// for shared memory or rows or channels too few for the mma tile.
extern "C" int babe_dilated_conv(const void* x, const void* w, const void* wt,
                                 void* y, int B, int F, int T, int C, int N,
                                 int KF, int KT, int df, int dt, int dtype,
                                 const int* meta, int n_meta, void* stream) {
  using namespace babe::dconv;
  if (KF < 1 || KF > 7 || KT < 1 || KT > 7 || KF % 2 == 0 || KT % 2 == 0 ||
      df < 1 || dt < 1)
    return (int)cudaErrorInvalidValue;
  Plan k;
  if (n_meta != (int)(sizeof(Plan) / sizeof(int)))
    return (int)cudaErrorInvalidValue;
  memcpy(&k, meta, sizeof(k));
  if (k.B != B || k.F != F || k.T != T || k.C != C || k.N != N ||
      k.KF != KF || k.KT != KT || k.df != df || k.dt != dt)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || F <= 0 || T <= 0 || N <= 0) return 0;
  Params p{};
  p.x = x;
  p.w = w;
  p.wt = static_cast<const bf16*>(wt);
  p.y = y;
  p.B = B;
  p.F = F;
  p.T = T;
  p.C = C;
  p.N = N;
  p.KF = KF;
  p.KT = KT;
  p.df = df;
  p.dt = dt;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && k.route == kRouteSimt) return launch_simt<float>(p, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  switch (k.route) {
    case kRouteSimt: return launch_simt<bf16>(p, st);
    case kRouteMma: return launch_mma(p, st);
    case kRouteTma: return launch_tma_route(p, k, st);
  }
  return (int)cudaErrorInvalidValue;
}
