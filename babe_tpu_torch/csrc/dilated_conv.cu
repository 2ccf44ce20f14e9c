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
// It is K1's tile (conv5x3_tile.cuh, conv5x3_mma.cuh) with the taps made
// general: the kernel extent and both dilations are runtime values, so the
// staged halo window is KF dilated input rows per output row and
// TT + (KT-1)*dt columns, and each kt shift reads that window kt*dt
// columns further on (an implicit im2col).  bf16 with rows of at least 16
// positions and at least 16 input channels runs on the tensor cores
// (mma.sync m16n8k16 through mma_frag.cuh, weights tap-major (KF*KT, N, C));
// fp32, short rows, few channels and windows too large for shared memory on
// the tensor-core path run the CUDA-core tile (weights HWIO).
//
// Bound on the H100: operation-bound at the model's widths (KF*KT*C
// multiply-adds per output element against a few bytes moved), like K1.
// Staging is synchronous; cp.async/TMA double buffering is later work.
#include "conv5x3_tile.cuh"
#include "mma_frag.cuh"

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

}  // namespace dconv
}  // namespace babe

// dtype 0 = fp32, 1 = bf16.  Returns the launch status (cudaSuccess = 0);
// cudaErrorInvalidValue for a kernel extent or type it does not take,
// cudaErrorInvalidConfiguration for a window too large for shared memory.
extern "C" int babe_dilated_conv(const void* x, const void* w, const void* wt,
                                 void* y, int B, int F, int T, int C, int N,
                                 int KF, int KT, int df, int dt, int dtype,
                                 void* stream) {
  using namespace babe::dconv;
  if (KF < 1 || KF > 7 || KT < 1 || KT > 7 || KF % 2 == 0 || KT % 2 == 0 ||
      df < 1 || dt < 1)
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
  if (dtype == 0) return launch_simt<float>(p, st);
  if (dtype != 1) return (int)cudaErrorInvalidValue;
  if (T >= 16 && C >= 16 && mma_smem(p, 16) <= (size_t)kMaxSmem)
    return launch_mma(p, st);
  return launch_simt<bf16>(p, st);
}
