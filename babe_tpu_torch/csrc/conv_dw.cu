// The weight gradient of a 'SAME' channels-last conv, in two modes:
//
//   conv_dw (kPlain): dW[i,j,c,n] = sum_{b,f,t} X[b, f+(i-PF)df, t+(j-PT)dt, c]
//                                                * G[b,f,t,n]
//     with X the conv's input, G the cotangent of its output, PF = (KF-1)/2,
//     PT = (KT-1)/2 and zero padding.  It serves K1 (KF, KT = 5, 3; dt = 1)
//     and K4 (any odd KF, KT up to 7; both dilations).
//   fused_stage_dw (kStage): the same reduction for one ResnetBlock dilation
//     stage (K2), with K2's prologue on the X side, h = gelu(x*a) rounded to
//     x's type in K2's order, and K2's backward prologue on the G side,
//     g_pre*s with g_pre = (g_y + g_mom[0] + 2*y*g_mom[1]) / sqrt2 rounded as
//     in dil_stage_bwd_ref: so h and g_pre*s are never stored.
//
// Replaces the weight half of the TPU kernels' custom vjps, which the JAX
// package leaves to XLA: babe_tpu/ops/conv_kernels.py:600-607 (K1's
// linear_transpose of conv_xla in w), :1090-1097 (K2, jax.vjp of
// _dil_stage_ref in w4) and babe_tpu/ops/pallas_conv.py:123-131 (K4).
//
// A GEMM of (KF*KT*C) x N whose reduction runs over all B*F*T positions.
// A block owns one kernel row i, 64 input channels (rows of dW) and 64
// output channels (columns), for all KT taps of that row, and walks a share
// of the positions in chunks of 64 consecutive t at one (b, f): it stages
// the chunk's G (64 positions) and the matching X row (64 + (KT-1)*dt
// columns of row f + (i-PF)*df, so every tap reads the same window shifted
// by j*dt), both transposed so that positions are contiguous.  The
// positions are split over blocks (enough blocks to fill the card at every
// shape), each block keeps its partial in registers and adds it into an
// fp32 dW with one atomic per element at the end: the summation order, and
// the last bits of dW, vary from run to run.
//
// bf16 with at least 16 input channels runs on the tensor cores: mma.sync
// m16n8k16 with A = the staged X (channels x positions; a tap shift can make
// a fragment word straddle two 32-bit words, so A is read as 16-bit pairs)
// and B = the staged G; 8 warps of 32 x 16 outputs each per tap.  fp32, and
// the 2-channel pyramid inputs, run a CUDA-core tile (4 x 4 outputs per
// thread and tap).
//
// Bound on the H100: operation-bound at the stage widths (2*KF*KT*C*N flops
// per position against 2*(C+N) bytes), bytes-bound for the pyramid convs.
// Staging is synchronous and each block re-stages its X row for every
// output-channel tile: simple first; staging and wgmma are later work.
#include "conv5x3_tile.cuh"
#include "mma_frag.cuh"

namespace babe {
namespace cdw {

using bf16 = __nv_bfloat16;
constexpr int kMaxSmem = 232448;  // what one block may use on sm_90
constexpr int kThreads = 256;
constexpr int kCB = 64;           // input channels per block
constexpr int kNB = 64;           // output channels per block
constexpr int kTP = 64;           // positions per staged chunk
constexpr int kGW = kTP + 8;      // bf16 per staged G row (tensor-core tile)
constexpr int kPlainDW = 0, kStageDW = 1;

struct Params {
  const void* x;      // (B, F, T, C) conv input; kStage: the stage input x
  const void* g;      // (B, F, T, N) output cotangent; kStage: g_y
  float* dw;          // (KF*KT, C, N) fp32, zeroed by the caller
  const float* a;     // kStage: (B, C) prologue multiplier
  const float* s;     // kStage: (B, C) gate scale
  const void* y;      // kStage: (B, F, T, C) the stage's output
  const float* gmom;  // kStage: (2, B, C) cotangent of the moments
  int B, F, T, C, N, KF, KT, df, dt;
  int XC;             // staged X columns: kTP + (KT-1)*dt
  int c_tiles, n_tiles, tchunks, n_chunks, splits;
};

// the staged X value at element idx = (b, f, t, c)
template <typename T, int MODE>
__device__ __forceinline__ float x_value(const Params& p, size_t idx, int b,
                                         int c) {
  const float xv = Elem<T>::load(static_cast<const T*>(p.x) + idx);
  if (MODE == kPlainDW) return xv;
  const float ab = Elem<T>::round(p.a[b * p.C + c]);
  return Elem<T>::round(gelu_poly(Elem<T>::round(xv * ab)));
}

// the staged G value at element idx = (b, f, t, n): kStage folds the
// moments' cotangent into y's, divides by sqrt2 and applies the gate, each
// step rounded to T as K2's backward prologue (stage_gpre) does
template <typename T, int MODE>
__device__ __forceinline__ float g_value(const Params& p, size_t idx, int b,
                                         int n, float sq2) {
  const float gy = Elem<T>::load(static_cast<const T*>(p.g) + idx);
  if (MODE == kPlainDW) return gy;
  const float yv = Elem<T>::load(static_cast<const T*>(p.y) + idx);
  const float r = Elem<T>::round(p.gmom[b * p.C + n] +
                                 2.0f * yv * p.gmom[(p.B + b) * p.C + n]);
  const float gp = Elem<T>::round(Elem<T>::round(gy + r) / sq2);
  return Elem<T>::round(gp * Elem<T>::round(p.s[b * p.C + n]));
}

// the chunk with index k: (b, f, t0)
__device__ __forceinline__ void chunk_at(const Params& p, int k, int& b,
                                         int& f, int& t0) {
  const int tc = k % p.tchunks, bf = k / p.tchunks;
  f = bf % p.F;
  b = bf / p.F;
  t0 = tc * kTP;
}

// the block's tile: kernel row i, first input channel c0, first output n0
__device__ __forceinline__ void tile_at(const Params& p, int& i, int& c0,
                                        int& n0) {
  int tile = blockIdx.y;
  n0 = (tile % p.n_tiles) * kNB;
  tile /= p.n_tiles;
  c0 = (tile % p.c_tiles) * kCB;
  i = tile / p.c_tiles;
}

// ------------------------------------------------------- CUDA-core tile

// X staged as [c][XC + 1] and G as [n][kTP + 1] in fp32 (odd strides keep
// the column reads free of bank conflicts)
template <typename T, int KT, int MODE>
__global__ void __launch_bounds__(kThreads) dw_simt(Params p) {
  extern __shared__ __align__(16) float fsm[];
  const int XS = p.XC + 1, GS = kTP + 1;
  float* xs = fsm;             // [kCB][XS]
  float* gs = fsm + kCB * XS;  // [kNB][GS]
  const int tid = threadIdx.x, tn = tid & 15, tc = tid >> 4;
  int i, c0, n0;
  tile_at(p, i, c0, n0);
  const int PF = (p.KF - 1) / 2, PT = (KT - 1) / 2;
  const float sq2 = Elem<T>::round(1.41421356237309515f);

  float acc[KT][4][4];
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[j][u][v] = 0.f;

  for (int k = blockIdx.x; k < p.n_chunks; k += p.splits) {
    int b, f, t0;
    chunk_at(p, k, b, f, t0);
    const int fx = f + (i - PF) * p.df;
    const bool rowin = fx >= 0 && fx < p.F;
    for (int e = tid; e < kCB * p.XC; e += kThreads) {
      const int c = e % kCB, col = e / kCB;
      const int t = t0 - PT * p.dt + col, cc = c0 + c;
      float v = 0.f;
      if (rowin && t >= 0 && t < p.T && cc < p.C)
        v = x_value<T, MODE>(
            p, (((size_t)b * p.F + fx) * p.T + t) * p.C + cc, b, cc);
      xs[c * XS + col] = v;
    }
    for (int e = tid; e < kNB * kTP; e += kThreads) {
      const int n = e % kNB, pos = e / kNB;
      const int t = t0 + pos, nn = n0 + n;
      float v = 0.f;
      if (t < p.T && nn < p.N)
        v = g_value<T, MODE>(
            p, (((size_t)b * p.F + f) * p.T + t) * p.N + nn, b, nn, sq2);
      gs[n * GS + pos] = v;
    }
    __syncthreads();
    for (int pos = 0; pos < kTP; ++pos) {
      float gv[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) gv[v] = gs[(tn * 4 + v) * GS + pos];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float xv = xs[(tc * 4 + u) * XS + pos + j * p.dt];
#pragma unroll
          for (int v = 0; v < 4; ++v) acc[j][u][v] = fmaf(xv, gv[v], acc[j][u][v]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int c = c0 + tc * 4 + u;
      if (c >= p.C) continue;
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int n = n0 + tn * 4 + v;
        if (n < p.N)
          atomicAdd(p.dw + ((size_t)(i * KT + j) * p.C + c) * p.N + n,
                    acc[j][u][v]);
      }
    }
}

// ---------------------------------------------------- tensor-core tile

// two consecutive bf16 as one fragment word, from any (even or odd) element
__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  const uint16_t* h = reinterpret_cast<const uint16_t*>(p);
  return (uint32_t)h[0] | ((uint32_t)h[1] << 16);
}

// X staged as [c][XW] (XW = XC + 8) and G as [n][kGW], both bf16
template <int KT, int MODE>
__global__ void __launch_bounds__(kThreads) dw_mma(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int XW = p.XC + 8;
  bf16* xs = reinterpret_cast<bf16*>(smem);  // [kCB][XW]
  bf16* gs = xs + kCB * XW;                  // [kNB][kGW]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wc = warp & 1, wn = warp >> 1;  // 2 x 4 warps of 32 c x 16 n
  int i, c0, n0;
  tile_at(p, i, c0, n0);
  const int PF = (p.KF - 1) / 2, PT = (KT - 1) / 2;
  const float sq2 = Elem<bf16>::round(1.41421356237309515f);
  const bf16* xg = static_cast<const bf16*>(p.x);
  const bool vec = (p.C % 8) == 0 && MODE == kPlainDW;

  float acc[KT][2][2][4];
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int v = 0; v < 2; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][u][v][e] = 0.f;

  for (int k = blockIdx.x; k < p.n_chunks; k += p.splits) {
    int b, f, t0;
    chunk_at(p, k, b, f, t0);
    const int fx = f + (i - PF) * p.df;
    const bool rowin = fx >= 0 && fx < p.F;
    // X: 8 channels per unit, transposed to [c][col]
    for (int u = tid; u < p.XC * (kCB / 8); u += kThreads) {
      const int c8 = u % (kCB / 8), col = u / (kCB / 8);
      const int t = t0 - PT * p.dt + col, cb = c0 + c8 * 8;
      __align__(16) bf16 v[8];
      const size_t idx = (((size_t)b * p.F + fx) * p.T + t) * p.C + cb;
      const bool inb = rowin && t >= 0 && t < p.T;
      if (vec && inb && cb + 8 <= p.C) {
        *reinterpret_cast<uint4*>(v) = *reinterpret_cast<const uint4*>(xg + idx);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = __float2bfloat16(
              (inb && cb + e < p.C) ? x_value<bf16, MODE>(p, idx + e, b, cb + e)
                                    : 0.f);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) xs[(c8 * 8 + e) * XW + col] = v[e];
    }
    // G: 8 channels per unit, transposed to [n][pos]
    for (int u = tid; u < kTP * (kNB / 8); u += kThreads) {
      const int n8 = u % (kNB / 8), pos = u / (kNB / 8);
      const int t = t0 + pos, nb = n0 + n8 * 8;
      const size_t idx = (((size_t)b * p.F + f) * p.T + t) * p.N + nb;
#pragma unroll
      for (int e = 0; e < 8; ++e)
        gs[(n8 * 8 + e) * kGW + pos] = __float2bfloat16(
            (t < p.T && nb + e < p.N)
                ? g_value<bf16, MODE>(p, idx + e, b, nb + e, sq2)
                : 0.f);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kTP; ks += 16) {
      // B[k][n]: position ks + k, output channel wn*16 + nt*8 + g
      uint32_t bq[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const uint32_t* pb = reinterpret_cast<const uint32_t*>(
            gs + (wn * 16 + nt * 8 + g) * kGW + ks + 2 * q);
        bq[nt][0] = pb[0];
        bq[nt][1] = pb[4];
      }
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          // A[m][k]: input channel wc*32 + mt*16 + m, position ks + k,
          // read j*dt columns on (tap j)
          const bf16* pa =
              xs + (wc * 32 + mt * 16 + g) * XW + ks + 2 * q + j * p.dt;
          const uint32_t af[4] = {ld_pair(pa), ld_pair(pa + 8 * XW),
                                  ld_pair(pa + 8), ld_pair(pa + 8 * XW + 8)};
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
            frag::mma(acc[j][mt][nt], af, bq[nt][0], bq[nt][1]);
        }
      }
    }
    __syncthreads();
  }

  // accumulator element e of (j, mt, nt): input channel
  // wc*32 + mt*16 + g + 8*(e>>1), output channel wn*16 + nt*8 + 2q + (e&1)
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + wc * 32 + mt * 16 + g + 8 * (e >> 1);
          const int n = n0 + wn * 16 + nt * 8 + 2 * q + (e & 1);
          if (c < p.C && n < p.N)
            atomicAdd(p.dw + ((size_t)(i * KT + j) * p.C + c) * p.N + n,
                      acc[j][mt][nt][e]);
        }
}

template <typename K>
int allow_smem(K kernel, bool& done) {
  if (done) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (err != cudaSuccess) return (int)err;
  done = true;
  return 0;
}

// one launch at a compile-time KT: the tensor-core tile for bf16 with at
// least 16 input channels, else the CUDA-core tile
template <typename T, int KT, int MODE>
int launch_kt(Params p, cudaStream_t st) {
  p.XC = kTP + (KT - 1) * p.dt;
  p.c_tiles = (p.C + kCB - 1) / kCB;
  p.n_tiles = (p.N + kNB - 1) / kNB;
  p.tchunks = (p.T + kTP - 1) / kTP;
  p.n_chunks = p.B * p.F * p.tchunks;
  const int tiles = p.KF * p.c_tiles * p.n_tiles;
  // about four blocks per SM of the H100's 132 over all tiles
  p.splits = (4 * 132 + tiles - 1) / tiles;
  if (p.splits > p.n_chunks) p.splits = p.n_chunks;
  dim3 grid(p.splits, tiles);
  if (sizeof(T) == 2 && p.C >= 16) {
    const size_t smem = (size_t)(kCB * (p.XC + 8) + kNB * kGW) * sizeof(bf16);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
    static bool configured = false;
    if (int rc = allow_smem(dw_mma<KT, MODE>, configured)) return rc;
    dw_mma<KT, MODE><<<grid, kThreads, smem, st>>>(p);
  } else {
    const size_t smem =
        (size_t)(kCB * (p.XC + 1) + kNB * (kTP + 1)) * sizeof(float);
    if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidConfiguration;
    static bool configured = false;
    if (int rc = allow_smem(dw_simt<T, KT, MODE>, configured)) return rc;
    dw_simt<T, KT, MODE><<<grid, kThreads, smem, st>>>(p);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_plain(Params p, cudaStream_t st) {
  switch (p.KT) {
    case 1: return launch_kt<T, 1, kPlainDW>(p, st);
    case 3: return launch_kt<T, 3, kPlainDW>(p, st);
    case 5: return launch_kt<T, 5, kPlainDW>(p, st);
    case 7: return launch_kt<T, 7, kPlainDW>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace cdw
}  // namespace babe

// dW (KF*KT, C, N) fp32 += the weight gradient of the 'SAME' conv of x
// (B, F, T, C) with cotangent g (B, F, T, N); dtype 0 = fp32, 1 = bf16.
extern "C" int babe_conv_dw(const void* x, const void* g, void* dw, int B,
                            int F, int T, int C, int N, int KF, int KT, int df,
                            int dt, int dtype, void* stream) {
  using namespace babe::cdw;
  if (KF < 1 || KF > 7 || KT < 1 || KT > 7 || KF % 2 == 0 || KT % 2 == 0 ||
      df < 1 || dt < 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || F <= 0 || T <= 0 || C <= 0 || N <= 0) return 0;
  Params p{};
  p.x = x;
  p.g = g;
  p.dw = static_cast<float*>(dw);
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
  if (dtype == 0) return launch_plain<float>(p, st);
  if (dtype == 1) return launch_plain<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}

// dW (5, 3, C, C) fp32 += the weight gradient of one K2 stage at dilation
// (d, 1): X = gelu(x*a), G = g_pre*s (see the file's head).
extern "C" int babe_fused_stage_dw(const void* x, const void* a,
                                   const void* s, const void* y,
                                   const void* g_y, const void* g_mom,
                                   void* dw, int B, int F, int T, int C, int d,
                                   int dtype, void* stream) {
  using namespace babe::cdw;
  if (d < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0 || F <= 0 || T <= 0 || C <= 0) return 0;
  Params p{};
  p.x = x;
  p.g = g_y;
  p.dw = static_cast<float*>(dw);
  p.a = static_cast<const float*>(a);
  p.s = static_cast<const float*>(s);
  p.y = y;
  p.gmom = static_cast<const float*>(g_mom);
  p.B = B;
  p.F = F;
  p.T = T;
  p.C = C;
  p.N = C;
  p.KF = 5;
  p.KT = 3;
  p.df = d;
  p.dt = 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_kt<float, 3, kStageDW>(p, st);
  if (dtype == 1) return launch_kt<__nv_bfloat16, 3, kStageDW>(p, st);
  return (int)cudaErrorInvalidValue;
}
