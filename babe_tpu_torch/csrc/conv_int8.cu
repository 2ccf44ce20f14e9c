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
// Three routes, chosen and cut by the host (kernels.conv_int8_route,
// conv_int8_plan, stage_plan) and passed in with their plan; a route that
// cannot take the call refuses it, none falls back to another:
//
//   tma   C and N multiples of 16 (the tensor maps' 16-byte strides; every
//         flagship int8 stage of 128 and 256 channels and its int8 input
//         gradient): an implicit GEMM on the TMA ring of
//         probe_gemm_sm90.cuh (its producer and consumer functions, its
//         128B-swizzled wgmma SS), K4's TMA route (dilated_conv.cu) in
//         int8.  The contraction is (tap, 128-channel chunk): one 128-byte
//         swizzle row of int8.  For each k-step the producer warp asks the
//         TMA for two A boxes, 128 channels x TT columns x TF rows x 1
//         item, from a 4-D tensor map over q (C, T, F, B) at (c0, t0 + kt -
//         1, f0 + (kf - 2) d, b) and (.., f0 + TF + (kf - 2) d, b), and one
//         B box, 128 channels x BN outputs, from a 3-D map over qw (C, N,
//         15) at (c0, n0, tap): the tap-major kernel as the launcher gets
//         it, no per-call weight pack.  The TMA zero-fills whatever lies
//         outside the tensor, negative coordinates included: that is the
//         'SAME' padding, with no padded copy; T, F and B are separate
//         dimensions, so no shift bleeds into the next row or item.  Two
//         consumer warpgroups each run four wgmma m64nBNk32 s8 (32 bytes of
//         K each, int32 accumulators) per k-step on their own A box and the
//         shared B box.  A box holds TT * TF <= 64 positions (the plan's K4
//         box): rows past TT * TF hold stale bits, whose products land only
//         in their own accumulator rows, which are never stored.  Epilogue:
//         the int32 sums go through a shared-memory tile (the ring, once
//         both warpgroups are done); each thread takes 8 channels of one
//         position, forms __fmul_rn(__int2float_rn(acc), scale[b, n]) and
//         writes 16 bytes along N (32 for fp32), masking ragged F, T and N,
//         and the int32 view to acc_out when asked.
//   engine C = N = 96 with rows of at least 16 positions (the flagship's
//         96-channel stages): the stage engine's int8 main loop
//         (stage_mma_sm90.cuh, conv_loop: cp.async ring, ldmatrix A, wgmma
//         m64n96k32 s8 from the engine's weight pack), then the same
//         epilogue.  Measured on the card, the TMA's cost goes with the box
//         rows it delivers, not their bytes: at 96 channels a 128-byte box
//         row is a quarter zero fill and the TMA route runs slower than
//         the engine (chip_smoke.py times both there); the same rows
//         without the fill ran faster than the engine, and three 32-byte
//         boxes (32-byte swizzle, no fill: three times the rows) slower
//         still (PERF.md, C8).  The engine stages each input row once per
//         kernel row and shifts it by ldmatrix for the three taps.
//   tile  every other shape (C or N not a multiple of 16): a tile of 32
//         positions of one row x 32 output channels per block, 64 input
//         channels a stage in shared memory, __dp4a over 4 channels a word.
//
// acc_out, when given, receives the int32 accumulator (the checks' view).
//
// Bound on the H100: 2*15*C*N operations per position at 1979 Tops/s
// against C bytes read and N * 2-4 bytes written: operations from C = 96.
// The tma route rereads each input chunk once per tap from L2 (15 A boxes
// per output position and chunk; a swizzled A descriptor moves in 8-row
// groups, so a kt shift cannot be taken inside shared memory), and each
// block reads all the weights of its BN outputs: 15 x (128 + BN) box rows
// a block and chunk.
#include <cuda_bf16.h>
#include <stdint.h>
#include <string.h>

#include "probe_gemm_sm90.cuh"
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

// the epilogue of the tma and engine routes: an int32 tile of 128 rows
// (tile row r: position pos(r), or none) x NT + 4 values in shared memory
// -> out (and acc_out) at (b, position, n0 + 8 cg ..), 8 channels a thread:
// one fp32 product each, 16-byte stores along N
template <int NT, typename T, typename Pos>
__device__ __forceinline__ void store_tile(const int32_t* tile,
                                           const float* sc, T* out,
                                           int32_t* acc_out, size_t rowbase,
                                           int N, int n0, Pos&& pos) {
  constexpr int NP = NT + 4, R = NT / 8;
  for (int u = threadIdx.x; u < 128 * R; u += 256) {
    const int row = u / R, cg = u - row * R;
    const int n = n0 + cg * 8;
    long long p;
    if (n >= N || (p = pos(row)) < 0) continue;
    const int32_t* src = tile + row * NP + cg * 8;
    const int4 a0 = *reinterpret_cast<const int4*>(src);
    const int4 a1 = *reinterpret_cast<const int4*>(src + 4);
    const float4 s0 = __ldg(reinterpret_cast<const float4*>(sc + n));
    const float4 s1 = __ldg(reinterpret_cast<const float4*>(sc + n + 4));
    const int32_t av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    const float sv[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = __fmul_rn(__int2float_rn(av[e]), sv[e]);
    const size_t idx = (rowbase + (size_t)p) * N + n;
    Out<T>::store8(out + idx, v);
    if (acc_out != nullptr) {
      *reinterpret_cast<int4*>(acc_out + idx) = a0;
      *reinterpret_cast<int4*>(acc_out + idx + 4) = a1;
    }
  }
}

// the accumulators of two warpgroups' m64nNT products (register n8*4 +
// hr*2 + e: warp row gq + 8hr, column 8 n8 + 2q + e) -> the int32 tile,
// warpgroup w's rows from 64w
template <int NT>
__device__ __forceinline__ void acc_to_tile(int32_t* tile,
                                            const int32_t (&acc)[NT / 2]) {
  constexpr int NP = NT + 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, q = lane & 3;
  const int r0 = (warp >> 2) * 64 + (warp & 3) * 16 + gq;
#pragma unroll
  for (int n8 = 0; n8 < NT / 8; ++n8)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<int2*>(tile + (r0 + 8 * hr) * NP + n8 * 8 + 2 * q) =
          make_int2(acc[n8 * 4 + hr * 2], acc[n8 * 4 + hr * 2 + 1]);
}

// ------------------------------------------------------------- tma route

// The cut of one tma call, made by the host (kernels.conv_int8_plan):
// these fields, all ints, in this order.  Block (gx, gy, z) owns outputs
// n0 = (z % n_tiles) * bn .. n0 + bn of item z / n_tiles at the TT x 2TF
// positions from (f0, t0) = (gy * 2TF, gx * TT), the first TF rows
// warpgroup 0's, the next TF warpgroup 1's; it walks n_k = 15 * nch ring
// stages (tap outer, 128-channel chunk inner).
struct Plan {
  int route, B, F, T, C, N, d;
  int TT, TF, bn, n_tiles, nch, n_k, stages, stage_bytes, smem, gx, gy, gz;
};

constexpr int kTmaThreads = 288;  // two consumer warpgroups, a producer warp
constexpr int kABox = 64 * 128;   // one warpgroup's A slot: 64 x 128 bytes
constexpr int kChunk = 128;       // int8 channels per ring stage

// as K4's TMA route: up to 128 outputs a block, two blocks an SM, the
// ring half of the SM's shared memory each; one block of 256
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

template <int BN, typename T>
__global__ void __launch_bounds__(kTmaThreads, tma_blocks<BN>())
    c8_tma(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tw,
           const float* __restrict__ scale, T* __restrict__ out,
           int32_t* __restrict__ acc_out, const Plan p) {
  using namespace babe::sm90;
  constexpr int kS = tma_stages<BN>(), kStage = tma_stage_bytes<BN>();
  static_assert(128 * (BN + 4) * 4 <= kS * kStage, "tile past the ring");
  extern __shared__ __align__(1024) unsigned char smem_c8[];
  __shared__ __align__(8) uint64_t full[kS], empty[kS];
  const uint32_t base = smem_u32(smem_c8);
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
      const CUtensorMap *pq = &tq, *pw = &tw;
      // what the three boxes deliver, zero fill included
      const uint32_t tx_bytes = 128 * (2 * p.TT * p.TF + BN);
      gemm90::produce<kS>(
          p.n_k, ring, kStage, tx_bytes, full, empty,
          [&](int it, uint32_t dst, uint32_t bar) {
            const int tap = it / p.nch, c0 = (it - tap * p.nch) * kChunk;
            const int kf = tap / 3, kt = tap - kf * 3;
            const int t = t0 + kt - 1, f = f0 + (kf - 2) * p.d;
            tma_load_4d(dst, pq, c0, t, f, b, bar);
            tma_load_4d(dst + kABox, pq, c0, t, f + p.TF, b, bar);
            tma_load_3d(dst + 2 * kABox, pw, c0, n0, tap, bar);
          });
    }
    return;
  }

  const int wg = tid >> 7;
  int32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0;
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
  int32_t* tile = reinterpret_cast<int32_t*>(smem_c8 + (ring - base));
  acc_to_tile<BN>(tile, acc);
  bar_sync(1, 256);
  // tile row r of warpgroup r / 64 is position (f0 + (r / 64) TF + (r %
  // 64) / TT, t0 + (r % 64) % TT) when r % 64 < TT * TF
  const int live = p.TT * p.TF;
  store_tile<BN>(tile, scale + (size_t)b * p.N, out, acc_out,
                 (size_t)b * p.F * p.T, p.N, n0, [&](int row) -> long long {
                   const int rr = row & 63;
                   if (rr >= live) return -1;
                   const int f = f0 + (row >> 6) * p.TF + rr / p.TT;
                   const int t = t0 + rr % p.TT;
                   if (f >= p.F || t >= p.T) return -1;
                   return (long long)f * p.T + t;
                 });
}

// the two tensor maps of a call: q (C, T, F, B) in boxes of 128 channels
// x TT x TF x 1, qw (C, N, 15) in boxes of 128 channels x bn x 1 tap;
// int8, 128B swizzle, zero fill outside the tensors.  Encoded per call on
// the host and passed as __grid_constant__ parameters, so a CUDA graph can
// capture the launch.
inline bool tma_maps(const Plan& k, const void* q, const void* qwt,
                     CUtensorMap* tq, CUtensorMap* tw) {
  const cuuint64_t qd[4] = {(cuuint64_t)k.C, (cuuint64_t)k.T,
                            (cuuint64_t)k.F, (cuuint64_t)k.B};
  const cuuint64_t qs[3] = {(cuuint64_t)k.C, (cuuint64_t)k.T * k.C,
                            (cuuint64_t)k.F * k.T * k.C};
  const cuuint32_t qb[4] = {kChunk, (cuuint32_t)k.TT, (cuuint32_t)k.TF, 1};
  const cuuint64_t wd[3] = {(cuuint64_t)k.C, (cuuint64_t)k.N, 15};
  const cuuint64_t ws[2] = {(cuuint64_t)k.C, (cuuint64_t)k.N * k.C};
  const cuuint32_t wb[3] = {kChunk, (cuuint32_t)k.bn, 1};
  return gemm90::tiled_map(tq, q, 4, qd, qs, qb, 1) &&
         gemm90::tiled_map(tw, qwt, 3, wd, ws, wb, 1);
}

// the tma route's plan checks: what the kernel and its maps assume
inline bool tma_plan_ok(const Plan& k, const void* q, const void* qwt,
                        const void* scale, const void* out,
                        const void* acc_out) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(q) |
                      reinterpret_cast<uintptr_t>(qwt) |
                      reinterpret_cast<uintptr_t>(scale) |
                      reinterpret_cast<uintptr_t>(out) |
                      reinterpret_cast<uintptr_t>(acc_out);
  return k.C % 16 == 0 && k.N % 16 == 0 && a % 16 == 0 && k.d >= 1 &&
         k.TT >= 1 && k.TF >= 1 && k.TT * k.TF <= 64 &&
         k.nch == (k.C + kChunk - 1) / kChunk && k.n_k == 15 * k.nch &&
         k.n_tiles == (k.N + k.bn - 1) / k.bn && k.gz == k.B * k.n_tiles &&
         (long)k.gx * k.TT >= k.T && (long)k.gy * 2 * k.TF >= k.F &&
         k.gy <= 65535 && k.gz <= 65535;
}

template <int BN, typename T>
int launch_tma(const Plan& k, const void* q, const void* qwt,
               const float* scale, T* out, int32_t* acc_out,
               cudaStream_t st) {
  if (k.stages != tma_stages<BN>() || k.smem != tma_smem<BN>() ||
      k.stage_bytes != tma_stage_bytes<BN>())
    return (int)cudaErrorInvalidValue;
  static bool configured = false;  // its barriers are static: ask for
  if (!configured) {                // only the dynamic bytes it takes
    const cudaError_t err = cudaFuncSetAttribute(
        c8_tma<BN, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        tma_smem<BN>());
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  CUtensorMap tq, tw;
  if (!tma_maps(k, q, qwt, &tq, &tw)) return (int)cudaErrorInvalidValue;
  c8_tma<BN, T><<<dim3(k.gx, k.gy, k.gz), kTmaThreads, k.smem, st>>>(
      tq, tw, scale, out, acc_out, k);
  return (int)cudaGetLastError();
}

template <typename T>
int tma(const Plan& k, const void* q, const void* qwt, const float* scale,
        T* out, int32_t* acc_out, cudaStream_t st) {
  if (!tma_plan_ok(k, q, qwt, scale, out, acc_out))
    return (int)cudaErrorInvalidValue;
  switch (k.bn) {
    case 64: return launch_tma<64, T>(k, q, qwt, scale, out, acc_out, st);
    case 96: return launch_tma<96, T>(k, q, qwt, scale, out, acc_out, st);
    case 128: return launch_tma<128, T>(k, q, qwt, scale, out, acc_out, st);
    case 256: return launch_tma<256, T>(k, q, qwt, scale, out, acc_out, st);
  }
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- engine

// block (gx, gy, z): positions f0 + q / TT, t0 + q % TT (q < 128) of item
// z, output channels 0 .. NT (C = N = NT, one channel tile)
template <int NT, typename T>
__global__ void __launch_bounds__(256, 2)
    c8_engine(const StagePlan p, const int8_t* q, const void* wpk,
              const float* scale, T* out, int32_t* acc_out) {
  extern __shared__ __align__(128) unsigned char smem_c8e[];
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * p.TT, f0 = blockIdx.y * p.TF;
  const size_t bbase = (size_t)b * p.F * p.T * p.C;
  int32_t acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0;
  sm90::conv_loop<NT, 1, false, 2>(
      p, reinterpret_cast<const unsigned char*>(q),
      static_cast<const unsigned char*>(wpk), bbase, f0, t0, 0,
      sm90::smem_u32(smem_c8e), acc);
  // the ring becomes the int32 tile (conv_loop returns with the ring free)
  int32_t* tile = reinterpret_cast<int32_t*>(smem_c8e);
  acc_to_tile<NT>(tile, acc);
  __syncthreads();
  store_tile<NT>(tile, scale + (size_t)b * p.C, out, acc_out,
                 (size_t)b * p.F * p.T, p.C, 0, [&](int row) -> long long {
                   const int f = f0 + (row >> p.tt_log2);
                   const int t = t0 + (row & (p.TT - 1));
                   if (f >= p.F || t >= p.T) return -1;
                   return (long long)f * p.T + t;
                 });
}

template <typename T>
int engine(const StagePlan& p, const int8_t* q, const void* wpk,
           const float* scale, T* out, int32_t* acc_out, cudaStream_t st) {
  if (p.splits != 1 || p.C != 96) return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        c8_engine<96, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        232448);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  c8_engine<96, T><<<dim3(p.gx, p.gy, p.gz), 256, p.smem, st>>>(
      p, q, wpk, scale, out, acc_out);
  return (int)cudaGetLastError();
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

// route (kernels.C8_ROUTES): 0 the tile (meta unread), 1 tma (meta a Plan,
// kernels.conv_int8_plan; wq read through its tensor map), 2 the engine
// (meta a StagePlan, kernels.stage_plan; wpk the engine's weight pack).
// wq is the tap-major kernel (15, N, C).  dtype of out: 0 fp32, 1 bf16.
// acc_out (optional): the int32 accumulator.  Returns the launch status
// (cudaSuccess = 0): cudaErrorInvalidValue for a plan, type, shape or
// alignment the route does not take.
extern "C" int babe_conv_int8(const void* q, const void* wq, const void* wpk,
                              const void* scale, void* out, void* acc_out,
                              int B, int F, int T, int C, int N, int d,
                              int dtype, int route, const int* meta,
                              int n_meta, void* stream) {
  using namespace babe::c8;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (B <= 0 || F <= 0 || T <= 0 || C <= 0 || N <= 0) return 0;
  const int8_t* qi = static_cast<const int8_t*>(q);
  const int8_t* w = static_cast<const int8_t*>(wq);
  const float* sc = static_cast<const float*>(scale);
  int32_t* ao = static_cast<int32_t*>(acc_out);
  if (route == 1) {
    Plan k;
    if (meta == nullptr || n_meta != (int)(sizeof(Plan) / sizeof(int)))
      return (int)cudaErrorInvalidValue;
    memcpy(&k, meta, sizeof(k));
    if (k.route != 1 || k.B != B || k.F != F || k.T != T || k.C != C ||
        k.N != N || k.d != d)
      return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return tma<float>(k, qi, w, sc, static_cast<float*>(out), ao, st);
    return tma<__nv_bfloat16>(k, qi, w, sc,
                              static_cast<__nv_bfloat16*>(out), ao, st);
  }
  if (route == 2) {
    StagePlan p;
    const uintptr_t a = reinterpret_cast<uintptr_t>(sc) |
                        reinterpret_cast<uintptr_t>(out) |
                        reinterpret_cast<uintptr_t>(ao);
    if (C != N || a % 16 != 0 ||
        !babe::sm90::read_plan(p, meta, n_meta, B, F, T, C, d) ||
        p.route != 1)
      return (int)cudaErrorInvalidValue;
    if (dtype == 0)
      return engine<float>(p, qi, wpk, sc, static_cast<float*>(out), ao, st);
    return engine<__nv_bfloat16>(p, qi, wpk, sc,
                                 static_cast<__nv_bfloat16*>(out), ao, st);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return tile<float>(qi, w, sc, static_cast<float*>(out), ao, B, F, T, C,
                       N, d, st);
  return tile<__nv_bfloat16>(qi, w, sc, static_cast<__nv_bfloat16*>(out), ao,
                             B, F, T, C, N, d, st);
}
