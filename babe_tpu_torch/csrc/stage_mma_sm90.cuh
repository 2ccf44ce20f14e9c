// K2's backward on Hopper: the conv transpose of one dilation stage with
// the vjp's elementwise chain fused around it, on sm_90a warpgroup tensor
// cores (wgmma) fed by a cp.async ring.  Same function and rounding order
// as the kBwd mode of conv5x3_tile.cuh / conv5x3_mma.cuh, which serve the
// shapes this engine does not take (fp32, T < 16, C not a multiple of 32
// in 64..256):
//
//   g_pre = round(round(g_y + round(g_m0 + 2 y g_m1)) / sqrt2)
//   dh    = conv5x3_d(round(g_pre * round(s)), w flipped, in/out swapped)
//   du    = round(round(dh) * gelu'(round(x * round(a))))
//   dx    = round(g_pre + round(du * round(a)))
//   ds    = sum g_pre * c,  da = sum du * x       per (B, C), fp32
//
// Replaces the backward of babe_tpu/ops/conv_kernels.py::_fused_bwd (XLA on
// the TPU, the vjp of _dil_stage_ref); plain version
// ops/conv_kernels.py::dil_stage_bwd_ref.
//
// The conv transpose's input g_pre * s is formed once per element by the
// operand pass that K2's weight gradient runs anyway (conv_dw.cu,
// babe_stage_dw_operands, in K2's rounding order), not in this kernel:
// recomputed here for every kernel row it cost more than the products.
//
// The cut (kernels.stage_bwd_plan, passed in as StagePlan): a block owns
// two warpgroups x 64 output positions (TF rows of F x TT columns of T, TT
// a power of two) and all N = C output channels, so no staged element is
// read for more than one channel tile.  The contraction walks n_it = 5 *
// C/16 ring stages, channel chunk outer, kf inner; a stage holds one kf's
// halo window (TF rows x TT+2 columns x 16 channels) of g_pre * s and the
// three kt taps' weights for every output channel.  A ring of kStages
// stages is filled by 16-byte cp.async (halo and padding rows zero-filled
// by the copy): while stage k's products run (and stage k-1's may still),
// the copies of stages k+1 .. k+3 are in flight.
//
// Products: wgmma.mma_async m64nNk16 (bf16, fp32 accumulate), one
// instruction of the full width N per tap (wgmma_rs.cuh).  A comes from
// registers, loaded from the staged window by ldmatrix: a kt shift moves
// the im2col row by one position, which a shared-memory A descriptor
// (8-row core matrices) cannot express, while each lane of ldmatrix names
// its own row.  B is the weights, read by a matrix descriptor from the
// no-swizzle K-major canonical layout [kt][n/8][k half][8 n][8 k] that the
// launcher packs from the forward kernel w in one permute
// (kernels.stage_bwd_weights: (kf, chunk, kt, n/8, k half, 8 n, 8 k) of
// w[kf, kt, n, k]); the transpose's flip is the kernel's reading of it at
// 4-kf and 2-kt.  LBO (k direction) 128 bytes, SBO (n direction) 256.
//
// Epilogue: the accumulators go through shared memory as bf16, so every
// read of g_y, y, x and c and the write of dx is 16 bytes along C; ds and
// da reduce by warp shuffles, shared-memory atomics, then one global fp32
// atomic per (b, channel) and block (last bits vary run to run).
//
// Bound on the H100: 2*15*C^2 flops per position against 5 tensors of C
// bf16 moved: bytes at C = 64 and 96, the tensor-core rate from C = 128.
#pragma once

#include "conv5x3_tile.cuh"
#include "sm90_frag.cuh"
#include "wgmma_rs.cuh"

namespace babe {
namespace sm90 {

using bf16 = __nv_bfloat16;
constexpr int kKC = 16;        // input channels per ring stage (a k-step)
constexpr int kPx = 24;        // bf16 per staged window pixel (16 + pad)
constexpr int kStages = 5;     // the cp.async ring
constexpr int kLead = kStages - 2;  // stages in flight ahead of the products
constexpr int kMaxUnits = 2;   // 16-byte window units per thread
constexpr int kThreads = 256;  // two warpgroups
constexpr int kPos = 128;      // output positions per block, 64 per warpgroup

// The cut of one call, made by the host (kernels.stage_bwd_plan): these
// fields, all ints, in this order.
struct StagePlan {
  int route, B, F, T, C, d;
  int tt_log2, TT, TF, n_it, ring_bytes, stage_bytes, win_bytes, smem, gx,
      gy, gz;
};

struct StageArgs {
  const bf16* gc;     // (B, F, T, C) the conv transpose's input g_pre * s
  const bf16* gy;     // (B, F, T, C) cotangent of y
  const float* gmom;  // (2, B, C) cotangent of the moments
  const bf16* y;      // the stage's output
  const bf16* x;      // the stage's input
  const bf16* c;      // the stage's conv output
  const float* a;     // (B, C)
  const bf16* wpk;    // packed weights (stage_bwd_weights)
  bf16* dx;           // (B, F, T, C)
  float* dsda;        // (2, B, C) [ds, da], zeroed by the caller
};

// no-swizzle K-major matrix descriptor: start address, LBO (between the
// two 8-wide k halves) and SBO (between 8-row n groups), in 16-byte units
__device__ __forceinline__ uint64_t desc_b(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int K>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}

// one stage's product operands: A for the three taps, B's descriptors
struct Operands {
  uint32_t a[3][4];
  uint64_t b[3];
};

// a compiler barrier that keeps the operands' registers live and defined
// here
__device__ __forceinline__ void hold(Operands& o) {
#pragma unroll
  for (int kt = 0; kt < 3; ++kt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(o.a[kt][i]));
    asm volatile("" : "+l"(o.b[kt]));
  }
}

// keep the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int K>
__device__ __forceinline__ void fence_acc(float (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// g_pre divides a bf16 value by sqrt2 rounded to bf16 (1.4140625) and
// rounds to bf16.  Multiplying by the fp32 reciprocal of 1.4140625 gives
// the same bf16 for every finite bf16 input (checked exhaustively by
// tests/test_torch_stage_engine.py) at a fraction of a division's cost.
constexpr float kInvSq2 = 0.70718234777450562f;

__device__ __forceinline__ void load8(float (&v)[8], const float* src) {
  *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(src);
  *reinterpret_cast<float4*>(v + 4) =
      *reinterpret_cast<const float4*>(src + 4);
}

// One thread's share of a stage's window: unit k is 8 channels of one
// pixel (px = u / 2, half u % 2) of the TF x TW window.
struct Units {
  int n;                 // units this thread owns
  int dst[kMaxUnits];    // byte offset in a window buffer
  int fb[kMaxUnits];     // the pixel's output row f0 + fr
  int t[kMaxUnits];      // its column t0 - 1 + col, -1 when outside [0, T)
  int ch[kMaxUnits];     // its channel offset in the chunk (0 or 8)
};

template <int N>
__global__ void __launch_bounds__(256, 1)
    stage_bwd_sm90(const StagePlan p, const StageArgs g) {
  constexpr int NP = N + 8;  // bf16 per row of the epilogue tile
  // epilogue positions per thread with their loads in flight: 4 at the
  // widest stages (16 positions a thread), where the accumulators'
  // registers are free by then; 1 below, where more would cost blocks
  // per SM (measured on an H100: 2 and 4 slowed C = 64..128)
  constexpr int kEpi = N >= 192 ? 4 : 1;
  extern __shared__ __align__(128) unsigned char smem_sm90[];
  unsigned char* smem = smem_sm90;
  // [ring: kStages x (W | G)] [gm0 gm1 a red0 red1: N floats each]
  float* vec = reinterpret_cast<float*>(smem + p.ring_bytes);
  float *gm0 = vec, *gm1 = vec + N, *ar = vec + 2 * N, *red = vec + 3 * N;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w4 = warp & 3;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * p.TT, f0 = blockIdx.y * p.TF;
  const int TW = p.TT + 2, C = p.C, F = p.F, T = p.T, d = p.d;
  const int nch = C / kKC;
  const size_t bbase = (size_t)b * F * T * C;
  const uint32_t sbase = smem_u32(smem);

  for (int n = tid; n < N; n += kThreads) {
    gm0[n] = g.gmom[b * C + n];
    gm1[n] = g.gmom[(p.B + b) * C + n];
    ar[n] = Elem<bf16>::round(g.a[b * C + n]);
    red[n] = 0.f;
    red[N + n] = 0.f;
  }

  Units un;
  un.n = 0;
#pragma unroll
  for (int k = 0; k < kMaxUnits; ++k) {
    const int u = tid + k * kThreads;
    un.dst[k] = un.fb[k] = un.t[k] = un.ch[k] = 0;
    if (u < p.TF * TW * 2) {
      const int px = u >> 1, fr = px / TW, col = px - fr * TW;
      const int t = t0 - 1 + col;
      un.dst[k] = px * kPx * 2 + (u & 1) * 16;
      un.fb[k] = f0 + fr;
      un.t[k] = (t >= 0 && t < T) ? t : -1;
      un.ch[k] = (u & 1) * 8;
      un.n = k + 1;
    }
  }

  // stage it -> ring slot: kf's window of the operand g_pre * s and the
  // three taps' weights
  auto issue = [&](int it) {
    const int chunk = it / 5, kf = it - chunk * 5, slot = it % kStages;
    const uint32_t sw = sbase + slot * p.stage_bytes;
    const uint32_t sg = sw + 3 * N * kKC * 2;
    const bf16* wsrc = g.wpk + (size_t)((4 - kf) * nch + chunk) * 3 * N * kKC;
    for (int u = tid; u < 6 * N; u += kThreads)
      cp16(sw + u * 16, wsrc + u * 8, true);
#pragma unroll
    for (int k = 0; k < kMaxUnits; ++k) {
      if (k < un.n) {
        const int f = un.fb[k] + (kf - 2) * d;
        const bool inb = un.t[k] >= 0 && f >= 0 && f < F && un.fb[k] < F;
        const size_t off =
            inb ? bbase + ((size_t)f * T + un.t[k]) * C + chunk * kKC +
                      un.ch[k]
                : 0;
        cp16(sg + un.dst[k], g.gc + off, inb);
      }
    }
  };

  float acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;

  // this lane's ldmatrix row: position wg*64 + w4*16 + (lane & 15), its
  // channel half lane >> 4; byte offset in a window buffer at kt = 0
  const int pos = wg * 64 + w4 * 16 + (lane & 15);
  const int a_off = (((pos >> p.tt_log2) * TW + (pos & (p.TT - 1))) * kPx +
                     (lane >> 4) * 8) * 2;

#pragma unroll
  for (int s = 0; s < kLead; ++s) {
    if (s < p.n_it) issue(s);
    cp_commit();
  }

  // one ring stage: its products stay in flight through the next stage's
  // wait, barrier, copies and fragment loads, so their operands (A and the
  // B descriptors) alternate between two register sets, each held live
  // until its products are done: a register of an in-flight wgmma that
  // other code redefines makes ptxas serialize the kernel's wgmma (it
  // still reports doing so at N <= 128, for a reason not found yet)
  auto step = [&](int it, Operands& cur, Operands& prev) {
    cp_wait<kLead - 1>();  // this thread's copies of stage it
    fence_async_shared();
    __syncthreads();  // everyone's; stage it-2's products are done
    if (it + kLead < p.n_it) issue(it + kLead);
    cp_commit();
    const uint32_t sw = sbase + (it % kStages) * p.stage_bytes;
    const uint32_t sg = sw + 3 * N * kKC * 2;
#pragma unroll
    for (int kt = 0; kt < 3; ++kt) {
      ldsm_x4(cur.a[kt], sg + a_off + kt * kPx * 2);
      cur.b[kt] = desc_b(sw + (2 - kt) * N * kKC * 2);
    }
    hold(cur);  // defined before the products start
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kt = 0; kt < 3; ++kt) wgmma_rs<N>(acc, cur.a[kt], cur.b[kt]);
    wg_commit();
    wg_wait<1>();  // stage it-1's products are done
    hold(prev);
    fence_acc(acc);
  };
  Operands o0 = {}, o1 = {};
  for (int it = 0; it < p.n_it; it += 2) {
    step(it, o0, o1);
    if (it + 1 < p.n_it) step(it + 1, o1, o0);
  }
  wg_wait<0>();
  hold(o0);
  hold(o1);
  fence_acc(acc);
  cp_wait<0>();
  __syncthreads();  // the ring is free: it becomes the epilogue tile

  // accumulator register n8*4 + hr*2 + e: warp row g + 8hr, column
  // 8 n8 + 2q + e -> bf16 tile
  bf16* tile = reinterpret_cast<bf16*>(smem);
  {
    const int gq = lane >> 2, q = lane & 3;
    const int r0 = wg * 64 + w4 * 16 + gq;
#pragma unroll
    for (int n8 = 0; n8 < N / 8; ++n8)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr)
        *reinterpret_cast<__nv_bfloat162*>(tile + (r0 + 8 * hr) * NP +
                                           n8 * 8 + 2 * q) =
            __floats2bfloat162_rn(acc[n8 * 4 + hr * 2],
                                  acc[n8 * 4 + hr * 2 + 1]);
  }
  __syncthreads();

  // 16-byte units (position, 8 channels): R per position, P positions per
  // pass; a thread keeps one channel group, so its sums stay in registers
  constexpr int R = N / 8;
  const int P = kThreads / R;
  const int cg = tid % R, p0 = tid / R;
  float m1[8], m2[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) m1[e] = m2[e] = 0.f;
  if (p0 < P) {
    float v0[8], v1[8], va[8];
    load8(v0, gm0 + cg * 8);
    load8(v1, gm1 + cg * 8);
    load8(va, ar + cg * 8);
    // kEpi positions per pass, their loads issued before any arithmetic
    for (int q0 = p0; q0 < kPos; q0 += kEpi * P) {
      uint4 in[kEpi][4];
      size_t idx[kEpi];
      bool live[kEpi];
#pragma unroll
      for (int u = 0; u < kEpi; ++u) {
        const int q = q0 + u * P;
        const int f = f0 + (q >> p.tt_log2), t = t0 + (q & (p.TT - 1));
        live[u] = q < kPos && f < F && t < T;
        idx[u] = bbase + ((size_t)f * T + t) * C + cg * 8;
        if (live[u]) {
          in[u][0] = *reinterpret_cast<const uint4*>(g.gy + idx[u]);
          in[u][1] = *reinterpret_cast<const uint4*>(g.y + idx[u]);
          in[u][2] = *reinterpret_cast<const uint4*>(g.x + idx[u]);
          in[u][3] = *reinterpret_cast<const uint4*>(g.c + idx[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < kEpi; ++u) {
        if (!live[u]) continue;
        __align__(16) bf16 crv[8], dxv[8];
        *reinterpret_cast<uint4*>(crv) = *reinterpret_cast<const uint4*>(
            tile + (q0 + u * P) * NP + cg * 8);
        const bf16* gyv = reinterpret_cast<const bf16*>(&in[u][0]);
        const bf16* yv = reinterpret_cast<const bf16*>(&in[u][1]);
        const bf16* xv = reinterpret_cast<const bf16*>(&in[u][2]);
        const bf16* cv = reinterpret_cast<const bf16*>(&in[u][3]);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float r = Elem<bf16>::round(
              v0[e] + 2.0f * __bfloat162float(yv[e]) * v1[e]);
          const float gp = Elem<bf16>::round(
              Elem<bf16>::round(__bfloat162float(gyv[e]) + r) * kInvSq2);
          const float xf = __bfloat162float(xv[e]), ab = va[e];
          const float du = Elem<bf16>::round(
              __bfloat162float(crv[e]) *
              gelu_poly_deriv(Elem<bf16>::round(xf * ab)));
          dxv[e] = __float2bfloat16(
              Elem<bf16>::round(gp + Elem<bf16>::round(du * ab)));
          m1[e] = fmaf(gp, __bfloat162float(cv[e]), m1[e]);
          m2[e] = fmaf(du, xf, m2[e]);
        }
        *reinterpret_cast<uint4*>(g.dx + idx[u]) =
            *reinterpret_cast<const uint4*>(dxv);
      }
    }
  }
  // lanes R, 2R, ... apart hold the same channels when R divides 32
  if (32 % R == 0) {
#pragma unroll
    for (int off = R; off < 32; off <<= 1)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        m1[e] += __shfl_xor_sync(0xffffffffu, m1[e], off);
        m2[e] += __shfl_xor_sync(0xffffffffu, m2[e], off);
      }
  }
  if (p0 < P && (32 % R != 0 || lane < R)) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      atomicAdd(&red[cg * 8 + e], m1[e]);
      atomicAdd(&red[N + cg * 8 + e], m2[e]);
    }
  }
  __syncthreads();
  for (int n = tid; n < N; n += kThreads) {
    atomicAdd(g.dsda + (size_t)b * C + n, red[n]);
    atomicAdd(g.dsda + ((size_t)p.B + b) * C + n, red[N + n]);
  }
}

template <int N>
int launch_one(const StagePlan& p, const StageArgs& g, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(stage_bwd_sm90<N>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  stage_bwd_sm90<N><<<dim3(p.gx, p.gy, p.gz), kThreads, p.smem, st>>>(p, g);
  return (int)cudaGetLastError();
}

// the engine's channel counts: multiples of 32 in 64..256
inline int launch_stage_bwd(const StagePlan& p, const StageArgs& g,
                            cudaStream_t st) {
  switch (p.C) {
    case 64: return launch_one<64>(p, g, st);
    case 96: return launch_one<96>(p, g, st);
    case 128: return launch_one<128>(p, g, st);
    case 160: return launch_one<160>(p, g, st);
    case 192: return launch_one<192>(p, g, st);
    case 224: return launch_one<224>(p, g, st);
    case 256: return launch_one<256>(p, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace sm90
}  // namespace babe
