// The stage engine on Hopper: the (5,3) conv at dilation (d,1) of one
// ResnetBlock dilation stage on sm_90a warpgroup tensor cores (wgmma) fed
// by a cp.async ring, with the stage's elementwise chain in an epilogue
// through shared memory.  Three modes share the main loop; each reads a
// conv input that an elementwise operand pass formed once per element:
//
//   kModeFwd  K2's forward (bf16), input h = gelu(x*a) (fused_stage.cu,
//             babe_stage_fwd_operand):
//               c   = round(conv5x3_d(h, w))         written if asked
//               y   = round(round(x + round(c * s)) / sqrt2)
//               mom = per-(B, C) [sum y, sum y^2]    fp32
//   kModeBwd  K2's backward (bf16), input g_pre * s (conv_dw.cu,
//             babe_stage_dw_operands), the kernel flipped and io-swapped:
//               g_pre = round(round(g_y + round(g_m0 + 2 y g_m1)) / sqrt2)
//               dh    = conv5x3_d(g_pre * s, w flipped, in/out swapped)
//               du    = round(round(dh) * gelu'(round(x * round(a))))
//               dx    = round(g_pre + round(du * round(a)))
//               ds    = sum g_pre * c,  da = sum du * x       per (B, C)
//   kModeI8   K3 (int8 products, bf16 x), input q = int8(gelu6(x*a) *
//             127/bound) (fused_stage_int8.cu, babe_stage_int8_operand):
//               acc = conv5x3_d(q, qw)               int32
//               y3  = x * (1/sqrt2) + float(acc) * post   fp32; y = bf16(y3)
//               mom = per-(B, C) [sum y3, sum y3^2, max |y3|]
//
// Replaces the TPU kernels babe_tpu/ops/conv_kernels.py::_build_fused_call
// (K2, oracle _dil_stage_ref), the backward of its custom vjp (_fused_bwd,
// XLA on the TPU) and _build_fused_int8_call (K3, oracle
// _dil_stage_int8_ref); plain versions in ops/conv_kernels.py
// (_dil_stage_parts, dil_stage_bwd_ref, _int8_stage_parts).  Each rounds
// every intermediate in the reference's order; y, c and q agree with the
// plain versions bit for bit apart from the conv's summation order (K3's
// int32 sums are exact, so its y does too).  The fp32 and odd shapes stay
// on the tiles of conv5x3_mma.cuh (K2) and fused_stage_int8.cu (K3).
//
// Why an operand pass: recomputed for every kernel row inside the engine,
// a gelu or a cotangent fold cost more than the products (PERF.md, section 6);
// one pass per element reads x once and writes the conv input once.
//
// The cut (kernels.stage_plan, passed in as StagePlan): a block owns two
// warpgroups x 64 output positions (TF rows of F x TT columns of T, TT a
// power of two) and NT = C / splits output channels, so no staged element
// is read for more than `splits` channel tiles.  The contraction walks
// n_it = 5 * C * elem / 32 ring stages, channel chunk outer, kf inner; a
// stage holds one kf's halo window (TF rows x TT+2 columns x 32 bytes of
// channels: 16 bf16 or 32 int8) of the input and the three kt taps'
// weights for the block's output channels.  A ring of kStages stages is
// filled by 16-byte cp.async (halo and padding rows zero-filled by the
// copy): while stage k's products run (and stage k-1's may still), the
// copies of stages k+1 .. k+3 are in flight.
//
// Products: one wgmma.mma_async of the full width NT per tap (wgmma_rs.cuh;
// m64nNTk16 bf16 with fp32 accumulate, or m64nNTk32 s8 with int32
// accumulate).  A comes from registers, loaded from the staged window by
// ldmatrix: a kt shift moves the im2col row by one position, which a
// shared-memory A descriptor (8-row core matrices) cannot express, while
// each lane of ldmatrix names its own row.  B is the weights, read by a
// matrix descriptor from the no-swizzle K-major canonical layout [kt][n/8]
// [k half][8 n][16 bytes] that the launcher packs in one permute
// (kernels.stage_fwd_weights, stage_bwd_weights, stage_int8_weights); the
// backward's flip is the kernel's reading of its pack at 4-kf and 2-kt.
// LBO (k direction) 128 bytes, SBO (n direction) 256.  In bytes the bf16
// and int8 forms stage, load and describe the same fragments (a 32-byte k
// step, 16-byte halves), so one loop serves both.
//
// Epilogue: the accumulators go through shared memory (bf16 c, or fp32
// float(acc) for K3), so every read of x (and of the backward's g_y, y,
// c) and every write of y, c and dx is 16 bytes along C; the per-channel
// sums reduce by warp shuffles, shared-memory atomics, then one global
// fp32 atomic per (b, channel) and block (last bits vary run to run); K3's
// max by atomicMax on the bits of the non-negative fp32.
//
// Bound on the H100: 2*15*C^2 products per position against 3 (forward,
// K3: x, y, the operand) or 5 (backward) tensors of C moved: bytes at C =
// 64 and 96 in bf16, the tensor-core rate from C = 128 (int8 runs twice
// the bf16 rate on half the operand bytes).
#pragma once

#include <string.h>

#include <type_traits>

#include "conv5x3_tile.cuh"
#include "sm90_frag.cuh"
#include "wgmma_rs.cuh"

namespace babe {
namespace sm90 {

using bf16 = __nv_bfloat16;
constexpr int kModeFwd = 0, kModeBwd = 1, kModeI8 = 2;
constexpr int kKB = 32;        // contraction bytes per ring stage (a k-step)
constexpr int kPxB = 48;       // bytes per staged window pixel (32 + pad)
constexpr int kStages = 5;     // the cp.async ring
constexpr int kLead = kStages - 2;  // stages in flight ahead of the products
constexpr int kMaxUnits = 2;   // 16-byte window units per thread
constexpr int kThreads = 256;  // two warpgroups
constexpr int kPos = 128;      // output positions per block, 64 per warpgroup

// The cut of one call, made by the host (kernels.stage_plan): these
// fields, all ints, in this order.
struct StagePlan {
  int route, mode, B, F, T, C, d, splits;
  int tt_log2, TT, TF, n_it, ring_bytes, stage_bytes, win_bytes, smem, gx,
      gy, gz;
};

// Every mode's tensors ((B, F, T, C) unless said); a mode reads only its
// own.
struct StageArgs {
  const void* src;    // the conv's input: h (kModeFwd), g_pre * s
                      // (kModeBwd), q int8 (kModeI8)
  const void* wpk;    // the packed weights
  const bf16* x;      // the stage's input
  const float* v0;    // (B, C): s (kModeFwd), g_m0 (kModeBwd), post
                      // (kModeI8)
  const float* v1;    // (B, C): kModeBwd g_m1
  const float* v2;    // (B, C): kModeBwd a
  const bf16* gy;     // kModeBwd: the cotangent of y
  const bf16* y;      // kModeBwd: the stage's output
  const bf16* c;      // kModeBwd: the stage's conv output
  bf16* out;          // y (kModeFwd, kModeI8), dx (kModeBwd)
  bf16* c_out;        // kModeFwd: the rounded conv output, or null
  float* sums;        // zeroed by the caller: kModeFwd [sum y, sum y^2]
                      // (2, B, C), kModeBwd [ds, da] (2, B, C), kModeI8
                      // [sum y3, sum y3^2, max |y3|] (3, B, C)
};

// no-swizzle K-major matrix descriptor: start address, LBO (between the
// two 16-byte k halves) and SBO (between 8-row n groups), in 16-byte units
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
template <int K>
__device__ __forceinline__ void fence_acc(int32_t (&d)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

template <int NT>
__device__ __forceinline__ void mma(float (&d)[NT / 2],
                                    const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs<NT>(d, a, b);
}
template <int NT>
__device__ __forceinline__ void mma(int32_t (&d)[NT / 2],
                                    const uint32_t (&a)[4], uint64_t b) {
  wgmma_rs_s8<NT>(d, a, b);
}

// K2 divides a bf16 value by sqrt2 rounded to bf16 (1.4140625) and rounds
// to bf16.  Multiplying by the fp32 reciprocal of 1.4140625 gives the same
// bf16 for every finite bf16 input (checked exhaustively by
// tests/test_torch_stage_engine.py) at a fraction of a division's cost.
constexpr float kInvSq2 = 0.70718234777450562f;
// K3's fp32 1/sqrt2, the plain version's float(0.7071067811865475)
constexpr float kI8InvSq2 = 0.7071067811865475f;

__device__ __forceinline__ void load8(float (&v)[8], const float* src) {
  *reinterpret_cast<float4*>(v) = *reinterpret_cast<const float4*>(src);
  *reinterpret_cast<float4*>(v + 4) =
      *reinterpret_cast<const float4*>(src + 4);
}

// One thread's share of a stage's window: unit k is 16 bytes of one pixel
// (px = u / 2, half u % 2) of the TF x TW window.
struct Units {
  int n;                 // units this thread owns
  int dst[kMaxUnits];    // byte offset in a window buffer
  int fb[kMaxUnits];     // the pixel's output row f0 + fr
  int t[kMaxUnits];      // its column t0 - 1 + col, -1 when outside [0, T)
  int ch[kMaxUnits];     // its byte offset in the chunk (0 or 16)
};

// Up to 128 channels a tile, two blocks share an SM (their rings fit its
// shared memory): the register budget of 128 a thread keeps them so.
template <int NT, int MODE>
__global__ void __launch_bounds__(256, NT <= 128 ? 2 : 1)
    stage_sm90(const StagePlan p, const StageArgs g) {
  using Acc = typename std::conditional<MODE == kModeI8, int32_t,
                                        float>::type;
  constexpr bool kFlip = MODE == kModeBwd;
  constexpr int kElem = MODE == kModeI8 ? 1 : 2;  // bytes per value
  constexpr int kSums = MODE == kModeI8 ? 3 : 2;
  // epilogue positions per thread with their loads in flight: the
  // backward reads four tensors a position, so 4 only at the widest
  // stages, where the accumulators' registers are free by then (measured
  // on an H100: 2 and 4 slowed its C = 64..128); the forward modes read
  // one
  constexpr int kEpi = MODE == kModeBwd ? (NT >= 192 ? 4 : 1) : 4;
  extern __shared__ __align__(128) unsigned char smem_sm90[];
  unsigned char* smem = smem_sm90;
  // [ring: kStages x (W | G)] [v0 v1 v2: NT floats each] [sums: 3 NT]
  float* vec = reinterpret_cast<float*>(smem + p.ring_bytes);
  float* red = vec + 3 * NT;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2, w4 = warp & 3;
  const int b = blockIdx.z / p.splits, n0 = (blockIdx.z % p.splits) * NT;
  const int t0 = blockIdx.x * p.TT, f0 = blockIdx.y * p.TF;
  const int TW = p.TT + 2, C = p.C, F = p.F, T = p.T, d = p.d;
  const int nch = C * kElem / kKB;
  const size_t bbase = (size_t)b * F * T * C;  // in values
  const uint32_t sbase = smem_u32(smem);
  const unsigned char* src = static_cast<const unsigned char*>(g.src);
  const unsigned char* wpk = static_cast<const unsigned char*>(g.wpk);

  for (int n = tid; n < NT; n += kThreads) {
    const int bc = b * C + n0 + n;
    if (MODE == kModeBwd) {
      vec[n] = g.v0[bc];
      vec[NT + n] = g.v1[bc];
      vec[2 * NT + n] = Elem<bf16>::round(g.v2[bc]);
    } else {
      vec[n] = MODE == kModeFwd ? Elem<bf16>::round(g.v0[bc]) : g.v0[bc];
    }
#pragma unroll
    for (int k = 0; k < kSums; ++k) red[k * NT + n] = 0.f;
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
      un.dst[k] = px * kPxB + (u & 1) * 16;
      un.fb[k] = f0 + fr;
      un.t[k] = (t >= 0 && t < T) ? t : -1;
      un.ch[k] = (u & 1) * 16;
      un.n = k + 1;
    }
  }

  // stage it -> ring slot: kf's window of the input and the three taps'
  // weights of the block's NT output channels
  auto issue = [&](int it) {
    const int chunk = it / 5, kf = it - chunk * 5, slot = it % kStages;
    const uint32_t sw = sbase + slot * p.stage_bytes;
    const uint32_t sg = sw + 3 * NT * kKB;
    const unsigned char* wsrc =
        wpk + (size_t)((kFlip ? 4 - kf : kf) * nch + chunk) * 3 * C * kKB +
        (size_t)n0 * kKB;
    for (int u = tid; u < 6 * NT; u += kThreads) {
      const int kt = u / (2 * NT), r = u - kt * 2 * NT;
      cp16(sw + u * 16, wsrc + (size_t)kt * C * kKB + r * 16, true);
    }
#pragma unroll
    for (int k = 0; k < kMaxUnits; ++k) {
      if (k < un.n) {
        const int f = un.fb[k] + (kf - 2) * d;
        const bool inb = un.t[k] >= 0 && f >= 0 && f < F && un.fb[k] < F;
        const size_t off =
            inb ? (bbase + ((size_t)f * T + un.t[k]) * C) * kElem +
                      chunk * kKB + un.ch[k]
                : 0;
        cp16(sg + un.dst[k], src + off, inb);
      }
    }
  };

  Acc acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0;

  // this lane's ldmatrix row: position wg*64 + w4*16 + (lane & 15), its
  // 16-byte k half lane >> 4; byte offset in a window buffer at kt = 0
  const int pos = wg * 64 + w4 * 16 + (lane & 15);
  const int a_off = ((pos >> p.tt_log2) * TW + (pos & (p.TT - 1))) * kPxB +
                    (lane >> 4) * 16;

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
  // still reports doing so at NT <= 128, for a reason not found yet)
  auto step = [&](int it, Operands& cur, Operands& prev) {
    cp_wait<kLead - 1>();  // this thread's copies of stage it
    fence_async_shared();
    __syncthreads();  // everyone's; stage it-2's products are done
    if (it + kLead < p.n_it) issue(it + kLead);
    cp_commit();
    const uint32_t sw = sbase + (it % kStages) * p.stage_bytes;
    const uint32_t sg = sw + 3 * NT * kKB;
#pragma unroll
    for (int kt = 0; kt < 3; ++kt) {
      ldsm_x4(cur.a[kt], sg + a_off + kt * kPxB);
      cur.b[kt] = desc_b(sw + (kFlip ? 2 - kt : kt) * NT * kKB);
    }
    hold(cur);  // defined before the products start
    fence_acc(acc);
    wg_fence();
#pragma unroll
    for (int kt = 0; kt < 3; ++kt) mma<NT>(acc, cur.a[kt], cur.b[kt]);
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

  // accumulator register n8*4 + hr*2 + e: warp row gq + 8hr, column
  // 8 n8 + 2q + e -> the tile, bf16 (rounded) or, for K3, fp32
  constexpr int NP = MODE == kModeI8 ? NT + 4 : NT + 8;  // values per row
  bf16* tile = reinterpret_cast<bf16*>(smem);
  float* ftile = reinterpret_cast<float*>(smem);
  {
    const int gq = lane >> 2, q = lane & 3;
    const int r0 = wg * 64 + w4 * 16 + gq;
#pragma unroll
    for (int n8 = 0; n8 < NT / 8; ++n8)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int o = (r0 + 8 * hr) * NP + n8 * 8 + 2 * q;
        if constexpr (MODE == kModeI8) {
          *reinterpret_cast<float2*>(ftile + o) =
              make_float2(__int2float_rn(acc[n8 * 4 + hr * 2]),
                          __int2float_rn(acc[n8 * 4 + hr * 2 + 1]));
        } else {
          *reinterpret_cast<__nv_bfloat162*>(tile + o) =
              __floats2bfloat162_rn(acc[n8 * 4 + hr * 2],
                                    acc[n8 * 4 + hr * 2 + 1]);
        }
      }
  }
  __syncthreads();

  // 16-byte units (position, 8 channels): R per position, P positions per
  // pass; a thread keeps one channel group, so its sums stay in registers
  constexpr int R = NT / 8;
  const int P = kThreads / R;
  const int cg = tid % R, p0 = tid / R;
  float m[kSums][8];
#pragma unroll
  for (int k = 0; k < kSums; ++k)
#pragma unroll
    for (int e = 0; e < 8; ++e) m[k][e] = 0.f;
  if (p0 < P) {
    float v0[8], v1[8], v2[8];
    load8(v0, vec + cg * 8);
    if (MODE == kModeBwd) {
      load8(v1, vec + NT + cg * 8);
      load8(v2, vec + 2 * NT + cg * 8);
    }
    constexpr int kIn = MODE == kModeBwd ? 4 : 1;  // tensors read
    // kEpi positions per pass, their loads issued before any arithmetic
    for (int q0 = p0; q0 < kPos; q0 += kEpi * P) {
      uint4 in[kEpi][kIn];
      size_t idx[kEpi];
      bool live[kEpi];
#pragma unroll
      for (int u = 0; u < kEpi; ++u) {
        const int q = q0 + u * P;
        const int f = f0 + (q >> p.tt_log2), t = t0 + (q & (p.TT - 1));
        live[u] = q < kPos && f < F && t < T;
        idx[u] = bbase + ((size_t)f * T + t) * C + n0 + cg * 8;
        if (live[u]) {
          in[u][0] = *reinterpret_cast<const uint4*>(g.x + idx[u]);
          if constexpr (MODE == kModeBwd) {
            in[u][1] = *reinterpret_cast<const uint4*>(g.gy + idx[u]);
            in[u][2] = *reinterpret_cast<const uint4*>(g.y + idx[u]);
            in[u][3] = *reinterpret_cast<const uint4*>(g.c + idx[u]);
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kEpi; ++u) {
        if (!live[u]) continue;
        const int row = (q0 + u * P) * NP + cg * 8;
        const bf16* xv = reinterpret_cast<const bf16*>(&in[u][0]);
        __align__(16) bf16 ov[8];
        if constexpr (MODE == kModeI8) {
          float av[8];
          load8(av, ftile + row);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float y3 = __fadd_rn(
                __fmul_rn(__bfloat162float(xv[e]), kI8InvSq2),
                __fmul_rn(av[e], v0[e]));
            ov[e] = __float2bfloat16(y3);
            m[0][e] += y3;
            m[1][e] = fmaf(y3, y3, m[1][e]);
            m[2][e] = fmaxf(m[2][e], fabsf(y3));
          }
        } else {
          __align__(16) bf16 crv[8];
          *reinterpret_cast<uint4*>(crv) =
              *reinterpret_cast<const uint4*>(tile + row);
          if constexpr (MODE == kModeFwd) {
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float t1 =
                  Elem<bf16>::round(__bfloat162float(crv[e]) * v0[e]);
              const float yv = Elem<bf16>::round(
                  Elem<bf16>::round(__bfloat162float(xv[e]) + t1) *
                  kInvSq2);
              ov[e] = __float2bfloat16(yv);
              m[0][e] += yv;
              m[1][e] = fmaf(yv, yv, m[1][e]);
            }
            if (g.c_out != nullptr)
              *reinterpret_cast<uint4*>(g.c_out + idx[u]) =
                  *reinterpret_cast<const uint4*>(crv);
          } else {
            const bf16* gyv = reinterpret_cast<const bf16*>(&in[u][1]);
            const bf16* yv = reinterpret_cast<const bf16*>(&in[u][2]);
            const bf16* cv = reinterpret_cast<const bf16*>(&in[u][3]);
#pragma unroll
            for (int e = 0; e < 8; ++e) {
              const float r = Elem<bf16>::round(
                  v0[e] + 2.0f * __bfloat162float(yv[e]) * v1[e]);
              const float gp = Elem<bf16>::round(
                  Elem<bf16>::round(__bfloat162float(gyv[e]) + r) *
                  kInvSq2);
              const float xf = __bfloat162float(xv[e]), ab = v2[e];
              const float du = Elem<bf16>::round(
                  __bfloat162float(crv[e]) *
                  gelu_poly_deriv(Elem<bf16>::round(xf * ab)));
              ov[e] = __float2bfloat16(
                  Elem<bf16>::round(gp + Elem<bf16>::round(du * ab)));
              m[0][e] = fmaf(gp, __bfloat162float(cv[e]), m[0][e]);
              m[1][e] = fmaf(du, xf, m[1][e]);
            }
          }
        }
        *reinterpret_cast<uint4*>(g.out + idx[u]) =
            *reinterpret_cast<const uint4*>(ov);
      }
    }
  }
  // lanes R, 2R, ... apart hold the same channels when R divides 32; the
  // last of K3's sums is a max of non-negative values
  if (32 % R == 0) {
#pragma unroll
    for (int off = R; off < 32; off <<= 1)
#pragma unroll
      for (int k = 0; k < kSums; ++k)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float o = __shfl_xor_sync(0xffffffffu, m[k][e], off);
          m[k][e] = k == 2 ? fmaxf(m[k][e], o) : m[k][e] + o;
        }
  }
  if (p0 < P && (32 % R != 0 || lane < R)) {
#pragma unroll
    for (int k = 0; k < kSums; ++k)
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float* dst = &red[k * NT + cg * 8 + e];
        if (k == 2)  // non-negative floats order as their bit patterns do
          atomicMax(reinterpret_cast<int*>(dst), __float_as_int(m[k][e]));
        else
          atomicAdd(dst, m[k][e]);
      }
  }
  __syncthreads();
  for (int n = tid; n < NT; n += kThreads) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) {
      float* dst = g.sums + ((size_t)k * p.B + b) * C + n0 + n;
      if (k == 2)
        atomicMax(reinterpret_cast<int*>(dst),
                  __float_as_int(red[2 * NT + n]));
      else
        atomicAdd(dst, red[k * NT + n]);
    }
  }
}

template <int NT, int MODE>
int launch_one(const StagePlan& p, const StageArgs& g, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t err =
        cudaFuncSetAttribute(stage_sm90<NT, MODE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  stage_sm90<NT, MODE><<<dim3(p.gx, p.gy, p.gz), kThreads, p.smem, st>>>(p,
                                                                        g);
  return (int)cudaGetLastError();
}

// The engine's channel tiles NT = C / splits: multiples of 32 in 64..256
// (96..256 for K3, whose route starts at 96 channels).  The caller has
// checked the plan against its tensors.
template <int MODE>
int launch_stage(const StagePlan& p, const StageArgs& g, cudaStream_t st) {
  if (p.mode != MODE || p.splits < 1 || p.C % p.splits != 0)
    return (int)cudaErrorInvalidValue;
  if (p.B <= 0 || p.F <= 0 || p.T <= 0) return 0;
  switch (p.C / p.splits) {
    case 64:
      if constexpr (MODE != kModeI8) return launch_one<64, MODE>(p, g, st);
      break;
    case 96: return launch_one<96, MODE>(p, g, st);
    case 128: return launch_one<128, MODE>(p, g, st);
    case 160: return launch_one<160, MODE>(p, g, st);
    case 192: return launch_one<192, MODE>(p, g, st);
    case 224: return launch_one<224, MODE>(p, g, st);
    case 256: return launch_one<256, MODE>(p, g, st);
  }
  return (int)cudaErrorInvalidValue;
}

// The plan from the launcher's int array, checked against the call's
// shape; false when it does not match.
inline bool read_plan(StagePlan& plan, const int* meta, int n_meta, int B,
                      int F, int T, int C, int d) {
  if (n_meta != (int)(sizeof(StagePlan) / sizeof(int))) return false;
  memcpy(&plan, meta, sizeof(plan));
  return plan.route == 0 || (plan.B == B && plan.F == F && plan.T == T &&
                             plan.C == C && plan.d == d);
}

}  // namespace sm90
}  // namespace babe
