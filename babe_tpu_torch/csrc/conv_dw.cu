// The weight gradient of a 'SAME' channels-last conv, and the operands of
// one K2 stage's weight gradient.
//
//   babe_conv_dw: dW[i,j,c,n] += sum_{b,f,t} X[b, f+(i-PF)df, t+(j-PT)dt, c]
//                                            * G[b,f,t,n]
//     with X the conv's input, G the cotangent of its output, PF = (KF-1)/2,
//     PT = (KT-1)/2 and zero padding.  It serves K1's dw (the pyramid convs:
//     KF, KT = 5, 3, dt = 1), K4's (any odd KF, KT up to 7, both dilations)
//     and, as the second of its two launches, K2's (`fused_stage_dw`).
//   babe_stage_dw_operands: the first launch of `fused_stage_dw`, an
//     elementwise pass that writes K2's conv input h = gelu(x*a) and the
//     conv output's cotangent G' = g_pre*s, with g_pre = (g_y + g_mom[0] +
//     2*y*g_mom[1]) / sqrt2, both in x's type and rounded step by step in
//     K2's order (x_value, g_value: the prologues of K2 and of its
//     backward, stage_gpre in conv5x3_tile.cuh).
//
// Replaces the weight half of the TPU kernels' custom vjps, which the JAX
// package leaves to XLA: babe_tpu/ops/conv_kernels.py:600-607 (K1's
// linear_transpose of conv_xla in w), :1090-1097 (K2, jax.vjp of
// _dil_stage_ref in w4) and babe_tpu/ops/pallas_conv.py:123-131 (K4).
//
// A GEMM of (KF*KT*C) x N whose reduction runs over all B*F*T positions.
// Operation-bound at the stage widths (2*KF*KT*C*N flops per position
// against 2*(C+N) bytes; the 75 stages of a flagship training step carry
// 7.8 TFLOP, 7.9 ms at the bf16 peak); bytes-bound for the 2-channel
// pyramid convs (0.07 ms of bytes per step).  The host (kernels/__init__.py
// dw_plan) cuts the work and passes the cut as a table: every tile, chunk
// and split is decided there, where the CPU tests can check that each
// (position, i, j, c, n) term is summed exactly once.  The blocks split the
// positions, as many per tile as fill the card's resident blocks (the host
// asks the occupancy calculator, babe_dw_slots) with a nearly full last
// wave; each adds its fp32 partial into the zeroed dW with one atomic per
// element, so dW's last bits vary from run to run.  Three routes:
//
//   kMma (bf16, C and N >= 16 and multiples of 8): tensor cores.  A block
//     owns one kernel row i, up to 3 taps j, a tile of bm input channels
//     (128, 96, 64 or 32, whichever divides C) and bn output channels, and
//     walks its share of row i's chunks.  A chunk is pp <= 128 positions at
//     one b: one run of 128 t of one f row, or nf whole rows when T < 128
//     (T = 32: four rows), each row with its own t halo.  Chunks are made
//     only of rows f whose X row f + (i-PF)df lies in [0, F): the rest
//     would multiply zeros.  Both operands are staged as they lie in memory,
//     [position][channel], by 16-byte cp.async into a ring of 3 stages (the
//     t halo and ragged channel tails zero-filled by the copy), so copies of
//     the next two chunks overlap the products of this one; the staging
//     steps without divisions and the chunk descriptors are fetched an
//     iteration ahead, so the loop issues copies, ldmatrix and mma only.
//     Fragments come from ldmatrix.x4.trans: a lane points at one
//     position's 8 channels, so a tap shift of j*dt positions only moves its
//     row pointer, always 16-byte aligned; rows are padded by 16 bytes so
//     the 8 rows of one matrix fall in distinct banks.  mma.sync m16n8k16, a
//     32 x 32 warp tile per tap, all taps of the block reusing one B
//     fragment.  On an H100 SXM (700 W) it reaches about a sixth of the
//     bf16 peak over a training step's stages; wgmma is the way to more.
//   kSimt (fp32 wide, and any other dtype or channel count): the same cut
//     on CUDA cores, 64 x 64 channels by all KT taps per block, a 4 x 4
//     tile per thread and tap.
//   kFold (min(C, N) < 16: the pyramid convs, C = 2, and their transposed
//     shapes, N = 2): the taps fold into the narrow side, R = KF*KT*Cn rows
//     (30 for the pyramid).  A thread owns one channel of the wide side and
//     32 folded rows: it reads the wide operand once, coalesced, and the
//     narrow operand's 32 values per position from a shared window that the
//     block gathers with the shifts of its rows; a chunk's loads are in
//     flight while the chunk before is multiplied.  With N narrow the shift
//     moves to G: dW[(i,j),c,n] = sum_q X[q,c] G[q - shift(i,j), n].  It is
//     bound by latency, not bytes: about 10x its bytes bound on an H100.
#include <string.h>

#include <algorithm>

#include "conv5x3_tile.cuh"
#include "mma_frag.cuh"

namespace babe {
namespace cdw {

using bf16 = __nv_bfloat16;
constexpr int kMaxSmem = 232448;  // what one block may use on sm_90
constexpr int kMma = 0, kSimt = 1, kFold = 2;
constexpr int kHeader = 8;        // ints before the chunk table (KF + 1 used)
constexpr int kStages = 3;        // cp.async ring of the tensor-core route
constexpr int kMaxWarps = 9;      // 96 x 96 channels of 32 x 32 warp tiles
constexpr int kSimtThreads = 256;
constexpr int kSimtTile = 64;     // channels per simt tile (both sides)
constexpr int kMaxKs = 8;         // k-steps of 16 positions per chunk
constexpr int kFoldRows = 32;     // folded rows per fold block
constexpr int kFoldWide = 64;     // wide channels per fold block
constexpr int kFoldLanes = 4;     // position lanes per fold block
constexpr int kFoldChunk = 64;    // positions per fold chunk
constexpr int kFoldStride = kFoldRows + 4;  // floats per staged position

// The cut of one weight gradient, made by the host (kernels.dw_plan): the
// fields in this order, all ints.
struct Plan {
  int route, B, F, T, C, N, KF, KT, df, dt;
  int bm, bn, c_tiles, n_tiles, taps, tap_groups;  // kMma, kSimt tiles
  int tl, nf, pp, xw;  // t per chunk row, rows per chunk, positions, X cols
  int splits;          // blocks along the positions
  int narrow_x, wide, groups, wide_tiles, n_chunks;  // kFold
  int smem, threads, tiles;  // launch: shared bytes, block size, grid.y
};

// ------------------------------------------------------- operand pass

// K2's conv input at element e = (b, f, t, c): gelu(x*a) rounded to T in
// K2's order
template <typename T>
__device__ __forceinline__ float x_value(float xv, const float* a, int b,
                                         int C, int c) {
  const float ab = Elem<T>::round(a[b * C + c]);
  return Elem<T>::round(gelu_poly(Elem<T>::round(xv * ab)));
}

// the cotangent of K2's conv output: the moments' cotangent folded into
// y's, divided by sqrt2 and gated, each step rounded to T as K2's backward
// prologue (stage_gpre) does
template <typename T>
__device__ __forceinline__ float g_value(float gy, float yv, const float* s,
                                         const float* gmom, int B, int b,
                                         int C, int c, float sq2) {
  const float r = Elem<T>::round(gmom[b * C + c] +
                                 2.0f * yv * gmom[(B + b) * C + c]);
  const float gp = Elem<T>::round(Elem<T>::round(gy + r) / sq2);
  return Elem<T>::round(gp * Elem<T>::round(s[b * C + c]));
}

// VEC consecutive elements per step (16 bytes when C allows, else 1)
template <typename T, int VEC>
__global__ void __launch_bounds__(256) stage_operands(
    const T* __restrict__ x, const float* __restrict__ a,
    const float* __restrict__ s, const T* __restrict__ y,
    const T* __restrict__ gy, const float* __restrict__ gmom,
    T* __restrict__ h, T* __restrict__ gc, int B, int FT, int C, size_t n) {
  const float sq2 = Elem<T>::round(1.41421356237309515f);
  const size_t per_b = (size_t)FT * C;
  for (size_t e = ((size_t)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
       e < n; e += (size_t)gridDim.x * blockDim.x * VEC) {
    const int b = (int)(e / per_b), c0 = (int)(e % C);
    __align__(16) T xv[VEC], yv[VEC], gv[VEC], hv[VEC], cv[VEC];
    if (VEC > 1) {
      *reinterpret_cast<uint4*>(xv) = *reinterpret_cast<const uint4*>(x + e);
      *reinterpret_cast<uint4*>(yv) = *reinterpret_cast<const uint4*>(y + e);
      *reinterpret_cast<uint4*>(gv) = *reinterpret_cast<const uint4*>(gy + e);
    } else {
      xv[0] = x[e];
      yv[0] = y[e];
      gv[0] = gy[e];
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      Elem<T>::store(hv + k,
                     x_value<T>(Elem<T>::load(xv + k), a, b, C, c0 + k));
      Elem<T>::store(cv + k,
                     g_value<T>(Elem<T>::load(gv + k), Elem<T>::load(yv + k),
                                s, gmom, B, b, C, c0 + k, sq2));
    }
    if (VEC > 1) {
      *reinterpret_cast<uint4*>(h + e) = *reinterpret_cast<uint4*>(hv);
      *reinterpret_cast<uint4*>(gc + e) = *reinterpret_cast<uint4*>(cv);
    } else {
      h[e] = hv[0];
      gc[e] = cv[0];
    }
  }
}

// --------------------------------------------------- tensor-core route

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, or 16 zero bytes when !valid
__device__ __forceinline__ void cp16(uint32_t dst, const void* src,
                                     bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 bf16 matrices, transposed: lanes 8m..8m+7 give matrix m's rows
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The block's tile from blockIdx.y: n tile fastest, then c tile, tap group,
// kernel row.
__device__ __forceinline__ void tile_at(const Plan& p, int& i, int& j0,
                                        int& c0, int& n0) {
  int tile = blockIdx.y;
  n0 = (tile % p.n_tiles) * p.bn;
  tile /= p.n_tiles;
  c0 = (tile % p.c_tiles) * p.bm;
  tile /= p.c_tiles;
  j0 = (tile % p.tap_groups) * p.taps;
  i = tile / p.tap_groups;
}

// Shared memory per stage: the X window, nf rows of xw positions (row r's
// position u is t = t0 - PT*dt + u), each position XS = 2*bm + 16 bytes;
// then pp positions of G, GS = 2*bn + 16 bytes each.  After the ring, one
// zero X row, read by the padding positions past the chunk's rows, and the
// row count of the chunk in each stage.
//
// Each thread stages one 16-byte channel segment of a fixed set of X
// columns and G positions, stepping through them without divisions; the
// chunk descriptor of the next load is fetched an iteration ahead, and each
// lane's fragment rows are worked out once, so the loop over chunks does
// copies, ldmatrix and mma only.
__global__ void __launch_bounds__(kMaxWarps * 32) dw_mma(
    const Plan p, const bf16* __restrict__ x, const bf16* __restrict__ g,
    float* __restrict__ dw, const int* __restrict__ table) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int XS = 2 * p.bm + 16, GS = 2 * p.bn + 16;
  const int xbytes = p.nf * p.xw * XS;
  const int stage_bytes = xbytes + p.pp * GS;
  unsigned char* zero_row = smem + kStages * stage_bytes;
  int* stage_nf = reinterpret_cast<int*>(zero_row + XS);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % (p.bm / 32), wn = warp / (p.bm / 32);
  int i, j0, c0, n0;
  tile_at(p, i, j0, c0, n0);
  const int nj = min(p.taps, p.KT - j0);
  const int PF = (p.KF - 1) / 2, PT = (p.KT - 1) / 2;
  const int sh = (i - PF) * p.df;
  const int k_first = table[i] + blockIdx.x, k_end = table[i + 1];
  const int n_mine =
      k_end > k_first ? (k_end - k_first + p.splits - 1) / p.splits : 0;
  const int4* chunks = reinterpret_cast<const int4*>(table + kHeader);

  for (int e = tid; e < XS / 16; e += blockDim.x)
    reinterpret_cast<uint4*>(zero_row)[e] = make_uint4(0, 0, 0, 0);

  // staging roles (blockDim = bm*bn/32): X channel segment sgx of columns
  // colx0, colx0 + bn/4, ...; G channel segment sgg of positions posg0,
  // posg0 + bm/4, ...
  const int xseg = p.bm / 8, gseg = p.bn / 8;
  const int sgx = tid % xseg, colx0 = tid / xseg, colstep = p.bn / 4;
  const int sgg = tid % gseg, posg0 = tid / gseg, posstep = p.bm / 4;
  const int cx = c0 + sgx * 8, ng = n0 + sgg * 8;
  const bool cx_ok = cx < p.C, ng_ok = ng < p.N;
  const int rx0 = colx0 / p.xw, ux0 = colx0 % p.xw;
  const int rg0 = posg0 / p.tl, tg0 = posg0 % p.tl;

  // chunk ck = (b, f0, nf, t0) into stage st
  auto load = [&](const int4 ck, int st) {
    unsigned char* xs = smem + st * stage_bytes;
    unsigned char* gs = xs + xbytes;
    if (tid == 0) stage_nf[st] = ck.z;
    const bf16* xb =
        x + ((size_t)ck.x * p.F + ck.y + sh) * p.T * p.C + cx;
    const int tb = ck.w - PT * p.dt, ncol = ck.z * p.xw;
    int r = rx0, u = ux0;
    for (int col = colx0; col < ncol; col += colstep) {
      const int t = tb + u;
      const bool ok = cx_ok && t >= 0 && t < p.T;
      cp16(smem_u32(xs + col * XS + sgx * 16),
           ok ? xb + ((size_t)r * p.T + t) * p.C : x, ok);
      for (u += colstep; u >= p.xw; u -= p.xw) ++r;
    }
    const bf16* gb = g + ((size_t)ck.x * p.F + ck.y) * p.T * p.N + ng;
    r = rg0;
    int tt = tg0;
    for (int pos = posg0; pos < p.pp; pos += posstep) {
      const int t = ck.w + tt;
      const bool ok = ng_ok && r < ck.z && t < p.T;
      cp16(smem_u32(gs + pos * GS + sgg * 16),
           ok ? gb + ((size_t)r * p.T + t) * p.N : g, ok);
      for (tt += posstep; tt >= p.tl; tt -= p.tl) ++r;
    }
  };

  float acc[3][2][4][4];
#pragma unroll
  for (int jj = 0; jj < 3; ++jj)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[jj][mt][nt][e] = 0.f;

  int4 ck_next = n_mine > 0 ? chunks[k_first] : make_int4(0, 0, 0, 0);
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_mine) load(ck_next, s);
    cp_commit();
    if (s + 1 < n_mine) ck_next = chunks[k_first + (s + 1) * p.splits];
  }

  // B[k][n] = G[position k][n]: lane row = position row + 8*(mat&1),
  // channels wn*32 + nn*16 + 8*(mat>>1); registers 0, 1 are n8 tile 2nn's
  // (k 0-7, 8-15), 2, 3 tile 2nn+1's.  A[m][k] = X[position k shifted by
  // tap j][m]: lane row = position row + 8*(mat>>1), channels wm*32 +
  // mt*16 + 8*(mat&1); padding positions (row >= the chunk's rows) read the
  // zero row at every tap.
  const int mat = lane >> 3, row = lane & 7;
  const int b_off = (row + 8 * (mat & 1)) * GS + 2 * (wn * 32 + 8 * (mat >> 1));
  const int a_ch = 2 * (wm * 32 + 8 * (mat & 1));
  int a_r[kMaxKs], a_off[kMaxKs];
#pragma unroll
  for (int ks = 0; ks < kMaxKs; ++ks) {
    const int ap = ks * 16 + row + 8 * (mat >> 1);
    a_r[ks] = ap / p.tl;
    a_off[ks] = (a_r[ks] * p.xw + ap % p.tl + j0 * p.dt) * XS + a_ch;
  }
  const int nks = p.pp / 16, xstep_live = p.dt * XS;

  for (int it = 0; it < n_mine; ++it) {
    cp_wait<kStages - 2>();
    __syncthreads();  // chunk it has landed; chunk it-1's stage is free
    const int nxt = it + kStages - 1;
    if (nxt < n_mine) load(ck_next, nxt % kStages);
    cp_commit();
    if (nxt + 1 < n_mine) ck_next = chunks[k_first + (nxt + 1) * p.splits];
    const int st = it % kStages, nf = stage_nf[st];
    const unsigned char* xs = smem + st * stage_bytes;
    const unsigned char* gs = xs + xbytes;
#pragma unroll
    for (int ks = 0; ks < kMaxKs; ++ks) {
      if (ks < nks) {
        uint32_t bq[2][4];
        const unsigned char* gb = gs + ks * 16 * GS + b_off;
#pragma unroll
        for (int nn = 0; nn < 2; ++nn)
          ldsm_x4_t(bq[nn], smem_u32(gb + 32 * nn));
        const bool live = a_r[ks] < nf;
        const unsigned char* xb = live ? xs + a_off[ks] : zero_row + a_ch;
        const int xstep = live ? xstep_live : 0;
#pragma unroll
        for (int jj = 0; jj < 3; ++jj) {
          if (jj < nj) {
            uint32_t af[2][4];
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
              ldsm_x4_t(af[mt], smem_u32(xb + jj * xstep + 32 * mt));
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int nt = 0; nt < 4; ++nt)
                frag::mma(acc[jj][mt][nt], af[mt], bq[nt >> 1][2 * (nt & 1)],
                          bq[nt >> 1][2 * (nt & 1) + 1]);
          }
        }
      }
    }
  }
  cp_wait<0>();

  // accumulator element e of (jj, mt, nt): input channel
  // wm*32 + mt*16 + g + 8*(e>>1), output channel wn*32 + nt*8 + 2q + (e&1)
  const int g8 = lane >> 2, q = lane & 3;
#pragma unroll
  for (int jj = 0; jj < 3; ++jj) {
    if (jj >= nj) continue;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = c0 + wm * 32 + mt * 16 + g8 + 8 * (e >> 1);
          const int n = n0 + wn * 32 + nt * 8 + 2 * q + (e & 1);
          if (c < p.C && n < p.N)
            atomicAdd(dw + ((size_t)(i * p.KT + j0 + jj) * p.C + c) * p.N + n,
                      acc[jj][mt][nt][e]);
        }
  }
}

// ------------------------------------------------------ CUDA-core route

// X staged as [c][XS] and G as [n][pp + 1] in fp32; X column nf*xw is
// zero (the padding positions read it)
template <typename T, int KT>
__global__ void __launch_bounds__(kSimtThreads) dw_simt(
    const Plan p, const T* __restrict__ x, const T* __restrict__ g,
    float* __restrict__ dw, const int* __restrict__ table) {
  extern __shared__ __align__(16) float fsm[];
  const int zc = p.nf * p.xw, XS = zc + 2, GS = p.pp + 1;
  float* xs = fsm;                   // [kSimtTile][XS]
  float* gs = fsm + kSimtTile * XS;  // [kSimtTile][GS]
  const int tid = threadIdx.x, tn = tid & 15, tc = tid >> 4;
  int i, j0, c0, n0;
  tile_at(p, i, j0, c0, n0);
  const int PF = (p.KF - 1) / 2, PT = (KT - 1) / 2;
  const int sh = (i - PF) * p.df;
  const int4* chunks = reinterpret_cast<const int4*>(table + kHeader);
  for (int c = tid; c < kSimtTile; c += kSimtThreads) xs[c * XS + zc] = 0.f;

  float acc[KT][4][4];
#pragma unroll
  for (int j = 0; j < KT; ++j)
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[j][u][v] = 0.f;

  for (int k = table[i] + blockIdx.x; k < table[i + 1]; k += p.splits) {
    const int4 ck = chunks[k];  // b, f0, nf, t0
    for (int e = tid; e < kSimtTile * ck.z * p.xw; e += kSimtThreads) {
      const int c = e % kSimtTile, col = e / kSimtTile;
      const int r = col / p.xw, t = ck.w - PT * p.dt + col % p.xw;
      const int cc = c0 + c;
      xs[c * XS + col] =
          (t >= 0 && t < p.T && cc < p.C)
              ? Elem<T>::load(x + (((size_t)ck.x * p.F + ck.y + r + sh) * p.T +
                                   t) * p.C + cc)
              : 0.f;
    }
    for (int e = tid; e < kSimtTile * p.pp; e += kSimtThreads) {
      const int n = e % kSimtTile, pos = e / kSimtTile;
      const int r = pos / p.tl, t = ck.w + pos % p.tl, nn = n0 + n;
      gs[n * GS + pos] =
          (r < ck.z && t < p.T && nn < p.N)
              ? Elem<T>::load(g + (((size_t)ck.x * p.F + ck.y + r) * p.T +
                                   t) * p.N + nn)
              : 0.f;
    }
    __syncthreads();
    for (int pos = 0; pos < p.pp; ++pos) {
      const int r = pos / p.tl;
      const bool live = r < ck.z;
      const int col = live ? r * p.xw + pos % p.tl : zc;
      const int step = live ? p.dt : 0;
      float gv[4];
#pragma unroll
      for (int v = 0; v < 4; ++v) gv[v] = gs[(tn * 4 + v) * GS + pos];
#pragma unroll
      for (int j = 0; j < KT; ++j) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float xv = xs[(tc * 4 + u) * XS + col + j * step];
#pragma unroll
          for (int v = 0; v < 4; ++v)
            acc[j][u][v] = fmaf(xv, gv[v], acc[j][u][v]);
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
          atomicAdd(dw + ((size_t)(i * KT + j) * p.C + c) * p.N + n,
                    acc[j][u][v]);
      }
    }
}

// ------------------------------------------------------------ fold route

// The table holds one int4 per folded row (groups * kFoldRows, padding rows
// with channel -1): (f shift, t shift, narrow channel, dW offset).  Row
// (i, j, ch) reads the narrow operand at (f + shift_f, t + shift_t, ch) for
// the wide operand's position (f, t); its sum for wide channel w lands at
// dW[offset + w * wide_stride].  A thread owns one wide channel and one of
// kFoldLanes interleaved position lanes.  It loads a chunk into registers
// (the wide operand at its kFoldPer positions, the narrow values of its
// folded row at kFoldGather positions) while it multiplies the chunk
// before, then stages the narrow values in shared memory.
template <typename T>
__global__ void __launch_bounds__(kFoldWide * kFoldLanes) dw_fold(
    const Plan p, const T* __restrict__ x, const T* __restrict__ g,
    float* __restrict__ dw, const int* __restrict__ table) {
  constexpr int kThreads = kFoldWide * kFoldLanes;
  constexpr int kFoldStage = kThreads / kFoldRows;  // positions per pass
  constexpr int kFoldGather = kFoldChunk / kFoldStage;
  constexpr int kFoldPer = kFoldChunk / kFoldLanes;
  __shared__ __align__(16) float ns[kFoldChunk * kFoldStride];
  const T* wide_src = p.narrow_x ? g : x;
  const T* narrow_src = p.narrow_x ? x : g;
  const int Cn = p.narrow_x ? p.C : p.N;
  const int wide_stride = p.narrow_x ? 1 : p.N;
  const int tid = threadIdx.x, wl = tid % kFoldWide, pl = tid / kFoldWide;
  const int grp = blockIdx.y % p.groups, wt = blockIdx.y / p.groups;
  const int4* rows = reinterpret_cast<const int4*>(table) + grp * kFoldRows;
  const int wch = wt * kFoldWide + wl;
  const bool wlive = wch < p.wide;
  const int FT = p.F * p.T, BFT = p.B * FT;
  // the folded row and first position this thread stages
  const int4 rs = rows[tid % kFoldRows];
  const int spos0 = tid / kFoldRows;

  float acc[kFoldRows];
#pragma unroll
  for (int r = 0; r < kFoldRows; ++r) acc[r] = 0.f;

  // chunk k's loads into wv (wide operand) and gv (this thread's narrow
  // values); issued a chunk ahead of their use
  float wv[kFoldPer], gv[kFoldGather];
  auto fetch = [&](int k) {
    const int q0 = k * kFoldChunk;
#pragma unroll
    for (int m = 0; m < kFoldPer; ++m) {
      const int q = q0 + pl + m * kFoldLanes;
      wv[m] = wlive && q < BFT
                  ? Elem<T>::load(wide_src + (size_t)q * p.wide + wch)
                  : 0.f;
    }
    // (b, f, t) of position q0 + spos0, then steps of kFoldStage positions
    int q = q0 + spos0;
    int b = q / FT, f = q % FT / p.T, t = q % p.T;
#pragma unroll
    for (int m = 0; m < kFoldGather; ++m) {
      const int fn = f + rs.x, tn = t + rs.y;
      gv[m] = rs.z >= 0 && q < BFT && fn >= 0 && fn < p.F && tn >= 0 &&
                      tn < p.T
                  ? Elem<T>::load(narrow_src +
                                  (((size_t)b * p.F + fn) * p.T + tn) * Cn +
                                  rs.z)
                  : 0.f;
      q += kFoldStage;
      for (t += kFoldStage; t >= p.T; t -= p.T)
        if (++f == p.F) {
          f = 0;
          ++b;
        }
    }
  };

  if (blockIdx.x < p.n_chunks) fetch(blockIdx.x);
  for (int k = blockIdx.x; k < p.n_chunks; k += p.splits) {
    __syncthreads();  // the last chunk's products are done
#pragma unroll
    for (int m = 0; m < kFoldGather; ++m)
      ns[(spos0 + m * kFoldStage) * kFoldStride + tid % kFoldRows] = gv[m];
    float wc[kFoldPer];
#pragma unroll
    for (int m = 0; m < kFoldPer; ++m) wc[m] = wv[m];
    __syncthreads();
    if (k + p.splits < p.n_chunks) fetch(k + p.splits);
#pragma unroll
    for (int m = 0; m < kFoldPer; ++m) {
      const float4* nr = reinterpret_cast<const float4*>(
          ns + (pl + m * kFoldLanes) * kFoldStride);
#pragma unroll
      for (int r4 = 0; r4 < kFoldRows / 4; ++r4) {
        const float4 v = nr[r4];
        acc[4 * r4] = fmaf(v.x, wc[m], acc[4 * r4]);
        acc[4 * r4 + 1] = fmaf(v.y, wc[m], acc[4 * r4 + 1]);
        acc[4 * r4 + 2] = fmaf(v.z, wc[m], acc[4 * r4 + 2]);
        acc[4 * r4 + 3] = fmaf(v.w, wc[m], acc[4 * r4 + 3]);
      }
    }
  }
  if (!wlive) return;
#pragma unroll
  for (int r = 0; r < kFoldRows; ++r) {
    const int4 rw = rows[r];
    if (rw.z >= 0) atomicAdd(dw + rw.w + (size_t)wch * wide_stride, acc[r]);
  }
}

// -------------------------------------------------------------- launch

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
int launch_simt(const Plan& p, const T* x, const T* g, float* dw,
                const int* table, cudaStream_t st) {
  const dim3 grid(p.splits, p.tiles);
  static bool configured[8] = {};
#define BABE_DW_SIMT(KT_)                                                  \
  case KT_: {                                                              \
    if (int rc = allow_smem(dw_simt<T, KT_>, configured[KT_])) return rc; \
    dw_simt<T, KT_><<<grid, kSimtThreads, p.smem, st>>>(p, x, g, dw,      \
                                                        table);            \
    return (int)cudaGetLastError();                                        \
  }
  switch (p.KT) {
    BABE_DW_SIMT(1)
    BABE_DW_SIMT(3)
    BABE_DW_SIMT(5)
    BABE_DW_SIMT(7)
  }
#undef BABE_DW_SIMT
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int launch(const Plan& p, const void* x, const void* g, float* dw,
           const int* table, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(g);
  if (p.route == kFold) {
    if (p.threads != kFoldWide * kFoldLanes || p.groups < 1 ||
        p.tiles != p.groups * p.wide_tiles)
      return (int)cudaErrorInvalidValue;
    dw_fold<T><<<dim3(p.splits, p.tiles), p.threads, 0, st>>>(p, xt, gt, dw,
                                                               table);
    return (int)cudaGetLastError();
  }
  if (p.smem > kMaxSmem || p.tiles != p.KF * p.tap_groups * p.c_tiles *
                                          p.n_tiles)
    return (int)cudaErrorInvalidValue;
  if (p.route == kSimt) {
    if (p.bm != kSimtTile || p.bn != kSimtTile || p.taps != p.KT)
      return (int)cudaErrorInvalidValue;
    return launch_simt<T>(p, xt, gt, dw, table, st);
  }
  if (p.route != kMma || sizeof(T) != 2 || p.taps != 3 || p.bm % 32 ||
      p.bn % 32 || p.threads != p.bm * p.bn / 32 ||
      p.threads > kMaxWarps * 32 || p.pp % 16 || p.pp > 16 * kMaxKs)
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (int rc = allow_smem(dw_mma, configured)) return rc;
  dw_mma<<<dim3(p.splits, p.tiles), p.threads, p.smem, st>>>(
      p, reinterpret_cast<const bf16*>(x), reinterpret_cast<const bf16*>(g),
      dw, table);
  return (int)cudaGetLastError();
}

}  // namespace cdw
}  // namespace babe

// dW (KF*KT, C, N) fp32 += the weight gradient of the 'SAME' conv of x
// (B, F, T, C) with cotangent g (B, F, T, N), cut as the host's plan says:
// meta holds the Plan's n_meta ints, table its chunk or row table (device
// memory).  dtype 0 = fp32, 1 = bf16.
extern "C" int babe_conv_dw(const void* x, const void* g, void* dw,
                            const void* table, const int* meta, int n_meta,
                            int dtype, void* stream) {
  using namespace babe::cdw;
  if (n_meta != (int)(sizeof(Plan) / sizeof(int)))
    return (int)cudaErrorInvalidValue;
  Plan p;
  memcpy(&p, meta, sizeof(Plan));
  if (p.KF < 1 || p.KF > 7 || p.KT < 1 || p.KT > 7 || p.KF % 2 == 0 ||
      p.KT % 2 == 0 || p.df < 1 || p.dt < 1 || p.splits < 1 || p.tiles < 1)
    return (int)cudaErrorInvalidValue;
  if (p.B <= 0 || p.F <= 0 || p.T <= 0 || p.C <= 0 || p.N <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* d = static_cast<float*>(dw);
  const int* tb = static_cast<const int*>(table);
  if (dtype == 0) return launch<float>(p, x, g, d, tb, st);
  if (dtype == 1) return launch<__nv_bfloat16>(p, x, g, d, tb, st);
  return (int)cudaErrorInvalidValue;
}

// How many blocks of a route's kernel the card holds at once (SMs x blocks
// per SM) at this block size and dynamic shared memory; the host's splits
// aim at it.  A negative value is a CUDA error.
extern "C" int babe_dw_slots(int route, int threads, int smem, int KT,
                             int dtype) {
  using namespace babe::cdw;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // the fold kernel's shared memory is static: it takes no dynamic
  auto occupancy = [&](auto kernel) {
    if (err == cudaSuccess && route != kFold)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
  };
  const bool f32 = dtype == 0;
  if (route == kMma) {
    occupancy(dw_mma);
  } else if (route == kFold) {
    if (f32) occupancy(dw_fold<float>);
    else occupancy(dw_fold<__nv_bfloat16>);
  } else if (route == kSimt) {
    switch (KT) {
      case 1: f32 ? occupancy(dw_simt<float, 1>)
                  : occupancy(dw_simt<__nv_bfloat16, 1>); break;
      case 3: f32 ? occupancy(dw_simt<float, 3>)
                  : occupancy(dw_simt<__nv_bfloat16, 3>); break;
      case 5: f32 ? occupancy(dw_simt<float, 5>)
                  : occupancy(dw_simt<__nv_bfloat16, 5>); break;
      case 7: f32 ? occupancy(dw_simt<float, 7>)
                  : occupancy(dw_simt<__nv_bfloat16, 7>); break;
      default: err = cudaErrorInvalidValue;
    }
  } else {
    err = cudaErrorInvalidValue;
  }
  return err == cudaSuccess ? per_sm * sms : -(int)err;
}

// h = gelu(x*a) and gc = g_pre*s of one K2 stage, (B, F, T, C) in x's type
// (see the file's head).
extern "C" int babe_stage_dw_operands(const void* x, const void* a,
                                      const void* s, const void* y,
                                      const void* g_y, const void* g_mom,
                                      void* h, void* gc, int B, int F, int T,
                                      int C, int dtype, void* stream) {
  using namespace babe::cdw;
  if (B <= 0 || F <= 0 || T <= 0 || C <= 0) return 0;
  const size_t n = (size_t)B * F * T * C;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int FT = F * T;
  const float* af = static_cast<const float*>(a);
  const float* sf = static_cast<const float*>(s);
  const float* gm = static_cast<const float*>(g_mom);
#define BABE_DW_OPERANDS(T_, VEC)                                           \
  do {                                                                      \
    const size_t steps = n / (VEC);                                         \
    const int blocks = (int)std::min<size_t>((steps + 255) / 256, 132 * 16); \
    stage_operands<T_, VEC><<<blocks, 256, 0, st>>>(                        \
        static_cast<const T_*>(x), af, sf, static_cast<const T_*>(y),       \
        static_cast<const T_*>(g_y), gm, static_cast<T_*>(h),               \
        static_cast<T_*>(gc), B, FT, C, n);                                 \
    return (int)cudaGetLastError();                                         \
  } while (0)
  if (dtype == 1) {
    if (C % 8 == 0) BABE_DW_OPERANDS(__nv_bfloat16, 8);
    BABE_DW_OPERANDS(__nv_bfloat16, 1);
  }
  if (dtype == 0) {
    if (C % 4 == 0) BABE_DW_OPERANDS(float, 4);
    BABE_DW_OPERANDS(float, 1);
  }
#undef BABE_DW_OPERANDS
  return (int)cudaErrorInvalidValue;
}
