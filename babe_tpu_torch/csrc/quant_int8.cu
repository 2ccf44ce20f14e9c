// Q8: the per-item int8 quantizers of the unfused int8 path, and the
// rescale of an int32 product.
//
//   babe_act_quant_dyn  amax[b] = max |x[b, ...]|, a = max(amax[b], 1e-20),
//                       s[b] = a / 127, q = clip(rint(float(x) * (127 / a)),
//                       +-127) int8: the dynamic per-item quantization, in
//                       one cooperative launch
//   babe_act_quant      the same quantize at a given per-item amax (a
//                       bound known before x)
//   babe_act_rescale    out = float(acc) * scale[b, n]  in the output type
//
// x is fp32 or bf16, (B, per_b) with per_b = F*T*C; acc is int32 (B,
// rows, N) with scale (B, N) fp32 = s_x[b] * s_w[n].  They stand for the
// XLA fusions of babe_tpu/ops/conv_kernels.py::_quant_act_per_item (the
// amax reduction and the quantize), _quant_act_with_scale (the quantize
// with a given amax: the hinted stage input) and the rescale after the
// int8 1x1 einsum of _dot1x1_int8_impl; no Pallas kernel.  Plain versions:
// babe_tpu_torch/ops/conv_kernels.py::quant_act_per_item,
// quant_act_ref and int8_rescale_ref.  Each rounds as the plain version
// does: the divisions are IEEE (__fdiv_rn), x * (127 / a) one rounded fp32
// product, the rounding to int half to even, so q and s agree with the
// plain versions bit for bit; the amax is a max, exact in any order, so it
// is the same whatever the cut.
//
// Bound on the H100: bytes (x read once from device memory and q written
// for the quantizers; the int32 read and the output's write for the
// rescale).  At the flagship's int8 stage tensors (3.1M to 12.6M elements
// at batch 1) that is 3 to 11 us, about a launch's own cost, so the design
// is about launches and instructions:
//   * act_quant_dyn is one launch where the dynamic quantization was three
//     (a memset, an amax kernel with atomics, a quantize).  The host cuts x
//     into units (kernels.q8_plan): per_item contiguous ranges of chunk
//     elements per item, a multiple of 16, one unit a resident block (one
//     block an SM).  Phase 1: a block reduces |x| over its unit in
//     registers, 16 elements a step (two 16-byte loads of bf16 or four of
//     fp32), then through warp shuffles and shared memory, and writes
//     partial[unit]: every slot is written before it is read, so nothing
//     is zeroed and there are no atomics.  A grid barrier
//     (cooperative_groups::this_grid().sync(); the cooperative launch
//     refuses a grid that is not resident at once).  Phase 2: each block
//     takes the max of its item's partials, forms 127 / a once, and reads
//     its own unit again, which at batch 1 comes from the 50 MB L2 (25.2 MB
//     of bf16 at most), writing 16 int8 a 16-byte store.  With one unit per
//     item (more items than resident blocks, or items too short to share)
//     a block owns whole items and walks them in turn, with no barrier.
//   * act_quant is phase 2 alone, in an ordinary launch on the same cut.
//   * No 64-bit division or modulo per element: a block finds its item
//     once.  A range's head and tail up to 16-element boundaries, and the
//     whole range when x is not 16-byte aligned, go one element a thread.
//   * act_rescale runs on a 2-D grid, row blocks x items (cut by
//     kernels.rescale_plan), so a block knows its item and rows from its
//     index; a thread takes 8 consecutive channels of its rows (two
//     16-byte int32 loads, one 16-byte bf16 store) with their 8 scales kept
//     in registers, and finds its channels and first row with one 32-bit
//     division, once.  N not a multiple of 8, or acc or out off 16-byte
//     alignment, take a scalar path on the same grid: warps over rows,
//     lanes over channels.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

namespace babe {
namespace q8 {

// one block of 1024 threads an SM (the occupancy at its 46-48 registers):
// the barrier's cost grows with the blocks that meet there (132 here, not
// the 792 of six 256-thread blocks an SM), and so does each block's gather
// of its item's partials
constexpr int kThreads = 1024;
constexpr int kGroup = 16;  // elements a step: one 16-byte store of int8
// how far an act_quant_dyn instantiation goes: everything (the serving
// kernel); phase 1, the barrier and s; phase 1 alone (the last two only
// to time the parts, through babe_act_quant_dyn_part)
enum Upto { kAll = 0, kScale = 1, kPartial = 2 };

template <typename T> struct In;
template <> struct In<float> {
  static __device__ __forceinline__ float load(const float* p) {
    return __ldg(p);
  }
  // 16 elements from a 16-byte aligned address
  static __device__ __forceinline__ void load16(const float* p,
                                                float (&v)[kGroup]) {
    const float4* p4 = reinterpret_cast<const float4*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 f = __ldg(p4 + i);
      v[4 * i] = f.x;
      v[4 * i + 1] = f.y;
      v[4 * i + 2] = f.z;
      v[4 * i + 3] = f.w;
    }
  }
};
template <> struct In<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(__ldg(p));
  }
  // a bf16 is the top half of its float's bits: the low half word of each
  // 32-bit word is the earlier element
  static __device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                                float (&v)[kGroup]) {
    const uint4* p4 = reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint4 u = __ldg(p4 + i);
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        v[8 * i + 2 * k] = __uint_as_float(w[k] << 16);
        v[8 * i + 2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
      }
    }
  }
};

template <typename T> struct Out;
template <> struct Out<float> {
  static __device__ __forceinline__ void store(float* p, float v) { *p = v; }
  // 8 values to a 16-byte aligned address: two 16-byte stores
  static __device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
};
template <> struct Out<__nv_bfloat16> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16(v);  // round to nearest even, as torch does
  }
  // one 16-byte store
  static __device__ __forceinline__ void store8(__nv_bfloat16* p,
                                                const float (&v)[8]) {
    __align__(16) __nv_bfloat16 o[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) o[e] = __float2bfloat16(v[e]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(o);
  }
};

__device__ __forceinline__ int quant(float x, float iv) {
  return max(-127, min(127, __float2int_rn(__fmul_rn(x, iv))));
}

// the low bytes of four ints, in order, as one word
__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

// a block's range of x [lo, hi) in elements of the whole tensor, in
// item b, with the part [vlo, vhi) that goes 16 elements a step (empty
// unless x and q are 16-byte aligned)
struct Span {
  long long lo, hi, vlo, vhi;
  int b;
};

__device__ __forceinline__ Span span(int b, long long lo, long long hi,
                                     bool vec) {
  Span s{lo, hi, lo, lo, b};
  if (vec) {
    s.vlo = llmin(hi, (lo + kGroup - 1) & ~(long long)(kGroup - 1));
    s.vhi = llmax(s.vlo, hi & ~(long long)(kGroup - 1));
  }
  return s;
}

// unit u of the cut: item b = u / per_item, its (u % per_item)-th chunk
__device__ __forceinline__ Span unit_span(int u, int per_item,
                                          long long per_b, long long chunk,
                                          bool vec) {
  const int b = u / per_item;
  const long long lo = (long long)(u - b * per_item) * chunk;
  return span(b, (long long)b * per_b + lo,
              (long long)b * per_b + llmin(lo + chunk, per_b), vec);
}

template <typename T>
__device__ __forceinline__ float span_amax(const T* __restrict__ x,
                                           const Span& s) {
  float m = 0.f;
  for (long long e = s.lo + threadIdx.x; e < s.vlo; e += kThreads)
    m = fmaxf(m, fabsf(In<T>::load(x + e)));
#pragma unroll 2
  for (long long e = s.vlo + (long long)threadIdx.x * kGroup; e < s.vhi;
       e += (long long)kThreads * kGroup) {
    float v[kGroup];
    In<T>::load16(x + e, v);
#pragma unroll
    for (int i = 0; i < kGroup; ++i) m = fmaxf(m, fabsf(v[i]));
  }
  for (long long e = s.vhi + threadIdx.x; e < s.hi; e += kThreads)
    m = fmaxf(m, fabsf(In<T>::load(x + e)));
  return m;
}

template <typename T>
__device__ __forceinline__ void span_quant(const T* __restrict__ x,
                                           int8_t* __restrict__ q,
                                           const Span& s, float iv) {
  for (long long e = s.lo + threadIdx.x; e < s.vlo; e += kThreads)
    q[e] = (int8_t)quant(In<T>::load(x + e), iv);
#pragma unroll 2
  for (long long e = s.vlo + (long long)threadIdx.x * kGroup; e < s.vhi;
       e += (long long)kThreads * kGroup) {
    float v[kGroup];
    In<T>::load16(x + e, v);
    uint4 o;
    o.x = pack4(quant(v[0], iv), quant(v[1], iv), quant(v[2], iv),
                quant(v[3], iv));
    o.y = pack4(quant(v[4], iv), quant(v[5], iv), quant(v[6], iv),
                quant(v[7], iv));
    o.z = pack4(quant(v[8], iv), quant(v[9], iv), quant(v[10], iv),
                quant(v[11], iv));
    o.w = pack4(quant(v[12], iv), quant(v[13], iv), quant(v[14], iv),
                quant(v[15], iv));
    *reinterpret_cast<uint4*>(q + e) = o;
  }
  for (long long e = s.vhi + threadIdx.x; e < s.hi; e += kThreads)
    q[e] = (int8_t)quant(In<T>::load(x + e), iv);
}

// the block's max of m, in every thread
__device__ __forceinline__ float block_max(float m, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __syncthreads();  // red's earlier readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int w = 1; w < kThreads / 32; ++w) m = fmaxf(m, red[w]);
  return m;
}

template <typename T>
__device__ __forceinline__ bool aligned16(const T* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// grid = B * per_item blocks when per_item > 1 (one unit a block, all
// resident: the cooperative launch), else at most the resident blocks,
// walking the items
template <typename T, int kUpto>
__global__ void __launch_bounds__(kThreads)
    act_quant_dyn(const T* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ s, float* __restrict__ partial, int B,
                  long long per_b, int per_item, long long chunk) {
  __shared__ float red[kThreads / 32];
  const bool vec = aligned16(x) && aligned16(q);
  if (per_item == 1) {
    for (int b = blockIdx.x; b < B; b += gridDim.x) {
      const Span sp = span(b, (long long)b * per_b,
                           (long long)(b + 1) * per_b, vec);
      const float m = block_max(span_amax(x, sp), red);
      if (kUpto == kPartial) {
        if (threadIdx.x == 0) partial[blockIdx.x] = m;
        continue;
      }
      const float a = fmaxf(m, 1e-20f);
      if (threadIdx.x == 0) s[b] = __fdiv_rn(a, 127.0f);
      if (kUpto == kAll) span_quant(x, q, sp, __fdiv_rn(127.0f, a));
    }
    return;
  }
  const int u = blockIdx.x;
  const Span sp = unit_span(u, per_item, per_b, chunk, vec);
  const int b = sp.b;
  const float m = block_max(span_amax(x, sp), red);
  if (threadIdx.x == 0) partial[u] = m;
  if (kUpto == kPartial) return;
  cg::this_grid().sync();
  float pm = 0.f;
  for (int k = threadIdx.x; k < per_item; k += kThreads)
    pm = fmaxf(pm, __ldcg(partial + (long long)b * per_item + k));
  const float a = fmaxf(block_max(pm, red), 1e-20f);
  if (threadIdx.x == 0 && u == b * per_item) s[b] = __fdiv_rn(a, 127.0f);
  if (kUpto == kAll) span_quant(x, q, sp, __fdiv_rn(127.0f, a));
}

// phase 2 alone at the given amax; blocks walk the units
template <typename T>
__global__ void __launch_bounds__(kThreads)
    act_quant(const T* __restrict__ x, const float* __restrict__ amax,
              int8_t* __restrict__ q, float* __restrict__ s, int B,
              long long per_b, int per_item, long long chunk) {
  const bool vec = aligned16(x) && aligned16(q);
  for (int u = blockIdx.x; u < B * per_item; u += gridDim.x) {
    const Span sp = unit_span(u, per_item, per_b, chunk, vec);
    const float a = fmaxf(__ldg(amax + sp.b), 1e-20f);
    if (threadIdx.x == 0 && u == sp.b * per_item)
      s[sp.b] = __fdiv_rn(a, 127.0f);
    span_quant(x, q, sp, __fdiv_rn(127.0f, a));
  }
}

// block (x, b) takes rows [x * rows_blk, (x + 1) * rows_blk) of item b.
// vec (N a multiple of 8, acc and out 16-byte aligned): thread t owns
// channels 8 (t % R) .. + 8 of rows t / R, + P, ... (R = N / 8 threads a
// row, P = blockDim / R rows a pass), its 8 scales in registers: two
// 16-byte int32 loads and one 16-byte bf16 store (two for fp32) a row.
// Else warp w takes rows w, w + 8, ..., its lanes the channels, one
// element a thread.  No division or modulo per element: a thread finds its
// channels and first row once.
template <typename T>
__global__ void __launch_bounds__(256)
    act_rescale(const int32_t* __restrict__ acc,
                const float* __restrict__ scale, T* __restrict__ out,
                int rows, int N, int rows_blk, int vec) {
  const int b = blockIdx.y;
  const int r_lo = blockIdx.x * rows_blk;
  const int r_hi = min(rows, r_lo + rows_blk);
  const float* sc = scale + (size_t)b * N;
  const size_t item = (size_t)b * rows;
  if (vec) {
    const int R = N >> 3, P = blockDim.x / R;
    const int cg = threadIdx.x % R, pr = threadIdx.x / R;
    if (pr >= P) return;
    float s8[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) s8[e] = __ldg(sc + 8 * cg + e);
#pragma unroll 4
    for (int r = r_lo + pr; r < r_hi; r += P) {
      const size_t idx = (item + r) * N + 8 * cg;
      const int4 a0 = __ldg(reinterpret_cast<const int4*>(acc + idx));
      const int4 a1 = __ldg(reinterpret_cast<const int4*>(acc + idx + 4));
      const int32_t av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float v[8];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[e] = __fmul_rn(__int2float_rn(av[e]), s8[e]);
      Out<T>::store8(out + idx, v);
    }
    return;
  }
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int r = r_lo + (int)(threadIdx.x >> 5); r < r_hi; r += nw) {
    const size_t row = (item + r) * N;
    for (int c = lane; c < N; c += 32)
      Out<T>::store(out + row + c,
                    __fmul_rn(__int2float_rn(__ldg(acc + row + c)),
                              __ldg(sc + c)));
  }
}

inline bool bad_cut(int B, long long per_b, int per_item, long long chunk,
                    int grid) {
  return B <= 0 || per_b <= 0 || per_item <= 0 || grid <= 0 || chunk <= 0 ||
         chunk % kGroup != 0 || (per_item - 1) * chunk >= per_b ||
         (long long)per_item * chunk < per_b ||
         (per_item > 1 && grid != B * per_item);
}

// act_quant_dyn<T, kUpto> on the cut, one cooperative launch
template <int kUpto>
int launch_dyn(const void* x, void* q, void* s, void* partial, int B,
               long long per_b, int dtype, int per_item, long long chunk,
               int grid, void* stream) {
  if (bad_cut(B, per_b, per_item, chunk, grid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int8_t* q_ = static_cast<int8_t*>(q);
  float* s_ = static_cast<float*>(s);
  float* p_ = static_cast<float*>(partial);
  cudaError_t err;
  if (dtype == 0) {
    const float* x_ = static_cast<const float*>(x);
    void* args[] = {&x_, &q_, &s_, &p_, &B, &per_b, &per_item, &chunk};
    err = cudaLaunchCooperativeKernel(
        (const void*)act_quant_dyn<float, kUpto>, grid, kThreads, args, 0,
        st);
  } else if (dtype == 1) {
    const __nv_bfloat16* x_ = static_cast<const __nv_bfloat16*>(x);
    void* args[] = {&x_, &q_, &s_, &p_, &B, &per_b, &per_item, &chunk};
    err = cudaLaunchCooperativeKernel(
        (const void*)act_quant_dyn<__nv_bfloat16, kUpto>, grid, kThreads,
        args, 0, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

}  // namespace q8
}  // namespace babe

// act_quant_dyn's resident blocks per SM at its 1024 threads (dtype 0
// fp32 / 1 bf16), or minus the CUDA error
extern "C" int babe_act_quant_dyn_slots(int dtype) {
  int per_sm = 0;
  cudaError_t err = cudaErrorInvalidValue;
  if (dtype == 0)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, babe::q8::act_quant_dyn<float, babe::q8::kAll>,
        babe::q8::kThreads, 0);
  else if (dtype == 1)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, babe::q8::act_quant_dyn<__nv_bfloat16, babe::q8::kAll>,
        babe::q8::kThreads, 0);
  return err == cudaSuccess ? per_sm : -(int)err;
}

// x (B, per_b) of dtype 0 fp32 / 1 bf16 -> q (B, per_b) int8, s (B,) at
// the per-item amax; partial holds grid floats; the cut (per_item, chunk,
// grid) is kernels.q8_plan's
extern "C" int babe_act_quant_dyn(const void* x, void* q, void* s,
                                  void* partial, int B, long long per_b,
                                  int dtype, int per_item, long long chunk,
                                  int grid, void* stream) {
  return babe::q8::launch_dyn<babe::q8::kAll>(
      x, q, s, partial, B, per_b, dtype, per_item, chunk, grid, stream);
}

// act_quant_dyn's parts, to time them: upto 1 = phase 1, the barrier and
// s (no q); 2 = phase 1 alone (partial[unit] = the unit's max, or, where
// blocks walk items, partial[block] = its last item's)
extern "C" int babe_act_quant_dyn_part(const void* x, void* q, void* s,
                                       void* partial, int B, long long per_b,
                                       int dtype, int per_item,
                                       long long chunk, int grid, int upto,
                                       void* stream) {
  using namespace babe::q8;
  if (upto == kScale)
    return launch_dyn<kScale>(x, q, s, partial, B, per_b, dtype, per_item,
                              chunk, grid, stream);
  if (upto == kPartial)
    return launch_dyn<kPartial>(x, q, s, partial, B, per_b, dtype, per_item,
                                chunk, grid, stream);
  return (int)cudaErrorInvalidValue;
}

// x (B, per_b) with the per-item amax (B,) -> q (B, per_b) int8, s (B,),
// on the same cut as act_quant_dyn
extern "C" int babe_act_quant(const void* x, const void* amax, void* q,
                              void* s, int B, long long per_b, int dtype,
                              int per_item, long long chunk, int grid,
                              void* stream) {
  using namespace babe::q8;
  if (bad_cut(B, per_b, per_item, chunk, grid))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    act_quant<float><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(amax),
        static_cast<int8_t*>(q), static_cast<float*>(s), B, per_b, per_item,
        chunk);
  else if (dtype == 1)
    act_quant<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(amax),
        static_cast<int8_t*>(q), static_cast<float*>(s), B, per_b, per_item,
        chunk);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// acc (B, rows, N) int32 with scale (B, N) -> out of dtype 0 fp32 / 1
// bf16, on the cut of kernels.rescale_plan: `threads` a block, rows_blk
// rows a block, a grid of gx x B blocks; vec the 8-channel path (N a
// multiple of 8, acc and out 16-byte aligned).  cudaErrorInvalidValue for
// a cut that does not cover the rows or that the path does not take.
extern "C" int babe_act_rescale(const void* acc, const void* scale,
                                void* out, int B, int rows, int N, int dtype,
                                int vec, int threads, int rows_blk, int gx,
                                void* stream) {
  if (B <= 0 || rows <= 0 || N <= 0) return 0;
  const uintptr_t a = reinterpret_cast<uintptr_t>(acc) |
                      reinterpret_cast<uintptr_t>(out);
  const bool cut_ok =
      B <= 65535 && threads >= 32 && threads <= 256 && rows_blk >= 1 &&
      gx >= 1 && (long long)gx * rows_blk >= rows &&
      (long long)(gx - 1) * rows_blk < rows &&
      (vec ? N % 8 == 0 && a % 16 == 0 && N / 8 <= 256 &&
                 threads == (N / 8) * (256 / (N / 8))
           : threads == 256);
  if (!cut_ok || (dtype != 0 && dtype != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(gx, B);
  if (dtype == 0)
    babe::q8::act_rescale<float><<<grid, threads, 0, st>>>(
        static_cast<const int32_t*>(acc), static_cast<const float*>(scale),
        static_cast<float*>(out), rows, N, rows_blk, vec);
  else
    babe::q8::act_rescale<__nv_bfloat16><<<grid, threads, 0, st>>>(
        static_cast<const int32_t*>(acc), static_cast<const float*>(scale),
        static_cast<__nv_bfloat16*>(out), rows, N, rows_blk, vec);
  return (int)cudaGetLastError();
}
