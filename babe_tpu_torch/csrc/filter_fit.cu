// The BABE filter fit: projected gradient descent on the breakpoints
// (fc_k, A_k) of the piecewise log-log lowpass, all iterations in one
// block.
//
// Replaces the JAX lax.while_loop of babe_tpu/sampling/blind.py::fit_params
// (XLA on the TPU; no Pallas kernel there).  The plain version is
// BlindSampler._fit_loop (PyTorch autograd through design_filter), which
// this kernel follows step for step:
//
//   H(f)   = 1 below fc_0; past breakpoint i the segment
//            seg_i(f) = 10^(A_i log2(max(f, fc_i) / fc_i) / 20) times
//            cont_i = H_{i-1}(f*_i), the previous response at the first bin
//            f*_i >= fc_i (each breakpoint overwrites every bin >= fc_i,
//            so a bin's value comes from the last breakpoint at or below it)
//   L      = sqrt(max(sum_f H^2 a - 2 H b + c, 1e-12))   (a, b, c: the
//            per-bin statistics of the fit, computed by the caller)
//   grad   = the exact reverse-mode derivative of that expression (ties of
//            max(f, fc) split the gradient in half, as torch.maximum does;
//            the bin index f*_i carries none)
//   update = p - mu * grad, then the sequential clamps (fc increasing by at
//            least 1 Hz, A non-increasing and negative); the loop stops
//            once both mean steps fall below tol, as the reference's does.
//
// Bound on the H100: neither bytes nor operations (a few kB and a few
// MFLOP per fit) but latency: max_iter dependent iterations, each a pass
// over the bins, a block-wide reduction and a K-step recurrence.  So the
// design keeps every iteration short:
//   - K is a template parameter (1..kMaxK), so every per-breakpoint array
//     is in registers (ptxas: no stack frame, no spills, for every K);
//   - one block of 128 threads (256 above 17 x 128 bins), each holding up
//     to 17 bins' f, a and -b in registers, loaded once (sum c is
//     constant, summed once);
//     per bin and iteration: the segment by K compares of the bin index
//     against the first-bin indices, one 16-byte shared-memory read of
//     that segment's constants, lg = max(log2(f * (1 / fc_j)), 0) and one
//     exp2f in place of powf;
//   - one reduction pass: each warp reduces its 3K + 1 sums together by
//     recursive halving (each shuffle level moves half the values: 3K + 1
//     shuffles in all where a sum at a time would take 5 (3K + 1)) and
//     writes one row; after one barrier warp 0 runs the update: the column
//     sums, the chain backward, the step and the clamps as recurrences on
//     registers gathered from its lanes, then the chain forward with one
//     lane per breakpoint (its constants, and its first bin as
//     ceil(fc * nfft / fs) corrected by a bin against the staged
//     frequencies, so `f >= fc` holds exactly as in the reference); each
//     lane publishes its breakpoint's segment for the second barrier,
//     which also carries the exit flag (__syncthreads_or);
//   - the update's serial chain avoids branches.
// The loss and gradient are rounded in another order than the plain
// version's (the sums; log2(f * (1 / fc)) for log2(f / fc), which keeps
// the segment's log within a few roundings of the reference's where
// log2 f - log2 fc would lose about 3 bits near fc; exp2 for pow);
// tests/test_torch_fit_engine.py mirrors this arithmetic and holds each
// step to autograd.  Over 100 steps the fit can amplify a difference of
// a few float32 roundings into a different end point
// (tools/fit_sensitivity.py measures by how much), so the chip check
// holds every single step sharply as well as the end point.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxK = 16;
constexpr int kSlots = 17;  // bins per thread, held in registers
constexpr int kMaxF = kSlots * 256;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLn10Over20 = 0.11512925464970229f;     // ln(10) / 20
constexpr float kLog2_10Over20 = 0.16609640474436813f;  // log2(10) / 20
constexpr float kLog2e = 1.4426950408889634f;     // 1 / ln(2)

struct FitArgs {
  const float* stats;  // (3, F): a, b, c
  const float* freqs;  // (F,) ascending
  const float* p0;     // (2, K)
  float* p_out;        // (2, K)
  int* iters;          // optional (1,): iterations run
  int F, K, max_iter;
  float mu0, mu1, tol0, tol1;
  int clamp_fc, clamp_A, only_negative_A;
  float fcmin, fcmax, Amin, Amax;
  float bin_scale;  // nfft / fs: bin n sits at n / bin_scale Hz
};

// the constants of one segment, for the bins; seg[0] is the region below
// the first breakpoint (H = 1)
struct __align__(16) Seg {
  float aq;    // A * log2(10) / 20
  float rfc;   // 1 / max(fc, 1e-9); 0 below the first breakpoint
  float cont;  // the chain factor
  int tb;      // the bin where f == fc (a tie), or -1
};

// What the update keeps between iterations, in shared memory: the
// parameters and, from the chain forward, what its backward needs
template <int K>
struct State {
  float fc[K], A[K];
  float gf[K];              // d seg_i / d fc_i = seg_i * w * gf_i
  int jp[K];                // the breakpoint whose segment holds f*_i, or -1
  float xA[K], xF[K], xS[K];  // d cont_i / d A_jp, / d fc_jp, / d cont_jp
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// Sum each of C values over the warp by recursive halving: at lane bit O
// the lanes with the bit set keep the upper half of the values and send
// the lower.  After the five levels lane l holds, in v[0 .. C/32 - 1],
// the totals of values l * C/32 + v when C >= 32; for C < 32 v[0] holds
// value l / (32 / C).
template <int C, int O, int N>
__device__ __forceinline__ void halve_sum(float (&v)[N], int lane) {
  if constexpr (O >= 1) {
    if constexpr (C > 1) {
      constexpr int H = C / 2;
      const bool up = (lane & O) != 0;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        const float send = up ? v[i] : v[i + H];
        const float keep = up ? v[i + H] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      halve_sum<H, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      halve_sum<1, O / 2>(v, lane);
    }
  }
}

__host__ __device__ constexpr int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// The first bin n with fr[n] >= fc, or F when there is none: the bin of
// ceil(fc * nfft / fs), corrected by one bin either way against the staged
// frequencies, so `f >= fc` holds exactly as in the reference (on the
// rfft grid of nfft at fs the estimate is off by a bin at most:
// tests/test_torch_fit_engine.py holds it to the mask's first index).
// Branch-free, so the update's other work overlaps its loads.
__device__ __forceinline__ int first_bin(const float* fr, int F, float fc,
                                         float bin_scale) {
  const int n = (int)fminf(fmaxf(ceilf(fc * bin_scale), 0.0f),
                           (float)(F - 1));  // NaN -> 0
  const float below = fr[n > 0 ? n - 1 : 0], at = fr[n], last = fr[F - 1];
  const int m = (n > 0 && below >= fc) ? n - 1 : (at < fc ? n + 1 : n);
  return last >= fc ? m : F;  // NaN too: an empty mask
}

// Warp 0: the chain forward.  Every lane holds all K parameters fc in
// registers; lane i < K also holds breakpoint i's (fc_i, A_i), computes
// its segment constants and first bin, and writes breakpoint i's entries
// of seg, nst and st.  The cont_i recurrence runs on registers gathered
// from the lanes, in every lane alike.
template <int K>
__device__ __forceinline__ void forward(const float (&fcs)[K], float fc,
                                        float A, const float* fr, int F,
                                        float bin_scale, Seg* seg, int* nst,
                                        State<K>& st, int lane) {
  const int nb = first_bin(fr, F, fc, bin_scale), n = lane < K ? nb : F;
  const float fci = fmaxf(fc, 1e-9f);
  const float rfc = 1.0f / fci;
  const float aq = A * kLog2_10Over20;
  const float gf =
      fc >= 1e-9f ? A * kLn10Over20 * (-rfc * kLog2e) : 0.0f;
  const float fst = n < F ? fr[n] : 0.0f;
  // jp: the last earlier breakpoint at or below f*, whose segment gives
  // cont_i = seg_jp(f*) cont_jp
  int jp = -1;
#pragma unroll
  for (int k = 0; k < K - 1; ++k)
    if (k < lane && n < F && fst >= fcs[k]) jp = k;
  const int src = jp >= 0 ? jp : 0;
  const float rfk = __shfl_sync(kFull, rfc, src);
  const float aqk = __shfl_sync(kFull, aq, src);
  const float fcik = __shfl_sync(kFull, fci, src);
  const float gfk = __shfl_sync(kFull, gf, src);
  const float lg = fmaxf(log2f(fst * rfk), 0.0f);
  const float sc = jp >= 0 ? exp2f(aqk * lg) : 1.0f;
  float cont[K];
  cont[0] = 1.0f;
#pragma unroll
  for (int i = 1; i < K; ++i) {
    const int ji = __shfl_sync(kFull, jp, i);
    const float si = __shfl_sync(kFull, sc, i);
    float ck = 1.0f;
#pragma unroll
    for (int k = 0; k < K; ++k) ck = (k < i && ji == k) ? cont[k] : ck;
    cont[i] = si * ck;  // si is 1 when unchained
  }
  float mine = cont[0], ck = 1.0f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    mine = lane == k ? cont[k] : mine;
    ck = jp == k ? cont[k] : ck;
  }
  if (lane < K) {
    const bool chained = jp >= 0;
    nst[lane] = n;
    Seg e;
    e.aq = aq;
    e.rfc = rfc;
    e.cont = mine;
    e.tb = (n < F && fc >= 1e-9f && fst == fc) ? n : -1;
    seg[lane + 1] = e;
    st.fc[lane] = fc;
    st.A[lane] = A;
    st.gf[lane] = gf;
    st.jp[lane] = jp;
    st.xA[lane] = chained ? ck * (sc * kLn10Over20 * lg) : 0.0f;
    st.xF[lane] =
        chained ? ck * (sc * gfk * (fst > fcik ? 1.0f : 0.5f)) : 0.0f;
    st.xS[lane] = chained ? sc : 0.0f;
  }
}

template <int K, int NT>
__global__ void __launch_bounds__(NT, 1) fit_kernel(FitArgs p) {
  constexpr int NW = NT / 32, NV = 3 * K + 1, P = pow2_at_least(NV);
  __shared__ float fr[kMaxF];  // bin frequencies
  __shared__ Seg seg[K + 1];
  __shared__ int nst[K];
  __shared__ State<K> st;
  __shared__ float red[NW][P];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int F = p.F;
  const float* a = p.stats;
  const float* bb = p.stats + F;
  const float* cc = p.stats + 2 * F;
  for (int i = tid; i < F; i += NT) {
    fr[i] = p.freqs[i];
  }
  // this thread's bins tid + k NT: f, a, -b; bins past F hold zeros
  float fv[kSlots], av[kSlots], nb[kSlots];
  float csum = 0.0f;
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int n = tid + k * NT;
    fv[k] = av[k] = nb[k] = 0.0f;
    if (n < F) {
      fv[k] = p.freqs[n];
      av[k] = a[n];
      nb[k] = -bb[n];
      csum += cc[n];
    }
  }
  csum = warp_sum(csum);
  if (lane == 0) red[warp][0] = csum;
  __syncthreads();

  float ctot = 0.0f;  // sum of c, warp 0
  if (warp == 0) {
#pragma unroll
    for (int w = 0; w < NW; ++w) ctot += red[w][0];
    float fcs[K];
#pragma unroll
    for (int i = 0; i < K; ++i) fcs[i] = p.p0[i];
    forward<K>(fcs, lane < K ? p.p0[lane] : 0.0f,
               lane < K ? p.p0[K + lane] : 0.0f, fr, F, p.bin_scale,
               seg, nst, st, lane);
    if (lane == 0) seg[0] = Seg{0.0f, 0.0f, 1.0f, -1};
  }
  __syncthreads();

  int it = 0;
  for (; it < p.max_iter; ++it) {
    int ns[K];
#pragma unroll
    for (int i = 0; i < K; ++i) ns[i] = nst[i];
    // the loss and, per segment, the sums the gradient needs: [0, K) for
    // A, [K, 2K) for fc, [2K, 3K) for cont, 3K the loss
    float acc[P];
#pragma unroll
    for (int v = 0; v < P; ++v) acc[v] = 0.0f;
#pragma unroll
    for (int k = 0; k < kSlots; ++k) {
      const int n = tid + k * NT;
      int j = -1;
#pragma unroll
      for (int i = 0; i < K; ++i) j = n >= ns[i] ? i : j;
      if (n >= F) j = -1;  // padding: H = 1, every term 0
      const Seg e = seg[j + 1];
      // rfc = 0 below fc_0, f = 0 on padding: log2 0 = -inf, so lg = 0
      const float lg = fmaxf(log2f(fv[k] * e.rfc), 0.0f);
      const float s = exp2f(e.aq * lg);
      const float H = s * e.cont;
      const float u = fmaf(H, av[k], nb[k]);  // H a - b: half of dS/dH
      acc[3 * K] = fmaf(H, u + nb[k], acc[3 * K]);
      const float us = u * s, t = us * e.cont;
      const float tA = t * lg, tF = n == e.tb ? 0.5f * t : t;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (j == i) {
          acc[i] += tA;
          acc[K + i] += tF;
          acc[2 * K + i] += us;
        }
      }
    }
    halve_sum<P, 16>(acc, lane);
    if constexpr (P >= 32) {
#pragma unroll
      for (int v = 0; v < P / 32; ++v) red[warp][lane * (P / 32) + v] = acc[v];
    } else {
      if (lane % (32 / P) == 0) red[warp][lane / (32 / P)] = acc[0];
    }
    __syncthreads();
    int stop = 0;  // warp 0 lane 0: the mean steps fell below tol
    if (warp == 0) {
      // the state the update reads, loaded ahead of the sums it waits on
      const int me = lane < K ? lane : 0;
      float ofc[K], oA[K], xA[K], xF[K], xS[K];
      int jps[K];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        ofc[i] = st.fc[i];
        oA[i] = st.A[i];
        jps[i] = st.jp[i];
        xA[i] = st.xA[i];
        xF[i] = st.xF[i];
        xS[i] = st.xS[i];
      }
      const float gfm = st.gf[me], fcm = st.fc[me], Am = st.A[me];
      // column c of the warps' rows summed by lane c % 32, then gathered
      float lo = 0.0f, hi = 0.0f;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        if (lane < P) lo += red[w][lane % P];
        if (P > 32) hi += red[w][(lane + 32) % P];
      }
      auto col = [&](int c) {  // c the same in every lane
        return c < 32 ? __shfl_sync(kFull, lo, c)
                      : __shfl_sync(kFull, hi, c - 32);
      };
      auto col_at = [&](int c) {  // c this lane's own
        const float l = __shfl_sync(kFull, lo, c & 31);
        const float h = __shfl_sync(kFull, hi, c & 31);
        return c < 32 ? l : h;
      };
      const float S = col(3 * K) + ctot;
      // d sqrt(clamp(S, 1e-12)) / dS (clamp passes the gradient at >=),
      // times 2: the sums hold half of dS/dH
      const float dLdS = S >= 1e-12f ? 1.0f / sqrtf(S) : 0.0f;
      // back through the chain factors, last breakpoint first: the cont
      // gradients on registers in every lane, then what lane i's A and fc
      // receive from the factors chained on breakpoint i
      float gc[K];
#pragma unroll
      for (int i = 0; i < K; ++i) gc[i] = dLdS * col(2 * K + i);
#pragma unroll
      for (int i = K - 1; i >= 1; --i) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (k < i && jps[i] == k) gc[k] = fmaf(gc[i], xS[i], gc[k]);
      }
      float gA = dLdS * kLn10Over20 * col_at(me);
      float gfc = dLdS * gfm * col_at(K + me);
#pragma unroll
      for (int i = 1; i < K; ++i) {
        if (jps[i] == lane) {
          gA = fmaf(gc[i], xA[i], gA);
          gfc = fmaf(gc[i], xF[i], gfc);
        }
      }
      // the step, then the sequential clamps and the mean steps on
      // registers gathered from the lanes
      const float sfc = __fsub_rn(fcm, __fmul_rn(p.mu0, gfc));
      const float sA = __fsub_rn(Am, __fmul_rn(p.mu1, gA));
      float nfc[K], nA[K];
#pragma unroll
      for (int i = 0; i < K; ++i) {
        nfc[i] = __shfl_sync(kFull, sfc, i);
        nA[i] = __shfl_sync(kFull, sA, i);
      }
      if (p.clamp_fc) {
        nfc[0] = fminf(fmaxf(nfc[0], p.fcmin), p.fcmax);
#pragma unroll
        for (int i = 1; i < K; ++i)
          nfc[i] = fminf(fmaxf(nfc[i], nfc[i - 1] + 1.0f), p.fcmax);
      }
      if (p.clamp_A) {
        nA[0] = fminf(fmaxf(nA[0], p.Amin),
                      p.only_negative_A ? -1.0f : p.Amax);
#pragma unroll
        for (int i = 1; i < K; ++i)
          nA[i] = fminf(fmaxf(nA[i], p.Amin),
                        p.only_negative_A ? nA[i - 1] : p.Amax);
      }
      float myfc = nfc[0], myA = nA[0];
#pragma unroll
      for (int i = 1; i < K; ++i) {
        myfc = lane == i ? nfc[i] : myfc;
        myA = lane == i ? nA[i] : myA;
      }
      __syncwarp();  // every lane has read st before it is rewritten
      // the next iteration's chain (harmless after the exit: the loop
      // reads only st.fc and st.A then)
      forward<K>(nfc, myfc, myA, fr, F, p.bin_scale, seg, nst, st,
                 lane);
      float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
      for (int i = 0; i < K; ++i) {
        d0 += fabsf(nfc[i] - ofc[i]);
        d1 += fabsf(nA[i] - oA[i]);
      }
      stop = lane == 0 && (d0 / K < p.tol0) && (d1 / K < p.tol1);
    }
    const int done = __syncthreads_or(stop);
    if (done) {  // the parameters freeze from here on
      ++it;
      break;
    }
  }
  if (tid < K) {
    p.p_out[tid] = st.fc[tid];
    p.p_out[K + tid] = st.A[tid];
  }
  if (tid == 0 && p.iters != nullptr) *p.iters = it;
}

template <int K>
int launch_k(const FitArgs& p, cudaStream_t st) {
  if (p.F <= kSlots * 128)
    fit_kernel<K, 128><<<1, 128, 0, st>>>(p);
  else
    fit_kernel<K, 256><<<1, 256, 0, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int babe_filter_fit(const void* stats, const void* freqs,
                               const void* p0, void* p_out, void* iters,
                               int F, int K, int max_iter, float mu0,
                               float mu1, float tol0, float tol1,
                               int clamp_fc, int clamp_A, int only_negative_A,
                               float fcmin, float fcmax, float Amin,
                               float Amax, float bin_scale, void* stream) {
  if (K < 1 || K > kMaxK || F < 1 || F > kMaxF)
    return (int)cudaErrorInvalidValue;
  const FitArgs p{static_cast<const float*>(stats),
                  static_cast<const float*>(freqs),
                  static_cast<const float*>(p0),
                  static_cast<float*>(p_out),
                  static_cast<int*>(iters),
                  F, K, max_iter, mu0, mu1, tol0, tol1, clamp_fc, clamp_A,
                  only_negative_A, fcmin, fcmax, Amin, Amax, bin_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 1: return launch_k<1>(p, st);
    case 2: return launch_k<2>(p, st);
    case 3: return launch_k<3>(p, st);
    case 4: return launch_k<4>(p, st);
    case 5: return launch_k<5>(p, st);
    case 6: return launch_k<6>(p, st);
    case 7: return launch_k<7>(p, st);
    case 8: return launch_k<8>(p, st);
    case 9: return launch_k<9>(p, st);
    case 10: return launch_k<10>(p, st);
    case 11: return launch_k<11>(p, st);
    case 12: return launch_k<12>(p, st);
    case 13: return launch_k<13>(p, st);
    case 14: return launch_k<14>(p, st);
    case 15: return launch_k<15>(p, st);
    case 16: return launch_k<16>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}
