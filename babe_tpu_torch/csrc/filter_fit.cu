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
// MFLOP per fit); the cost is the serial chain of max_iter iterations, each
// a block-wide reduction.  One block keeps the whole loop on the card with
// no host round trip or per-iteration launches.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxK = 16;
constexpr int kMaxF = 8192;
constexpr float kLn10Over20 = 0.11512925464970229f;  // ln(10) / 20
constexpr float kLn2 = 0.6931471805599453f;

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
};

// seg_i(f) and its partial derivatives by A_i and fc_i
__device__ __forceinline__ void segment(float f, float fc, float A,
                                        float* seg, float* dA, float* dfc) {
  const float fci = fmaxf(fc, 1e-9f);
  const float lg = log2f(fmaxf(f, fci) / fci);
  const float s = powf(10.0f, A * lg / 20.0f);
  *seg = s;
  *dA = s * kLn10Over20 * lg;
  // d lg / d fc: -1/(fci ln2) past the breakpoint, half of that at a tie
  // (torch.maximum splits the gradient), zero where the 1e-9 clamp holds
  const float w = (f > fci) ? 1.0f : 0.5f;
  *dfc = (fc >= 1e-9f) ? s * kLn10Over20 * A * (-w / (fci * kLn2)) : 0.0f;
}

__global__ void __launch_bounds__(kThreads) filter_fit_kernel(FitArgs p) {
  __shared__ float fr[kMaxF];
  __shared__ float pv[2][kMaxK];
  __shared__ float red[32][3 * kMaxK + 1];
  __shared__ float tot[3 * kMaxK + 1];
  __shared__ int done;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int F = p.F, K = p.K, NV = 3 * K + 1;
  const float* a = p.stats;
  const float* bb = p.stats + F;
  const float* cc = p.stats + 2 * F;
  for (int i = tid; i < F; i += kThreads) fr[i] = p.freqs[i];
  if (tid < 2 * K) pv[tid / K][tid % K] = p.p0[tid];
  if (tid == 0) done = 0;
  __syncthreads();

  int it = 0;
  for (; it < p.max_iter; ++it) {
    float fc[kMaxK], A[kMaxK], cont[kMaxK], fst[kMaxK];
    int jprev[kMaxK];
    for (int i = 0; i < K; ++i) {
      fc[i] = pv[0][i];
      A[i] = pv[1][i];
    }
    // the chain factors, in order: cont_i = H_{i-1}(f*_i)
    cont[0] = 1.0f;
    jprev[0] = -1;
    fst[0] = 0.0f;
    for (int i = 1; i < K; ++i) {
      cont[i] = 1.0f;
      jprev[i] = -1;
      fst[i] = 0.0f;
      if (!(fr[F - 1] >= fc[i])) continue;  // empty mask: H unchanged
      int lo = 0, hi = F - 1;  // first bin >= fc_i
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (fr[mid] >= fc[i]) hi = mid; else lo = mid + 1;
      }
      const float f = fr[lo];
      fst[i] = f;
      for (int k = i - 1; k >= 0; --k) {
        if (f >= fc[k]) {
          float s, dA, dfc;
          segment(f, fc[k], A[k], &s, &dA, &dfc);
          cont[i] = s * cont[k];
          jprev[i] = k;
          break;
        }
      }
    }
    // per-bin terms: loss sum and the sums the gradient needs, per segment
    float acc[3 * kMaxK + 1];
    for (int v = 0; v < NV; ++v) acc[v] = 0.0f;
    for (int n = tid; n < F; n += kThreads) {
      const float f = fr[n];
      int j = -1;
      for (int i = 0; i < K; ++i)
        if (f >= fc[i]) j = i;
      float H = 1.0f, s = 0.0f, dA = 0.0f, dfc = 0.0f;
      if (j >= 0) {
        segment(f, fc[j], A[j], &s, &dA, &dfc);
        H = s * cont[j];
      }
      acc[NV - 1] += H * H * a[n] - 2.0f * H * bb[n] + cc[n];
      if (j >= 0) {
        const float gH = 2.0f * H * a[n] - 2.0f * bb[n];  // dS/dH
        acc[j] += gH * cont[j] * dA;
        acc[K + j] += gH * cont[j] * dfc;
        acc[2 * K + j] += gH * s;
      }
    }
    // block reduction of the NV sums
    for (int v = 0; v < NV; ++v) {
      float x = acc[v];
      for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffff, x, o);
      if (lane == 0) red[warp][v] = x;
    }
    __syncthreads();
    if (tid < NV) {
      float x = 0.0f;
      for (int w = 0; w < kThreads / 32; ++w) x += red[w][tid];
      tot[tid] = x;
    }
    __syncthreads();
    if (tid == 0) {
      const float S = tot[NV - 1];
      // d sqrt(clamp(S, 1e-12)) / dS (clamp passes the gradient at >=)
      const float dLdS = (S >= 1e-12f) ? 0.5f / sqrtf(S) : 0.0f;
      float gA[kMaxK], gfc[kMaxK], gcont[kMaxK];
      for (int i = 0; i < K; ++i) {
        gA[i] = dLdS * tot[i];
        gfc[i] = dLdS * tot[K + i];
        gcont[i] = dLdS * tot[2 * K + i];
      }
      // back through the chain factors, last breakpoint first
      for (int i = K - 1; i >= 1; --i) {
        const int k = jprev[i];
        if (k < 0) continue;
        float s, dA, dfc;
        segment(fst[i], fc[k], A[k], &s, &dA, &dfc);
        gA[k] += gcont[i] * cont[k] * dA;
        gfc[k] += gcont[i] * cont[k] * dfc;
        gcont[k] += gcont[i] * s;
      }
      // the step and the sequential clamps
      float nfc[kMaxK], nA[kMaxK];
      for (int i = 0; i < K; ++i) {
        nfc[i] = fc[i] - p.mu0 * gfc[i];
        nA[i] = A[i] - p.mu1 * gA[i];
      }
      if (p.clamp_fc) {
        nfc[0] = fminf(fmaxf(nfc[0], p.fcmin), p.fcmax);
        for (int i = 1; i < K; ++i)
          nfc[i] = fminf(fmaxf(nfc[i], nfc[i - 1] + 1.0f), p.fcmax);
      }
      if (p.clamp_A) {
        nA[0] = fminf(fmaxf(nA[0], p.Amin),
                      p.only_negative_A ? -1.0f : p.Amax);
        for (int i = 1; i < K; ++i)
          nA[i] = fminf(fmaxf(nA[i], p.Amin),
                        p.only_negative_A ? nA[i - 1] : p.Amax);
      }
      float d0 = 0.0f, d1 = 0.0f;
      for (int i = 0; i < K; ++i) {
        d0 += fabsf(nfc[i] - fc[i]);
        d1 += fabsf(nA[i] - A[i]);
      }
      for (int i = 0; i < K; ++i) {
        pv[0][i] = nfc[i];
        pv[1][i] = nA[i];
      }
      done = (d0 / K < p.tol0) && (d1 / K < p.tol1);
    }
    __syncthreads();
    if (done) {  // the parameters freeze from here on
      ++it;
      break;
    }
  }
  if (tid < 2 * K) p.p_out[tid] = pv[tid / K][tid % K];
  if (tid == 0 && p.iters != nullptr) *p.iters = it;
}

}  // namespace

extern "C" int babe_filter_fit(const void* stats, const void* freqs,
                               const void* p0, void* p_out, void* iters,
                               int F, int K, int max_iter, float mu0,
                               float mu1, float tol0, float tol1,
                               int clamp_fc, int clamp_A, int only_negative_A,
                               float fcmin, float fcmax, float Amin,
                               float Amax, void* stream) {
  if (K < 1 || K > kMaxK || F < 1 || F > kMaxF)
    return (int)cudaErrorInvalidValue;
  FitArgs p{static_cast<const float*>(stats),
            static_cast<const float*>(freqs),
            static_cast<const float*>(p0),
            static_cast<float*>(p_out),
            static_cast<int*>(iters),
            F, K, max_iter, mu0, mu1, tol0, tol1, clamp_fc, clamp_A,
            only_negative_A, fcmin, fcmax, Amin, Amax};
  filter_fit_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}
