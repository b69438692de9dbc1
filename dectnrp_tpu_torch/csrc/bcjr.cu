// Sliding-window max-log-MAP BCJR over the 8-state LTE RSC trellis, for Hopper.
//
// Replaces dectnrp_tpu/phy/fec/bcjr_pallas.py::_pallas_bcjr_call (the TPU
// kernel behind bcjr_posterior_pallas_cm) and computes what it computes:
// windows of Lw trellis steps, each acquiring its boundary metrics over D
// steps on either side; the trellis ends start in the zero state, window
// boundaries uniform; steps outside [0, K+3) leave the metrics unchanged;
// the posterior is max over the c=1 edges minus max over the c=0 edges.
// Metrics are renormalized every step (subtract the max over the 8 states),
// as the plain twin turbo_jax._bcjr_posterior_windowed does.
//
// Mapping: ONE THREAD PER (codeblock, window) pair. blockIdx.y is the
// window, threadIdx.x + 32*blockIdx.x the codeblock, so the 32 threads of a
// warp read neighbouring codeblocks of one trellis row: every LLR load
// coalesces in the column-major [K+3, B] layout. Gammas are recomputed per
// step from the two LLR loads (never stored); the forward pass keeps its Lw
// pre-update alpha vectors in shared memory (Lw*8 floats = 4 KB a thread at
// Lw = 128, laid out [step][state][thread] so a warp's accesses hit 32
// distinct banks); the backward pass is fused with the posterior and writes
// only [K, B].
//
// Bound: latency. A thread's 2*(Lw+D) steps are a serial dependency chain,
// and 4 KB of shared memory per thread caps residency at one 32-thread block
// (128 KB) per SM. The design accepts that for a first, simple kernel; the
// next step is 8 lanes per pair (one state per lane, shuffles for the
// permutations), which keeps the same shared memory per pair with 8x the
// threads in flight.
#include <cuda_runtime.h>

namespace {

constexpr int NS = 8;        // trellis states
constexpr int CB = 32;       // codeblocks (threads) per block
constexpr float NEG = -1e30f;

// state s = (r1<<2)|(r2<<1)|r3; a = c^r2^r3; z = a^r1^r3; next = (a<<2)|(r1<<1)|r2
__host__ __device__ constexpr int nxt_state(int s, int c) {
  return ((c ^ ((s >> 1) & 1) ^ (s & 1)) << 2) | (((s >> 2) & 1) << 1) | ((s >> 1) & 1);
}
__host__ __device__ constexpr int out_z(int s, int c) {
  return c ^ ((s >> 1) & 1) ^ (s & 1) ^ ((s >> 2) & 1) ^ (s & 1);
}
// the two predecessors of state s (edge j has r3 = j) and their input bits
__host__ __device__ constexpr int pred_s(int s, int j) {
  return (((s >> 1) & 1) << 2) | ((s & 1) << 1) | j;
}
__host__ __device__ constexpr int pred_c(int s, int j) {
  return ((s >> 2) & 1) ^ (s & 1) ^ j;
}

// gamma(s, c) = 0.5 * (sgn_c * Lsys + sgn_z * Lp) with sgn = +-1: written as
// signed adds so the rounding equals the plain twin's (no FMA contraction)
__device__ __forceinline__ float gam(int c, int z, float ls, float lp) {
  return 0.5f * ((c ? ls : -ls) + (z ? lp : -lp));
}

__global__ void __launch_bounds__(CB)
bcjr_kernel(const float* __restrict__ lsys, const float* __restrict__ lpar,
            float* __restrict__ post, int K, int B, int Lw, int D) {
  extern __shared__ float alpha_sm[];                 // [Lw][NS][CB]
  const int tid = threadIdx.x;
  const int cb = blockIdx.x * CB + tid;
  const int w = blockIdx.y;
  if (cb >= B) return;                                // threads share no data
  const int Kt = K + 3;

  float a[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) a[s] = (w == 0 && s > 0) ? NEG : 0.f;

  const int p0 = w * Lw - D;
  for (int t = 0; t < D + Lw; ++t) {
    if (t >= D) {
#pragma unroll
      for (int s = 0; s < NS; ++s) alpha_sm[((t - D) * NS + s) * CB + tid] = a[s];
    }
    const int pos = p0 + t;
    if (pos >= 0 && pos < Kt) {
      const float ls = lsys[(size_t)pos * B + cb];
      const float lp = lpar[(size_t)pos * B + cb];
      float an[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const int q0 = pred_s(s, 0), q1 = pred_s(s, 1);
        const int c0 = pred_c(s, 0), c1 = pred_c(s, 1);
        an[s] = fmaxf(a[q0] + gam(c0, out_z(q0, c0), ls, lp),
                      a[q1] + gam(c1, out_z(q1, c1), ls, lp));
      }
      float m = an[0];
#pragma unroll
      for (int s = 1; s < NS; ++s) m = fmaxf(m, an[s]);
#pragma unroll
      for (int s = 0; s < NS; ++s) a[s] = an[s] - m;
    }
  }

  float b[NS];
  const bool reaches_end = (w + 1) * Lw + D >= Kt;
#pragma unroll
  for (int s = 0; s < NS; ++s) b[s] = (reaches_end && s > 0) ? NEG : 0.f;

  const int pb = (w + 1) * Lw + D - 1;
  for (int t = 0; t < Lw + D; ++t) {
    const int pos = pb - t;
    if (pos < 0 || pos >= Kt) continue;
    const float ls = lsys[(size_t)pos * B + cb];
    const float lp = lpar[(size_t)pos * B + cb];
    if (t >= D && pos < K) {
      // b holds beta_{pos+1}; posterior at pos with the stored alpha_pos
      const int k = pos - w * Lw;
      float m0 = NEG, m1 = NEG;
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float as = alpha_sm[(k * NS + s) * CB + tid];
        m0 = fmaxf(m0, as + gam(0, out_z(s, 0), ls, lp) + b[nxt_state(s, 0)]);
        m1 = fmaxf(m1, as + gam(1, out_z(s, 1), ls, lp) + b[nxt_state(s, 1)]);
      }
      post[(size_t)pos * B + cb] = m1 - m0;
    }
    float bn[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s)
      bn[s] = fmaxf(b[nxt_state(s, 0)] + gam(0, out_z(s, 0), ls, lp),
                    b[nxt_state(s, 1)] + gam(1, out_z(s, 1), ls, lp));
    float m = bn[0];
#pragma unroll
    for (int s = 1; s < NS; ++s) m = fmaxf(m, bn[s]);
#pragma unroll
    for (int s = 0; s < NS; ++s) b[s] = bn[s] - m;
  }
}

}  // namespace

// Lsys, Lp: float32 [K+3, B] row-major (step x codeblock); post: [K, B].
// Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int bcjr_posterior_cm(const void* lsys, const void* lp, void* post,
                                 int K, int B, int Lw, int D, void* stream) {
  if (K <= 0 || B <= 0 || Lw <= 0 || D < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Lw * NS * CB * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      bcjr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int W = (K + 3 + Lw - 1) / Lw;
  dim3 grid((B + CB - 1) / CB, W);
  bcjr_kernel<<<grid, CB, smem, (cudaStream_t)stream>>>(
      (const float*)lsys, (const float*)lp, (float*)post, K, B, Lw, D);
  return (int)cudaGetLastError();
}
