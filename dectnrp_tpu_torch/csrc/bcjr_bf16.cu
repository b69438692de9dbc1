// Sliding-window max-log-MAP BCJR with bf16 state metrics, for Hopper.
//
// Replaces dectnrp_tpu/phy/fec/bcjr_pallas.py::_pallas_bcjr_call_bf16 (the
// TPU kernel behind bcjr_posterior_pallas_cm(..., bf16=True), reached by
// turbo_decode(impl="pallas_bf16")) and computes what it computes: the
// windowed BCJR of bcjr.cu (Lw-step windows, D acquisition steps on either
// side, zero-state trellis ends, uniform window edges, steps outside
// [0, K+3) leave the metrics unchanged) with
//   - branch metrics 0.5 * (+-Lsys +- Lp) computed in float32 and rounded to
//     bf16 once per step (four values: the LTE RSC has four distinct edges);
//   - bf16 alpha/beta updates: max of two bf16 sums per state;
//   - the state-0 metric subtracted after every group of 4 trellis steps, in
//     both passes (beta groups run t = T-4-4i+k, k = 3..0, T = Lw + 2D);
//   - posterior ((alpha + gamma) + beta) in bf16, max over the 8 states per
//     input bit in float32, hi - lo in float32.
// The TPU kernel packs two codeblock groups into one [16, CT] bf16 tile (a
// sublane trick); here one thread owns one codeblock, with the same
// arithmetic. Each bf16 op rounds once to nearest even, as the plain twin
// (bcjr_cuda.bcjr_windowed_cm_bf16_plain) does: the two agree bit for bit.
// The TPU kernel's last D beta steps (t < D) reach no output and are not run.
//
// Mapping: ONE THREAD PER (codeblock, window), as in bcjr.cu: blockIdx.y is
// the window, threadIdx.x + 32*blockIdx.x the codeblock, so a warp's LLR
// loads coalesce in the column-major [K+3, B] layout. The 8 state metrics
// are four __nv_bfloat162 registers updated with __hadd2 / __hmax2; the
// state permutations of the trellis are register moves (compile-time
// indices). The Lw pre-update alphas go to shared memory as bf16 pairs,
// laid out [step][pair][thread] (a warp's 4-byte accesses hit 32 banks):
// 2 KB a thread at Lw = 128, 64 KB per 32-thread block, so three blocks fit
// an SM where bcjr.cu's 4 KB a thread fits one.
//
// Bound: latency, as bcjr.cu: a thread's 2(Lw + D) steps are one dependency
// chain and residency is capped by shared memory (3 x 32 threads an SM).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NS = 8;        // trellis states
constexpr int NP = NS / 2;   // bf16 pairs holding them
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

typedef __nv_bfloat16 bf;
typedef __nv_bfloat162 bf2;

__device__ __forceinline__ bf el(const bf2 (&v)[NP], int i) {
  return (i & 1) ? v[i >> 1].y : v[i >> 1].x;
}
__device__ __forceinline__ bf2 pair(const bf2 (&v)[NP], int i, int j) {
  return __halves2bfloat162(el(v, i), el(v, j));
}

// g[c][z] = bf16(0.5 * (sgn_c * Lsys + sgn_z * Lp)), sgn = +-1: signed adds
// in float32 (no FMA can contract them), one rounding to bf16 each
struct Gam {
  bf v[2][2];
  __device__ __forceinline__ Gam(float ls, float lp) {
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int z = 0; z < 2; ++z)
        v[c][z] = __float2bfloat16_rn(0.5f * ((c ? ls : -ls) + (z ? lp : -lp)));
  }
  __device__ __forceinline__ bf2 two(int c0, int z0, int c1, int z1) const {
    return __halves2bfloat162(v[c0][z0], v[c1][z1]);
  }
};

// subtract the state-0 metric from all 8
__device__ __forceinline__ void renorm(bf2 (&v)[NP]) {
  const bf2 r = __bfloat162bfloat162(v[0].x);
#pragma unroll
  for (int k = 0; k < NP; ++k) v[k] = __hsub2(v[k], r);
}

__device__ __forceinline__ void init_metrics(bf2 (&v)[NP], bool zero_state) {
  const bf neg = __float2bfloat16_rn(NEG), zero = __float2bfloat16_rn(0.f);
  v[0] = __halves2bfloat162(zero, zero_state ? neg : zero);
#pragma unroll
  for (int k = 1; k < NP; ++k) v[k] = zero_state ? __bfloat162bfloat162(neg)
                                                 : __bfloat162bfloat162(zero);
}

__global__ void __launch_bounds__(CB)
bcjr_bf16_kernel(const float* __restrict__ lsys, const float* __restrict__ lpar,
                 float* __restrict__ post, int K, int B, int Lw, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf2* alpha_sm = reinterpret_cast<bf2*>(smem_raw);   // [Lw][NP][CB]
  const int tid = threadIdx.x;
  const int cb = blockIdx.x * CB + tid;
  const int w = blockIdx.y;
  if (cb >= B) return;                                // threads share no data
  const int Kt = K + 3;
  const int p0 = w * Lw - D;                          // position of window step 0

  bf2 a[NP];
  init_metrics(a, w == 0);
  for (int t = 0; t < D + Lw; ++t) {
    if (t >= D) {
#pragma unroll
      for (int k = 0; k < NP; ++k) alpha_sm[((t - D) * NP + k) * CB + tid] = a[k];
    }
    const int pos = p0 + t;
    if (pos >= 0 && pos < Kt) {
      const Gam g(lsys[(size_t)pos * B + cb], lpar[(size_t)pos * B + cb]);
      bf2 an[NP];
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int s0 = 2 * k, s1 = 2 * k + 1;
        const int q00 = pred_s(s0, 0), q10 = pred_s(s1, 0);
        const int q01 = pred_s(s0, 1), q11 = pred_s(s1, 1);
        const int c00 = pred_c(s0, 0), c10 = pred_c(s1, 0);
        const int c01 = pred_c(s0, 1), c11 = pred_c(s1, 1);
        const bf2 e0 = __hadd2(pair(a, q00, q10),
                               g.two(c00, out_z(q00, c00), c10, out_z(q10, c10)));
        const bf2 e1 = __hadd2(pair(a, q01, q11),
                               g.two(c01, out_z(q01, c01), c11, out_z(q11, c11)));
        an[k] = __hmax2(e0, e1);
      }
#pragma unroll
      for (int k = 0; k < NP; ++k) a[k] = an[k];
    }
    if ((t & 3) == 3) renorm(a);
  }

  bf2 b[NP];
  init_metrics(b, (w + 1) * Lw + D >= Kt);
  for (int t = Lw + 2 * D - 1; t >= D; --t) {
    const int pos = p0 + t;
    if (pos >= 0 && pos < Kt) {
      const Gam g(lsys[(size_t)pos * B + cb], lpar[(size_t)pos * B + cb]);
      bf2 bs0[NP], bs1[NP], g0[NP], g1[NP];
#pragma unroll
      for (int k = 0; k < NP; ++k) {
        const int s0 = 2 * k, s1 = 2 * k + 1;
        bs0[k] = pair(b, nxt_state(s0, 0), nxt_state(s1, 0));
        bs1[k] = pair(b, nxt_state(s0, 1), nxt_state(s1, 1));
        g0[k] = g.two(0, out_z(s0, 0), 0, out_z(s1, 0));
        g1[k] = g.two(1, out_z(s0, 1), 1, out_z(s1, 1));
      }
      if (t < D + Lw && pos < K) {
        // b holds beta_{pos+1}; posterior at pos with the stored alpha_pos
        const int j = t - D;
        bf2 e1[NP], e0[NP];
#pragma unroll
        for (int k = 0; k < NP; ++k) {
          const bf2 ak = alpha_sm[(j * NP + k) * CB + tid];
          e1[k] = __hadd2(__hadd2(ak, g1[k]), bs1[k]);
          e0[k] = __hadd2(__hadd2(ak, g0[k]), bs0[k]);
        }
        const bf2 hi2 = __hmax2(__hmax2(e1[0], e1[1]), __hmax2(e1[2], e1[3]));
        const bf2 lo2 = __hmax2(__hmax2(e0[0], e0[1]), __hmax2(e0[2], e0[3]));
        const float hi = fmaxf(__low2float(hi2), __high2float(hi2));
        const float lo = fmaxf(__low2float(lo2), __high2float(lo2));
        post[(size_t)pos * B + cb] = hi - lo;
      }
#pragma unroll
      for (int k = 0; k < NP; ++k)
        b[k] = __hmax2(__hadd2(bs0[k], g0[k]), __hadd2(bs1[k], g1[k]));
    }
    if ((t & 3) == 0) renorm(b);
  }
}

}  // namespace

// Lsys, Lp: float32 [K+3, B] row-major (step x codeblock); post: [K, B].
// Needs (Lw + 2D) % 4 == 0 and (D + Lw) % 4 == 0 (the 4-step renormalization
// groups). Launches on `stream`; returns the cudaError_t of the launch.
extern "C" int bcjr_posterior_cm_bf16(const void* lsys, const void* lp, void* post,
                                      int K, int B, int Lw, int D, void* stream) {
  if (K <= 0 || B <= 0 || Lw <= 0 || D < 0 || (Lw + 2 * D) % 4 || (D + Lw) % 4)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)Lw * NP * CB * sizeof(bf2);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      bcjr_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int W = (K + 3 + Lw - 1) / Lw;
  dim3 grid((B + CB - 1) / CB, W);
  bcjr_bf16_kernel<<<grid, CB, smem, (cudaStream_t)stream>>>(
      (const float*)lsys, (const float*)lp, (float*)post, K, B, Lw, D);
  return (int)cudaGetLastError();
}
