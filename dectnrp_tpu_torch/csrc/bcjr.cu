// Sliding-window max-log-MAP BCJR over the 8-state LTE RSC trellis, for Hopper.
//
// Replaces dectnrp_tpu/phy/fec/bcjr_pallas.py::_pallas_bcjr_call (the TPU
// kernel behind bcjr_posterior_pallas_cm) and computes what it computes:
// windows of Lw trellis steps, each acquiring its boundary metrics over D
// steps on either side; the trellis ends start in the zero state, window
// boundaries uniform; steps outside [0, K+3) leave the metrics unchanged;
// the posterior is max over the c=1 edges minus max over the c=0 edges.
// Metrics are renormalized every step (subtract the max over the 8 states),
// as the plain twin turbo_jax._bcjr_posterior_windowed does. Run as ONE
// window (Lw >= K+3: zero-state starts at both ends, no acquisition) it is
// the unwindowed BCJR of turbo._bcjr_posterior, bit for bit: the PCC decode
// (K = 56, 96) and every other decode below 512 bits go through it so.
//
// Mapping: ONE THREAD PER (codeblock, window) pair, all 8 state metrics in
// registers, so a trellis step is 8 independent add-add-max chains and the
// state permutations are register moves (no shuffles). blockIdx.y is the
// window, threadIdx.x + 32*blockIdx.x the codeblock: the 32 threads of a
// warp read neighbouring codeblocks of one trellis row, so every LLR load
// coalesces in the column-major [K+3, B] layout. Threads share no data.
//
// What bounds it, and what the design does about it. A thread's trellis
// steps are one serial dependency chain, so the kernel is bound by latency:
// the time of one step times the steps of a window, over the warps an SM
// can keep in flight.
//  1. No device-memory load sits in the chain. The LLR rows are fetched
//     through registers a chunk of CH = 8 steps ahead (16 independent
//     coalesced loads started before the 8 steps that hide them), in both
//     passes. A step then costs its ~45 arithmetic instructions.
//  2. Alpha checkpoints raise the threads in flight. The forward pass
//     stores only every C-th alpha vector ([checkpoint][state][thread]
//     floats: a warp's access is 32 consecutive words, one wavefront, no
//     bank conflict); the backward pass reloads a checkpoint and recomputes
//     the C-1 vectors after it with the forward pass's own instructions on
//     the same inputs, hence the same bits. Shared memory falls from 4 KB a
//     thread (one warp an SM) to 4/C KB at Lw = 128. With C = 8 a block
//     asks for 16 KB (128 registers a thread, no spills) and 13 one-warp
//     blocks share an SM (bcjr_blocks_per_sm, the occupancy calculator's
//     answer on an H100), so the 1,222 blocks of a K = 6016 x 832 call,
//     9.3 an SM, run as one wave, for (C-1)/C of a forward pass in extra
//     arithmetic.
//     Checkpoints were chosen over 8 lanes per pair because the lane
//     mapping pays 5 to 11 dependent warp shuffles a step (one shuffle per
//     clock and SM: a floor near 0.1 ms at K = 6016 x 832), while this one
//     keeps the chain in registers and only adds independent arithmetic.
//     Measured at K = 6016 x 832 on an H100 (700 W): C = 1, 2, 4, 8 took
//     0.415, 0.178, 0.103, 0.084 ms; C = 8 is built in.
//  3. No wasted steps. Both passes run over the valid positions only: the
//     forward pass from max(0, w Lw - D) to the window's last checkpoint,
//     the backward pass from min((w+1) Lw + D, K+3) down; a window that holds
//     only tail steps (K a multiple of Lw) exits at once.
// Arithmetic is unchanged: branch metrics 0.5 * (+-Lsys +- Lp) by signed
// adds, one add per candidate, (alpha + gamma) + beta in the posterior.
// The only product is the exact scaling by 0.5, so a contraction into an
// FMA rounds as the separate ops do. fmaxf is exact in any order.
#include <cuda_runtime.h>

namespace {

constexpr int NS = 8;        // trellis states
constexpr int CB = 32;       // codeblocks (threads) per block
constexpr int CH = 8;        // trellis rows fetched ahead per chunk
constexpr int C = 8;         // every C-th alpha vector is kept (checkpoints)
static_assert(CH % C == 0, "checkpoint groups must tile a chunk");
constexpr float NEG = -1e30f;
constexpr size_t SMEM_MAX = 232448;   // dynamic shared memory a block may ask for

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
// signed adds so the rounding equals the plain twin's
__device__ __forceinline__ float gam(int c, int z, float ls, float lp) {
  return 0.5f * ((c ? ls : -ls) + (z ? lp : -lp));
}

__device__ __forceinline__ void init_metrics(float (&v)[NS], bool zero_state) {
#pragma unroll
  for (int s = 0; s < NS; ++s) v[s] = (zero_state && s > 0) ? NEG : 0.f;
}

// subtract the max over the 8 states (a depth-3 tree: fmaxf is exact)
__device__ __forceinline__ void renorm(float (&v)[NS], const float (&n)[NS]) {
  const float m = fmaxf(fmaxf(fmaxf(n[0], n[1]), fmaxf(n[2], n[3])),
                        fmaxf(fmaxf(n[4], n[5]), fmaxf(n[6], n[7])));
#pragma unroll
  for (int s = 0; s < NS; ++s) v[s] = n[s] - m;
}

// out = alpha after the trellis step with LLRs (ls, lp), from alpha a
__device__ __forceinline__ void alpha_step(float (&out)[NS], const float (&a)[NS],
                                           float ls, float lp) {
  float an[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int q0 = pred_s(s, 0), q1 = pred_s(s, 1);
    const int c0 = pred_c(s, 0), c1 = pred_c(s, 1);
    an[s] = fmaxf(a[q0] + gam(c0, out_z(q0, c0), ls, lp),
                  a[q1] + gam(c1, out_z(q1, c1), ls, lp));
  }
  renorm(out, an);
}

// b = beta before the trellis step with LLRs (ls, lp), from the beta after it
__device__ __forceinline__ void beta_step(float (&b)[NS], float ls, float lp) {
  float bn[NS];
#pragma unroll
  for (int s = 0; s < NS; ++s)
    bn[s] = fmaxf(b[nxt_state(s, 0)] + gam(0, out_z(s, 0), ls, lp),
                  b[nxt_state(s, 1)] + gam(1, out_z(s, 1), ls, lp));
  renorm(b, bn);
}

// posterior of the step's input bit from alpha before it and beta after it
__device__ __forceinline__ float posterior(const float (&a)[NS], const float (&b)[NS],
                                           float ls, float lp) {
  float m0 = NEG, m1 = NEG;
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    m0 = fmaxf(m0, a[s] + gam(0, out_z(s, 0), ls, lp) + b[nxt_state(s, 0)]);
    m1 = fmaxf(m1, a[s] + gam(1, out_z(s, 1), ls, lp) + b[nxt_state(s, 1)]);
  }
  return m1 - m0;
}

// CH trellis rows of one codeblock column; rows outside [lo, hi) read as 0
// and are never used
struct Rows {
  float s[CH], p[CH];
  __device__ __forceinline__ void load(const float* __restrict__ lsys,
                                       const float* __restrict__ lpar,
                                       int pos0, int lo, int hi, int B, int col) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int pos = pos0 + i;
      const bool ok = pos >= lo && pos < hi;
      s[i] = ok ? __ldg(lsys + (size_t)pos * B + col) : 0.f;
      p[i] = ok ? __ldg(lpar + (size_t)pos * B + col) : 0.f;
    }
  }
};

__global__ void __launch_bounds__(CB)
bcjr_kernel(const float* __restrict__ lsys, const float* __restrict__ lpar,
            float* __restrict__ post, int K, int B, int Lw, int D) {
  extern __shared__ float alpha_sm[];                 // [ceil(Lw/C)][NS][CB]
  const int tid = threadIdx.x;
  const int cb = blockIdx.x * CB + tid;
  const int col = min(cb, B - 1);                     // ragged block: loads clamped,
  const bool live = cb < B;                           // stores guarded
  const int w = blockIdx.y;
  const int Kt = K + 3;
  const int w0 = w * Lw;                              // first output position
  const int oe = min(w0 + Lw, K);                     // end of the outputs
  if (oe <= w0) return;                               // tail steps only (whole block)
  const int fs = max(0, w0 - D);                      // first forward position
  const int be = min(w0 + Lw + D, Kt);                // end of the backward positions

  // forward: alpha from fs up to the last checkpoint (every C-th output
  // position; the backward pass recomputes what lies beyond it)
  const int fe = w0 + (oe - 1 - w0) / C * C + 1;
  float a[NS];
  init_metrics(a, w == 0);
  Rows cur, nxt;
  cur.load(lsys, lpar, fs, fs, fe, B, col);
  for (int p = fs; p < fe; p += CH) {
    nxt.load(lsys, lpar, p + CH, fs, fe, B, col);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int k = p + i - w0;
      if (p + i < fe) {
        if (k >= 0 && k % C == 0) {
#pragma unroll
          for (int s = 0; s < NS; ++s) alpha_sm[((k / C) * NS + s) * CB + tid] = a[s];
        }
        alpha_step(a, a, cur.s[i], cur.p[i]);
      }
    }
    cur = nxt;
  }

  // backward over [w0, be), in chunks of CH positions from w0, each chunk in
  // groups of C: a group with outputs reloads its checkpoint and recomputes
  // the alphas after it, then steps down through its positions
  float b[NS];
  init_metrics(b, w0 + Lw + D >= Kt);
  int base = w0 + (be - 1 - w0) / CH * CH;
  cur.load(lsys, lpar, base, w0, be, B, col);
  for (; base >= w0; base -= CH) {
    nxt.load(lsys, lpar, base - CH, w0, be, B, col);
#pragma unroll
    for (int j = CH / C - 1; j >= 0; --j) {
      const int gp = base + j * C;                    // the group's first position
      float ar[C][NS];
      if (gp < oe) {
        const int ck = (gp - w0) / C;
#pragma unroll
        for (int s = 0; s < NS; ++s) ar[0][s] = alpha_sm[(ck * NS + s) * CB + tid];
#pragma unroll
        for (int i = 1; i < C; ++i)
          alpha_step(ar[i], ar[i - 1], cur.s[j * C + i - 1], cur.p[j * C + i - 1]);
      }
#pragma unroll
      for (int i = C - 1; i >= 0; --i) {
        const int pos = gp + i;
        const float ls = cur.s[j * C + i], lp = cur.p[j * C + i];
        if (pos < be) {
          if (pos < oe) {
            // b holds beta_{pos+1}; ar[i] is alpha_pos
            const float o = posterior(ar[i], b, ls, lp);
            if (live) post[(size_t)pos * B + cb] = o;
          }
          beta_step(b, ls, lp);
        }
      }
    }
    cur = nxt;
  }
}

// shared memory of a block: the alpha checkpoints of one window
size_t smem_bytes(int Lw) {
  return (size_t)((Lw + C - 1) / C) * NS * CB * sizeof(float);
}

}  // namespace

// Lsys, Lp: float32 [K+3, B] row-major (step x codeblock); post: [K, B].
// A block keeps ceil(Lw / 8) alpha vectors of 1 KB in shared memory, which
// must fit 232,448 bytes. Launches on `stream`; returns the cudaError_t of
// the launch.
extern "C" int bcjr_posterior_cm(const void* lsys, const void* lp, void* post,
                                 int K, int B, int Lw, int D, void* stream) {
  if (K <= 0 || B <= 0 || Lw <= 0 || D < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Lw);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      bcjr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int W = (K + 3 + Lw - 1) / Lw;
  dim3 grid((B + CB - 1) / CB, W);
  bcjr_kernel<<<grid, CB, smem, (cudaStream_t)stream>>>(
      (const float*)lsys, (const float*)lp, (float*)post, K, B, Lw, D);
  return (int)cudaGetLastError();
}

// The blocks of bcjr_posterior_cm that one SM holds at a time for windows of
// Lw steps (the occupancy calculator's answer), or -1 on an error.
extern "C" int bcjr_blocks_per_sm(int Lw) {
  const size_t smem = smem_bytes(Lw);
  int n = 0;
  if (Lw <= 0 || smem > SMEM_MAX ||
      cudaFuncSetAttribute(bcjr_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bcjr_kernel, CB, smem) !=
          cudaSuccess)
    return -1;
  return n;
}
