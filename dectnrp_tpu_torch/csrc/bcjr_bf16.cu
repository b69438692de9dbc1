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
//
// Renormalisation by position. The wrapper asks (Lw + 2D) % 4 == 0 and
// (D + Lw) % 4 == 0, so Lw and D are multiples of 4 and a window step t
// lies at a position pos = w Lw - D + t with t = pos (mod 4): the forward
// pass renormalises after the steps at pos = 3 (mod 4), the backward pass
// after those at pos = 0 (mod 4), whatever step a loop starts from. A step
// outside [0, K+3) leaves the initial metrics, whose state 0 holds +0, and
// subtracting +0 changes no value (NEG - 0 = NEG): so such steps can be left
// out entirely, renormalisations included.
//
// Mapping: ONE THREAD PER (codeblock, window), as in bcjr.cu: blockIdx.y is
// the window, threadIdx.x + 32*blockIdx.x the codeblock, so a warp's LLR
// loads coalesce in the column-major [K+3, B] layout. The 8 state metrics
// are four __nv_bfloat162 registers updated with __hadd2 / __hmax2; the
// state permutations of the trellis are register moves (compile-time
// indices).
//
// What bounds it, and what the design does about it (bcjr.cu's three moves,
// in bf16). A thread's trellis steps are one serial dependency chain, so
// the kernel is bound by latency: the time of a step times the steps of a
// window, over the warps an SM keeps in flight.
//  1. No device-memory load sits in the chain. The LLR rows are fetched
//     through registers a chunk of CH = 8 rows (two renormalisation groups)
//     ahead, in both passes; a row's branch metrics are packed into bf16
//     pairs from the loaded values, off the chain. Deeper prefetch (a ring
//     of 4 to 8 chunks in shared memory, filled by cp.async) was timed
//     about 5% faster at best and is not used: the loads are not what is
//     left.
//  2. Alpha checkpoints: the forward pass keeps every C-th alpha vector as
//     four bf16 pairs, laid out [checkpoint][pair][thread] (a warp's access
//     is 32 consecutive words, one wavefront); the backward pass reloads a
//     checkpoint and recomputes the C-1 vectors after it with the forward
//     pass's own instructions, renormalisations included, hence the same
//     bits. C is a multiple of 4 and checkpoints lie at w Lw + kC, so each
//     starts a renormalisation group. Shared memory falls from 2 KB a
//     thread to 2/C KB at Lw = 128: 8 KB a 32-thread block at C = 8.
//  3. Valid steps only: the forward pass runs from max(0, w Lw - D) to the
//     window's last checkpoint, the backward pass from min((w+1) Lw + D,
//     K+3) down; only the ceil(K / Lw) windows that hold outputs are
//     launched, none of tail steps only.
// Measured on an H100 (700 W) by bcjr_bf16_turns, graph replay, window 128:
// 66.4 us at K = 6016 x 832 (the earlier design, every alpha of a window in
// shared memory and a load in each step of the chain: 432 us); 32.5-33 us at
// 50 to 192 codeblocks, under one block an SM, where one thread's chain is
// the time.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NS = 8;        // trellis states
constexpr int NP = NS / 2;   // bf16 pairs holding them
constexpr int CB = 32;       // codeblocks (threads) per block
constexpr int CH = 8;        // trellis rows fetched ahead per chunk
constexpr int C = 8;         // every C-th alpha vector is kept (checkpoints)
static_assert(CH % C == 0, "checkpoint groups must tile a chunk");
static_assert(C % 4 == 0 && CH % 4 == 0, "groups must hold whole renormalisation groups");
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

typedef __nv_bfloat16 bf;
typedef __nv_bfloat162 bf2;

__device__ __forceinline__ bf el(const bf2 (&v)[NP], int i) {
  return (i & 1) ? v[i >> 1].y : v[i >> 1].x;
}
__device__ __forceinline__ bf2 pair(const bf2 (&v)[NP], int i, int j) {
  return __halves2bfloat162(el(v, i), el(v, j));
}

// the branch metrics of one trellis row: f[c][z] = 0.5 * (sgn_c * Lsys +
// sgn_z * Lp), sgn = +-1, by signed adds in float32 (no FMA can contract
// them); two() packs two of them into a bf16 pair, each rounded once
struct Gam {
  float f[2][2];
  __device__ __forceinline__ Gam(float ls, float lp) {
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int z = 0; z < 2; ++z) f[c][z] = 0.5f * ((c ? ls : -ls) + (z ? lp : -lp));
  }
  __device__ __forceinline__ bf2 two(int c0, int z0, int c1, int z1) const {
    return __floats2bfloat162_rn(f[c0][z0], f[c1][z1]);
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

// out = alpha after the trellis step with branch metrics g, from alpha a
// (before the renormalisation its position may call for)
__device__ __forceinline__ void alpha_step(bf2 (&out)[NP], const bf2 (&a)[NP],
                                           const Gam& g) {
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
  for (int k = 0; k < NP; ++k) out[k] = an[k];
}

// CH trellis rows of one codeblock column; rows outside [lo, hi) read as 0
// and are never used
struct Rows {
  float s[CH], p[CH];
  __device__ __forceinline__ void load(const float* __restrict__ lsys,
                                       const float* __restrict__ lpar,
                                       int pos0, int lo, int hi, int B, int cb) {
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int pos = pos0 + i;
      const bool ok = pos >= lo && pos < hi;
      s[i] = ok ? __ldg(lsys + (size_t)pos * B + cb) : 0.f;
      p[i] = ok ? __ldg(lpar + (size_t)pos * B + cb) : 0.f;
    }
  }
};

__global__ void __launch_bounds__(CB)
bcjr_bf16_kernel(const float* __restrict__ lsys, const float* __restrict__ lpar,
                 float* __restrict__ post, int K, int B, int Lw, int D) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf2* alpha_sm = reinterpret_cast<bf2*>(smem_raw);   // [ceil(Lw/C)][NP][CB]
  const int tid = threadIdx.x;
  const int cb = blockIdx.x * CB + tid;
  if (cb >= B) return;                                // no barrier below
  const int w = blockIdx.y;
  const int Kt = K + 3;
  const int w0 = w * Lw;                              // first output position (< K)
  const int oe = min(w0 + Lw, K);                     // end of the outputs
  const int fs = max(0, w0 - D);                      // first forward position
  const int be = min(w0 + Lw + D, Kt);                // end of the backward positions

  // forward: alpha from fs up to the last checkpoint. fs = 0 (mod 4), so a
  // chunk's row i lies at a position = i (mod 4)
  const int fe = w0 + (oe - 1 - w0) / C * C + 1;
  bf2 a[NP];
  init_metrics(a, w == 0);
  Rows cur, nxt;
  cur.load(lsys, lpar, fs, fs, fe, B, cb);
  for (int p = fs; p < fe; p += CH) {
    nxt.load(lsys, lpar, p + CH, fs, fe, B, cb);
#pragma unroll
    for (int i = 0; i < CH; ++i) {
      const int k = p + i - w0;
      if (p + i < fe) {
        if (k >= 0 && k % C == 0) {
#pragma unroll
          for (int q = 0; q < NP; ++q) alpha_sm[((k / C) * NP + q) * CB + tid] = a[q];
        }
        alpha_step(a, a, Gam(cur.s[i], cur.p[i]));
        if ((i & 3) == 3) renorm(a);
      }
    }
    cur = nxt;
  }

  // backward over [w0, be), in chunks of CH positions from w0 (so row i of
  // a chunk lies at a position = i (mod 4)), each chunk in groups of C: a
  // group with outputs reloads its checkpoint and recomputes the alphas
  // after it, then steps down through its positions
  bf2 b[NP];
  init_metrics(b, w0 + Lw + D >= Kt);
  int base = w0 + (be - 1 - w0) / CH * CH;
  cur.load(lsys, lpar, base, w0, be, B, cb);
  for (; base >= w0; base -= CH) {
    nxt.load(lsys, lpar, base - CH, w0, be, B, cb);
#pragma unroll
    for (int j = CH / C - 1; j >= 0; --j) {
      const int gp = base + j * C;                    // the group's first position
      bf2 ar[C][NP];
      if (gp < oe) {
        const int ck = (gp - w0) / C;
#pragma unroll
        for (int q = 0; q < NP; ++q) ar[0][q] = alpha_sm[(ck * NP + q) * CB + tid];
#pragma unroll
        for (int i = 1; i < C; ++i) {
          alpha_step(ar[i], ar[i - 1], Gam(cur.s[j * C + i - 1], cur.p[j * C + i - 1]));
          if (((i - 1) & 3) == 3) renorm(ar[i]);
        }
      }
#pragma unroll
      for (int i = C - 1; i >= 0; --i) {
        const int pos = gp + i;
        if (pos < be) {
          const Gam g(cur.s[j * C + i], cur.p[j * C + i]);
          bf2 bs0[NP], bs1[NP], g0[NP], g1[NP];
#pragma unroll
          for (int k = 0; k < NP; ++k) {
            const int s0 = 2 * k, s1 = 2 * k + 1;
            bs0[k] = pair(b, nxt_state(s0, 0), nxt_state(s1, 0));
            bs1[k] = pair(b, nxt_state(s0, 1), nxt_state(s1, 1));
            g0[k] = g.two(0, out_z(s0, 0), 0, out_z(s1, 0));
            g1[k] = g.two(1, out_z(s0, 1), 1, out_z(s1, 1));
          }
          if (pos < oe) {
            // b holds beta_{pos+1}; ar[i] is alpha_pos
            bf2 e1[NP], e0[NP];
#pragma unroll
            for (int k = 0; k < NP; ++k) {
              e1[k] = __hadd2(__hadd2(ar[i][k], g1[k]), bs1[k]);
              e0[k] = __hadd2(__hadd2(ar[i][k], g0[k]), bs0[k]);
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
          if ((i & 3) == 0) renorm(b);
        }
      }
    }
    cur = nxt;
  }
}

// shared memory of a block: the alpha checkpoints of one window
size_t smem_bytes(int Lw) {
  return (size_t)((Lw + C - 1) / C) * NP * CB * sizeof(bf2);
}

}  // namespace

// Lsys, Lp: float32 [K+3, B] row-major (step x codeblock); post: [K, B].
// Needs (Lw + 2D) % 4 == 0 and (D + Lw) % 4 == 0 (the 4-step renormalization
// groups). A block keeps ceil(Lw / 8) alpha vectors of 512 bytes in shared
// memory, which must fit 232,448 bytes. Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int bcjr_posterior_cm_bf16(const void* lsys, const void* lp, void* post,
                                      int K, int B, int Lw, int D, void* stream) {
  if (K <= 0 || B <= 0 || Lw <= 0 || D < 0 || (Lw + 2 * D) % 4 || (D + Lw) % 4)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Lw);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      bcjr_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int W = (K + Lw - 1) / Lw;                   // windows with outputs
  dim3 grid((B + CB - 1) / CB, W);
  bcjr_bf16_kernel<<<grid, CB, smem, (cudaStream_t)stream>>>(
      (const float*)lsys, (const float*)lp, (float*)post, K, B, Lw, D);
  return (int)cudaGetLastError();
}

// The blocks of bcjr_posterior_cm_bf16 that one SM holds at a time for
// windows of Lw steps (the occupancy calculator's answer), or -1 on an error.
extern "C" int bcjr_bf16_blocks_per_sm(int Lw) {
  const size_t smem = smem_bytes(Lw);
  int n = 0;
  if (Lw <= 0 || smem > SMEM_MAX ||
      cudaFuncSetAttribute(bcjr_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, bcjr_bf16_kernel, CB, smem) !=
          cudaSuccess)
    return -1;
  return n;
}
