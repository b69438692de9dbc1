// Polyphase fractional-resampler FIR for Hopper: register-blocked frame x
// phase tiles over a staged span.
//
// Replaces dectnrp_tpu/phy/ops/polyphase.py::_pallas_call (the TPU kernel
// behind polyphase_fir_pallas, chosen by phy/resampler.py::_resolve_impl) and
// computes the resampler's FIR on complex rows x [rows, n_in]:
//   y[r, g L + l] = sum_w G[l, w] x[r, g M + m0 + w],   g L + l < n_out,
// with x zero outside [0, n_in). G [L, W] holds phase l at its input-window
// offset (phy/resampler.py::_design).
//
// The TPU kernel embeds G in a dense block-Toeplitz matrix to feed the MXU.
// Here the FIR of a row is the small product Y[g, l] = sum_j X[g, j] G[l, j]
// with X[g, j] = x[g M + m0 + j], blocked in registers as a SIMT GEMM is:
// - a thread holds F frames (32 lanes apart) x LG phases of complex sums;
//   the L phases split into NG = L / LG groups (LG = 1, 2, 9 or 10), taken
//   by different warps; F = 1 at LG = 9, 10 (80 registers, 3 blocks of 8
//   warps an SM) and 8 at LG = 1, 2. At each tap index j = q M + r a thread
//   reads F samples and the group's LG taps and does 2 F LG fused
//   multiply-adds; the taps are j-major in shared memory ([group][j][LGP]),
//   one broadcast 16-byte read per 4 taps; j walks frame rows q, then r, so
//   a tap costs a pointer step, not an index division;
// - a group walks only its tap range [lo, hi): from the first to the last
//   index at which any of its phases is nonzero, worked out once on the host
//   (phy/ops/polyphase.py::tap_ranges) and passed in. Every output sums its
//   taps in ascending j with fmaf from +0; a zero tap leaves a finite sum
//   unchanged, so y is bit for bit the direct FIR over each phase's nonzero
//   span, and the twin polyphase_fir_tiled repeats it;
// - a tile of TF frames stages its span (TF M + W - M samples, zero outside
//   [0, n_in)) frame-padded: sample i at (i / M) SP + i % M with SP = M | 1
//   odd, so the 32 lanes' 8-byte reads of consecutive frames fall in
//   distinct bank pairs (2 wavefronts a read);
// - a block walks an equal share of the rows x frames space (the wrapper
//   launches one wave), tile by tile, copying the next tile's span with
//   8-byte cp.async into the other half of a double buffer while this one
//   computes;
// - once every warp has read the span, the tile's sums (all phase groups)
//   go into the same half in y's order, and one thread stores the tile's
//   outputs, one contiguous run of y, with a bulk asynchronous copy
//   (cp.async.bulk): the stores leave while the block computes the next
//   tile, without holding its warps on the store queue (with 8-byte stores
//   by every thread, stores and compute ran one after the other). At
//   L = 20, 40, 80, where rows of L float2 put the lanes' writes in 4 to
//   16 times the same banks, the sums pass through rows of L + 1 and
//   registers first. A half holds the larger of span and outputs.
//
// Bound: memory. At the wall step's shapes (NVIDIA H100, 3.35 TB/s,
// 67 TFLOP/s fp32): the 9/10 down-resampler moves 64 rows x (85,900 in +
// 77,310 out) x 8 B = 83.6 MB, about 24.9 us, against about 0.49 GFLOP
// (25 taps x 4 flop per output), about 7.4 us; the 10/9 up-resampler moves
// 64 x (23,040 + 25,600) x 8 B = 24.9 MB, about 7.4 us. Zeros included, the
// fused multiply-adds at 9/10 take about 10 us of fp32 issue.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;             // threads a block
constexpr int NWARP = NT / 32;
constexpr int NG_MAX = 8;           // phase groups a design may have
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a block may use

struct Ranges {                     // [lo, hi) tap range of each phase group
  int lo[NG_MAX], hi[NG_MAX];
};

__host__ __device__ constexpr int frames_of(int LG) { return LG >= 9 ? 1 : 8; }
// blocks an SM the registers must allow
__host__ __device__ constexpr int min_blocks_of(int LG) { return LG >= 9 ? 3 : 2; }
__host__ __device__ constexpr int lgp_of(int LG) {
  return LG <= 2 ? LG : (LG + 3) / 4 * 4;
}

// The tiling of one design (phy/ops/polyphase.py::kernel_plan names the
// reason when it refuses).
struct Plan {
  int LG, NG, TF, NBF, SP, BUF;
  size_t tap_bytes, smem;
};

bool plan_of(int L, int M, int W, Plan* p) {
  if (L <= 0 || M <= 0 || W < M) return false;
  const int LG = L <= 10 ? L : (L % 10 == 0 ? 10 : (L % 9 == 0 ? 9 : 0));
  if (LG != 1 && LG != 2 && LG != 9 && LG != 10) return false;
  p->LG = LG;
  p->NG = L / LG;
  if (p->NG > NG_MAX) return false;
  p->TF = (NWARP / p->NG > 1 ? NWARP / p->NG : 1) * 32 * frames_of(LG);
  p->NBF = p->TF + (W - 1) / M;
  p->SP = M | 1;
  p->BUF = p->NBF * p->SP > p->TF * (L + 1) ? p->NBF * p->SP : p->TF * (L + 1);
  p->BUF += p->BUF & 1;               // halves start on 16 bytes
  p->tap_bytes = ((size_t)p->NG * W * lgp_of(LG) * sizeof(float) + 15) / 16 * 16;
  p->smem = p->tap_bytes + (size_t)2 * p->BUF * sizeof(float2);
  return p->smem <= (size_t)SMEM_MAX;
}

// one thread: store `bytes` (a multiple of 16, both ends 16-byte aligned)
// from shared memory to y asynchronously; the warps go on computing
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               ::"l"(dst), "r"((unsigned)__cvta_generic_to_shared(src)), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

template <int LG>
__global__ void __launch_bounds__(NT, min_blocks_of(LG))
polyphase_kernel(const float2* __restrict__ x, const float* __restrict__ taps,
                 float2* __restrict__ y, Ranges rg, int n_in, int n_out, int L,
                 int M, int W, int m0, int NF, int TF, int BUF, int SP,
                 long long FT, int tap_bytes) {
  constexpr int F = frames_of(LG), LGP = lgp_of(LG);
  extern __shared__ __align__(16) unsigned char smem[];
  float* gs = (float*)smem;                                // taps [NG][W][LGP]
  float2* xb = (float2*)(smem + tap_bytes);                // halves [2][BUF]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // a warp's task this tile (at most one: NG <= NWARP): phase group grp of
  // the 32 F frames from fr0
  const int NG = L / LG, n_tasks = TF / (32 * F) * NG;
  const int grp = warp % NG, fr0 = warp / NG * 32 * F;

  for (int i = tid; i < NG * W * LGP; i += NT) {
    const int l = i % LGP, gj = i / LGP, j = gj % W, g = gj / W;
    gs[i] = l < LG ? taps[(size_t)(g * LG + l) * W + j] : 0.f;
  }

  // this block's share [f_beg, f_end) of the rows x NF frames
  const long long f_beg = FT * blockIdx.x / gridDim.x;
  const long long f_end = FT * (blockIdx.x + 1) / gridDim.x;
  auto tile_at = [&](long long cur, long long& row, int& g0, int& nf) {
    row = cur / NF;
    g0 = (int)(cur - row * NF);
    nf = (int)min((long long)TF, min(f_end - cur, (long long)(NF - g0)));
  };

  // copy a tile's span into `buf`, thread tid taking samples tid + k NT
  const int q0 = tid / M, r0 = tid - q0 * M, dq = NT / M, dr = NT - dq * M;
  auto stage = [&](long long row, int g0, int nf, float2* buf) {
    const int span = nf * M + W - M;
    const float2* xr = x + row * n_in;
    const long long s0 = (long long)g0 * M + m0;
    int q = q0, r = r0;
    for (int i = tid; i < span; i += NT) {
      const long long s = s0 + i;
      const bool ok = s >= 0 && s < n_in;
      cp_async8(buf + q * SP + r, ok ? xr + s : xr, ok ? 8 : 0);
      q += dq;
      r += dr;
      if (r >= M) {
        r -= M;
        ++q;
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  long long cur = f_beg, row;
  int g0, nf, hb = 0;
  if (cur < f_end) {
    tile_at(cur, row, g0, nf);
    stage(row, g0, nf, xb);
  }
  while (cur < f_end) {
    tile_at(cur, row, g0, nf);
    const long long nxt = cur + nf;
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    if (tid == 0)      // the other half's outputs have left it
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    __syncthreads();   // this span (and, first time, the taps) landed
    if (nxt < f_end) {
      long long row1;
      int g1, nf1;
      tile_at(nxt, row1, g1, nf1);
      stage(row1, g1, nf1, xb + (hb ^ 1) * BUF);
    }
    float2* buf = xb + hb * BUF;
    const bool busy = warp < n_tasks && fr0 < nf;
    float ar[F][LG], ai[F][LG];
#pragma unroll
    for (int f = 0; f < F; ++f)
#pragma unroll
      for (int l = 0; l < LG; ++l) ar[f][l] = ai[f][l] = 0.f;
    if (busy) {
      const int lo = rg.lo[grp], hi = rg.hi[grp];
      // tap j = q M + r of frame fr sits at (fr + q) SP + r: walk q, then r
      const float2* xq = buf + (fr0 + lane + lo / M) * SP;
      const float* gp = gs + ((size_t)grp * W + lo) * LGP;
      int r = lo % M;
      for (int j = lo; j < hi; xq += SP, r = 0) {
        const int r_end = min(M, r + hi - j);
        j += r_end - r;
        const float2* xp = xq + r;
        for (; r < r_end; ++r, ++xp, gp += LGP) {
          float2 v[F];
#pragma unroll
          for (int f = 0; f < F; ++f) v[f] = xp[f * 32 * SP];
          float h[LGP];
          if constexpr (LGP % 4 == 0) {
#pragma unroll
            for (int k = 0; k < LGP / 4; ++k) {
              const float4 t = reinterpret_cast<const float4*>(gp)[k];
              h[4 * k] = t.x;
              h[4 * k + 1] = t.y;
              h[4 * k + 2] = t.z;
              h[4 * k + 3] = t.w;
            }
          } else {
#pragma unroll
            for (int l = 0; l < LGP; ++l) h[l] = gp[l];
          }
#pragma unroll
          for (int f = 0; f < F; ++f)
#pragma unroll
            for (int l = 0; l < LG; ++l) {
              ar[f][l] = fmaf(h[l], v[f].x, ar[f][l]);
              ai[f][l] = fmaf(h[l], v[f].y, ai[f][l]);
            }
        }
      }
    }
    // the tile's outputs, y[row, g0 L + o] for o < n_o, go to buf[o + par]:
    // par makes the 16-byte units of the half and of y coincide
    float2* yt = y + row * n_out + (long long)g0 * L;
    const int n_o = (int)min((long long)nf * L, (long long)n_out - (long long)g0 * L);
    const int par = (int)(((size_t)yt >> 3) & 1);
    // at L = 20, 40, 80 the lanes' rows of L float2 fall in 4 to 16 times
    // the same banks: the sums go to rows of L + 1 first, then through
    // registers into y's order
    const bool pad = LG == 10 && (L & 3) == 0;
    const int LS = pad ? L + 1 : L;
    __syncthreads();   // every read of the span done: the half takes the sums
    if (busy) {
#pragma unroll
      for (int f = 0; f < F; ++f)
#pragma unroll
        for (int l = 0; l < LG; ++l)
          buf[(fr0 + f * 32 + lane) * LS + grp * LG + l + (pad ? 0 : par)] =
              make_float2(ar[f][l], ai[f][l]);
    }
    if constexpr (LG == 10) {
      if (pad) {         // n_o <= TF L = F LG NT: F LG outputs a thread
        float2 v[F * LG];
        const int oq = NT / L, orr = NT - oq * L;   // o = tid + k NT: frame
        int q = tid / L, r = tid - q * L;           // q, phase r
        __syncthreads();
#pragma unroll
        for (int k = 0; k < F * LG; ++k) {
          if (tid + k * NT < n_o) v[k] = buf[q * LS + r];
          q += oq;
          r += orr;
          if (r >= L) {
            r -= L;
            ++q;
          }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < F * LG; ++k)
          if (tid + k * NT < n_o) buf[tid + k * NT + par] = v[k];
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const int n_bulk = (n_o - par) & ~1;   // whole 16-byte units from o = par
    if (tid == 0 && n_bulk > 0)
      bulk_store(yt + par, buf + 2 * par, n_bulk * (int)sizeof(float2));
    if (tid == 32 && par) yt[0] = buf[1];
    if (tid == 64 && par + n_bulk < n_o) yt[n_o - 1] = buf[n_o - 1 + par];
    cur = nxt;
    hb ^= 1;
  }
  if (tid == 0) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

using KernelFn = void (*)(const float2*, const float*, float2*, Ranges, int, int,
                          int, int, int, int, int, int, int, int, long long, int);

KernelFn pick(int LG) {
  switch (LG) {
    case 1: return polyphase_kernel<1>;
    case 2: return polyphase_kernel<2>;
    case 9: return polyphase_kernel<9>;
    case 10: return polyphase_kernel<10>;
    default: return nullptr;
  }
}

}  // namespace

// Blocks of the kernel for an L/M design of W taps an SM holds at once (the
// occupancy calculator's answer), or -1 if the design is not served.
extern "C" int polyphase_blocks_per_sm(int L, int M, int W) {
  Plan p;
  if (!plan_of(L, M, W, &p)) return -1;
  KernelFn k = pick(p.LG);
  int n = 0;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)p.smem) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, NT, p.smem) !=
          cudaSuccess)
    return -1;
  return n;
}

// x: complex64 [rows, n_in] as interleaved float32 pairs; taps: float32
// [L, W]; ranges: host array of the [lo, hi) tap range of each of the
// design's phase groups (NULL: [0, W) each); y: complex64 [rows, n_out]. m0
// is the input index of frame 0's first tap (negative reads zeros). `grid`
// blocks share the rows x frames space. Launches on `stream`; returns the
// cudaError_t of the launch, cudaErrorInvalidValue for a shape or design the
// tiling does not serve (phy/ops/polyphase.py::kernel_plan names the reason).
extern "C" int polyphase_fir(const void* x, const void* taps, const int* ranges,
                             void* y, int rows, int n_in, int n_out, int L, int M,
                             int W, int m0, int grid, void* stream) {
  Plan p;
  if (rows <= 0 || rows > 65535 || n_in <= 0 || n_out <= 0 || grid <= 0 ||
      !plan_of(L, M, W, &p))
    return (int)cudaErrorInvalidValue;
  Ranges rg;
  for (int g = 0; g < p.NG; ++g) {
    rg.lo[g] = ranges ? ranges[2 * g] : 0;
    rg.hi[g] = ranges ? ranges[2 * g + 1] : W;
    if (rg.lo[g] < 0 || rg.hi[g] < rg.lo[g] || rg.hi[g] > W)
      return (int)cudaErrorInvalidValue;
  }
  KernelFn k = pick(p.LG);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (e != cudaSuccess) return (int)e;
  const int NF = (n_out + L - 1) / L;
  const long long FT = (long long)rows * NF;
  if (grid > FT) grid = (int)FT;
  k<<<grid, NT, p.smem, (cudaStream_t)stream>>>(
      (const float2*)x, (const float*)taps, (float2*)y, rg, n_in, n_out, L, M, W,
      m0, NF, p.TF, p.BUF, p.SP, FT, (int)p.tap_bytes);
  return (int)cudaGetLastError();
}
