// Smoothed, gated STF detection metric in one pass, for Hopper.
//
// Replaces dectnrp_tpu/phy/ops/sync_detect.py::build_sync_sm (the TPU
// kernel at the head of phy/sync.py::build_sync) and computes its `sm`:
//   C[t]  = sum_j w_j * movsum_P(x[i] conj(x[i+P]))[t + jP]
//   P2[t] = movsum_L(|x|^2)[t]                (both summed over R antennas)
//   metric = n_pat/(n_pat-1) |C| / P2, gated to (thr, mmax) and t in [0, n_t),
//   sm[t] = sum of the gated metric over [t-sl, t+sr], divided by k.
//
// Grid: (tile of TT output samples, batch row). A block needs the gated
// metric over [t0-sl, t0+TT+sr) (M samples), hence x over
// [t0-sl, t0+TT+sr+L) (M+L samples). It forms the lag products and powers
// of that window in shared memory, turns them into exclusive prefix sums
// with a block-wide scan (warp shuffles, 256 elements a round), and reads
// every moving sum as a difference of two prefix entries: O(n_pat) work per
// sample, linear in the stream, not O(L). Antennas accumulate C and P2 in
// shared memory one after another, so R does not bound the shared memory.
// The gated metric is scanned once more for the box smoothing, and sm is
// written once. Tile-local sums (about TT+L terms) are more precise than the
// plain twin's T-long float32 prefix sums.
//
// The TPU kernel's P % 128 == 0 limit (a lane-width artifact) does not
// apply: any P works, b = 1 included.
//
// Bound: memory, nominally (one read of x with a halo of (L+sl+sr)/TT,
// about 94% extra at the flagship, plus one write of sm); the scans' barriers
// and shared-memory traffic cap it below that in this first version.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int NW = NT / 32;  // warps per block
constexpr int TT = 2048;     // output samples per block

// In-place exclusive prefix sum of a[0..n); writes the total to a[n].
// Called by all threads of the block; ends with a barrier.
__device__ void block_excl_scan(float* a, int n, float* wt) {
  const int tid = threadIdx.x, lane = tid & 31, wid = tid >> 5;
  float carry = 0.f;
  for (int base = 0; base < n; base += NT) {
    const int i = base + tid;
    const float x = (i < n) ? a[i] : 0.f;
    float v = x;                                     // warp-inclusive scan
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, v, o);
      if (lane >= o) v += y;
    }
    float e = __shfl_up_sync(0xffffffffu, v, 1);     // warp-exclusive
    if (lane == 0) e = 0.f;
    if (lane == 31) wt[wid] = v;
    __syncthreads();
    if (wid == 0) {                                  // scan the warp totals
      float s = (lane < NW) ? wt[lane] : 0.f;
#pragma unroll
      for (int o = 1; o < NW; o <<= 1) {
        const float y = __shfl_up_sync(0xffffffffu, s, o);
        if (lane >= o) s += y;
      }
      if (lane < NW) wt[lane] = s;
    }
    __syncthreads();
    const float off = (wid > 0) ? wt[wid - 1] : 0.f;
    if (i < n) a[i] = carry + (off + e);
    carry += wt[NW - 1];
    __syncthreads();                                 // wt is rewritten next round
  }
  if (tid == 0) a[n] = carry;
  __syncthreads();
}

__global__ void __launch_bounds__(NT)
sync_sm_kernel(const float2* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ sm, int R, int T, int P, int n_pat, int sl,
               int sr, float thr, float mmax) {
  extern __shared__ float smem[];
  __shared__ float wt[NW];
  const int tid = threadIdx.x;
  const int L = n_pat * P;
  const int n_t = T - L - P;
  const int M = TT + sl + sr;       // gated-metric samples of this tile
  const int NX = M + L;             // x samples of this tile
  const int NP = M + L - P;         // lag products of this tile
  float* spr = smem;                // lag product (re), then prefix [NP+1]
  float* spi = spr + (NX + 1);      // lag product (im), then prefix [NP+1]
  float* spw = spi + (NX + 1);      // power, then prefix [NX+1]
  float* cre = spw + (NX + 1);      // C (re) [M]
  float* cim = cre + M;             // C (im) [M]
  float* p2 = cim + M;              // P2 [M]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TT;
  const int g0 = t0 - sl;           // stream index of local sample 0

  for (int m = tid; m < M; m += NT) cre[m] = cim[m] = p2[m] = 0.f;
  for (int r = 0; r < R; ++r) {
    const float2* xa = x + ((size_t)b * R + r) * T;
    for (int i = tid; i < NX; i += NT) {
      const int g = g0 + i;
      const float2 v = (g >= 0 && g < T) ? xa[g] : make_float2(0.f, 0.f);
      spw[i] = v.x * v.x + v.y * v.y;
      if (i < NP) {
        const int g2 = g + P;
        const float2 u = (g2 >= 0 && g2 < T) ? xa[g2] : make_float2(0.f, 0.f);
        spr[i] = v.x * u.x + v.y * u.y;            // x[g] conj(x[g+P])
        spi[i] = v.y * u.x - v.x * u.y;
      }
    }
    __syncthreads();
    block_excl_scan(spw, NX, wt);
    block_excl_scan(spr, NP, wt);
    block_excl_scan(spi, NP, wt);
    for (int m = tid; m < M; m += NT) {
      float ar = 0.f, ai = 0.f;
      for (int j = 0; j < n_pat - 1; ++j) {
        const float wj = w[j];
        ar += wj * (spr[m + (j + 1) * P] - spr[m + j * P]);
        ai += wj * (spi[m + (j + 1) * P] - spi[m + j * P]);
      }
      cre[m] += ar;
      cim[m] += ai;
      p2[m] += spw[m + L] - spw[m];
    }
    __syncthreads();                                 // before the next antenna
  }

  const float norm = (float)n_pat / (float)(n_pat - 1);
  for (int m = tid; m < M; m += NT) {
    const int g = g0 + m;
    const float met = norm * sqrtf(cre[m] * cre[m] + cim[m] * cim[m]) /
                      fmaxf(p2[m], 1e-20f);
    spr[m] = (g >= 0 && g < n_t && met > thr && met < mmax) ? met : 0.f;
  }
  __syncthreads();
  block_excl_scan(spr, M, wt);
  const int k = sl + sr + 1;
  for (int o = tid; o < TT; o += NT) {
    const int t = t0 + o;
    if (t < n_t) sm[(size_t)b * n_t + t] = (spr[o + k] - spr[o]) / (float)k;
  }
}

}  // namespace

// x: complex64 [B, R, T] as interleaved float32 pairs; w: float32 [n_pat-1];
// sm: float32 [B, n_t], n_t = T - (n_pat+1) P. Launches on `stream`;
// returns the cudaError_t of the launch.
extern "C" int sync_detect_sm(const void* x, const void* w, void* sm, int B,
                              int R, int T, int P, int n_pat, int sl, int sr,
                              float thr, float mmax, void* stream) {
  const int L = n_pat * P;
  const int n_t = T - L - P;
  if (B <= 0 || R <= 0 || P <= 0 || n_pat < 2 || sl < 0 || sr < 0 || n_t <= 0)
    return (int)cudaErrorInvalidValue;
  const int M = TT + sl + sr;
  const int NX = M + L;
  const size_t smem = (size_t)(3 * (NX + 1) + 3 * M) * sizeof(float);
  if (smem > 232448 - NW * sizeof(float)) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      sync_sm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((n_t + TT - 1) / TT, B);
  sync_sm_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float2*)x, (const float*)w, (float*)sm, R, T, P, n_pat, sl, sr,
      thr, mmax);
  return (int)cudaGetLastError();
}
