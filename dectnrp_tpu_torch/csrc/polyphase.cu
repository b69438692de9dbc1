// Polyphase fractional-resampler FIR, direct form, for Hopper.
//
// Replaces dectnrp_tpu/phy/ops/polyphase.py::_pallas_call (the TPU kernel
// behind polyphase_fir_pallas, chosen by phy/resampler.py::_resolve_impl) and
// computes the resampler's FIR on complex rows x [rows, n_in]:
//   y[r, g L + l] = sum_w G[l, w] x[r, g M + m0 + w],   g L + l < n_out,
// with x zero outside [0, n_in). G [L, W] holds phase l at its input-window
// offset (phy/resampler.py::_design).
//
// The TPU kernel embeds G in a dense block-Toeplitz [mp + Eh, sop] matrix
// (512 x 384 at 10/9) to feed the 128 x 128 MXU: about 20x the multiply-adds
// of the FIR itself. Here each output takes only its phase's nonzero taps
// (22-25 at 10/9 and 9/10), applied as real taps to both parts of the
// interleaved complex64 samples; no real/imag row split.
//
// Grid: (tile of TF frames, row). A block stages its input span
// (TF M + W - M samples, zero-filled outside [0, n_in)) with coalesced loads
// in shared memory -- this replaces the JAX path's pad copy, so x is read
// once -- and the taps beside it. Each phase's nonzero taps are found once
// per block and copied to a row of their own at an odd stride CS: the lanes
// of a warp read taps of up to L phases at the same step t, and rows at
// offsets l*W + first[l] drift by less than a bank from phase to phase
// (10/9: W = 31 = -1 mod 32, first[l] ~ 0.9 l), so up to 10 lanes hit one
// bank at different addresses; at stride CS = W | 1 from each row's first
// tap the L rows fall in L different banks. Threads then walk the block's
// TF L outputs in order, so the stores coalesce. Every ratio of the
// resampler's set and its inverse works (L, M <= 80, W <= 143); there is no
// feasibility search.
//
// Bound: memory. At the wall step's shapes (NVIDIA H100, 3.35 TB/s,
// 67 TFLOP/s fp32): the 9/10 down-resampler moves 64 rows x (85,900 in +
// 77,310 out) x 8 B = 83.6 MB, about 24.9 us, against about 0.49 GFLOP
// (25 taps x 4 flop per output), about 7.4 us; the 10/9 up-resampler moves
// 64 x (23,040 + 25,600) x 8 B = 24.9 MB, about 7.4 us.
#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;             // threads per block
constexpr int OUT_PER_BLOCK = 2048; // target outputs per block
constexpr int SMEM_MAX = 232448;    // dynamic shared memory a block may use

__global__ void __launch_bounds__(NT)
polyphase_kernel(const float2* __restrict__ x, const float* __restrict__ taps,
                 float2* __restrict__ y, int n_in, int n_out, int L, int M,
                 int W, int m0, int TF) {
  extern __shared__ float2 smem2[];
  const int span = TF * M + W - M;
  float2* xs = smem2;                            // input span [span]
  const int CS = W | 1;                          // compacted row stride, odd
  float* gs = (float*)(xs + span);               // taps [L * W]
  float* gc = gs + L * W;                        // nonzero taps [L * CS]
  int* first = (int*)(gc + L * CS);              // first nonzero tap [L]
  int* cnt = first + L;                          // nonzero span length [L]

  const int row = blockIdx.y;
  const int g0 = blockIdx.x * TF;                // first frame of the block
  const long long i0 = (long long)g0 * M + m0;   // stream index of xs[0]
  const float2* xr = x + (size_t)row * n_in;
#pragma unroll 4
  for (int i = threadIdx.x; i < span; i += NT) {   // 4 loads in flight
    const long long g = i0 + i;
    xs[i] = (g >= 0 && g < n_in) ? xr[g] : make_float2(0.f, 0.f);
  }
  for (int i = threadIdx.x; i < L * W; i += NT) gs[i] = taps[i];
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += NT) {
    const float* h = gs + l * W;
    int f = 0, e = W;
    while (f < W && h[f] == 0.f) ++f;
    while (e > f && h[e - 1] == 0.f) --e;
    first[l] = f;
    cnt[l] = e - f;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < L * CS; i += NT) {
    const int l = i / CS, j = i - l * CS;
    gc[i] = (j < cnt[l]) ? gs[l * W + first[l] + j] : 0.f;
  }
  __syncthreads();

  const long long o0 = (long long)g0 * L;
  const int n_o = (int)min((long long)TF * L, (long long)n_out - o0);
  float2* yr = y + (size_t)row * n_out + o0;
  for (int o = threadIdx.x; o < n_o; o += NT) {
    const int g = o / L, l = o - g * L;
    const int f = first[l], c = cnt[l];
    const float* h = gc + l * CS;
    const float2* xv = xs + g * M + f;
    float re = 0.f, im = 0.f;
    for (int t = 0; t < c; ++t) {
      const float2 v = xv[t];
      re = fmaf(h[t], v.x, re);
      im = fmaf(h[t], v.y, im);
    }
    yr[o] = make_float2(re, im);
  }
}

}  // namespace

// x: complex64 [rows, n_in] as interleaved float32 pairs; taps: float32
// [L, W]; y: complex64 [rows, n_out]. m0 is the input index of frame 0's
// first tap (negative reads zeros). Launches on `stream`; returns the
// cudaError_t of the launch.
extern "C" int polyphase_fir(const void* x, const void* taps, void* y, int rows,
                             int n_in, int n_out, int L, int M, int W, int m0,
                             void* stream) {
  if (rows <= 0 || rows > 65535 || n_in <= 0 || n_out <= 0 || L <= 0 ||
      M <= 0 || W < M)
    return (int)cudaErrorInvalidValue;
  const size_t fixed = (size_t)L * (W + (W | 1)) * sizeof(float) +
                       2 * L * sizeof(int) + (size_t)(W - M) * sizeof(float2);
  if (fixed + M * sizeof(float2) > (size_t)SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  int TF = OUT_PER_BLOCK / L;
  const int tf_smem = (int)(((size_t)SMEM_MAX - fixed) / (M * sizeof(float2)));
  if (TF > tf_smem) TF = tf_smem;
  if (TF < 1) TF = 1;
  const size_t smem = fixed + (size_t)TF * M * sizeof(float2);
  cudaError_t e = cudaFuncSetAttribute(
      polyphase_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int n_frames = (n_out + L - 1) / L;
  dim3 grid((n_frames + TF - 1) / TF, rows);
  polyphase_kernel<<<grid, NT, smem, (cudaStream_t)stream>>>(
      (const float2*)x, (const float*)taps, (float2*)y, n_in, n_out, L, M, W,
      m0, TF);
  return (int)cudaGetLastError();
}
