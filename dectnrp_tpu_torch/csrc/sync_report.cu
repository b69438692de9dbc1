// The sync chunk's report after detection, for Hopper: one block a peak.
//
// Replaces no TPU kernel. The JAX package computes this part of
// phy/sync.py::build_sync in XLA after its detection kernel; the port did
// the same in PyTorch (phy/ops/sync_report.py::sync_report_plain), about 95
// launches of a few microseconds of arithmetic at the runtime's chunk
// [1, R, 2,496], so each chunk's report was bound by the host's launch rate.
// This kernel computes the whole report in one launch.
//
// Given iq x [B, R, T], the detection metric sm [B, n_t] (csrc/sync_detect.cu)
// and the module's tables, block (b, k) computes row b's peak k:
//  1. Coarse peaks: k + 1 argmax rounds over sm[b] (first index wins ties,
//     NaN is the largest, as torch.argmax); in round j every t with
//     |t - t_i| < L for an earlier peak t_i reads -1.
//  2. Over the L-sample window of peak t_k (clamped to [0, T-L]):
//     c = sum x[n] conj(x[n+P]) w_rep[n], p2 = sum |x|^2 (all antennas);
//     metric = norm |c| / max(p2, 1e-20), rms = sqrt(p2 / (L R)),
//     cfo = -angle(c) / P; detected = metric in (thr, mmax), rms in
//     (rms_min, rms_max) where the gate is on, and sm[t_k] > thr.
//  3. Fine peak and N_eff: the seg_len samples from t0 = clamp(t_k - half, 0,
//     T - seg_len), derotated by the CFO, correlated DIRECTLY with each of the
//     M conjugated templates at each of the D lags (the linear correlation the
//     plain twin takes by FFT); m = sum_R |xc|^2 / max(e_win, 1e-20) with
//     e_win the lag's window energy; the first argmax over d M + m gives
//     t_fine = t0 + d and n_eff = neff[m].
//
// Bound: latency at the runtime's chunk. The compulsory bytes are the metric
// row, K windows of x, the templates and the outputs (about 30 KB there,
// 0.01 us at 3.35 TB/s) and the work K R (D M L complex multiply-adds + D L
// squares) (0.5 MFLOP); what costs is the chain of dependent steps:
//  - A block's values depend on its row and peak alone, never on B (the
//    time-sharded search's B = c_loc calls equal its dense call bit for
//    bit). The K blocks of a row run side by side: block k repeats the first
//    k argmax rounds of the blocks before it (a round is one pass over a
//    row, from L1 / L2 after the first) rather than wait for them.
//  - The metric row is read from global memory, so a row of any length is
//    served (the 192,512-sample streams' 190k floats too); a round tests each
//    t against the earlier peaks, kept in shared memory, rather than masking
//    a copy. A round is a strided pass, LU loads in flight a thread (ties
//    resolved by the stride order), a warp shuffle, and every warp reducing
//    the 16 warps' winners itself: two barriers a round.
//  - The block's peak segment (R seg_len samples) is staged in shared memory
//    once, raw; warp 0 sums the peak window from it (lane-strided, then a xor
//    butterfly), then every thread derotates its own samples in place.
//  - The fine search is the arithmetic: D M L R complex multiply-adds a
//    peak, 3.7 M at b = 16 (where the FFT of the plain twin is cheaper in
//    operations but ~95 launches long). Its sums are held to one order, so
//    every product and sum is its own instruction (no FMA): the SM's issue
//    rate bounds it, so a thread carries 4 consecutive lags of one template
//    (or one antenna's energies): each template sample, loaded once, meets
//    4 segment samples that slide through registers, one new load a sample,
//    and 8 independent sums hide the add latency. The window energy of each
//    (antenna, lag) is summed once, into shared memory, before the
//    correlations that divide by it. D = 32 b + 1 lags are 8 b groups of 4
//    and one single lag (`lag_group`). A (lag group, template) item is
//    spread over R adjacent lanes, one antenna each, which hand their values
//    by shuffle to the first in antenna order: with several antennas (the
//    wall's 4) a few rows still fill the block. The templates are read from
//    global memory as [L, M], so a warp's M templates at one sample share a
//    32-byte sector.
//  - The loops are unrolled, so a thread has several loads in flight
//    (unrolling keeps each sum's order).
// Products and sums use __fmul_rn / __fadd_rn / __fsub_rn, divisions
// __fdiv_rn and square roots __fsqrt_rn, so nothing is contracted into an FMA
// and the tiled twin (phy/ops/sync_report.py::sync_report_tiled), which
// repeats this order of operations, rounds as the kernel does.
//
// Shared memory: the segment, the energies, the fine-search values, the K
// peaks and the scratch (`smem_bytes`; phy/ops/sync_report.py::_refusal
// refuses the same): 205 KB at most for R = 8 at b = 16, u >= 2.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 512;                 // threads a block: 16 warps
constexpr int NW = NT / 32;
constexpr size_t SMEM_MAX = 232448;
constexpr int TD4 = 4;                  // lags a fine-search thread carries
constexpr int LU = 8;                   // metric loads a thread has in flight

// a beats b (values va, vb at indices ia, ib) in torch.argmax's order: NaN
// above everything, then the larger value, then the smaller index
__device__ __forceinline__ bool beats(float va, int ia, float vb, int ib) {
  const bool na = va != va, nb = vb != vb;
  if (na || nb) return na && (!nb || ia < ib);
  if (va != vb) return va > vb;
  return ia < ib;
}

// the warp's best (v, i) in every lane; i < 0 marks a lane that holds none
__device__ __forceinline__ void warp_argmax(float& v, int& i) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, v, o);
    const int oi = __shfl_xor_sync(0xffffffffu, i, o);
    if (oi >= 0 && (i < 0 || beats(ov, oi, v, i))) {
      v = ov;
      i = oi;
    }
  }
}

// the block's best (v, i) in every thread; one barrier, after which red_v /
// red_i may be written again only past another barrier
__device__ __forceinline__ void block_argmax(float& v, int& i, float* red_v,
                                             int* red_i) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_argmax(v, i);
  if (lane == 0) {
    red_v[warp] = v;
    red_i[warp] = i;
  }
  __syncthreads();
  v = red_v[lane % NW];
  i = red_i[lane % NW];
  warp_argmax(v, i);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// lags d .. d + TD - 1 of one antenna's segment s (from lag d) against one
// template t (stride M): each lag's sum over n in order, the TD lags sharing
// each template load and sliding over the segment in registers
template <int TD>
__device__ __forceinline__ void corr_lags(const float2* s, const float2* __restrict__ t,
                                          int M, int L, float (&ar)[TD], float (&ai)[TD]) {
  float2 w[TD];
#pragma unroll
  for (int j = 0; j < TD - 1; ++j) w[j] = s[j];
#pragma unroll 4
  for (int n = 0; n < L; ++n) {
    w[TD - 1] = s[n + TD - 1];
    const float2 tv = __ldg(t + (size_t)n * M);
#pragma unroll
    for (int j = 0; j < TD; ++j) {
      ar[j] = __fadd_rn(ar[j], __fsub_rn(__fmul_rn(w[j].x, tv.x), __fmul_rn(w[j].y, tv.y)));
      ai[j] = __fadd_rn(ai[j], __fadd_rn(__fmul_rn(w[j].x, tv.y), __fmul_rn(w[j].y, tv.x)));
    }
#pragma unroll
    for (int j = 0; j < TD - 1; ++j) w[j] = w[j + 1];
  }
}

// the window energies of lags d .. d + TD - 1 of s (from lag d), in order
template <int TD>
__device__ __forceinline__ void energy_lags(const float2* s, int L, float (&e)[TD]) {
  float2 w[TD];
#pragma unroll
  for (int j = 0; j < TD - 1; ++j) w[j] = s[j];
#pragma unroll 4
  for (int n = 0; n < L; ++n) {
    w[TD - 1] = s[n + TD - 1];
#pragma unroll
    for (int j = 0; j < TD; ++j)
      e[j] = __fadd_rn(e[j], __fadd_rn(__fmul_rn(w[j].x, w[j].x), __fmul_rn(w[j].y, w[j].y)));
#pragma unroll
    for (int j = 0; j < TD - 1; ++j) w[j] = w[j + 1];
  }
}

// lag group g of nG groups of TD4 lags followed by single lags: its first
// lag, and its width in `width`
__device__ __forceinline__ int lag_group(int g, int nG, int& width) {
  width = g < nG ? TD4 : 1;
  return g < nG ? TD4 * g : TD4 * nG + (g - nG);
}

size_t smem_bytes(int R, int seg_len, int D, int M, int K) {
  return sizeof(float2) * (size_t)R * seg_len +
         sizeof(float) * ((size_t)R * D + (size_t)D * M) +
         sizeof(int) * (2 * NW + (size_t)K) + sizeof(float) * 2;
}

__global__ void __launch_bounds__(NT) sync_report_kernel(
    const float2* __restrict__ x, const float* __restrict__ sm,
    const float* __restrict__ wrep, const float2* __restrict__ tc,
    const long long* __restrict__ neff, uint8_t* __restrict__ det,
    int* __restrict__ ti, float* __restrict__ tf, int B, int R, int T, int P,
    int L, int half, int M, int K, float norm, float thr, float mmax,
    int rms_gate, float rms_min, float rms_max, float inv_lr, float inv_p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int n_t = T - L - P, seg_len = L + 2 * half, D = 2 * half + 1;
  const int DM = D * M;
  float2* seg_s = reinterpret_cast<float2*>(smem_raw);          // [R, seg_len]
  float* e_s = reinterpret_cast<float*>(seg_s + (size_t)R * seg_len);  // [R, D]
  float* val_s = e_s + (size_t)R * D;                            // [D M]
  float* red_v = val_s + DM;                                     // [NW]
  int* red_i = reinterpret_cast<int*>(red_v + NW);               // [NW]
  int* tk_s = red_i + NW;                                        // [K]
  float* cfo_s = reinterpret_cast<float*>(tk_s + K);             // [1]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / K, k = blockIdx.x % K;
  const float2* xb = x + (size_t)b * R * T;
  const float* smb = sm + (size_t)b * n_t;

  // 1. coarse peaks 0..k
  int t_k = 0;
  for (int j = 0; j <= k; ++j) {
    float v = 0.f;
    int vi = -1;
    for (int base = tid; base < n_t; base += NT * LU) {
      float sv[LU];
#pragma unroll
      for (int u = 0; u < LU; ++u) {
        const int i = base + u * NT;
        sv[u] = i < n_t ? __ldg(smb + i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < LU; ++u) {
        const int i = base + u * NT;
        if (i >= n_t) break;
        float s = sv[u];
        for (int q = 0; q < j; ++q)
          if (abs(i - tk_s[q]) < L) s = -1.f;
        if (vi < 0 || beats(s, i, v, vi)) {
          v = s;
          vi = i;
        }
      }
    }
    block_argmax(v, vi, red_v, red_i);
    if (tid == 0) tk_s[j] = vi;
    t_k = vi;
    __syncthreads();
  }

  // 2a. the peak's segment, raw
  const int t0 = min(max(t_k - half, 0), T - seg_len);
#pragma unroll 4
  for (int i = tid; i < R * seg_len; i += NT) {
    const int r = i / seg_len, n = i % seg_len;
    seg_s[i] = xb[(size_t)r * T + t0 + n];
  }
  __syncthreads();

  // 2b. gates and CFO: warp 0, over the window inside the segment
  const size_t o = (size_t)b * K + k, BK = (size_t)B * K;
  if (warp == 0) {
    const int ws = min(max(t_k, 0), T - L) - t0;
    float cr = 0.f, ci = 0.f, p2 = 0.f;
    for (int r = 0; r < R; ++r) {
      const float2* xr = seg_s + (size_t)r * seg_len + ws;
#pragma unroll 4
      for (int n = lane; n < L - P; n += 32) {
        const float2 a = xr[n], c = xr[n + P];
        const float w = __ldg(wrep + n);
        const float pr = __fadd_rn(__fmul_rn(a.x, c.x), __fmul_rn(a.y, c.y));
        const float pi = __fsub_rn(__fmul_rn(a.y, c.x), __fmul_rn(a.x, c.y));
        cr = __fadd_rn(cr, __fmul_rn(pr, w));
        ci = __fadd_rn(ci, __fmul_rn(pi, w));
      }
#pragma unroll 4
      for (int n = lane; n < L; n += 32) {
        const float2 a = xr[n];
        p2 = __fadd_rn(p2, __fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y)));
      }
    }
    cr = warp_sum(cr);
    ci = warp_sum(ci);
    p2 = warp_sum(p2);
    if (lane == 0) {
      const float mag = __fsqrt_rn(__fadd_rn(__fmul_rn(cr, cr), __fmul_rn(ci, ci)));
      const float met = __fdiv_rn(__fmul_rn(norm, mag), fmaxf(p2, 1e-20f));
      const float rms = __fsqrt_rn(__fmul_rn(p2, inv_lr));
      const float cfo = __fmul_rn(-atan2f(ci, cr), inv_p);
      bool ok = met > thr && met < mmax && __ldg(smb + t_k) > thr;
      if (rms_gate) ok = ok && rms > rms_min && rms < rms_max;
      det[o] = ok;
      ti[BK + o] = t_k;             // t_coarse
      tf[o] = cfo;
      tf[BK + o] = met;
      tf[2 * BK + o] = rms;
      cfo_s[0] = cfo;
    }
  }
  __syncthreads();

  // 3a. the segment derotated by the CFO, in place
  const float cfo = cfo_s[0];
#pragma unroll 2
  for (int i = tid; i < R * seg_len; i += NT) {
    const int n = i % seg_len;
    const float2 s = seg_s[i];
    const float ph = -__fmul_rn(cfo, (float)n);
    const float c = cosf(ph), sn = sinf(ph);
    seg_s[i] = make_float2(__fsub_rn(__fmul_rn(s.x, c), __fmul_rn(s.y, sn)),
                           __fadd_rn(__fmul_rn(s.x, sn), __fmul_rn(s.y, c)));
  }
  __syncthreads();

  // 3b. the window energies: item (r, group of lags)
  const int nG = D / TD4, nS = D % TD4, nLG = nG + nS;
  for (int i = tid; i < R * nLG; i += NT) {
    const int r = i / nLG;
    int width;
    const int d = lag_group(i % nLG, nG, width);
    const float2* s = seg_s + (size_t)r * seg_len + d;
    float* e_r = e_s + (size_t)r * D + d;
    if (width == TD4) {
      float e[TD4] = {0.f, 0.f, 0.f, 0.f};
      energy_lags<TD4>(s, L, e);
#pragma unroll
      for (int j = 0; j < TD4; ++j) e_r[j] = e[j];
    } else {
      float e[1] = {0.f};
      energy_lags<1>(s, L, e);
      e_r[0] = e[0];
    }
  }
  __syncthreads();

  // 3c. the direct correlations: item (group of lags, template m, antenna
  // r), r fastest over Rp (R up to a power of two) lanes, whose lane r = 0
  // then adds the R antennas' values in order
  int Rp = 1;
  while (Rp < R) Rp <<= 1;
  const int n_items = nLG * M * Rp;
  for (int base = warp * 32; base < n_items; base += NT) {   // warp-uniform
    const int i = base + lane, r = i % Rp, gm = i / Rp, m = gm % M;
    int width;
    const int d = lag_group(gm / M, nG, width);
    float q[TD4] = {0.f, 0.f, 0.f, 0.f};
    if (i < n_items && r < R) {
      const float2* sr = seg_s + (size_t)r * seg_len + d;
      const float* er = e_s + (size_t)r * D + d;
      if (width == TD4) {
        float ar[TD4] = {0.f, 0.f, 0.f, 0.f}, ai[TD4] = {0.f, 0.f, 0.f, 0.f};
        corr_lags<TD4>(sr, tc + m, M, L, ar, ai);
#pragma unroll
        for (int j = 0; j < TD4; ++j)
          q[j] = __fdiv_rn(__fadd_rn(__fmul_rn(ar[j], ar[j]), __fmul_rn(ai[j], ai[j])),
                           fmaxf(er[j], 1e-20f));
      } else {
        float ar[1] = {0.f}, ai[1] = {0.f};
        corr_lags<1>(sr, tc + m, M, L, ar, ai);
        q[0] = __fdiv_rn(__fadd_rn(__fmul_rn(ar[0], ar[0]), __fmul_rn(ai[0], ai[0])),
                         fmaxf(er[0], 1e-20f));
      }
    }
    float val[TD4] = {q[0], q[1], q[2], q[3]};
    for (int rr = 1; rr < Rp; ++rr) {
#pragma unroll
      for (int j = 0; j < TD4; ++j) {
        const float o = __shfl_sync(0xffffffffu, q[j], (lane & ~(Rp - 1)) + rr);
        if (rr < R) val[j] = __fadd_rn(val[j], o);
      }
    }
    if (i < n_items && r == 0) {
      if (width == TD4) {
#pragma unroll
        for (int j = 0; j < TD4; ++j) val_s[(d + j) * M + m] = val[j];
      } else {
        val_s[d * M + m] = val[0];
      }
    }
  }
  __syncthreads();

  // 3d. fine peak
  float v = 0.f;
  int vi = -1;
  for (int j = tid; j < DM; j += NT) {
    const float s = val_s[j];
    if (vi < 0 || beats(s, j, v, vi)) {
      v = s;
      vi = j;
    }
  }
  block_argmax(v, vi, red_v, red_i);
  if (tid == 0) {
    ti[o] = t0 + vi / M;                    // t_fine
    ti[2 * BK + o] = (int)neff[vi % M];     // n_eff_tx
  }
}

}  // namespace

// x: complex64 [B, R, T] as float pairs; sm: float32 [B, T - L - P]; wrep:
// float32 [L - P]; tc: the conjugated templates, complex64 [L, M]; neff:
// int64 [M]. Writes det bool [B, K], ti int32 [3, B, K] (t_fine, t_coarse,
// n_eff_tx) and tf float32 [3, B, K] (cfo, metric, rms). rms_gate != 0 turns
// the RMS gate (rms_min, rms_max) on; inv_lr and inv_p are the float32
// reciprocals of L R and P. Launches B K blocks on `stream`; returns the
// cudaError_t of the launch, cudaErrorInvalidValue for a shape it does not
// serve (phy/ops/sync_report.py::_refusal names the reason).
extern "C" int sync_report(const void* x, const void* sm, const void* wrep,
                           const void* tc, const void* neff, void* det, void* ti,
                           void* tf, int B, int R, int T, int P, int L, int half,
                           int M, int K, float norm, float thr, float mmax,
                           int rms_gate, float rms_min, float rms_max, float inv_lr,
                           float inv_p, void* stream) {
  const int seg_len = L + 2 * half;
  if (B <= 0 || R <= 0 || R > 32 || K <= 0 || M <= 0 || P <= 0 || L <= P || half < 0 ||
      T - L - P <= 0 || seg_len > T || (long long)B * K > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(R, seg_len, 2 * half + 1, M, K);
  if (smem > SMEM_MAX) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        sync_report_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  sync_report_kernel<<<B * K, NT, smem, (cudaStream_t)stream>>>(
      (const float2*)x, (const float*)sm, (const float*)wrep, (const float2*)tc,
      (const long long*)neff, (uint8_t*)det, (int*)ti, (float*)tf, B, R, T, P, L,
      half, M, K, norm, thr, mmax, rms_gate, rms_min, rms_max, inv_lr, inv_p);
  return (int)cudaGetLastError();
}
