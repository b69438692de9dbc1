// Smoothed, gated STF detection metric, for Hopper.
//
// Replaces dectnrp_tpu/phy/ops/sync_detect.py::build_sync_sm (the TPU
// kernel at the head of phy/sync.py::build_sync) and computes its `sm`:
//   C[t]  = sum_j w_j * movsum_P(x[i] conj(x[i+P]))[t + jP]
//   P2[t] = movsum_L(|x|^2)[t]                (both summed over R antennas)
//   metric = n_pat/(n_pat-1) |C| / P2, gated to (thr, mmax) and t in [0, n_t),
//   and, where p2_lo > 0, to P2 in [p2_lo, p2_hi]: the RMS window gate
//   rms = sqrt(P2 / (n_pat P R)) in (rms_min, rms_max) (JAX phy/sync.py:
//   176-177, which the TPU kernel cannot fold and routes to XLA). IEEE
//   division and square root are monotone, so the gate is exactly an
//   interval of P2, whose float32 ends the wrapper finds on the host
//   (phy/ops/sync_detect.py::rms_gate_bounds): two compares a sample in
//   place of a division and a square root, the same decision at every
//   P2, ties included. p2_lo <= 0 skips the gate,
//   sm[t] = sum of the gated metric over [t-sl, t+sr], divided by k.
//
// Bound: memory. x is read once and sm written once (B R T 8 + B n_t 4
// bytes; 44.0 us at the flagship's B = 64, T = 192,512 on 3.35 TB/s); the
// arithmetic is ~60 flops a sample, far below the fp32 rate.
//
// Design: the TPU kernel's row decomposition at the pattern length P = 16 b,
// with a row of P samples on Q = 32 lanes (16 at b = 1), V = P/Q consecutive
// samples a lane. Every prefix sum is ROW-LOCAL (at most P terms), so
//   movsum_P(p)[iP+r] = Rp[i] - pre_p[i][r] + pre_p[i+1][r]
//   C[iP+r]  = sum_j w_j Rp[i+j] + sum_m c_m pre_p[i+m][r],
//              c_m = w_{m-1} - w_m (w_{-1} = w_{n_pat-1} = 0; 5 nonzero)
//   P2[iP+r] = sum_{j<n_pat} Rw[i+j] - pre_w[i][r] + pre_w[i+n_pat][r]
// and the box smoothing reads the gated metric's row-local prefix of rows
// i-1, i, i+1 (sl, sr+1 <= P). Against the three losses of the first version:
//  1. Scans in registers: a lane scans its V samples serially, one segmented
//     warp-shuffle scan over the Q lanes finishes the row. No barrier is
//     spent on a scan; a sub-tile of G = 256/Q rows costs 2 barriers (one
//     more for each further antenna stage, see 3).
//  2. One read of x: the x rows of a sub-tile (its G prefix rows and the
//     one after) are copied into shared memory with cp.async, 16 bytes a
//     thread, coalesced over the whole block, while the stage before
//     computes (no registers held, no load latency in the chain); row j's
//     product takes x row j+1 from the same copy, so each sample is read
//     from device memory once per block (the one row two sub-tiles share
//     again from L2). Spread over all warps, not a row a warp, the copy
//     also keeps the b = 16 instance below 128 registers. A block walks a
//     long span of rows (about one wave over the card, chosen by the wrapper
//     from the occupancy below) in sub-tiles of G rows; the n_pat+1 prefix rows and
//     2 metric rows a sub-tile shares with the next stay in shared rings, so
//     only the span's first n_pat+2 rows are a halo. Row-local sums need no
//     rebasing.
//  3. Antennas are summed in registers before the scans (the moving sums are
//     linear): a sub-tile takes its antennas in stages of RC (all R where
//     they fit), each stage's x rows in one half of a double buffer, so the
//     shared memory a block takes does not grow with R. C and P2 are formed
//     in registers from the telescoped form, 5 complex (8-byte) + 2 real
//     shared reads an output, in a [k][lane] layout with lanes on
//     consecutive words: no bank conflicts (the x rows are swizzled for
//     their 16-byte reads, see swz).
// Products and sums use __fmul_rn / __fadd_rn where a contraction into an FMA
// would round differently from the tiled twin (phy/ops/sync_detect.py
// ::detect_sm_tiled), which repeats this order of operations; FMAs remain
// only where the product is exact (weights +-1, +-2). The two divisions are
// multiplications by an IEEE reciprocal (1/P2 and 1/k), as in the twin.
//
// Serves DECT NR+'s b in {1, 2, 4, 8, 12, 16}, every R and every u; the TPU
// kernel's P % 128 == 0 limit does not apply.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;         // threads per block
constexpr int NPAT_MAX = 9;     // longest cover sequence (u > 1)
constexpr int W_SLOTS = 16;     // shared floats kept for w and c (16-byte alignment)
constexpr size_t SMEM_MAX = 232448;

constexpr int lanes_of(int P) { return P == 16 ? 16 : 32; }

__device__ __forceinline__ int pmod(int a, int m) {
  const int r = a % m;
  return r < 0 ? r + m : r;
}

// Row-local exclusive prefix of a[0..V) across the Q lanes of a row: serial
// over V, then a Hillis-Steele shuffle scan of the lane totals. Returns the
// row total. All 32 lanes of the warp must call it.
template <int V, int Q>
__device__ __forceinline__ float row_excl_scan(float (&a)[V], int lq) {
  float run = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float t = a[k];
    a[k] = run;
    run = __fadd_rn(run, t);
  }
  float v = run;
#pragma unroll
  for (int o = 1; o < Q; o <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, v, o, Q);
    if (lq >= o) v = __fadd_rn(v, y);
  }
  float off = __shfl_up_sync(0xffffffffu, v, 1, Q);
  if (lq == 0) off = 0.f;
  const float tot = __shfl_sync(0xffffffffu, v, Q - 1, Q);
#pragma unroll
  for (int k = 0; k < V; ++k) a[k] = __fadd_rn(off, a[k]);
  return tot;
}

// The x buffer keeps each row in sample order, in 16-byte chunks of two
// samples; chunk c of a row sits at swz<V>(c), which spreads the chunks a
// quarter-warp reads at once (lane lq reads chunks lq V/2 .. lq V/2 + V/2-1)
// over the 8 bank groups, while the copy writes consecutive chunks.
template <int V>
__device__ __forceinline__ int swz(int c) {
  if constexpr (V == 8) return c ^ ((c >> 3) & 3);
  else if constexpr (V == 4) return c ^ ((c >> 3) & 1);
  else return c;
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes,
                                         int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (bytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
}

// Lane lq's V samples of a buffered x row.
template <int V, int Q>
__device__ __forceinline__ void read_run(const float2* row, int lq, float2 (&v)[V]) {
  if constexpr (V % 2 == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
    for (int h = 0; h < V / 2; ++h) {
      const float4 f = r4[swz<V>(lq * (V / 2) + h)];
      v[2 * h] = make_float2(f.x, f.y);
      v[2 * h + 1] = make_float2(f.z, f.w);
    }
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const int e = lq * V + k;
      v[k] = row[2 * swz<V>(e >> 1) + (e & 1)];
    }
  }
}

// 2 blocks an SM, which their shared memory allows: at most 128 registers
template <int V, int Q>
__global__ void __launch_bounds__(NT, 2)
sync_sm_kernel(const float2* __restrict__ x, const float* __restrict__ w,
               float* __restrict__ sm, int R, int T, int n_pat, int sl, int sr,
               float thr, float mmax, float p2_lo, float p2_hi, int RC,
               int n_rows, int span, int n_span, int vec_in, int vec_out) {
  constexpr int P = Q * V;
  constexpr int G = NT / Q;           // row groups: rows a sub-tile
  extern __shared__ float smem[];
  const int RS = G + n_pat;           // prefix-row ring
  float* pre = smem;                  // [RS]: float2 pre_p [V][Q], pre_w [V][Q]
  float* pre_tot = pre + RS * 3 * P;  // [RS][4]: Rp re, im, Rw
  float* gr = pre_tot + RS * 4;       // [G+2][V][Q]: gated metric prefix
  float* g_tot = gr + (G + 2) * P;    // [G+4]
  float* cw = g_tot + (G + 4);        // c_m [W_SLOTS]
  float* ww = cw + W_SLOTS;           // w_j [W_SLOTS]
  float2* xr = reinterpret_cast<float2*>(ww + W_SLOTS);  // [2][G+1][RC][P]

  const int tid = threadIdx.x;
  const int lq = tid % Q, grp = tid / Q;
  const int b = blockIdx.x / n_span;
  const int o0 = (blockIdx.x % n_span) * span;
  const int o_end = min(o0 + span, n_rows);
  const int n_t = T - n_pat * P - P;
  const int ksm = sl + sr + 1;
  const float norm = (float)n_pat / (float)(n_pat - 1);
  const float inv_k = __frcp_rn((float)ksm);
  const float2* xb = x + (size_t)b * R * T;

  if (tid < n_pat)
    cw[tid] = (tid > 0 ? w[tid - 1] : 0.f) - (tid < n_pat - 1 ? w[tid] : 0.f);
  if (tid < n_pat - 1) ww[tid] = w[tid];
  __syncthreads();

  // sub-tile s: prefix rows [js, js+G), gated metric rows [bs, bs+G) and
  // output rows [bs-1, bs-1+G) with bs = o0 + 1 + s G, js = bs + n_pat.
  // s_min starts below the span's first prefix row (o0 - 1), so the x row
  // of every prefix row it needs was loaded by this block.
  const int s_min = -((n_pat + 3 + G - 1) / G);
  const int n_it = (o_end - o0 + G - 1) / G;
  const int n_c = (R + RC - 1) / RC;  // antenna stages a sub-tile
  // stage (s, c): x rows js .. js+G of antennas [c RC, c RC + RC) into
  // buffer half h, spread over all NT threads: 16-byte chunks of two
  // samples where T is even and x 16-byte aligned, else 8-byte samples
  auto start_copy = [&](int s_, int c_, int h) {
    const int js0 = o0 + 1 + s_ * G + n_pat;
    const int r0 = c_ * RC, nr = min(RC, R - r0);
    float2* dst = xr + (size_t)h * (G + 1) * RC * P;
    if (vec_in) {
#pragma unroll 1
      for (int r = 0; r < nr; ++r) {
        const float2* xa = xb + (size_t)(r0 + r) * T;
        for (int id = tid; id < (G + 1) * (P / 2); id += NT) {
          const int i = id / (P / 2), cc = id % (P / 2);
          const int row = js0 + i;
          if (row >= o0 - 1 && row <= o_end + n_pat + 1) {
            const long long e = (long long)row * P + 2 * cc;
            const int n = (e < 0 || e >= T) ? 0 : (e + 1 < T ? 16 : 8);
            cp_async(dst + ((size_t)i * RC + r) * P + 2 * swz<V>(cc),
                     n ? xa + e : xa, 16, n);
          }
        }
      }
    } else {
#pragma unroll 1
      for (int r = 0; r < nr; ++r) {
        const float2* xa = xb + (size_t)(r0 + r) * T;
        for (int id = tid; id < (G + 1) * P; id += NT) {
          const int i = id / P, k = id % P;
          const int row = js0 + i;
          if (row >= o0 - 1 && row <= o_end + n_pat + 1) {
            const long long e = (long long)row * P + k;
            const int n = (e >= 0 && e < T) ? 8 : 0;
            cp_async(dst + ((size_t)i * RC + r) * P + 2 * swz<V>(k >> 1) + (k & 1),
                     n ? xa + e : xa, 8, n);
          }
        }
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  start_copy(s_min, 0, 0);

  // output row o: box sum from the gated prefix of rows o-1, o, o+1
  auto output_row = [&](int o) {
    const int so = pmod(o, G + 2);
    const int sp = so == 0 ? G + 1 : so - 1;
    const int sn = so == G + 1 ? 0 : so + 1;
    const float* gm = gr + (size_t)sp * P;
    const float* g0 = gr + (size_t)so * P;
    const float* gp = gr + (size_t)sn * P;
    const float tm = g_tot[sp], t0 = g_tot[so];
    float out[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      // sample lq V + k + d of row o sits at lane lq + floor(d / V), slot
      // (d mod V): the same for every lane, so the index math is uniform
      const int da = k + sr + 1, db = k - sl;
      const int qa = da / V, qb = db >= 0 ? db / V : -((V - 1 - db) / V);
      const int la = lq + qa, lb = lq + qb;
      const float ha = *((la < Q ? g0 + la : gp + la - Q) + (da - qa * V) * Q);
      const float hb = *((lb >= 0 ? g0 + lb : gm + lb + Q) + (db - qb * V) * Q);
      const float hi = la < Q ? ha : __fadd_rn(t0, ha);
      const float lo = lb >= 0 ? hb : __fsub_rn(hb, tm);
      out[k] = __fmul_rn(__fsub_rn(hi, lo), inv_k);
    }
    const long long t0g = (long long)o * P + lq * V;
    float* dst = sm + (size_t)b * n_t + t0g;
    if constexpr (V % 4 == 0) {
      if (vec_out && t0g + V <= n_t) {
#pragma unroll
        for (int h = 0; h < V / 4; ++h)
          reinterpret_cast<float4*>(dst)[h] =
              make_float4(out[4 * h], out[4 * h + 1], out[4 * h + 2], out[4 * h + 3]);
        return;
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (t0g + k < n_t) dst[k] = out[k];
  };

  // stage c of the sub-tile: add its antennas' products and powers to
  // prefix row j (x rows j, j+1 at rows grp, grp+1 of buffer half `hf`),
  // antenna after antenna from 0 as the twin adds them
  float pr[V], pi[V], pw[V];
  auto add_stage = [&](int c, int hf) {
    const float2* cur = xr + ((size_t)hf * (G + 1) + grp) * RC * P;
    const float2* nxt = cur + (size_t)RC * P;
    const int nr = min(RC, R - c * RC);
#pragma unroll 1
    for (int r = 0; r < nr; ++r) {
      float2 a[V], e[V];
      read_run<V, Q>(cur + (size_t)r * P, lq, a);
      read_run<V, Q>(nxt + (size_t)r * P, lq, e);
#pragma unroll
      for (int k = 0; k < V; ++k) {
        // x[i] conj(x[i+P]) and |x[i]|^2
        const float qr = __fadd_rn(__fmul_rn(a[k].x, e[k].x), __fmul_rn(a[k].y, e[k].y));
        const float qi = __fsub_rn(__fmul_rn(a[k].y, e[k].x), __fmul_rn(a[k].x, e[k].y));
        const float qw = __fadd_rn(__fmul_rn(a[k].x, a[k].x), __fmul_rn(a[k].y, a[k].y));
        pr[k] = __fadd_rn(pr[k], qr);
        pi[k] = __fadd_rn(pi[k], qi);
        pw[k] = __fadd_rn(pw[k], qw);
      }
    }
  };
  // a stage's x rows have landed; start the next stage's copy
  auto next_stage = [&](int s, int c, int hf) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
    if (c + 1 < n_c) start_copy(s, c + 1, hf ^ 1);
    else if (s + 1 < n_it) start_copy(s + 1, 0, hf ^ 1);
  };

  // iteration s also writes the output rows of iteration s-1, whose metric
  // rows are complete at its first barrier: 1 + n_c barriers a sub-tile
  int half = 0;                       // buffer half of the current stage
  for (int s = s_min; s <= n_it; ++s) {
    const int bs = o0 + 1 + s * G;
    const int j = bs + n_pat + grp;   // this group's prefix row

    next_stage(s, 0, half);
    if (s >= 1 && bs - 1 - G + grp < o_end) output_row(bs - 1 - G + grp);
    if (s == n_it) break;

    // ---- prefix row j: antennas summed, stage by stage, then scanned
    {
#pragma unroll
      for (int k = 0; k < V; ++k) pr[k] = pi[k] = pw[k] = 0.f;
      add_stage(0, half);
#pragma unroll 1
      for (int c = 1; c < n_c; ++c) {
        half ^= 1;
        next_stage(s, c, half);
        add_stage(c, half);
      }
      half ^= 1;
      const float tr = row_excl_scan<V, Q>(pr, lq);
      const float ti = row_excl_scan<V, Q>(pi, lq);
      const float tw = row_excl_scan<V, Q>(pw, lq);
      if (j >= o0 - 1 && j <= o_end + n_pat) {
        const int sj = pmod(j, RS);
        float* dst = pre + (size_t)sj * 3 * P;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          reinterpret_cast<float2*>(dst)[k * Q + lq] = make_float2(pr[k], pi[k]);
          dst[2 * P + k * Q + lq] = pw[k];
        }
        if (lq == 0) {
          pre_tot[sj * 4] = tr;
          pre_tot[sj * 4 + 1] = ti;
          pre_tot[sj * 4 + 2] = tw;
        }
      }
    }
    __syncthreads();

    // ---- gated metric row m from prefix rows m .. m+n_pat
    {
      const int m = bs + grp;
      int slot[NPAT_MAX + 1];         // ring slots of rows m .. m+n_pat
      slot[0] = pmod(m, RS);
#pragma unroll
      for (int jj = 1; jj <= NPAT_MAX; ++jj)
        slot[jj] = slot[jj - 1] + 1 == RS ? 0 : slot[jj - 1] + 1;
      float ar = 0.f, ai = 0.f, wsum = 0.f;
#pragma unroll
      for (int jj = 0; jj < NPAT_MAX; ++jj) {
        if (jj < n_pat) {
          const float* tt = pre_tot + slot[jj] * 4;
          if (jj < n_pat - 1) {
            // w_j = +-1: the product is exact, so the FMA rounds as add does
            ar = fmaf(ww[jj], tt[0], ar);
            ai = fmaf(ww[jj], tt[1], ai);
          }
          wsum = __fadd_rn(wsum, tt[2]);
        }
      }
      float cr[V], ci[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        cr[k] = ar;
        ci[k] = ai;
      }
#pragma unroll
      for (int mm = 0; mm < NPAT_MAX; ++mm) {
        const float c = cw[mm];
        if (mm < n_pat && c != 0.f) {
          // c_m in {+-1, +-2}: exact products again
          const float2* src = reinterpret_cast<const float2*>(pre + (size_t)slot[mm] * 3 * P);
#pragma unroll
          for (int k = 0; k < V; ++k) {
            const float2 v = src[k * Q + lq];
            cr[k] = fmaf(c, v.x, cr[k]);
            ci[k] = fmaf(c, v.y, ci[k]);
          }
        }
      }
      const float* w0 = pre + (size_t)slot[0] * 3 * P + 2 * P;
      const float* wN = pre + (size_t)pmod(m + n_pat, RS) * 3 * P + 2 * P;
      float g[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        const float p2 = __fadd_rn(__fsub_rn(wsum, w0[k * Q + lq]), wN[k * Q + lq]);
        const float mag = sqrtf(__fadd_rn(__fmul_rn(cr[k], cr[k]), __fmul_rn(ci[k], ci[k])));
        const float met = __fmul_rn(__fmul_rn(norm, mag), __frcp_rn(fmaxf(p2, 1e-20f)));
        const long long t = (long long)m * P + lq * V + k;
        const bool rms_ok = p2_lo <= 0.f || (p2 >= p2_lo && p2 <= p2_hi);
        g[k] = (t >= 0 && t < n_t && met > thr && met < mmax && rms_ok) ? met : 0.f;
      }
      const float tg = row_excl_scan<V, Q>(g, lq);
      if (m >= o0 - 1 && m <= o_end) {
        const int sg = pmod(m, G + 2);
        float* dst = gr + (size_t)sg * P;
#pragma unroll
        for (int k = 0; k < V; ++k) dst[k * Q + lq] = g[k];
        if (lq == 0) g_tot[sg] = tg;
      }
    }
    // no further barrier: the copies the next iteration starts after its
    // first barrier go to the buffer half read before it, and its prefix
    // and metric rows, written after its last stage's and its scan barrier,
    // overwrite rows last read before those barriers.
  }
}

using KernelFn = void (*)(const float2*, const float*, float*, int, int, int, int,
                          int, float, float, float, float, int, int, int, int,
                          int, int);

KernelFn pick(int P) {
  switch (P) {
    case 16: return sync_sm_kernel<1, 16>;
    case 32: return sync_sm_kernel<1, 32>;
    case 64: return sync_sm_kernel<2, 32>;
    case 128: return sync_sm_kernel<4, 32>;
    case 192: return sync_sm_kernel<6, 32>;
    case 256: return sync_sm_kernel<8, 32>;
    default: return nullptr;
  }
}

// Shared memory a block takes with RC antennas a stage (bytes); the wrapper
// (phy/ops/sync_detect.py::kernel_plan) picks RC from the same count.
size_t smem_bytes(int P, int n_pat, int RC) {
  const int G = NT / lanes_of(P);
  const size_t RS = G + n_pat;
  const size_t floats = RS * 3 * P + RS * 4 + (size_t)(G + 2) * P + (G + 4) +
                        2 * W_SLOTS;
  return floats * sizeof(float) + (size_t)2 * (G + 1) * RC * P * sizeof(float2);
}

// The tiling's assumptions; 0 when the shape is served.
int check_shape(int R, int T, int P, int n_pat, int sl, int sr, int RC) {
  if (pick(P) == nullptr || R <= 0 || RC <= 0 || RC > R || n_pat < 2 ||
      n_pat > NPAT_MAX || sl < 0 || sr < 0 || sl > P || sr + 1 > P ||
      T - (n_pat + 1) * P <= 0 || smem_bytes(P, n_pat, RC) > SMEM_MAX)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

// Blocks of the kernel serving P an SM holds at once with RC antennas a
// stage (the occupancy calculator's answer), or -1 if that is not served.
extern "C" int sync_detect_blocks_per_sm(int P, int n_pat, int RC) {
  KernelFn k = pick(P);
  if (k == nullptr || check_shape(RC, (n_pat + 2) * P, P, n_pat, 0, 0, RC) != 0)
    return -1;
  const size_t smem = smem_bytes(P, n_pat, RC);
  int n = 0;
  if (cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, NT, smem) != cudaSuccess)
    return -1;
  return n;
}

// x: complex64 [B, R, T] as interleaved float32 pairs; w: float32 [n_pat-1];
// sm: float32 [B, n_t], n_t = T - (n_pat+1) P; p2_lo > 0 turns the RMS gate
// (P2 in [p2_lo, p2_hi]) on, p2_lo <= 0 leaves it off. Each block walks `span`
// output rows of P samples of one stream and takes the antennas RC at a
// time. Launches on `stream`; returns the cudaError_t of the launch,
// cudaErrorInvalidValue for a shape the tiling does not serve or an RC
// whose buffers exceed a block's shared memory (phy/ops/sync_detect.py
// ::kernel_plan names the reason).
extern "C" int sync_detect_sm(const void* x, const void* w, void* sm, int B,
                              int R, int T, int P, int n_pat, int sl, int sr,
                              float thr, float mmax, float p2_lo, float p2_hi,
                              int RC, int span, void* stream) {
  if (B <= 0 || span <= 0 || check_shape(R, T, P, n_pat, sl, sr, RC) != 0)
    return (int)cudaErrorInvalidValue;
  const int n_t = T - (n_pat + 1) * P;
  const int n_rows = (n_t + P - 1) / P;
  const int n_span = (n_rows + span - 1) / span;
  if ((long long)n_span * B > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  KernelFn k = pick(P);
  const size_t smem = smem_bytes(P, n_pat, RC);
  cudaError_t e = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int vec_in = (T % 2 == 0) && ((uintptr_t)x % 16 == 0);
  const int vec_out = (n_t % 4 == 0) && ((uintptr_t)sm % 16 == 0);
  k<<<n_span * B, NT, smem, (cudaStream_t)stream>>>(
      (const float2*)x, (const float*)w, (float*)sm, R, T, n_pat, sl, sr, thr,
      mmax, p2_lo, p2_hi, RC, n_rows, span, n_span, vec_in, vec_out);
  return (int)cudaGetLastError();
}
