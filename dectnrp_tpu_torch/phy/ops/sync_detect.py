"""Smoothed, gated STF detection metric: CUDA kernel wrapper and plain twins.

Port of dectnrp_tpu/phy/ops/sync_detect.py::build_sync_sm (the TPU kernel
chosen at dectnrp_tpu/phy/sync.py:148-151). For an IQ stream x [B, R, T]
with STF pattern length P = 16 b and n_pat patterns (L = n_pat P):

  C[t]  = sum_j w_j * sum_{i=t+jP}^{t+(j+1)P-1} x[i] conj(x[i+P])
  P2[t] = sum_{i=t}^{t+L-1} |x[i]|^2            (both summed over R antennas)
  metric = n_pat/(n_pat-1) * |C| / P2, gated to (thr, mmax), zero outside
  [0, n_t) with n_t = T - L - P, box-smoothed over [t-sl, t+sr] / k.

With rms_min > 0 the RMS window gate of JAX's XLA route
(dectnrp_tpu/phy/sync.py:176-177) also applies: rms = sqrt(P2 / (L R)) in
(rms_min, rms_max). The TPU kernel cannot fold it; the CUDA kernel does, as
the P2 interval `rms_gate_bounds` gives (the same decision at every P2),
and at rms_min <= 0 skips it, so its output is then what it was without.
The twins compute the RMS itself, as JAX does.

`detect_sm` launches the kernel (csrc/sync_detect.cu) for CUDA tensors and
runs `detect_sm_plain` (the `sm` of phy/sync.py::_detect_xla, T-long
blocked float32 prefix sums) for CPU tensors; any other device raises.
`detect_sm_tiled` repeats the kernel's decomposition and order of
operations in plain torch (rows of P samples on Q lanes, row-local prefix
sums, the telescoped C, the block's walk over its span with its rings); the
tests hold it to the float64 reference and the kernel to it.
The kernel serves DECT NR+'s b in {1, 2, 4, 8, 12, 16} (`kernel_plan`);
unlike the TPU kernel (P % 128 == 0) that includes b = 1, 2, 4 and 12.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

launches = 0          # kernel launches made by detect_sm

_NT = 256             # threads a block (csrc/sync_detect.cu)
_NPAT_MAX = 9         # the longest cover sequence (u > 1)
_W_SLOTS = 16
_SMEM_MAX = 232448    # shared memory a block may take on an H100
_LANES = {16: 16, 32: 32, 64: 32, 128: 32, 192: 32, 256: 32}   # P -> Q


def _prefix0(x: torch.Tensor, blk: int = 512) -> torch.Tensor:
    """Exclusive prefix sum along the last axis, blocked two-level form
    (port of dectnrp_tpu/phy/sync.py::_prefix0): concat([0, cumsum(x)])."""
    T = x.shape[-1]
    nb = -(-T // blk)
    xb = torch.cat([x, x.new_zeros((*x.shape[:-1], nb * blk - T))], -1)
    xb = xb.reshape(*x.shape[:-1], nb, blk)
    local = torch.cumsum(xb, -1)
    totals = local[..., -1]
    base = torch.cumsum(totals, -1) - totals
    incl = (local + base[..., None]).reshape(*x.shape[:-1], nb * blk)[..., :T]
    return torch.cat([torch.zeros_like(incl[..., :1]), incl], -1)


def detect_metric_plain(iq: torch.Tensor, P: int, w: torch.Tensor):
    """(metric [B, n_t], Cs [B, n_t], P2s [B, n_t]) by prefix sums."""
    n_pat = w.numel() + 1
    T = iq.shape[-1]
    L = n_pat * P
    n_t = T - L - P
    p = iq[..., :-P] * torch.conj(iq[..., P:])
    Sp = _prefix0(p)
    C = sum(w[j] * (Sp[..., (j + 1) * P:(j + 1) * P + n_t]
                    - Sp[..., j * P:j * P + n_t]) for j in range(n_pat - 1))
    Sw = _prefix0(iq.abs() ** 2)
    P2 = Sw[..., L:L + n_t] - Sw[..., :n_t]
    Cs, P2s = C.sum(1), P2.sum(1)
    metric = n_pat / (n_pat - 1) * Cs.abs() / P2s.clamp_min(1e-20)
    return metric, Cs, P2s


def detect_rms(P2s: torch.Tensor, n_lr: int) -> torch.Tensor:
    """The RMS gate's statistic sqrt(P2 / n_lr), n_lr = L R samples, as an
    IEEE division (by a tensor: torch multiplies by the reciprocal of a
    Python scalar on the card) and a square root, as JAX computes it."""
    return torch.sqrt(P2s / torch.full_like(P2s, float(n_lr)))


@lru_cache(maxsize=None)
def rms_gate_bounds(rms_min: float, rms_max: float, n_lr: int) -> tuple[float, float]:
    """(p2_lo, p2_hi): the float32 P2 for which rms = sqrt(P2 / n_lr), a
    float32 IEEE division and square root as JAX and the twins compute it,
    lies in (rms_min, rms_max) (as float32) are exactly [p2_lo, p2_hi].
    Both operations are monotone, so that set is an interval of P2; its
    ends are found by bisection over the bit patterns of the float32 values
    from 0 to inf (a NaN end: no P2 passes)."""
    n, r_lo, r_hi = np.float32(n_lr), np.float32(rms_min), np.float32(rms_max)

    def f32(bits):
        return np.array(bits, np.int32).view(np.float32)

    def first(pred):
        """Smallest bit pattern in [0, inf + 1] where the monotone pred holds."""
        a, b = 0, 0x7F800001
        while a < b:
            m = (a + b) // 2
            a, b = (a, m) if pred(np.sqrt(f32(m) / n)) else (m + 1, b)
        return a
    return (float(f32(first(lambda r: r > r_lo))),
            float(f32(first(lambda r: not r < r_hi) - 1)))


def detect_sm_plain(iq: torch.Tensor, P: int, w: torch.Tensor, sl: int,
                    sr: int, thr: float, mmax: float, *, rms_min: float = 0.0,
                    rms_max: float = math.inf) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: iq complex64 [B, R, T] -> sm [B, n_t]."""
    metric, _, P2s = detect_metric_plain(iq, P, w)
    gate = (metric > thr) & (metric < mmax)
    if rms_min > 0.0:
        rms = detect_rms(P2s, (w.numel() + 1) * P * iq.shape[1])
        gate &= (rms > rms_min) & (rms < rms_max)
    g = torch.where(gate, metric, torch.zeros_like(metric))
    k = sl + sr + 1
    Sm = _prefix0(torch.nn.functional.pad(g, (sl, sr)))
    return (Sm[..., k:] - Sm[..., :-k]) / k


def gate_tie_mask(metric: torch.Tensor, thr: float, mmax: float, sl: int,
                  sr: int, eps: float, rms: torch.Tensor | None = None,
                  rms_min: float = 0.0,
                  rms_max: float = math.inf) -> torch.Tensor:
    """[B, n_t] True where no sample in the smoothing window [t-sl, t+sr]
    has a metric within eps of a gate edge, nor, with the RMS gate on
    (rms_min > 0), an rms within eps relative of rms_min or rms_max.

    Two correct float32 implementations may gate such a sample differently
    (a tie), which moves sm by metric/k over the window; outside these
    windows the two must agree to rounding.
    """
    tie = (((metric - thr).abs() < eps) | ((metric - mmax).abs() < eps))
    if rms_min > 0.0:
        tie |= (rms - rms_min).abs() < eps * rms_min
        if math.isfinite(rms_max):
            tie |= (rms - rms_max).abs() < eps * rms_max
    k = sl + sr + 1
    S = _prefix0(torch.nn.functional.pad(tie.to(torch.float32), (sl, sr)))
    return (S[..., k:] - S[..., :-k]) == 0


@dataclass(frozen=True)
class KernelPlan:
    """The kernel's tiling of one shape: V samples on each of Q lanes make a
    row of P; G = 256 / Q rows a sub-tile; the R antennas taken RC at a time
    in n_c stages a sub-tile; `smem` bytes a block."""
    V: int
    Q: int
    G: int
    RC: int
    n_c: int
    n_t: int
    n_rows: int
    smem: int


def kernel_plan(R: int, T: int, P: int, n_pat: int, sl: int,
                sr: int) -> KernelPlan:
    """The kernel's tiling for x [B, R, T]; raises ValueError, with the
    reason, on a shape it does not serve (the C entry refuses the same).
    RC is all R where their x rows fit a block's shared memory, else the
    fewest even stages that fit."""
    if P not in _LANES:
        raise ValueError(f"sync kernel: P = {P} is not 16 b for a DECT NR+ b "
                         "in {1, 2, 4, 8, 12, 16} (a row is V samples on 16 "
                         "or 32 lanes)")
    if not 2 <= n_pat <= _NPAT_MAX:
        raise ValueError(f"sync kernel: n_pat = {n_pat} outside [2, {_NPAT_MAX}]")
    if R < 1:
        raise ValueError(f"sync kernel: R = {R} antennas")
    if sl < 0 or sr < 0 or sl > P or sr + 1 > P:
        raise ValueError(f"sync kernel: smoothing sl = {sl}, sr = {sr} must "
                         f"reach at most one row (sl <= P, sr + 1 <= P = {P})")
    n_t = T - (n_pat + 1) * P
    if n_t <= 0:
        raise ValueError("sync kernel: stream shorter than STF + one pattern")
    Q = _LANES[P]
    G = _NT // Q
    RS = G + n_pat
    rings = (RS * 3 * P + RS * 4 + (G + 2) * P + G + 4 + 2 * _W_SLOTS) * 4
    x_bytes = 2 * (G + 1) * P * 8          # one antenna's x rows, both halves
    n_c = -(-R // ((_SMEM_MAX - rings) // x_bytes))
    RC = -(-R // n_c)
    return KernelPlan(P // Q, Q, G, RC, n_c, n_t, -(-n_t // P),
                      rings + RC * x_bytes)


def auto_span(B: int, n_rows: int, G: int, resident: int) -> int:
    """Output rows a block walks: the streams' rows shared out so that the
    B x (blocks a stream) blocks fit the `resident` blocks the card holds at
    once (one wave), in whole sub-tiles of G rows."""
    per_stream = max(1, resident // B)
    span = -(-n_rows // per_stream)
    return -(-span // G) * G


def default_span(iq: torch.Tensor, P: int, n_pat: int, sl: int, sr: int) -> int:
    """The span `detect_sm` gives a block for iq [B, R, T] on the card."""
    B, R, T = iq.shape
    pl = kernel_plan(R, T, P, n_pat, sl, sr)
    dev = iq.device.index if iq.device.index is not None \
        else torch.cuda.current_device()
    return auto_span(B, pl.n_rows, pl.G, resident_blocks(dev, P, n_pat, pl.RC))


@lru_cache(maxsize=None)
def resident_blocks(device_index: int, P: int, n_pat: int, RC: int) -> int:
    """Blocks of the kernel the whole card holds at once with RC antennas a
    stage."""
    from ... import kernels

    n = kernels.load().sync_detect_blocks_per_sm(P, n_pat, RC)
    if n < 1:
        raise RuntimeError(f"sync kernel: occupancy query failed ({n})")
    return n * torch.cuda.get_device_properties(device_index).multi_processor_count


def _row_excl_scan(a: torch.Tensor, V: int, Q: int):
    """Row-local exclusive prefix of a [..., P] and the row totals [...], in
    the kernel's order: serial over each lane's V samples, then a
    Hillis-Steele scan of the Q lane totals."""
    a = a.reshape(*a.shape[:-1], Q, V)
    run = torch.zeros_like(a[..., 0])
    ex = []
    for k in range(V):
        ex.append(run)
        run = run + a[..., k]
    lane = torch.arange(Q, device=a.device)
    v, o = run, 1
    while o < Q:
        y = torch.cat([torch.zeros_like(v[..., :o]), v[..., :-o]], -1)
        v = torch.where(lane >= o, v + y, v)
        o *= 2
    off = torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1]], -1)
    pre = torch.stack([off + e for e in ex], -1)
    return pre.reshape(*pre.shape[:-2], Q * V), v[..., -1]


class _Ring:
    """A shared-memory ring of rows: slot = row mod n; a read checks that
    the slot still holds the row asked for."""

    def __init__(self, n: int, shape, device):
        self.n = n
        self.data = torch.zeros((n, *shape), dtype=torch.float32, device=device)
        self.tag = [None] * n

    def put(self, rows, vals, keep):
        for g, (row, k) in enumerate(zip(rows, keep)):
            if k:
                self.data[row % self.n] = vals[g]
                self.tag[row % self.n] = row

    def get(self, rows, check):
        for row, c in zip(rows, check):
            if c and self.tag[row % self.n] != row:
                raise AssertionError(f"ring slot of row {row} holds "
                                     f"{self.tag[row % self.n]}")
        return self.data[[row % self.n for row in rows]]


def detect_sm_tiled(iq: torch.Tensor, P: int, w: torch.Tensor, sl: int,
                    sr: int, thr: float, mmax: float,
                    span_rows: int | None = None, *, rms_min: float = 0.0,
                    rms_max: float = math.inf) -> torch.Tensor:
    """The kernel's computation in plain torch: sm [B, n_t] of iq complex64
    [B, R, T], block by block (each `span_rows` output rows of a stream,
    default all), sub-tile by sub-tile of G rows and antenna stage by stage,
    through the same buffers and rings, with the kernel's order of float32
    operations, the RMS gate included. Values do not depend on the span:
    every sum is row-local."""
    B, R, T = iq.shape
    n_pat = w.numel() + 1
    pl = kernel_plan(R, T, P, n_pat, sl, sr)
    V, Q, G, RC, n_c = pl.V, pl.Q, pl.G, pl.RC, pl.n_c
    n_t, n_rows = pl.n_t, pl.n_rows
    span = n_rows if span_rows is None else int(span_rows)
    if span < 1:
        raise ValueError(f"detect_sm_tiled: span_rows = {span}")
    dev, f32 = iq.device, torch.float32
    wf = w.to(f32).cpu()
    zero = torch.zeros((), dtype=f32)
    cw = [(wf[m - 1] if m > 0 else zero) - (wf[m] if m < n_pat - 1 else zero)
          for m in range(n_pat)]
    cw = [c.to(dev) for c in cw]
    c_nz = [float(c) != 0.0 for c in cw]
    wd = wf.to(dev)
    one = lambda v: torch.tensor(v, dtype=f32, device=dev)   # noqa: E731
    norm, inv_k = one(n_pat) / one(n_pat - 1), 1 / one(sl + sr + 1)
    thr32, mmax32, eps = one(thr), one(mmax), one(1e-20)

    # x in rows of P, zero outside [0, T), row i at xp[..., i - lo, :]
    lo = -(n_pat + 3 + 2 * G)
    hi = n_rows + n_pat + 2 * G + 3
    xr = torch.view_as_real(iq).to(f32)
    xp = torch.zeros((B, R, (hi - lo) * P, 2), dtype=f32, device=dev)
    xp[:, :, -lo * P:-lo * P + T] = xr
    xp = xp.reshape(B, R, hi - lo, P, 2)
    pos = torch.arange(P, device=dev)

    sm = torch.full((B, n_t), float("nan"), dtype=f32, device=dev)
    n_pro = -(-(n_pat + 3) // G)       # prologue sub-tiles (the kernel's -s_min)
    for o0 in range(0, n_rows, span):
        o_end = min(o0 + span, n_rows)
        n_it = -(-(o_end - o0) // G)
        # x double buffer: half h, row i holds (x row, stage) xtag[h][i]
        xbuf = torch.zeros((2, G + 1, B, RC, P, 2), dtype=f32, device=dev)
        xtag = [[None] * (G + 1) for _ in range(2)]

        def copy(s, c, h):
            js0 = o0 + 1 + s * G + n_pat
            r0 = c * RC
            nr = min(RC, R - r0)
            for i in range(G + 1):
                if o0 - 1 <= js0 + i <= o_end + n_pat + 1:
                    xbuf[h, i, :, :nr] = xp[:, r0:r0 + nr, js0 + i - lo]
                    xtag[h][i] = (js0 + i, c)

        pring = _Ring(G + n_pat, (B, 3, P), dev)
        ptot = _Ring(G + n_pat, (B, 3), dev)
        gring = _Ring(G + 2, (B, P), dev)
        gtot = _Ring(G + 2, (B,), dev)
        half = 0
        copy(-n_pro, 0, half)
        for s in range(-n_pro, n_it):
            bs = o0 + 1 + s * G
            js = [bs + n_pat + g for g in range(G)]
            need = [o0 - 1 <= j <= o_end + n_pat for j in js]
            for c in range(n_c):
                if c + 1 < n_c:
                    copy(s, c + 1, half ^ 1)
                elif s + 1 < n_it:
                    copy(s + 1, 0, half ^ 1)
                for g, j in enumerate(js):
                    if need[g] and xtag[half][g:g + 2] != [(j, c), (j + 1, c)]:
                        raise AssertionError(f"x buffer rows of row {j}, stage "
                                             f"{c} hold {xtag[half][g:g + 2]}")
                cur, nxt = xbuf[half, :G], xbuf[half, 1:]   # [G, B, RC, P, 2]
                if c == 0:
                    pr, pi, pw = (torch.zeros((G, B, P), dtype=f32, device=dev)
                                  for _ in range(3))
                for r in range(min(RC, R - c * RC)):
                    ax, ay = cur[:, :, r, :, 0], cur[:, :, r, :, 1]
                    cx, cy = nxt[:, :, r, :, 0], nxt[:, :, r, :, 1]
                    pr = pr + (ax * cx + ay * cy)
                    pi = pi + (ay * cx - ax * cy)
                    pw = pw + (ax * ax + ay * ay)
                half ^= 1
            scans = [_row_excl_scan(a, V, Q) for a in (pr, pi, pw)]
            pring.put(js, torch.stack([p for p, _ in scans], 2), need)
            ptot.put(js, torch.stack([t for _, t in scans], 2), need)

            ms = [bs + g for g in range(G)]
            need_g = [o0 - 1 <= m <= o_end for m in ms]
            tot = [ptot.get([m + jj for m in ms], need_g) for jj in range(n_pat)]
            ar = torch.zeros((G, B), dtype=f32, device=dev)
            ai, wsum = ar.clone(), ar.clone()
            for jj in range(n_pat):
                if jj < n_pat - 1:
                    ar = ar + wd[jj] * tot[jj][..., 0]
                    ai = ai + wd[jj] * tot[jj][..., 1]
                wsum = wsum + tot[jj][..., 2]
            cr = ar[..., None].expand(G, B, P)
            ci = ai[..., None].expand(G, B, P)
            for mm in range(n_pat):
                if c_nz[mm]:
                    src = pring.get([m + mm for m in ms], need_g)
                    cr = cr + cw[mm] * src[:, :, 0]
                    ci = ci + cw[mm] * src[:, :, 1]
            w0 = pring.get(ms, need_g)[:, :, 2]
            wN = pring.get([m + n_pat for m in ms], need_g)[:, :, 2]
            p2 = (wsum[..., None] - w0) + wN
            met = (norm * torch.sqrt(cr * cr + ci * ci)) * torch.reciprocal(
                torch.maximum(p2, eps))
            t = torch.tensor(ms, device=dev)[:, None, None] * P + pos
            gate = (t >= 0) & (t < n_t) & (met > thr32) & (met < mmax32)
            if rms_min > 0.0:
                rms = detect_rms(p2, n_pat * P * R)
                gate &= (rms > one(rms_min)) & (rms < one(rms_max))
            g = torch.where(gate, met, torch.zeros_like(met))
            gpre, gt = _row_excl_scan(g, V, Q)
            gring.put(ms, gpre, need_g)
            gtot.put(ms, gt, need_g)

            if s < 0:
                continue
            os_ = [bs - 1 + g for g in range(G)]
            need_o = [o < o_end for o in os_]
            gm = gring.get([o - 1 for o in os_], need_o)
            g0 = gring.get(os_, need_o)
            gp = gring.get([o + 1 for o in os_], need_o)
            tm = gtot.get([o - 1 for o in os_], need_o)[..., None]
            t0 = gtot.get(os_, need_o)[..., None]
            ra, rb = pos + sr + 1, pos - sl
            hi_ = torch.where(ra < P, g0[..., ra.clamp(max=P - 1)],
                              t0 + gp[..., (ra - P).clamp(min=0)])
            lo_ = torch.where(rb >= 0, g0[..., rb.clamp(min=0)],
                              gm[..., (rb + P).clamp(max=P - 1)] - tm)
            out = (hi_ - lo_) * inv_k                       # [G, B, P]
            for g, o in enumerate(os_):
                if need_o[g]:
                    n = min(P, n_t - o * P)
                    sm[:, o * P:o * P + n] = out[g, :, :n]
    if torch.isnan(sm).any():
        raise AssertionError("detect_sm_tiled: an output was never written")
    return sm


def detect_sm(iq: torch.Tensor, P: int, w: torch.Tensor, sl: int, sr: int,
              thr: float, mmax: float, *, rms_min: float = 0.0,
              rms_max: float = math.inf) -> torch.Tensor:
    """Smoothed gated metric sm [B, n_t] of iq complex64 [B, R, T].

    w: float32 [n_pat-1] pairwise cover weights, on iq's device.
    rms_min > 0 adds the RMS window gate (rms_min, rms_max).
    CUDA tensors launch the kernel, each block walking about one wave's
    share of a stream (`default_span`); CPU tensors run the plain twin.
    """
    if iq.device.type == "cpu":
        return detect_sm_plain(iq, P, w, sl, sr, thr, mmax, rms_min=rms_min,
                               rms_max=rms_max)
    if iq.device.type != "cuda":
        raise ValueError(f"detect_sm: unsupported device {iq.device}")
    if iq.dtype != torch.complex64 or iq.dim() != 3 or not iq.is_contiguous():
        raise ValueError("detect_sm: iq must be contiguous complex64 [B, R, T]")
    if w.dtype != torch.float32 or w.device != iq.device or not w.is_contiguous():
        raise ValueError("detect_sm: w must be contiguous float32 on iq's device")
    B, R, T = iq.shape
    n_pat = w.numel() + 1
    pl = kernel_plan(R, T, P, n_pat, sl, sr)
    span = default_span(iq, P, n_pat, sl, sr)
    from ... import kernels

    lib = kernels.load()
    p2_lo, p2_hi = (rms_gate_bounds(float(rms_min), float(rms_max), n_pat * P * R)
                    if rms_min > 0.0 else (0.0, 0.0))
    sm = torch.empty((B, pl.n_t), dtype=torch.float32, device=iq.device)
    err = lib.sync_detect_sm(torch.view_as_real(iq).data_ptr(), w.data_ptr(),
                             sm.data_ptr(), B, R, T, P, n_pat, sl, sr,
                             float(thr), float(mmax), p2_lo, p2_hi, pl.RC, span,
                             kernels.stream_ptr(iq.device))
    kernels.check(err, "sync_detect_sm")
    global launches
    launches += 1
    return sm
