"""The sync chunk's report after detection: CUDA kernel wrapper and twins.

Given a chunk iq complex64 [B, R, T] and its smoothed, gated detection
metric sm float32 [B, n_t] (ops/sync_detect.py), the report of phy/sync.py
::Sync for up to K packets a row, fields [B, K]: detected (bool), t_fine,
t_coarse, n_eff_tx (int32), cfo, metric, rms (float32). Every function here
takes the sizes and tables explicitly: P (a pattern), L (the STF), half (the
fine search's half width; seg_len = L + 2 half, D = 2 half + 1 lags), norm,
params (a SyncParams: the gates), K, w_rep [L - P], neff [M], and the
templates: tconj, the conjugated time templates [L, M], or, for the plain
twin, Gc, their conjugated spectra [nfft, M].

`sync_report_plain` is the port's computation as it was inside
Sync.forward: argmax rounds, the peaks' O(L) windows summed by `_sum_rows`,
the fine search by FFT cross-correlation. It serves CPU tensors.
`sync_report_kernel` launches csrc/sync_report.cu, one block a peak, which
replaces no TPU kernel: it exists because the ~95 launches of the plain
twin's chain at the runtime's chunk [1, R, 2,496] cost the host ~2 ms for a
few microseconds of arithmetic. `sync_report_tiled` repeats the kernel's
order of float32 operations in plain torch (lane-strided peak sums and
their xor butterfly, the direct correlation, the window energies as direct
sums); the tests hold it to the plain twin and to JAX, and the kernel to
it. `sync_report` takes the kernel for a CUDA tensor and the plain twin for
a CPU one; a CUDA shape the kernel does not serve (`_refusal`) raises.
"""
from __future__ import annotations

import numpy as np
import torch

launches = 0          # kernel launches made by sync_report_kernel

_NT = 512             # threads a block (csrc/sync_report.cu)
_LANES = 32
_SMEM_MAX = 232448    # shared memory a block may take on an H100


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    """x [..., n] summed over its last dim in an order that does not depend
    on how many rows x has: 32 columns at a time, repeatedly (zero padded).
    PyTorch's CUDA reduction shares a long row among more threads when it
    has fewer rows (Reduce.cuh, set_block_dimension), so a plain .sum(-1)
    of the same row differs in its last bits between batch sizes; a row of
    at most 32 is always one warp's. The time-sharded search relies on it:
    its B = c_loc calls equal the dense search's one call bit for bit."""
    while x.shape[-1] > 1:
        pad = -x.shape[-1] % 32
        if pad:
            x = torch.cat([x, x.new_zeros((*x.shape[:-1], pad))], -1)
        x = x.reshape(*x.shape[:-1], -1, 32).sum(-1)
    return x[..., 0]


def _windows(x: torch.Tensor, start: torch.Tensor, n: int) -> torch.Tensor:
    """x [B, R, T], start [B, K] -> x[b, :, start[b,k]:+n] as [B, K, R, n]."""
    B, R, _ = x.shape
    idx = start[..., None] + torch.arange(n, device=x.device)       # [B,K,n]
    K = start.shape[1]
    return torch.gather(x[:, None].expand(B, K, R, x.shape[-1]), 3,
                        idx[:, :, None, :].expand(B, K, R, n))


def _coarse_peaks(sm: torch.Tensor, K: int, L: int) -> torch.Tensor:
    """t_coarse [B, K]: argmax rounds with +-1 STF masking between rounds."""
    tt = torch.arange(sm.shape[-1], device=sm.device)
    sm_cur, t_list = sm, []
    for _ in range(K):
        t_k = sm_cur.argmax(-1)
        t_list.append(t_k)
        if K > 1:
            sm_cur = torch.where((tt[None, :] - t_k[:, None]).abs() < L,
                                 torch.full_like(sm_cur, -1.0), sm_cur)
    return torch.stack(t_list, -1)


def _peak_vals(x, t_coarse, P, L, norm, w_rep):
    """metric / C / rms at the K peaks from O(L) windows."""
    R = x.shape[1]
    xw = _windows(x, t_coarse.clamp(0, x.shape[-1] - L), L)     # [B,K,R,L]
    pwin = xw[..., :L - P] * torch.conj(xw[..., P:])
    c = _sum_rows((pwin * w_rep).flatten(-2))
    p2 = _sum_rows((xw.abs() ** 2).flatten(-2))
    met = norm * c.abs() / p2.clamp_min(1e-20)
    rms = torch.sqrt(p2 / (L * R))
    return c, met, rms


def sync_report_plain(iq, sm, P, L, half, norm, params, K, w_rep, Gc, neff):
    """The report [B, K] of iq [B, R, T] with metric sm [B, n_t] in plain
    PyTorch: the FFT fine search of Sync.forward before the kernel."""
    pr, T = params, iq.shape[-1]
    seg_len, D = L + 2 * half, 2 * half + 1
    t_coarse = _coarse_peaks(sm, K, L)                          # [B,K]
    # both the instantaneous and the smoothed metric must clear the gate
    sm_pk = torch.gather(sm, -1, t_coarse)
    c_pk, peak_metric, peak_rms = _peak_vals(iq, t_coarse, P, L, norm, w_rep)
    inst_ok = (peak_metric > pr.metric_threshold) & \
        (peak_metric < pr.metric_max)
    if pr.rms_min > 0.0:
        inst_ok &= (peak_rms > pr.rms_min) & (peak_rms < pr.rms_max)
    detected = inst_ok & (sm_pk > pr.metric_threshold)
    cfo = -torch.angle(c_pk) / P                              # rad/sample

    # fine peak + N_eff_TX: FFT cross-correlation of the coarse-peak
    # segment against all templates (seg_len = L + D - 1, so one
    # nfft >= seg_len circular correlation is the valid linear one)
    t0 = (t_coarse - half).clamp(0, T - seg_len)
    seg = _windows(iq, t0, seg_len)                           # [B,K,R,S]
    n = torch.arange(seg_len, dtype=torch.float32, device=iq.device)
    seg = seg * torch.polar(torch.ones_like(n), -(cfo[..., None] * n))[:, :, None]
    A = torch.fft.fft(seg, n=Gc.shape[0], dim=-1)             # [B,K,R,nfft]
    xc = torch.fft.ifft(A[..., None] * Gc, dim=-2)[..., :D, :]
    cs = torch.cumsum(seg.abs() ** 2, -1)
    cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], -1)
    e_win = cs[..., L:L + D] - cs[..., :D]                    # [B,K,R,D]
    m = (xc.abs() ** 2 / e_win.clamp_min(1e-20)[..., None]).sum(2)  # [B,K,D,M]
    flat = m.flatten(-2).argmax(-1)
    M = m.shape[-1]
    t_fine = t0 + flat // M
    n_eff = neff[flat % M]
    return {"detected": detected, "t_fine": t_fine.to(torch.int32),
            "t_coarse": t_coarse.to(torch.int32),
            "cfo": cfo.to(torch.float32), "n_eff_tx": n_eff.to(torch.int32),
            "metric": peak_metric.to(torch.float32),
            "rms": peak_rms.to(torch.float32)}


def _smem(R: int, L: int, half: int, M: int, K: int) -> int:
    """Shared memory of a block (csrc/sync_report.cu::smem_bytes): the
    peak's segment, the window energies, the fine-search values, the K
    peaks and the scratch."""
    seg_len, D = L + 2 * half, 2 * half + 1
    return 8 * R * seg_len + 4 * (R * D + D * M) + 4 * (2 * _NT // _LANES + K) + 8


def _refusal(R: int, T: int, P: int, L: int, half: int, M: int, K: int) -> str:
    """Why the kernel does not serve a chunk [B, R, T] of a module of these
    sizes; "" where it does (the C entry refuses the same)."""
    if min(R, K, M, P) < 1 or L <= P or half < 0:
        return (f"sync report kernel: R = {R}, K = {K}, M = {M}, P = {P}, "
                f"L = {L}, half = {half}")
    if R > _LANES:
        return f"sync report kernel: R = {R} antennas, more than a warp's {_LANES} lanes"
    if T - L - P <= 0 or L + 2 * half > T:
        return (f"sync report kernel: T = {T} shorter than STF + one pattern "
                "or than the fine search's segment")
    smem = _smem(R, L, half, M, K)
    if smem > _SMEM_MAX:
        return (f"sync report kernel: a peak's {R} antenna segments, energies and "
                f"fine-search values take {smem} bytes, more than a block's "
                f"{_SMEM_MAX}")
    return ""


def _lane_sum(t: torch.Tensor) -> torch.Tensor:
    """t [..., R, N] summed in the kernel's order: lane l of a warp adds
    t[r, n] for n = l (mod 32), r-major, then a xor butterfly over the 32
    lanes (lane 0's order: own half first)."""
    acc = torch.zeros((*t.shape[:-2], _LANES), dtype=t.dtype, device=t.device)
    for r in range(t.shape[-2]):
        for n0 in range(0, t.shape[-1], _LANES):
            part = t[..., r, n0:n0 + _LANES]
            nv = part.shape[-1]
            acc = torch.cat([acc[..., :nv] + part, acc[..., nv:]], -1)
    while acc.shape[-1] > 1:
        h = acc.shape[-1] // 2
        acc = acc[..., :h] + acc[..., h:]
    return acc[..., 0]


def _f32(v: float) -> float:
    """v rounded to float32, as a Python float."""
    return float(np.float32(v))


def sync_report_tiled(iq, sm, P, L, half, norm, params, K, w_rep, tconj, neff):
    """The kernel's computation in plain torch, with its order of float32
    operations (every product and sum rounded on its own, as the kernel's
    _rn intrinsics do), on any device: the same report as the plain twin up
    to the order of the float32 sums."""
    pr = params
    B, R, T = iq.shape
    seg_len, D = L + 2 * half, 2 * half + 1
    t_coarse = _coarse_peaks(sm, K, L)                           # [B,K]

    xw = _windows(iq, t_coarse.clamp(0, T - L), L)              # [B,K,R,L]
    ax, ay = xw.real[..., :L - P], xw.imag[..., :L - P]
    cx, cy = xw.real[..., P:], xw.imag[..., P:]
    cr = _lane_sum((ax * cx + ay * cy) * w_rep)
    ci = _lane_sum((ay * cx - ax * cy) * w_rep)
    p2 = _lane_sum(xw.real * xw.real + xw.imag * xw.imag)
    mag = torch.sqrt(cr * cr + ci * ci)
    met = (_f32(norm) * mag) / p2.clamp_min(1e-20)
    rms = torch.sqrt(p2 * _f32(1.0 / (L * R)))
    cfo = -torch.atan2(ci, cr) * _f32(1.0 / P)
    ok = (met > pr.metric_threshold) & (met < pr.metric_max) & \
        (torch.gather(sm, -1, t_coarse) > pr.metric_threshold)
    if pr.rms_min > 0.0:
        ok &= (rms > pr.rms_min) & (rms < pr.rms_max)

    t0 = (t_coarse - half).clamp(0, T - seg_len)
    seg = _windows(iq, t0, seg_len)                              # [B,K,R,S]
    n = torch.arange(seg_len, dtype=torch.float32, device=iq.device)
    ph = -(cfo[..., None] * n)[:, :, None]                       # [B,K,1,S]
    co, sn = torch.cos(ph), torch.sin(ph)
    sx = seg.real * co - seg.imag * sn
    sy = seg.real * sn + seg.imag * co
    tx, ty = tconj.real, tconj.imag                              # [L, M]
    M = tx.shape[1]
    ar = torch.zeros((B, K, R, D, M), dtype=torch.float32, device=iq.device)
    ai = torch.zeros_like(ar)
    e = torch.zeros((B, K, R, D, 1), dtype=torch.float32, device=iq.device)
    for j in range(L):
        vx, vy = sx[..., j:j + D, None], sy[..., j:j + D, None]  # [B,K,R,D,1]
        ar = ar + (vx * tx[j] - vy * ty[j])
        ai = ai + (vx * ty[j] + vy * tx[j])
        e = e + (vx * vx + vy * vy)
    q = (ar * ar + ai * ai) / e.clamp_min(1e-20)                 # [B,K,R,D,M]
    val = torch.zeros_like(q[:, :, 0])
    for r in range(R):
        val = val + q[:, :, r]
    flat = val.flatten(-2).argmax(-1)                            # [B,K]
    return {"detected": ok, "t_fine": (t0 + flat // M).to(torch.int32),
            "t_coarse": t_coarse.to(torch.int32), "cfo": cfo,
            "n_eff_tx": neff[flat % M].to(torch.int32), "metric": met,
            "rms": rms}


def sync_report_kernel(iq, sm, P, L, half, norm, params, K, w_rep, tconj, neff):
    """The report [B, K] by the kernel: iq contiguous complex64 [B, R, T]
    and sm contiguous float32 [B, n_t] on one CUDA device, the tables there
    too. Raises ValueError on anything else, and on a shape `_refusal`
    names."""
    if iq.device.type != "cuda":
        raise ValueError(f"sync_report_kernel: unsupported device {iq.device}")
    if iq.dtype != torch.complex64 or iq.dim() != 3 or not iq.is_contiguous():
        raise ValueError("sync_report_kernel: iq must be contiguous complex64 [B, R, T]")
    B, R, T = iq.shape
    M = tconj.shape[1]
    why = _refusal(R, T, P, L, half, M, K)
    if why:
        raise ValueError(why)
    n_t = T - L - P
    if (sm.dtype != torch.float32 or sm.shape != (B, n_t)
            or not sm.is_contiguous() or sm.device != iq.device):
        raise ValueError("sync_report_kernel: sm must be contiguous float32 "
                         f"[{B}, {n_t}] on iq's device")
    if not all(t.device == iq.device and t.is_contiguous()
               for t in (w_rep, tconj, neff)):
        raise ValueError("sync_report_kernel: the tables are not contiguous on "
                         "iq's device")
    if (w_rep.dtype, tconj.dtype, neff.dtype) != (torch.float32, torch.complex64,
                                                   torch.int64) \
            or w_rep.shape != (L - P,) or tconj.shape != (L, M) or neff.shape != (M,):
        raise ValueError("sync_report_kernel: the tables must be float32 w_rep "
                         "[L - P], complex64 tconj [L, M], int64 neff [M]")
    from ... import kernels

    pr = params
    det = torch.empty((B, K), dtype=torch.bool, device=iq.device)
    ti = torch.empty((3, B, K), dtype=torch.int32, device=iq.device)
    tf = torch.empty((3, B, K), dtype=torch.float32, device=iq.device)
    err = kernels.load().sync_report(
        iq.data_ptr(), sm.data_ptr(), w_rep.data_ptr(), tconj.data_ptr(),
        neff.data_ptr(), det.data_ptr(), ti.data_ptr(), tf.data_ptr(), B, R, T,
        P, L, half, M, K, norm, pr.metric_threshold, pr.metric_max,
        int(pr.rms_min > 0.0), pr.rms_min, pr.rms_max, 1.0 / (L * R), 1.0 / P,
        kernels.stream_ptr(iq.device))
    kernels.check(err, "sync_report")
    global launches
    launches += 1
    return {"detected": det, "t_fine": ti[0], "t_coarse": ti[1], "cfo": tf[0],
            "n_eff_tx": ti[2], "metric": tf[1], "rms": tf[2]}


def sync_report(iq, sm, P, L, half, norm, params, K, w_rep, tconj, Gc, neff):
    """The report [B, K]: the kernel for a CUDA tensor (raising on a shape
    it does not serve), the plain twin for a CPU one."""
    if iq.device.type == "cuda":
        return sync_report_kernel(iq, sm, P, L, half, norm, params, K, w_rep,
                                  tconj, neff)
    return sync_report_plain(iq, sm, P, L, half, norm, params, K, w_rep, Gc, neff)
