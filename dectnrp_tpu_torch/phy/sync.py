"""STF synchronization: detection, coarse/fine peak, CFO, N_eff_TX.

Port of dectnrp_tpu/phy/sync.py (reference pipeline
lib/src/phy/rx/sync/sync_chunk.cpp:146-278: autocorrelator_detection ->
autocorrelator_peak -> crosscorrelator). The whole chunk's smoothed, gated
detection metric comes from the detection kernel (ops/sync_detect.py: the
CUDA kernel on the card, its plain twin on CPU); up to `max_peaks` packets
are found by argmax rounds with +-1 STF masking; metric, CFO and RMS are
recomputed per peak from O(L) windows; the fine peak and N_eff_TX come from
an FFT cross-correlation against all STF templates.

This is the JAX module's fused-detection branch (sync.py:234-238) on every
device, so CPU and card share one code path and differ only in `sm`. Like
that branch it does not fold an RMS gate into the smoothing (rms_min must be
<= 0). `est_beta_icfo` is not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..sections.part3.stf import cover_sequence, n_stf_patterns, stf_freq_grid
from ..sections.part3.transmission_packet_structure import get_N_samples_STF
from .ops.sync_detect import detect_sm
from .plan import register_tables


@dataclass(frozen=True)
class SyncParams:
    """Runtime equivalents of the reference's sync_param.hpp (as
    dectnrp_tpu.phy.sync.SyncParams; the RMS gate's upper bound is not
    ported because the gate itself is refused, see Sync)."""
    metric_threshold: float = 0.25
    metric_max: float = 1.5
    rms_min: float = 0.0        # must stay 0: no RMS window gate
    smooth_left: int = 7        # metric smoothing, x b samples (peak search)
    smooth_right: int = 1
    fine_search_half: int = 16  # x b samples around the coarse peak
    est_beta_icfo: bool = False


@lru_cache(maxsize=None)
def stf_time_template(u: int, b: int, N_eff_TX: int) -> np.ndarray:
    """Unit-energy time-domain STF (copy of the JAX builder)."""
    grid = stf_freq_grid(b, N_eff_TX)
    body = np.fft.ifft(np.fft.ifftshift(grid))
    pattern = body[: 16 * b]
    cover = cover_sequence(u)
    t = np.concatenate([c * pattern for c in cover])
    return (t / np.linalg.norm(t)).astype(np.complex64)


def _windows(x: torch.Tensor, start: torch.Tensor, n: int) -> torch.Tensor:
    """x [B, R, T], start [B, K] -> x[b, :, start[b,k]:+n] as [B, K, R, n]."""
    B, R, _ = x.shape
    idx = start[..., None] + torch.arange(n, device=x.device)       # [B,K,n]
    K = start.shape[1]
    return torch.gather(x[:, None].expand(B, K, R, x.shape[-1]), 3,
                        idx[:, :, None, :].expand(B, K, R, n))


class Sync(torch.nn.Module):
    """sync(iq complex64 [B, N_RX, T]) -> report dict.

    max_peaks == 1: fields [B]; max_peaks = K > 1: fields [B, K] ordered by
    descending smoothed metric. Fields: detected, t_fine, t_coarse, cfo
    (rad/sample), n_eff_tx, metric, rms.
    """

    def __init__(self, u: int, b: int, T: int,
                 neff_candidates: tuple[int, ...] = (1, 2, 4, 8),
                 params: SyncParams = SyncParams(), max_peaks: int = 1):
        super().__init__()
        if params.rms_min > 0.0:
            raise AssertionError(
                "fused detection does not fold the RMS gate into the smoothing")
        if params.est_beta_icfo:
            raise NotImplementedError("build_sync: est_beta_icfo is not ported yet")
        self.P = P = 16 * b
        self.n_pat = n_pat = n_stf_patterns(u)
        self.L = L = n_pat * P
        assert get_N_samples_STF(u, b) == L
        self.T, self.params, self.max_peaks = T, params, max_peaks
        self.n_t = T - L - P
        if self.n_t <= 0:
            raise ValueError("build_sync: chunk shorter than STF + one pattern")
        self.half = params.fine_search_half * b
        self.sl, self.sr = params.smooth_left * b, params.smooth_right * b
        self.norm = n_pat / (n_pat - 1)
        self.seg_len = L + 2 * self.half
        self.D = 2 * self.half + 1
        nfft = 1 << int(np.ceil(np.log2(self.seg_len)))
        cover = cover_sequence(u)
        w = (cover[:-1] * cover[1:]).astype(np.float32)
        templates = np.conj(np.stack(
            [stf_time_template(u, b, m) for m in neff_candidates], axis=1))
        register_tables(self, {
            "w": w, "w_rep": np.repeat(w, P).astype(np.float32),
            "Gc": np.conj(np.fft.fft(np.conj(templates), n=nfft, axis=0)),
            "neff": np.asarray(neff_candidates, np.int64)})
        self.nfft = nfft

    def _peak_vals(self, x, t_coarse):
        """metric / C / rms at the K peaks from O(L) windows."""
        L, P, R = self.L, self.P, x.shape[1]
        xw = _windows(x, t_coarse.clamp(0, self.T - L), L)        # [B,K,R,L]
        pwin = xw[..., :L - P] * torch.conj(xw[..., P:])
        c = (pwin * self.w_rep).sum((-2, -1))
        p2 = (xw.abs() ** 2).sum((-2, -1))
        met = self.norm * c.abs() / p2.clamp_min(1e-20)
        rms = torch.sqrt(p2 / (L * R))
        return c, met, rms

    def forward(self, iq: torch.Tensor) -> dict:
        pr, L, P = self.params, self.L, self.P
        sm = detect_sm(iq, P, self.w, self.sl, self.sr, pr.metric_threshold,
                       pr.metric_max)                             # [B,n_t]

        # coarse peaks: argmax rounds with +-1 STF masking between rounds
        tt = torch.arange(self.n_t, device=iq.device)
        sm_cur, t_list = sm, []
        for _ in range(self.max_peaks):
            t_k = sm_cur.argmax(-1)
            t_list.append(t_k)
            if self.max_peaks > 1:
                sm_cur = torch.where((tt[None, :] - t_k[:, None]).abs() < L,
                                     torch.full_like(sm_cur, -1.0), sm_cur)
        t_coarse = torch.stack(t_list, -1)                        # [B,K]
        # both the instantaneous and the smoothed metric must clear the gate
        sm_pk = torch.gather(sm, -1, t_coarse)
        c_pk, peak_metric, peak_rms = self._peak_vals(iq, t_coarse)
        inst_ok = (peak_metric > pr.metric_threshold) & \
            (peak_metric < pr.metric_max)
        detected = inst_ok & (sm_pk > pr.metric_threshold)
        cfo = -torch.angle(c_pk) / P                              # rad/sample

        # fine peak + N_eff_TX: FFT cross-correlation of the coarse-peak
        # segment against all templates (seg_len = L + D - 1, so one
        # nfft >= seg_len circular correlation is the valid linear one)
        D = self.D
        t0 = (t_coarse - self.half).clamp(0, self.T - self.seg_len)
        seg = _windows(iq, t0, self.seg_len)                      # [B,K,R,S]
        n = torch.arange(self.seg_len, dtype=torch.float32, device=iq.device)
        seg = seg * torch.polar(torch.ones_like(n), -(cfo[..., None] * n))[:, :, None]
        A = torch.fft.fft(seg, n=self.nfft, dim=-1)               # [B,K,R,nfft]
        xc = torch.fft.ifft(A[..., None] * self.Gc, dim=-2)[..., :D, :]
        cs = torch.cumsum(seg.abs() ** 2, -1)
        cs = torch.cat([torch.zeros_like(cs[..., :1]), cs], -1)
        e_win = cs[..., L:L + D] - cs[..., :D]                    # [B,K,R,D]
        m = (xc.abs() ** 2 / e_win.clamp_min(1e-20)[..., None]).sum(2)  # [B,K,D,M]
        flat = m.flatten(-2).argmax(-1)
        M = m.shape[-1]
        t_fine = t0 + flat // M
        n_eff = self.neff[flat % M]

        out = {"detected": detected, "t_fine": t_fine.to(torch.int32),
               "t_coarse": t_coarse.to(torch.int32),
               "cfo": cfo.to(torch.float32), "n_eff_tx": n_eff.to(torch.int32),
               "metric": peak_metric.to(torch.float32),
               "rms": peak_rms.to(torch.float32)}
        if self.max_peaks == 1:
            out = {k: v[..., 0] for k, v in out.items()}
        return out


def build_sync(u: int, b: int, T: int,
               neff_candidates: tuple[int, ...] = (1, 2, 4, 8),
               params: SyncParams = SyncParams(), max_peaks: int = 1) -> Sync:
    """Sync module for a [B, N_RX, T] chunk (dectnrp_tpu/phy/sync.py:108)."""
    return Sync(u, b, T, neff_candidates, params, max_peaks)


class RxStream(torch.nn.Module):
    """rx over an unaligned stream: sync-report-driven slice + CFO derotation.

    rx_stream(iq [B, N_RX, T], t0 [B], cfo [B], noise_var) -> rx dict.
    """

    def __init__(self, psdef, network_id: int, plcf_type: int, T: int, **rx_kw):
        super().__init__()
        from .rx import build_rx

        self.rx = build_rx(psdef, network_id, plcf_type, **rx_kw)
        self.n_pkt = self.rx.ps.N_samples_packet
        if T < self.n_pkt:
            raise ValueError("build_rx_stream: stream shorter than one packet")
        self.T = T

    def forward(self, iq, t0, cfo, noise_var):
        from .rx import _exp_ramp

        ramp = _exp_ramp(-cfo, self.n_pkt)                        # [B, n_pkt]
        start = t0.to(torch.int64).clamp(0, self.T - self.n_pkt)[:, None]
        seg = _windows(iq, start, self.n_pkt)[:, 0]               # [B,R,n_pkt]
        return self.rx(seg * ramp[:, None, :], noise_var)


def build_rx_stream(psdef, network_id: int, plcf_type: int, T: int,
                    **rx_kw) -> RxStream:
    """Stream RX module (dectnrp_tpu/phy/sync.py:392)."""
    return RxStream(psdef, network_id, plcf_type, T, **rx_kw)
