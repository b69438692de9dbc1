"""STF synchronization: detection, coarse/fine peak, CFO, N_eff_TX.

Port of dectnrp_tpu/phy/sync.py (reference pipeline
lib/src/phy/rx/sync/sync_chunk.cpp:146-278: autocorrelator_detection ->
autocorrelator_peak -> crosscorrelator). The whole chunk's smoothed, gated
detection metric comes from the detection kernel (ops/sync_detect.py: the
CUDA kernel on the card, its plain twin on CPU); up to `max_peaks` packets
are found by argmax rounds with +-1 STF masking; metric, CFO and RMS are
recomputed per peak from O(L) windows; the fine peak and N_eff_TX come from
a cross-correlation against all STF templates. That report after detection
is ops/sync_report.py: one kernel launch (csrc/sync_report.cu) for a CUDA
chunk, its plain twin (an FFT correlation) for a CPU one.

This is the JAX module's fused-detection branch (sync.py:234-238) on every
device, so CPU and card share one code path and differ only in `sm` and in
the report's order of float32 sums (the kernel's direct fine search). Unlike
that branch it also serves the RMS window gate (rms_min > 0, which JAX
routes to its XLA detection, sync.py:176-177): the detection kernel folds
it into the smoothing, and the peaks' own RMS must pass it too. With
`est_beta_icfo` the f-domain stage (`build_beta_icfo`, JAX sync.py:319-389)
reports each peak's bandwidth beta and integer CFO in bins.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from ..sections.part3.stf import cover_sequence, n_stf_patterns, stf_freq_grid
from ..sections.part3.transmission_packet_structure import get_N_samples_STF
from .ops.sync_detect import detect_sm
from .ops.sync_report import _windows, sync_report
from .plan import register_tables


@dataclass(frozen=True)
class SyncParams:
    """Runtime equivalents of the reference's sync_param.hpp (as
    dectnrp_tpu.phy.sync.SyncParams). rms gates default off (simulator)."""
    metric_threshold: float = 0.25
    metric_max: float = 1.5
    rms_min: float = 0.0        # 0 disables the RMS window gate
    rms_max: float = float("inf")
    smooth_left: int = 7        # metric smoothing, x b samples (peak search)
    smooth_right: int = 1
    fine_search_half: int = 16  # x b samples around the coarse peak
    est_beta_icfo: bool = False # f-domain beta + integer-CFO stage


@lru_cache(maxsize=None)
def stf_time_template(u: int, b: int, N_eff_TX: int) -> np.ndarray:
    """Unit-energy time-domain STF (copy of the JAX builder)."""
    grid = stf_freq_grid(b, N_eff_TX)
    body = np.fft.ifft(np.fft.ifftshift(grid))
    pattern = body[: 16 * b]
    cover = cover_sequence(u)
    t = np.concatenate([c * pattern for c in cover])
    return (t / np.linalg.norm(t)).astype(np.complex64)


class Sync(torch.nn.Module):
    """sync(iq complex64 [B, N_RX, T]) -> report dict.

    max_peaks == 1: fields [B]; max_peaks = K > 1: fields [B, K] ordered by
    descending smoothed metric. Fields: detected, t_fine, t_coarse, cfo
    (rad/sample), n_eff_tx, metric, rms; with est_beta_icfo also beta and
    cfo_int (integer CFO in bins of the 64 b FFT).
    """

    def __init__(self, u: int, b: int, T: int,
                 neff_candidates: tuple[int, ...] = (1, 2, 4, 8),
                 params: SyncParams = SyncParams(), max_peaks: int = 1):
        super().__init__()
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
            "tconj": np.ascontiguousarray(templates),
            "neff": np.asarray(neff_candidates, np.int64)})
        self.nfft = nfft
        self.beta_icfo = BetaIcfo(u, b) if params.est_beta_icfo else None

    def forward(self, iq: torch.Tensor) -> dict:
        pr = self.params
        sm = detect_sm(iq, self.P, self.w, self.sl, self.sr, pr.metric_threshold,
                       pr.metric_max, rms_min=pr.rms_min,
                       rms_max=pr.rms_max)                        # [B,n_t]
        out = sync_report(iq, sm, self.P, self.L, self.half, self.norm, pr,
                          self.max_peaks, self.w_rep, self.tconj, self.Gc,
                          self.neff)                              # [B,K] each
        if self.beta_icfo is not None:
            # the FFT window of 64 b samples from the fine peak
            Nfft = self.beta_icfo.Nfft
            t_fine = out["t_fine"].to(torch.int64)
            beta, s = self.beta_icfo(
                _windows(iq, t_fine.clamp(0, self.T - Nfft), Nfft))
            out["beta"], out["cfo_int"] = beta.to(torch.int32), s.to(torch.int32)
        if self.max_peaks == 1:
            out = {k: v[..., 0] for k, v in out.items()}
        return out


def build_sync(u: int, b: int, T: int,
               neff_candidates: tuple[int, ...] = (1, 2, 4, 8),
               params: SyncParams = SyncParams(), max_peaks: int = 1,
               device: torch.device | str = "cuda") -> Sync:
    """Sync module for a [B, N_RX, T] chunk (dectnrp_tpu/phy/sync.py:108),
    on `device`."""
    return Sync(u, b, T, neff_candidates, params, max_peaks).to(device)


class BetaIcfo(torch.nn.Module):
    """f-domain coarse-peak stage: joint beta + integer-CFO estimation
    (port of dectnrp_tpu/phy/sync.py::build_beta_icfo; the reference
    declares it, coarse_peak_f_domain.cpp:94-201, and ships it disabled).

    At the b_max rate every beta's STF occupies bins k = 0 (mod 4),
    4 <= |k| <= 28 beta of the 64 b_max FFT, so one FFT at the STF start
    gives the bandwidth (how far the comb extends) and the integer CFO (how
    far it is shifted). est(seg [..., R, 64 b_max]) -> (beta [...], s [...]
    in bins): per candidate (beta, s) the comb's power above the in-band
    off-comb mean is scored; s is the argmax over the shifts of the best
    score, beta the smallest candidate scoring >= 90 % of the best at s.
    `shifts` must span less than one comb period (4 bins).
    """

    def __init__(self, u: int, b_max: int,
                 candidates: tuple[int, ...] = (1, 2, 4, 8, 12, 16),
                 shifts: tuple[int, ...] = (-1, 0, 1, 2)):
        super().__init__()
        self.Nfft = Nfft = 64 * b_max
        dc = Nfft // 2
        cands = [c for c in candidates if c <= b_max]
        assert max(shifts) - min(shifts) < 4, "shift window spans a comb period"
        sh = np.asarray(shifts, np.int64)
        # the window spans exactly 4 STF patterns: undo their cover signs,
        # else the +-1 modulation smears the comb off the = 0 (mod 4) bins
        tables = {"decov": np.repeat(cover_sequence(u)[:4], 16 * b_max
                                     ).astype(np.float32),
                  "cands": np.asarray(cands, np.int64),
                  "shifts": sh}
        n_cells, n_off = [], []
        for i, c in enumerate(cands):
            cells = dc + np.array([k for k in range(-28 * c, 28 * c + 1, 4)
                                   if k != 0])
            tables[f"idx{i}"] = cells[:, None] + sh[None, :]      # [n_cells, n_s]
            tables[f"lo{i}"] = dc - 28 * c + sh
            tables[f"hi{i}"] = dc + 28 * c + sh + 1
            n_cells.append(cells.size)
            n_off.append(56 * c + 1 - cells.size)
        self.n_cells, self.n_off = n_cells, n_off
        register_tables(self, tables)

    def forward(self, seg: torch.Tensor):
        S = torch.fft.fftshift(torch.fft.fft(seg * self.decov, dim=-1), dim=-1)
        Pw = (S.abs() ** 2).sum(-2)                               # [..., Nfft]
        cs = torch.cat([torch.zeros_like(Pw[..., :1]), torch.cumsum(Pw, -1)], -1)
        X = []
        for i, (nc, no) in enumerate(zip(self.n_cells, self.n_off)):
            comb = Pw[..., getattr(self, f"idx{i}")].sum(-2)      # [..., n_s]
            band = cs[..., getattr(self, f"hi{i}")] - cs[..., getattr(self, f"lo{i}")]
            mu_off = (band - comb) / no
            X.append(comb - nc * mu_off)
        X = torch.stack(X, -2)                                    # [..., n_c, n_s]
        s_idx = X.amax(-2).argmax(-1)                             # [...]
        col = torch.gather(X, -1, s_idx[..., None, None].expand(
            *X.shape[:-1], 1))[..., 0]                            # [..., n_c]
        good = col >= 0.9 * col.amax(-1, keepdim=True)
        # the smallest candidate on the plateau
        b_idx = good.to(torch.uint8).argmax(-1)
        return self.cands[b_idx], self.shifts[s_idx]


def build_beta_icfo(u: int, b_max: int,
                    candidates: tuple[int, ...] = (1, 2, 4, 8, 12, 16),
                    shifts: tuple[int, ...] = (-1, 0, 1, 2),
                    device: torch.device | str = "cuda") -> BetaIcfo:
    """beta + integer-CFO estimator (dectnrp_tpu/phy/sync.py:319), on
    `device`."""
    return BetaIcfo(u, b_max, candidates, shifts).to(device)


class RxStream(torch.nn.Module):
    """rx over an unaligned stream: sync-report-driven slice + CFO derotation.

    rx_stream(iq [B, N_RX, T], t0 [B], cfo [B], noise_var) -> rx dict.
    """

    def __init__(self, psdef, network_id: int, plcf_type: int, T: int,
                 device: torch.device | str, **rx_kw):
        super().__init__()
        from .rx import build_rx

        self.rx = build_rx(psdef, network_id, plcf_type, device=device, **rx_kw)
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
                    device: torch.device | str = "cuda", **rx_kw) -> RxStream:
    """Stream RX module (dectnrp_tpu/phy/sync.py:392), on `device`."""
    return RxStream(psdef, network_id, plcf_type, T, device, **rx_kw)
