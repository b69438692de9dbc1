"""Synchronized RX: whole-packet demodulation + decode (port of dectnrp_tpu/phy/rx.py).

Reference: lib/src/phy/rx/rx_synced/rx_synced.cpp:186-436, batched over
packets and RX antennas:

  iq -> STF residual CFO -> CP strip + batched FFT -> DRS ZF estimates
     -> DRS CFO refinement, fractional STO, 4th-order SNR estimate
     -> Wiener bank (SNR x selectivity) in frequency, linear in time
     -> PCC: MRC -> QPSK soft demap -> blind PLCF type 1 AND 2 decode
     -> PDC: MRC -> soft demap -> turbo decode -> TB CRC.

This slice is `build_rx` at its defaults with one transmit stream:
chestim_mode="lr_t", freq_kind="wiener", time_kind="linear", dd_passes=0,
est_sto and est_cfo on, genie off. Any other value of these options, and
Alamouti/MMSE combining (N_TS > 1), raise NotImplementedError (queued in
ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from ..sections.part3.drs import get_N_step
from ..sections.part3.packet_sizes import PacketSizesDef
from ..sections.part3.stf import cover_sequence, n_stf_patterns
from .chestim import (WIENER_PRESETS, comb_offsets, freq_interp_matrices,
                      time_interp_matrix)
from .fec.chain import PdcPlan, pcc_decode, pdc_decode
from .modulation import demap_llr
from .packet_config import get_packet_luts
from .plan import register_tables


def _exp_ramp(phase_per_n: torch.Tensor, n_len: int) -> torch.Tensor:
    """exp(1j * phase_per_n * n) for n in [0, n_len) as an outer product
    e^{j p 256 q} * e^{j p r} (n = 256 q + r). Returns [B, n_len] complex64."""
    B = phase_per_n.shape[0]
    nq = -(-n_len // 256)
    dev = phase_per_n.device
    q = torch.arange(nq, dtype=torch.float32, device=dev) * 256.0
    r = torch.arange(256, dtype=torch.float32, device=dev)
    A = torch.polar(torch.ones((B, nq), device=dev), phase_per_n[:, None] * q)
    Bt = torch.polar(torch.ones((B, 256), device=dev), phase_per_n[:, None] * r)
    return (A[:, :, None] * Bt[:, None, :]).reshape(B, nq * 256)[:, :n_len]


def _cexp(phase: torch.Tensor) -> torch.Tensor:
    """exp(1j * phase) for a real float32 tensor."""
    return torch.polar(torch.ones_like(phase), phase)


def _mrc(y, h):
    """y [B,R,n], h [B,R,n] -> (x_eq [B,n], csi [B,n])."""
    den = (h.abs() ** 2).sum(1)
    num = (torch.conj(h) * y).sum(1)
    return num / den.clamp_min(1e-12), den


#: the options of dectnrp_tpu/phy/rx.py::build_rx and the one value each
#: takes in this port
RX_DEFAULTS = {"chestim_mode": "lr_t", "freq_kind": "wiener",
               "time_kind": "linear", "dd_passes": 0, "est_sto": True,
               "est_cfo": True, "genie": False}


class Rx(torch.nn.Module):
    """rx(iq complex64 [B, N_RX, N_samples_packet], noise_var) -> dict."""

    def __init__(self, psdef: PacketSizesDef, network_id: int, plcf_type: int,
                 n_iter: int = 6):
        super().__init__()
        luts = get_packet_luts(psdef)
        ps = self.ps = luts.ps
        if ps.tm_mode.N_TS != 1:
            raise NotImplementedError("build_rx: N_TS > 1 (Alamouti/MMSE) is not ported yet")
        q = ps.numerology
        N, S, cp = q.N_b_DFT, ps.N_PACKET_symb, q.N_b_CP
        N_occ = q.N_b_OCC
        self.N, self.S, self.cp, self.N_occ = N, S, cp, N_occ
        self.network_id, self.plcf_type, self.n_iter = network_id, plcf_type, n_iter
        self.plan = PdcPlan.get(ps.N_TB_bits, ps.G, ps.mcs.N_bps, psdef.Z)
        self.rx_scale = float(np.sqrt(N_occ) / N)

        # Wiener bank on two axes: estimated SNR (narrow presets) and
        # measured selectivity (wide Wiener at low SNR, clamped linear
        # above), as dectnrp_tpu/phy/rx.py:164-184
        tau_narrow = min(tau for tau, _ in WIENER_PRESETS)
        Wf_bank = [freq_interp_matrices(psdef.b, "wiener", tau_narrow, sn,
                                        centered=True, u=psdef.u)
                   for _, sn in WIENER_PRESETS]
        Wf_bank += [freq_interp_matrices(psdef.b, "wiener", 1000e-9,
                                         WIENER_PRESETS[0][1], centered=True,
                                         u=psdef.u),
                    freq_interp_matrices(psdef.b, "linear"),
                    freq_interp_matrices(psdef.b, "linear")]
        preset_snrs = np.array([sn for _, sn in WIENER_PRESETS], np.float32)
        combs = comb_offsets(psdef.u, psdef.b, S, 1)              # [1, n_symb]
        self.comb_vals = [int(c) for c in np.unique(combs)]
        self.n_wf = len(Wf_bank)

        P_stf = self.P_stf = 16 * psdef.b
        self.n_pat = n_stf_patterns(psdef.u)
        cov = cover_sequence(psdef.u)
        self.n_drs_symb = luts.n_drs_symb
        self.n4 = N_occ // 4
        self.N_step_drs = get_N_step(1)
        drs_lin = np.asarray(luts.drs_lin)
        sc_drs = ((drs_lin % N) - N // 2).astype(np.float32).reshape(
            1, self.n_drs_symb, self.n4)
        tables = {
            "w_pat": (cov[:-1] * cov[1:]).astype(np.float32),
            "w3": (cov[:-3] * cov[3:]).astype(np.float32),
            "pcc_lin": luts.pcc_lin, "pdc_lin": luts.pdc_lin,
            "drs_lin": drs_lin, "drs_conj": np.conj(luts.drs_vals_per_ts),
            "pcc_locc": luts.pcc_locc, "pdc_locc": luts.pdc_locc,
            "sc_drs": sc_drs,
            "pair_ok": (np.diff(sc_drs, axis=-1) == 4).astype(np.float32),
            "t_sym": np.arange(S, dtype=np.float32) * (N + cp),
            "ksc": np.arange(N, dtype=np.float32) - N // 2,
            "preset_snrs": preset_snrs,
            "Tm": time_interp_matrix(psdef.u, psdef.b, S, 1,
                                     "lr_t").astype(np.complex64),
        }
        for i, Wf in enumerate(Wf_bank):
            for c in self.comb_vals:
                tables[f"wf{i}_{c}"] = Wf[c]
        for c in self.comb_vals:                # DRS symbols on comb c
            tables[f"comb{c}"] = (combs == c)
        register_tables(self, tables)

    def _interp(self, h_zf, i):
        """Frequency interpolation of the DRS ZF estimates with bank entry i:
        [B,R,T,n_symb,n4] -> [B,R,T,n_symb,N_occ]."""
        B, R = h_zf.shape[:2]
        hf = torch.zeros((B, R, 1, self.n_drs_symb, self.N_occ),
                         dtype=torch.complex64, device=h_zf.device)
        for c in self.comb_vals:
            hc = torch.einsum("brtnp,kp->brtnk", h_zf, getattr(self, f"wf{i}_{c}"))
            mask = getattr(self, f"comb{c}")[None, None, :, :, None]
            hf = torch.where(mask, hc, hf)
        return hf

    def forward(self, iq: torch.Tensor, noise_var) -> dict:
        B, R = iq.shape[0], iq.shape[1]
        N, S, cp, N_occ, n4 = self.N, self.S, self.cp, self.N_occ, self.n4
        ps, ns, P_stf = self.ps, self.n_drs_symb, self.P_stf
        nv_bin = noise_var * N_occ / N

        # residual fractional CFO from STF pattern pairs: lag P, then lag 3P
        # disambiguated by the first, then derotate the whole packet
        stf_t = iq[..., :self.n_pat * P_stf].reshape(B, R, self.n_pat, P_stf)
        qq = (stf_t[:, :, :-1] * torch.conj(stf_t[:, :, 1:])
              * self.w_pat[None, None, :, None]).sum((1, 2, 3))
        cfo_a = -torch.angle(qq) / P_stf
        lag = 3
        q3 = (stf_t[:, :, :-lag] * torch.conj(stf_t[:, :, lag:])
              * self.w3[None, None, :, None]).sum((1, 2, 3))
        r3 = torch.angle(q3 * _cexp(cfo_a * (lag * P_stf)))
        cfo_res = cfo_a - r3 / (lag * P_stf)
        iq = iq * _exp_ramp(-cfo_res, iq.shape[-1])[:, None, :]

        # CP strip + batched FFT of the data field
        n0 = ps.N_samples_STF
        df = iq[..., n0:n0 + ps.N_DF_symb * (N + cp)]
        sym = df.reshape(B, R, ps.N_DF_symb, N + cp)[..., cp:]
        Y = torch.fft.fftshift(torch.fft.fft(sym, dim=-1), dim=-1) * self.rx_scale
        grid = torch.zeros((B, R, S, N), dtype=torch.complex64, device=iq.device)
        grid[:, :, 1:1 + ps.N_DF_symb] = Y.to(torch.complex64)
        gf = grid.reshape(B, R, S * N)

        # DRS ZF estimates [B,R,1,n_symb,n4]
        h_zf = (gf[..., self.drs_lin] * self.drs_conj).reshape(B, R, 1, ns, n4)

        # residual-CFO refinement from the DRS symbol-pair phase progression
        if ns >= 2:
            prod = (h_zf[..., 1:, :] * torch.conj(h_zf[..., :-1, :])).sum((1, 2, 4))
            dphi = torch.angle(prod.sum(-1))
            cfo2 = dphi / (self.N_step_drs * (N + cp))
            ph = _cexp(-(cfo2[:, None] * self.t_sym))
            grid = grid * ph[:, None, :, None]
            gf = grid.reshape(B, R, S * N)
            h_zf = (gf[..., self.drs_lin] * self.drs_conj).reshape(B, R, 1, ns, n4)
            cfo_res = cfo_res + cfo2

        # fractional STO: phase slope across the DRS pilots
        qs = (h_zf[..., 1:] * torch.conj(h_zf[..., :-1])
              * self.pair_ok).sum((1, 2, 3, 4))
        theta = torch.angle(qs) / 4.0
        h_zf = h_zf * _cexp(-(theta[:, None, None, None, None] * self.sc_drs))
        sto_frac = -theta * N / (2.0 * np.pi)

        # preamble/DRS SNR from 4th-order pilot differences (E|d4|^2 = 70 s^2)
        spn = (h_zf.abs() ** 2).mean((1, 2, 3, 4))
        d4 = (h_zf[..., 4:] - 4.0 * h_zf[..., 3:-1] + 6.0 * h_zf[..., 2:-2]
              - 4.0 * h_zf[..., 1:-3] + h_zf[..., :-4])
        nois = (d4.abs() ** 2).mean((1, 2, 3, 4)) / 70.0
        snr_lin = (spn - nois).clamp_min(1e-10) / nois.clamp_min(1e-10)
        snr_db = 10.0 * torch.log10(snr_lin)

        h_end = h_zf[..., -1, :]                                  # [B,R,1,n4]
        h_cells = h_end[..., :n4 // 4 * 4].reshape(B, R, 1, 4, -1).mean(-1)

        # frequency interpolation: SNR x selectivity one-hot mix of the bank
        snr_idx = (snr_db[:, None] - self.preset_snrs).abs().argmin(1)
        d2m = ((h_zf[..., 2:] - 2.0 * h_zf[..., 1:-1] + h_zf[..., :-2]
                ).abs() ** 2).mean((1, 2, 3, 4))
        c2 = (d2m - 6.0 * nois).clamp_min(0.0)
        selective = (c2 / spn.clamp_min(1e-12)) > 3e-4
        idx = snr_idx + 3 * selective.to(snr_idx.dtype)
        sel = torch.nn.functional.one_hot(idx, self.n_wf).to(torch.complex64)
        hf = sum(sel[:, i, None, None, None, None] * self._interp(h_zf, i)
                 for i in range(self.n_wf))
        chest = torch.einsum("tsn,brtnk->brtsk", self.Tm, hf)
        cf = chest.reshape(B, R, 1, S * N_occ)
        return self._finish(gf, cf, theta, sto_frac, cfo_res, snr_db, h_cells,
                            nv_bin, B)

    def _finish(self, gf, cf, theta, sto_frac, cfo_res, snr_db, h_cells,
                nv_bin, B):
        N, S, ps = self.N, self.S, self.ps
        # fractional-STO derotation once on the grid, per subcarrier
        R_ = gf.shape[1]
        tbl = _cexp(-(theta[:, None] * self.ksc))                 # [B,N]
        gf = (gf.reshape(B, R_, S, N) * tbl[:, None, None, :]).reshape(B, R_, S * N)

        # PCC: combine, demap QPSK, blind decode both PLCF types
        x_pcc, csi_pcc = _mrc(gf[..., self.pcc_lin], cf[..., self.pcc_locc][:, :, 0])
        llr_pcc = demap_llr(x_pcc, csi_pcc, 2, nv_bin)
        a1, ok1, cl1, bf1 = pcc_decode(llr_pcc, 1, self.n_iter)
        a2, ok2, cl2, bf2 = pcc_decode(llr_pcc, 2, self.n_iter)

        # PDC: combine, demap, turbo decode, TB CRC
        x_pdc, csi_pdc = _mrc(gf[..., self.pdc_lin], cf[..., self.pdc_locc][:, :, 0])
        llr_pdc = demap_llr(x_pdc, csi_pdc, ps.mcs.N_bps, nv_bin)
        tb, tb_ok = pdc_decode(llr_pdc, self.plan, self.network_id,
                               self.plcf_type, n_iter=self.n_iter)
        return {
            "plcf1": a1, "plcf1_ok": ok1, "plcf1_cl": cl1, "plcf1_bf": bf1,
            "plcf2": a2, "plcf2_ok": ok2, "plcf2_cl": cl2, "plcf2_bf": bf2,
            "tb": tb, "tb_ok": tb_ok, "snr_db": snr_db, "h_cells": h_cells,
            "sto_frac": sto_frac.to(torch.float32),
            "cfo_res": cfo_res.to(torch.float32),
        }


def build_rx(psdef: PacketSizesDef, network_id: int, plcf_type: int,
             n_iter: int = 6, **options) -> Rx:
    """Aligned RX module for one packet configuration (dectnrp_tpu/phy/rx.py:120).

    `options` takes the JAX builder's chestim options, each only at its
    default (`RX_DEFAULTS`); any other value is not ported yet."""
    for k, v in options.items():
        if k not in RX_DEFAULTS:
            raise TypeError(f"build_rx: unknown option {k!r}")
        if v != RX_DEFAULTS[k]:
            raise NotImplementedError(f"build_rx: {k}={v!r} is not ported yet")
    return Rx(psdef, network_id, plcf_type, n_iter)
