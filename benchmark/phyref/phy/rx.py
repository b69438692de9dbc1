"""Synchronized RX: whole-packet demodulation + decode (port of dectnrp_tpu/phy/rx.py).

Reference: lib/src/phy/rx/rx_synced/rx_synced.cpp:186-436, batched over
packets and RX antennas:

  iq -> STF residual CFO -> CP strip + batched FFT -> DRS ZF estimates
     -> DRS CFO refinement, fractional STO, 4th-order SNR estimate
     -> frequency interpolation (Wiener bank: SNR x selectivity) x time
        interpolation (lr_t / lr_f, or the Doppler-selected Wiener bank)
     -> PCC: MRC or Alamouti combine -> QPSK soft demap -> blind PLCF
        type 1 AND 2 decode
     -> PDC: MRC (+ decision-directed phase refinement), Alamouti or MMSE
        -> soft demap -> turbo decode -> TB CRC.

Every option of the JAX builder (JAX rx.py:120-509):
- chestim_mode "lr_t" (between the DRS symbols) or "lr_f" (causal);
- freq_kind "wiener" (the two-axis bank), "linear", or any other string,
  which like JAX's gives one Wiener matrix at `freq_interp_matrices`'
  defaults (chestim.py:111-126);
- time_kind "wiener" with lr_t and >= 2 DRS symbols a transmit stream: the
  bank of `wiener_time_matrix` over NU_TIME_PRESETS, one-hot selected by
  the measured DRS-step correlation; else linear;
- dd_passes: per-symbol common-phase refinement of the PDC's MRC channel
  from its own hard decisions, applied where the channel measures
  frequency-selective (N_TS = 1);
- est_sto / est_cfo: the fractional STO ramp and the residual CFO
  (STF pattern pairs + DRS symbol pairs) on or off; est_sto also sets
  `centered=` of the Wiener bank;
- one spatial stream (N_SS = 1) over N_TS = 1 (MRC) or N_TS = 2/4/8
  transmit streams (Alamouti), and N_SS > 1 spatial streams (MMSE per cell,
  JAX rx.py:73-93, 486-495; the PCC stays Alamouti over N_TS);
- genie=True: a given TRUE channel in place of the DRS estimates (JAX
  rx.py:145-146, 302-314), no CFO or STO estimated.
"""
from __future__ import annotations

import numpy as np
import torch

from ..sections.part3.drs import get_N_step
from ..sections.part3.packet_sizes import PacketSizesDef
from ..sections.part3.stf import cover_sequence, n_stf_patterns
from ..sections.part3.tx_div import TS_PAIRS, get_modulo
from ..sections.part3.drs import nof_drs_symbols_per_ts
from .chestim import (NU_TIME_PRESETS, WIENER_PRESETS, _j0, comb_offsets,
                      freq_interp_matrices, time_interp_matrix,
                      wiener_time_matrix)
from .fec.chain import PdcPlan, pcc_decode, pdc_decode
from .modulation import demap_llr, hard_decision
from .packet_config import get_packet_luts
from .plan import register_tables


def _pair_ts(n_cells: int, N_TS: int) -> tuple[np.ndarray, np.ndarray]:
    """Per cell-pair (ts_a, ts_b) transmit-stream indices of the Alamouti map."""
    pairs = TS_PAIRS[N_TS]
    mod = get_modulo(N_TS)
    p = np.arange(n_cells // 2) % mod
    return pairs[p, 0].astype(np.int32), pairs[p, 1].astype(np.int32)


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


def _mmse(y, h, nv, N_SS):
    """Per-cell MMSE spatial equalizer for N_SS > 1 spatial multiplexing.

    y [B,R,n], h [B,R,S,n] -> (x_eq unbiased [B,S,n], sinr [B,S,n]):
    x_hat = (H^H H + nv I)^-1 H^H y, unbiased by the diagonal gain g, with
    the per-stream post-MMSE SINR g/(1-g) as the demapper's CSI. The Gram
    matrix is inverted once; `inv_ex` leaves errors unchecked, as XLA's,
    so no host sync.
    """
    H = h.permute(0, 3, 1, 2)                             # [B,n,R,S]
    yv = y.permute(0, 2, 1)[..., None]                    # [B,n,R,1]
    Hh = torch.conj(H.transpose(-1, -2))                  # [B,n,S,R]
    eye = torch.eye(N_SS, dtype=h.dtype, device=h.device)
    gram = Hh @ H + nv * eye                              # [B,n,S,S]
    ginv = torch.linalg.inv_ex(gram)[0]
    x = (ginv @ (Hh @ yv))[..., 0]                        # [B,n,S]
    g = 1.0 - nv * torch.diagonal(ginv, dim1=-2, dim2=-1).real
    g = g.clamp(1e-6, 1.0 - 1e-6)
    return (x / g).permute(0, 2, 1), (g / (1.0 - g)).permute(0, 2, 1)


def _alamouti(y, h, ts_a, ts_b):
    """y [B,R,n], h [B,R,N_TS,n] -> (x_eq [B,n], csi [B,n]).

    TX mapping (tx_div.alamouti_map): ta carries (x0, x1)/sqrt2,
    tb carries (-x1*, x0*)/sqrt2. csi is the post-combining |h_eff|^2.
    """
    B = y.shape[0]
    y0, y1 = y[..., 0::2], y[..., 1::2]                          # [B,R,P]
    h_even = h[..., 0::2]                                        # [B,R,T,P]
    pair_idx = torch.arange(ts_a.numel(), device=h.device)
    ha = h_even[:, :, ts_a, pair_idx]                            # [B,R,P]
    hb = h_even[:, :, ts_b, pair_idx]
    x0u = (torch.conj(ha) * y0 + hb * torch.conj(y1)).sum(1)    # [B,P]
    x1u = (torch.conj(ha) * y1 - hb * torch.conj(y0)).sum(1)
    G = (ha.abs() ** 2 + hb.abs() ** 2).sum(1)                   # [B,P]
    s = 1.0 / np.sqrt(2.0)
    x0 = x0u / (s * G).clamp_min(1e-12)
    x1 = x1u / (s * G).clamp_min(1e-12)
    x = torch.stack([x0, x1], -1).reshape(B, -1)
    # jnp's .repeat(2, -1) repeats each element (repeat_interleave), it
    # does not tile
    csi = (0.5 * G).repeat_interleave(2, -1)
    return x, csi


#: the options of dectnrp_tpu/phy/rx.py::build_rx and their defaults
#: (genie forces est_sto and est_cfo off, as JAX's does)
RX_DEFAULTS = {"chestim_mode": "lr_t", "freq_kind": "wiener",
               "time_kind": "linear", "dd_passes": 0, "est_sto": True,
               "est_cfo": True, "genie": False}


class Rx(torch.nn.Module):
    """rx(iq complex64 [B, N_RX, N_samples_packet], noise_var[, h_genie])
    -> dict; h_genie [B, N_RX, N_TS, S, N_occ] (the true channel) is
    required with genie=True and refused otherwise."""

    def __init__(self, psdef: PacketSizesDef, network_id: int, plcf_type: int,
                 chestim_mode: str = "lr_t", freq_kind: str = "wiener",
                 time_kind: str = "linear", dd_passes: int = 0,
                 n_iter: int = 6, est_sto: bool = True, est_cfo: bool = True,
                 genie: bool = False):
        super().__init__()
        if genie:
            est_sto = est_cfo = False
        luts = get_packet_luts(psdef)
        ps = self.ps = luts.ps
        self.genie, self.est_sto, self.est_cfo = genie, est_sto, est_cfo
        self.dd_passes = dd_passes
        self.N_TS = N_TS = ps.tm_mode.N_TS
        self.N_SS = ps.tm_mode.N_SS
        q = ps.numerology
        N, S, cp = q.N_b_DFT, ps.N_PACKET_symb, q.N_b_CP
        N_occ = q.N_b_OCC
        self.N, self.S, self.cp, self.N_occ = N, S, cp, N_occ
        self.network_id, self.plcf_type, self.n_iter = network_id, plcf_type, n_iter
        self.plan = PdcPlan.get(ps.N_TB_bits, ps.G, ps.mcs.N_bps, psdef.Z)
        self.rx_scale = float(np.sqrt(N_occ) / N)

        if freq_kind == "wiener":
            # Wiener bank on two axes: estimated SNR (narrow presets) and
            # measured selectivity (wide Wiener at low SNR, clamped linear
            # above), as dectnrp_tpu/phy/rx.py:164-184
            tau_narrow = min(tau for tau, _ in WIENER_PRESETS)
            Wf_bank = [freq_interp_matrices(psdef.b, "wiener", tau_narrow, sn,
                                            centered=est_sto, u=psdef.u)
                       for _, sn in WIENER_PRESETS]
            Wf_bank += [freq_interp_matrices(psdef.b, "wiener", 1000e-9,
                                             WIENER_PRESETS[0][1],
                                             centered=est_sto, u=psdef.u),
                        freq_interp_matrices(psdef.b, "linear"),
                        freq_interp_matrices(psdef.b, "linear")]
            preset_snrs = np.array([sn for _, sn in WIENER_PRESETS], np.float32)
        else:
            Wf_bank = [freq_interp_matrices(psdef.b, freq_kind)]
            preset_snrs = np.zeros(1, np.float32)
        combs = comb_offsets(psdef.u, psdef.b, S, N_TS)           # [T, n_symb]
        self.comb_vals = [int(c) for c in np.unique(combs)]
        self.n_wf = len(Wf_bank)
        # the Doppler axis: time-Wiener presets selected by the measured
        # DRS-step correlation rho, the bounds midway between the presets'
        # own J0(2 pi nu N_step) (dectnrp_tpu/phy/rx.py:188-200)
        Tm_bank = [time_interp_matrix(psdef.u, psdef.b, S, N_TS, chestim_mode)]
        rho_bounds = np.zeros(0, np.float32)
        if (chestim_mode == "lr_t" and time_kind == "wiener"
                and nof_drs_symbols_per_ts(psdef.u, S, N_TS) >= 2):
            Tm_bank = [wiener_time_matrix(psdef.u, psdef.b, S, N_TS, nu)
                       for nu in NU_TIME_PRESETS]
            rho_p = _j0(2.0 * np.pi * np.asarray(NU_TIME_PRESETS)
                        * get_N_step(N_TS))
            rho_bounds = ((rho_p[1:] + rho_p[:-1]) / 2.0).astype(np.float32)
        self.n_tm = len(Tm_bank)

        P_stf = self.P_stf = 16 * psdef.b
        self.n_pat = n_stf_patterns(psdef.u)
        cov = cover_sequence(psdef.u)
        self.n_drs_symb = luts.n_drs_symb
        self.n4 = N_occ // 4
        self.N_step_drs = get_N_step(N_TS)
        drs_lin = np.asarray(luts.drs_lin)
        sc_drs = ((drs_lin % N) - N // 2).astype(np.float32).reshape(
            N_TS, self.n_drs_symb, self.n4)
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
            "preset_snrs": preset_snrs, "rho_bounds": rho_bounds,
        }
        if dd_passes and N_TS == 1:
            # the OFDM symbol of each PDC cell, as an index and one-hot
            sym_of_pdc = np.asarray(luts.pdc_lin) // N
            tables["sym_of_pdc"] = sym_of_pdc
            tables["pdc_sym_onehot"] = np.eye(S, dtype=np.complex64)[sym_of_pdc]
        for i, Tm in enumerate(Tm_bank):
            tables[f"tm{i}"] = Tm.astype(np.complex64)
        if N_TS > 1:
            tables["pcc_tsa"], tables["pcc_tsb"] = _pair_ts(98, N_TS)
        if N_TS > 1 and self.N_SS == 1:
            tables["pdc_tsa"], tables["pdc_tsb"] = _pair_ts(ps.N_PDC_subc, N_TS)
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
        hf = torch.zeros((B, R, self.N_TS, self.n_drs_symb, self.N_occ),
                         dtype=torch.complex64, device=h_zf.device)
        for c in self.comb_vals:
            hc = torch.einsum("brtnp,kp->brtnk", h_zf, getattr(self, f"wf{i}_{c}"))
            mask = getattr(self, f"comb{c}")[None, None, :, :, None]
            hf = torch.where(mask, hc, hf)
        return hf

    def forward(self, iq: torch.Tensor, noise_var, h_genie=None) -> dict:
        B, R = iq.shape[0], iq.shape[1]
        N, S, cp, N_occ, n4 = self.N, self.S, self.cp, self.N_occ, self.n4
        ps, ns, P_stf, N_TS = self.ps, self.n_drs_symb, self.P_stf, self.N_TS
        nv_bin = noise_var * N_occ / N
        if (h_genie is None) == self.genie:
            raise ValueError("rx: h_genie is required with genie=True and "
                             "only then")

        if not self.est_cfo:
            cfo_res = torch.zeros((B,), dtype=torch.float32, device=iq.device)
        else:
            # residual fractional CFO from STF pattern pairs: lag P, then lag
            # 3P disambiguated by the first, then derotate the whole packet
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
        if self.genie:
            return self._genie(gf, h_genie, cfo_res, nv_bin, B, R)

        # DRS ZF estimates [B,R,T,n_symb,n4]
        h_zf = (gf[..., self.drs_lin] * self.drs_conj).reshape(B, R, N_TS, ns, n4)

        # residual-CFO refinement from the DRS symbol-pair phase progression
        if self.est_cfo and ns >= 2:
            prod = (h_zf[..., 1:, :] * torch.conj(h_zf[..., :-1, :])).sum((1, 2, 4))
            dphi = torch.angle(prod.sum(-1))
            cfo2 = dphi / (self.N_step_drs * (N + cp))
            ph = _cexp(-(cfo2[:, None] * self.t_sym))
            grid = grid * ph[:, None, :, None]
            gf = grid.reshape(B, R, S * N)
            h_zf = (gf[..., self.drs_lin] * self.drs_conj).reshape(B, R, N_TS, ns, n4)
            cfo_res = cfo_res + cfo2

        # fractional STO: phase slope across the DRS pilots
        if self.est_sto:
            qs = (h_zf[..., 1:] * torch.conj(h_zf[..., :-1])
                  * self.pair_ok).sum((1, 2, 3, 4))
            theta = torch.angle(qs) / 4.0
            h_zf = h_zf * _cexp(-(theta[:, None, None, None, None] * self.sc_drs))
        else:
            theta = torch.zeros((B,), dtype=torch.float32, device=iq.device)
        sto_frac = -theta * N / (2.0 * np.pi)

        # preamble/DRS SNR from 4th-order pilot differences (E|d4|^2 = 70 s^2)
        spn = (h_zf.abs() ** 2).mean((1, 2, 3, 4))
        d4 = (h_zf[..., 4:] - 4.0 * h_zf[..., 3:-1] + 6.0 * h_zf[..., 2:-2]
              - 4.0 * h_zf[..., 1:-3] + h_zf[..., :-4])
        nois = (d4.abs() ** 2).mean((1, 2, 3, 4)) / 70.0
        snr_lin = (spn - nois).clamp_min(1e-10) / nois.clamp_min(1e-10)
        snr_db = 10.0 * torch.log10(snr_lin)

        h_end = h_zf[..., -1, :]                                  # [B,R,T,n4]
        h_cells = h_end[..., :n4 // 4 * 4].reshape(B, R, N_TS, 4, -1).mean(-1)

        if self.n_tm > 1:
            sel_t = torch.nn.functional.one_hot(
                self._time_preset(h_zf, nois), self.n_tm).to(torch.complex64)

        # frequency interpolation: SNR x selectivity one-hot mix of the bank
        if self.n_wf == 1:
            selective = torch.zeros((B,), dtype=torch.bool, device=iq.device)
            hf = self._interp(h_zf, 0)
        else:
            snr_idx = (snr_db[:, None] - self.preset_snrs).abs().argmin(1)
            d2m = ((h_zf[..., 2:] - 2.0 * h_zf[..., 1:-1] + h_zf[..., :-2]
                    ).abs() ** 2).mean((1, 2, 3, 4))
            c2 = (d2m - 6.0 * nois).clamp_min(0.0)
            selective = (c2 / spn.clamp_min(1e-12)) > 3e-4
            idx = snr_idx + 3 * selective.to(snr_idx.dtype)
            sel = torch.nn.functional.one_hot(idx, self.n_wf).to(torch.complex64)
            hf = sum(sel[:, i, None, None, None, None] * self._interp(h_zf, i)
                     for i in range(self.n_wf))
        if self.n_tm == 1:
            chest = torch.einsum("tsn,brtnk->brtsk", self.tm0, hf)
        else:
            chest = sum(sel_t[:, i, None, None, None, None]
                        * torch.einsum("tsn,brtnk->brtsk", getattr(self, f"tm{i}"), hf)
                        for i in range(self.n_tm))
        cf = chest.reshape(B, R, N_TS, S * N_occ)
        return self._finish(gf, cf, theta, sto_frac, cfo_res, snr_db, h_cells,
                            nv_bin, B, selective)

    def _time_preset(self, h_zf, nois):
        """The time-Wiener preset [B] of each packet: the measured DRS-step
        correlation magnitude rho = |sum h[n+1] h[n]*| / (sum |h[n]|^2 -
        noise bias) against the bank's rho bounds (the Doppler axis)."""
        R, _, ns, n4 = h_zf.shape[1:]
        qt = (h_zf[..., 1:, :] * torch.conj(h_zf[..., :-1, :])).sum((1, 2, 3, 4))
        d_t = (h_zf[..., :-1, :].abs() ** 2).sum((1, 2, 3, 4))
        cnt = R * self.N_TS * (ns - 1) * n4
        rho = qt.abs() / (d_t - nois * cnt).clamp_min(1e-12)
        return (rho[:, None] < self.rho_bounds).sum(1)

    def _genie(self, gf, h_genie, cfo_res, nv_bin, B, R):
        """The true channel in place of DRS ZF and interpolation; no STO."""
        S, n4 = self.S, self.n4
        cf = h_genie.reshape(B, R, self.N_TS, S * self.N_occ).to(torch.complex64)
        zero = torch.zeros((B,), dtype=torch.float32, device=gf.device)
        spn = (h_genie.abs() ** 2).mean((1, 2, 3, 4))
        nv_den = (nv_bin.clamp_min(1e-12) if torch.is_tensor(nv_bin)
                  else max(nv_bin, 1e-12))
        snr_db = 10.0 * torch.log10((spn / nv_den).clamp_min(1e-10))
        h_end = h_genie[..., S - 1, 0::4]                         # [B,R,T,n4]
        h_cells = h_end[..., :n4 // 4 * 4].reshape(B, R, self.N_TS, 4, -1).mean(-1)
        return self._finish(gf, cf, zero, zero, cfo_res, snr_db, h_cells,
                            nv_bin, B, torch.zeros((B,), dtype=torch.bool,
                                                   device=gf.device))

    def _combine(self, y, h, name):
        """MRC over the RX rows for one transmit stream, Alamouti otherwise:
        y [B,R,n], h [B,R,T,n] -> (x_eq [B,n], csi [B,n])."""
        if self.N_TS == 1:
            return _mrc(y, h[:, :, 0])
        return _alamouti(y, h, getattr(self, f"{name}_tsa"),
                         getattr(self, f"{name}_tsb"))

    def _dd_refine(self, x_pdc, csi_pdc, y_pdc, h1, selective):
        """Decision-directed chestim refinement (JAX rx.py:446-478): per
        pass, the hard decisions' residual against the channel estimate,
        summed per OFDM symbol, gives a per-symbol common phase that
        corrects h; applied only where the channel measured selective."""
        use = selective[:, None]
        for _ in range(self.dd_passes):
            dec = hard_decision(x_pdc, self.ps.mcs.N_bps)           # [B,n]
            resid = (y_pdc * torch.conj(dec)[:, None, :] * torch.conj(h1)).sum(1)
            r_sym = resid @ self.pdc_sym_onehot                     # [B,S]
            ph = r_sym / r_sym.abs().clamp_min(1e-20)
            h1 = h1 * ph[:, self.sym_of_pdc][:, None, :]
            x_dd, csi_dd = _mrc(y_pdc, h1)
            x_pdc = torch.where(use, x_dd, x_pdc)
            csi_pdc = torch.where(use, csi_dd, csi_pdc)
        return x_pdc, csi_pdc

    def _finish(self, gf, cf, theta, sto_frac, cfo_res, snr_db, h_cells,
                nv_bin, B, selective):
        N, S, ps = self.N, self.S, self.ps
        # fractional-STO derotation once on the grid, per subcarrier
        R_ = gf.shape[1]
        tbl = _cexp(-(theta[:, None] * self.ksc))                 # [B,N]
        gf = (gf.reshape(B, R_, S, N) * tbl[:, None, None, :]).reshape(B, R_, S * N)

        # PCC: combine, demap QPSK, blind decode both PLCF types
        x_pcc, csi_pcc = self._combine(gf[..., self.pcc_lin], cf[..., self.pcc_locc],
                                       "pcc")
        llr_pcc = demap_llr(x_pcc, csi_pcc, 2, nv_bin)
        a1, ok1, cl1, bf1 = pcc_decode(llr_pcc, 1, self.n_iter)
        a2, ok2, cl2, bf2 = pcc_decode(llr_pcc, 2, self.n_iter)

        # PDC: combine, demap, turbo decode, TB CRC
        y_pdc, h_pdc = gf[..., self.pdc_lin], cf[..., self.pdc_locc]
        if self.N_SS == 1:
            x_pdc, csi_pdc = self._combine(y_pdc, h_pdc, "pdc")
            if self.N_TS == 1 and self.dd_passes:
                x_pdc, csi_pdc = self._dd_refine(x_pdc, csi_pdc, y_pdc,
                                                 h_pdc[:, :, 0], selective)
            llr_pdc = demap_llr(x_pdc, csi_pdc, ps.mcs.N_bps, nv_bin)
        else:
            # MMSE, then undo the TX's round-robin (stream s carries serial
            # symbol i N_SS + s at cell i); the CSI is already the
            # post-equalization SINR, so demap at unit noise
            xs, sinr = _mmse(y_pdc, h_pdc, nv_bin, self.N_SS)      # [B,S,n]
            x_pdc = xs.transpose(1, 2).reshape(B, -1)
            csi_pdc = sinr.transpose(1, 2).reshape(B, -1)
            llr_pdc = demap_llr(x_pdc, csi_pdc, ps.mcs.N_bps, 1.0)
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
             n_iter: int = 6, device: torch.device | str = "cuda",
             **options) -> Rx:
    """Aligned RX module for one packet configuration (dectnrp_tpu/phy/rx.py:120),
    on `device`; `options` are the JAX builder's (`RX_DEFAULTS`)."""
    for k in options:
        if k not in RX_DEFAULTS:
            raise TypeError(f"build_rx: unknown option {k!r}")
    return Rx(psdef, network_id, plcf_type, n_iter=n_iter,
              **{**RX_DEFAULTS, **options}).to(device)
