"""Whole-packet TX synthesis, batched over packets (port of dectnrp_tpu/phy/tx.py).

Reference: lib/src/phy/tx/tx.cpp:165-314. Bits -> FEC -> QAM -> one grid
scatter -> beamforming einsum -> batched IFFT + CP -> STF assembly + cover
sequence -> GI, at the native DECT rate.

This slice covers one transmit stream (N_TS = 1, any N_TX through the
first beamforming matrix W of the codebook), redundancy version 0 and no
TX windowing; other codebook entries, redundancy versions and modes raise
NotImplementedError (Alamouti/spatial multiplexing, beamforming codebooks
and `window_fraction` are queued in ROADMAP.md).
"""
from __future__ import annotations

import numpy as np
import torch

from ..sections.part3.beamforming import get_W
from ..sections.part3.packet_sizes import PacketSizesDef
from ..sections.part3.stf import cover_sequence, n_stf_patterns
from .fec.chain import PdcPlan, pcc_encode, pdc_encode
from .modulation import map_bits
from .packet_config import get_packet_luts
from .plan import register_tables


class Tx(torch.nn.Module):
    """tx(plcf_bits [B, 40/80], tb_bits [B, N_TB], cl [B], bf [B])
    -> iq complex64 [B, N_TX, N_samples_packet]."""

    def __init__(self, psdef: PacketSizesDef, network_id: int, plcf_type: int,
                 codebook_idx: int = 0, rv: int = 0,
                 window_fraction: float = 0.0):
        super().__init__()
        luts = get_packet_luts(psdef)
        ps = luts.ps
        if ps.tm_mode.N_TS != 1:
            raise NotImplementedError("build_tx: N_TS > 1 is not ported yet")
        if window_fraction > 0.0:
            raise NotImplementedError("build_tx: TX windowing is not ported yet")
        if codebook_idx or rv:
            raise NotImplementedError("build_tx: only codebook entry 0 and "
                                      "redundancy version 0 are ported yet")
        self.ps, self.network_id, self.plcf_type = ps, network_id, plcf_type
        q = ps.numerology
        self.N, self.S, self.cp = q.N_b_DFT, ps.N_PACKET_symb, q.N_b_CP
        self.N_TX = ps.tm_mode.N_TX
        self.plan = PdcPlan.get(ps.N_TB_bits, ps.G, ps.mcs.N_bps, psdef.Z)
        self.scale = luts.tx_scale
        W = get_W(1, self.N_TX, 0).astype(np.complex64)            # [N_TX, 1]
        register_tables(self, {
            "drs_idx": luts.drs_flat_idx, "drs_val": luts.drs_values,
            "pcc_idx": luts.pcc_flat_idx.ravel(),
            "pdc_idx": luts.pdc_flat_idx.ravel(), "W": W,
            "stf": self._stf(W, luts.stf_grid, psdef.u, psdef.b)})

    def _stf(self, W, stf_grid, u, b):
        """STF [N_TX, n_pat*16b]: base pattern from its IFFT, n_pat
        repetitions, cover sequence (stream 0 carries the STF)."""
        stf_bf = torch.einsum("at,n->an", torch.as_tensor(W[:, :1]),
                              torch.as_tensor(stf_grid))
        body = torch.fft.ifft(torch.fft.ifftshift(stf_bf, dim=-1), dim=-1) * self.scale
        pattern = body[:, :16 * b]
        n_pat = n_stf_patterns(u)
        cover = torch.as_tensor(cover_sequence(u).astype(np.float32))
        reps = pattern[:, None, :].expand(-1, n_pat, -1) * cover[None, :, None]
        return reps.reshape(self.N_TX, -1).to(torch.complex64).numpy()

    def forward(self, plcf_bits, tb_bits, cl, bf):
        B = plcf_bits.shape[0]
        ps, N, S, cp = self.ps, self.N, self.S, self.cp
        e_pcc = pcc_encode(plcf_bits, cl, bf, self.plcf_type)     # [B, 196]
        x_pcc = map_bits(e_pcc, 2)                                # [B, 98]
        e_pdc = pdc_encode(tb_bits, self.plan, self.network_id,
                           self.plcf_type)                        # [B, G]
        x_pdc = map_bits(e_pdc, ps.mcs.N_bps)

        grid = torch.zeros((B, S * N), dtype=torch.complex64,
                           device=plcf_bits.device)
        grid[:, self.drs_idx] = self.drs_val
        grid[:, self.pcc_idx] = x_pcc
        grid[:, self.pdc_idx] = x_pdc
        grid_tx = torch.einsum("at,btsn->basn", self.W, grid.reshape(B, 1, S, N))

        df = grid_tx[:, :, 1:1 + ps.N_DF_symb]                    # [B,N_TX,N_DF,N]
        body = torch.fft.ifft(torch.fft.ifftshift(df, dim=-1), dim=-1) * self.scale
        df_t = torch.cat([body[..., N - cp:], body], -1)          # +CP
        df_t = df_t.reshape(B, self.N_TX, ps.N_DF_symb * (N + cp))
        stf_t = self.stf[None].expand(B, -1, -1)
        gi = torch.zeros((B, self.N_TX, ps.N_samples_GI), dtype=torch.complex64,
                         device=plcf_bits.device)
        return torch.cat([stf_t, df_t.to(torch.complex64), gi], -1)


def build_tx(psdef: PacketSizesDef, network_id: int, plcf_type: int,
             codebook_idx: int = 0, rv: int = 0,
             window_fraction: float = 0.0) -> Tx:
    """TX module for one packet configuration (dectnrp_tpu/phy/tx.py:46)."""
    return Tx(psdef, network_id, plcf_type, codebook_idx, rv, window_fraction)
