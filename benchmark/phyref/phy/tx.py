"""Whole-packet TX synthesis, batched over packets (port of dectnrp_tpu/phy/tx.py).

Reference: lib/src/phy/tx/tx.cpp:165-314. Bits -> FEC -> QAM -> one grid
scatter -> beamforming einsum -> batched IFFT + CP -> STF assembly + cover
sequence -> GI, at the native DECT rate.

Every option of the JAX builder: a single transmit stream, N_TS = 2/4/8
transmit streams by Alamouti transmit diversity (JAX tx.py:26-42, 108-116),
and N_SS > 1 spatial multiplexing (the PDC's serial symbols round-robin
onto the N_SS = N_TS streams, JAX tx.py:100-103; the PCC stays Alamouti
over N_TS), mapped onto the N_TX antennas through beamforming matrix W
`codebook_idx` of the codebook (an index beyond the codebook raises
ValueError, as JAX's `get_W` does); any redundancy version rv (the PDC rate
matching's start, for HARQ retransmissions); and raised-cosine TX windowing
over `window_fraction` of the CP (JAX tx.py:48-76, 133-152; reference
tx.cpp:882-911).
"""
from __future__ import annotations

import numpy as np
import torch

from ..sections.part3.beamforming import get_W
from ..sections.part3.packet_sizes import PacketSizesDef
from ..sections.part3.stf import cover_sequence, n_stf_patterns
from .fec.chain import PdcPlan, pcc_encode, pdc_encode
from .filters import raised_cosine_window
from .modulation import map_bits
from .packet_config import AlamoutiLuts, get_packet_luts
from .plan import register_tables


def _alamouti_tables(al: AlamoutiLuts, name: str) -> dict:
    return {f"{name}_a": al.a.astype(np.complex64),
            f"{name}_b": al.b.astype(np.complex64),
            f"{name}_ga": al.ga, f"{name}_gb": al.gb}


class Tx(torch.nn.Module):
    """tx(plcf_bits [B, 40/80], tb_bits [B, N_TB], cl [B], bf [B])
    -> iq complex64 [B, N_TX, N_samples_packet]."""

    def __init__(self, psdef: PacketSizesDef, network_id: int, plcf_type: int,
                 codebook_idx: int = 0, rv: int = 0,
                 window_fraction: float = 0.0):
        super().__init__()
        luts = get_packet_luts(psdef)
        ps = luts.ps
        self.ps, self.network_id, self.plcf_type = ps, network_id, plcf_type
        self.rv = rv
        q = ps.numerology
        self.N, self.S, self.cp = q.N_b_DFT, ps.N_PACKET_symb, q.N_b_CP
        self.N_TX, self.N_TS = ps.tm_mode.N_TX, ps.tm_mode.N_TS
        self.N_SS = ps.tm_mode.N_SS
        self.plan = PdcPlan.get(ps.N_TB_bits, ps.G, ps.mcs.N_bps, psdef.Z)
        self.scale = luts.tx_scale
        W = get_W(self.N_TS, self.N_TX, codebook_idx).astype(np.complex64)
        stf, pattern, cover_last = self._stf(W, luts.stf_grid, psdef.u, psdef.b)
        tables = {
            "drs_idx": luts.drs_flat_idx, "drs_val": luts.drs_values,
            "pcc_idx": luts.pcc_flat_idx.ravel(),
            "pdc_idx": luts.pdc_flat_idx.ravel(), "W": W, "stf": stf}
        self.n_w = 0
        if window_fraction > 0.0:
            # raised-cosine rise on each symbol's CP head, overlap-added with
            # the previous symbol's cyclic tail (body start x falling edge);
            # symbol 0's predecessor is the STF, which continues as
            # cover[-1] * pattern. Only CP heads and the GI start are shaped.
            self.n_w = n_w = max(2, int(round(self.cp * window_fraction)))
            assert n_w <= self.cp and n_w <= 16 * psdef.b
            rc = raised_cosine_window(0, n_w)        # [2 n_w]: rise, fall
            w_rise = torch.as_tensor(rc[:n_w].astype(np.float32))
            w_fall = torch.as_tensor(rc[n_w:].astype(np.float32))
            stf = torch.as_tensor(stf)
            stf[..., :n_w] *= w_rise
            tables.update(
                stf=stf.numpy(), w_rise=w_rise.numpy(), w_fall=w_fall.numpy(),
                stf_tail=(pattern[:, :n_w] * cover_last * w_fall).to(
                    torch.complex64).numpy())
        if self.N_TS > 1:
            tables.update(_alamouti_tables(luts.pcc_alamouti, "pcc"))
        if luts.pdc_alamouti is not None:
            tables.update(_alamouti_tables(luts.pdc_alamouti, "pdc"))
        register_tables(self, tables)

    def _stf(self, W, stf_grid, u, b):
        """(STF [N_TX, n_pat*16b], its base pattern [N_TX, 16b], the cover
        sequence's last sign): the pattern from its IFFT, n_pat repetitions,
        cover sequence (stream 0 carries the STF)."""
        stf_bf = torch.einsum("at,n->an", torch.as_tensor(W[:, :1]),
                              torch.as_tensor(stf_grid))
        body = torch.fft.ifft(torch.fft.ifftshift(stf_bf, dim=-1), dim=-1) * self.scale
        pattern = body[:, :16 * b]
        n_pat = n_stf_patterns(u)
        cover = torch.as_tensor(cover_sequence(u).astype(np.float32))
        reps = pattern[:, None, :].expand(-1, n_pat, -1) * cover[None, :, None]
        return (reps.reshape(self.N_TX, -1).to(torch.complex64).numpy(),
                pattern, cover[-1])

    def _spread(self, x, name):
        """Cells [B, n] -> transmit streams [B, N_TS, n] (Alamouti for N_TS > 1):
        out[t, i] = a[t, i] x[ga[t, i]] + b[t, i] conj(x[gb[t, i]])."""
        if self.N_TS == 1:
            return x[:, None, :]
        a, bm = getattr(self, f"{name}_a"), getattr(self, f"{name}_b")
        ga, gb = getattr(self, f"{name}_ga"), getattr(self, f"{name}_gb")
        return a * x[:, ga] + bm * torch.conj(x[:, gb])

    def forward(self, plcf_bits, tb_bits, cl, bf):
        B = plcf_bits.shape[0]
        ps, N, S, cp = self.ps, self.N, self.S, self.cp
        e_pcc = pcc_encode(plcf_bits, cl, bf, self.plcf_type)     # [B, 196]
        x_pcc = map_bits(e_pcc, 2)                                # [B, 98]
        e_pdc = pdc_encode(tb_bits, self.plan, self.network_id,
                           self.plcf_type, self.rv)               # [B, G]
        x_pdc = map_bits(e_pdc, ps.mcs.N_bps)
        if self.N_SS > 1:
            # serial symbols round-robin onto the spatial streams, each
            # stream on its own transmit stream: [B, N_SS = N_TS, n_pdc]
            ts_pdc = x_pdc.reshape(B, -1, self.N_SS).transpose(1, 2)
        else:
            ts_pdc = self._spread(x_pdc, "pdc")

        grid = torch.zeros((B, self.N_TS * S * N), dtype=torch.complex64,
                           device=plcf_bits.device)
        grid[:, self.drs_idx] = self.drs_val
        grid[:, self.pcc_idx] = self._spread(x_pcc, "pcc").reshape(B, -1)
        grid[:, self.pdc_idx] = ts_pdc.reshape(B, -1)
        grid_tx = torch.einsum("at,btsn->basn", self.W,
                               grid.reshape(B, self.N_TS, S, N))

        df = grid_tx[:, :, 1:1 + ps.N_DF_symb]                    # [B,N_TX,N_DF,N]
        body = torch.fft.ifft(torch.fft.ifftshift(df, dim=-1), dim=-1) * self.scale
        df_t = torch.cat([body[..., N - cp:], body], -1)          # +CP
        gi = torch.zeros((B, self.N_TX, ps.N_samples_GI), dtype=torch.complex64,
                         device=plcf_bits.device)
        if self.n_w:
            n_w = self.n_w
            tails = body[..., :n_w] * self.w_fall                 # [B,NTX,NDF,nw]
            prev = torch.cat([self.stf_tail[None, :, None].expand(B, -1, 1, -1),
                              tails[..., :-1, :]], 2)
            heads = df_t[..., :n_w] * self.w_rise + prev
            df_t = torch.cat([heads, df_t[..., n_w:]], -1)
            gi[..., :n_w] = tails[:, :, -1]                       # last tail
        df_t = df_t.reshape(B, self.N_TX, ps.N_DF_symb * (N + cp))
        stf_t = self.stf[None].expand(B, -1, -1)
        return torch.cat([stf_t, df_t.to(torch.complex64), gi], -1)


def build_tx(psdef: PacketSizesDef, network_id: int, plcf_type: int,
             codebook_idx: int = 0, rv: int = 0,
             window_fraction: float = 0.0,
             device: torch.device | str = "cuda") -> Tx:
    """TX module for one packet configuration (dectnrp_tpu/phy/tx.py:46),
    on `device`."""
    return Tx(psdef, network_id, plcf_type, codebook_idx, rv,
              window_fraction).to(device)
