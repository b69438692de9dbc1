"""Packet size derivation: psdef -> full packet geometry.

Behavioral parity with reference lib/src/sections_part3/derivative/packet_sizes.cpp:97-227,
including the validity rejections:
- N_eff_TX=4 requires N_PACKET_symb >= 15
- u=8 & N_eff_TX=8 requires N_PACKET_symb >= 20 and a multiple of 10
- N_PDC_subc must be > 0
- N_TB_bits must be > 0
- codeblock segmentation must yield zero filler bits

Copy of `dectnrp_tpu/sections/part3/packet_sizes.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from . import cbsegm as cbsegm_mod
from . import pdc, tbs
from .constants import ALLOWED_B, ALLOWED_U, SAMP_RATE_MIN_U_B
from .mcs import Mcs, get_mcs
from .numerologies import Numerology, get_numerology
from .tm_mode import TmMode, get_tm_mode
from .transmission_packet_structure import (
    get_N_DF_symb,
    get_N_PACKET_symb,
    get_N_samples_GI,
    get_N_samples_OFDM_symbol,
    get_N_samples_STF,
    get_N_samples_STF_CP_only,
)


@dataclass(frozen=True)
class PacketSizesDef:
    """The 7 degrees of freedom defining a packet (psdef)."""
    u: int
    b: int
    PacketLengthType: int   # 0: subslots, 1: slots
    PacketLength: int       # 1..16
    tm_mode_index: int      # 0..11
    mcs_index: int          # 0..11
    Z: int                  # 2048 or 6144


@dataclass(frozen=True)
class PacketSizes:
    psdef: PacketSizesDef
    numerology: Numerology
    mcs: Mcs
    tm_mode: TmMode
    N_PACKET_symb: int
    N_PDC_subc: int
    G: int
    N_PDC_bits: int
    N_TB_bits: int
    N_TB_byte: int
    C: int
    N_DF_symb: int
    N_DRS_subc: int
    N_samples_OFDM_symbol: int
    N_samples_STF: int
    N_samples_STF_CP_only: int
    N_samples_DF: int
    N_samples_GI: int
    N_samples_packet_no_GI: int
    N_samples_packet: int

    @property
    def cb_segm(self) -> cbsegm_mod.CbSegm:
        return cbsegm_mod.cbsegm(self.N_TB_bits, self.psdef.Z)


@lru_cache(maxsize=None)
def get_packet_sizes(psdef: PacketSizesDef) -> PacketSizes | None:
    """Derive the full packet geometry, or None if the psdef is invalid."""
    u, b = psdef.u, psdef.b
    if u not in ALLOWED_U or b not in ALLOWED_B:
        raise ValueError("u/b undefined")
    if not (0 <= psdef.PacketLengthType <= 1):
        raise ValueError("PacketLengthType undefined")
    if not (1 <= psdef.PacketLength <= 16):
        raise ValueError("PacketLength undefined")
    if psdef.Z not in (2048, 6144):
        raise ValueError("Z undefined")

    q = get_numerology(u, b)
    N_PACKET_symb = get_N_PACKET_symb(
        psdef.PacketLengthType, psdef.PacketLength, q.N_SLOT_u_symb, q.N_SLOT_u_subslot)
    assert 5 <= N_PACKET_symb <= 1280 and N_PACKET_symb % 5 == 0

    tm = get_tm_mode(psdef.tm_mode_index)
    N_eff_TX = tm.N_eff_TX

    if N_eff_TX == 4 and N_PACKET_symb < 15:
        return None
    if u == 8 and N_eff_TX == 8 and (N_PACKET_symb < 20 or N_PACKET_symb % 10 != 0):
        return None

    N_PDC_subc = pdc.get_N_PDC_subc(N_PACKET_symb, u, N_eff_TX, q.N_b_OCC)
    if N_PDC_subc == 0:
        return None

    mcs = get_mcs(psdef.mcs_index)
    N_TB_bits = tbs.get_N_TB_bits(
        tm.N_SS, N_PDC_subc, mcs.N_bps, mcs.R_numerator, mcs.R_denominator, psdef.Z)
    if N_TB_bits == 0:
        return None

    seg = cbsegm_mod.cbsegm(N_TB_bits, psdef.Z)
    if seg.F > 0:
        return None

    from .drs import get_N_DRS_subc
    N_samples_OFDM_symbol = get_N_samples_OFDM_symbol(b)
    N_DF_symb = get_N_DF_symb(u, N_PACKET_symb)
    n_stf = get_N_samples_STF(u, b)
    n_gi = get_N_samples_GI(u, b)
    n_df = N_samples_OFDM_symbol * N_DF_symb

    ps = PacketSizes(
        psdef=psdef,
        numerology=q,
        mcs=mcs,
        tm_mode=tm,
        N_PACKET_symb=N_PACKET_symb,
        N_PDC_subc=N_PDC_subc,
        G=tbs.get_G(tm.N_SS, N_PDC_subc, mcs.N_bps),
        N_PDC_bits=tbs.get_N_PDC_bits(
            tm.N_SS, N_PDC_subc, mcs.N_bps, mcs.R_numerator, mcs.R_denominator),
        N_TB_bits=N_TB_bits,
        N_TB_byte=-(-N_TB_bits // 8),
        C=seg.C,
        N_DF_symb=N_DF_symb,
        N_DRS_subc=get_N_DRS_subc(u, N_PACKET_symb, N_eff_TX, q.N_b_OCC),
        N_samples_OFDM_symbol=N_samples_OFDM_symbol,
        N_samples_STF=n_stf,
        N_samples_STF_CP_only=get_N_samples_STF_CP_only(u, b),
        N_samples_DF=n_df,
        N_samples_GI=n_gi,
        N_samples_packet_no_GI=n_stf + n_df,
        N_samples_packet=n_stf + n_df + n_gi,
    )
    assert ps.N_samples_packet == N_samples_OFDM_symbol * N_PACKET_symb
    return ps


def get_N_samples_at_samp_rate(ps: PacketSizes, samp_rate: int) -> int:
    """Packet length in samples after resampling to an SDR rate (ceil)."""
    dect_rate = ps.psdef.u * ps.psdef.b * SAMP_RATE_MIN_U_B
    return -(-(ps.N_samples_packet * samp_rate) // dect_rate)
