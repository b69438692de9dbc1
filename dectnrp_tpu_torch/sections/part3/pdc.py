"""PDC (physical data channel) cell allocation, ETSI TS 103 636-3 5.2.5.

Behavioral parity with reference lib/src/sections_part3/pdc.cpp:40-219. Instead
of the reference's 21-symbol repetition LUT we build the allocation directly on
the actual packet grid -- every occupied subcarrier in DF symbols 1..N_DF_symb
not used by DC/guards/DRS/PCC is a PDC cell, in linear order. The counting
formulas (get_N_PDC_subc) are shared and asserted in tests over the full
(u, b, N_TS) lattice.

Copy of `dectnrp_tpu/sections/part3/pdc.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import drs, pcc, phyres
from .constants import PCC_CELLS
from .transmission_packet_structure import get_N_DF_symb


def get_N_PDC_subc(N_PACKET_symb: int, u: int, N_eff_TX: int, N_b_OCC: int) -> int:
    N_DF_symb = get_N_DF_symb(u, N_PACKET_symb)
    N_DRS_subc = drs.get_N_DRS_subc(u, N_PACKET_symb, N_eff_TX, N_b_OCC)
    if N_DF_symb * N_b_OCC <= N_DRS_subc + PCC_CELLS:
        return 0
    return N_DF_symb * N_b_OCC - N_DRS_subc - PCC_CELLS


@lru_cache(maxsize=None)
def pdc_linear_indices(u: int, b: int, N_PACKET_symb: int, N_TS: int) -> np.ndarray:
    """Linear cell indices (l*N_b_DFT + k_dft) of all PDC cells, in order."""
    N_b_DFT = b * 64
    N_DF_symb = get_N_DF_symb(u, N_PACKET_symb)
    g_top, g_bot = phyres.guards(b)

    free = np.ones((N_PACKET_symb, N_b_DFT), dtype=bool)
    free[:, N_b_DFT // 2] = False
    free[:, :g_bot] = False
    free[:, N_b_DFT - g_top:] = False

    free.ravel()[drs.drs_linear_indices(u, b, N_PACKET_symb, N_TS).ravel()] = False
    free.ravel()[pcc.pcc_linear_indices(b, N_TS)] = False

    # PDC occupies DF symbols l = 1 .. N_DF_symb
    mask = np.zeros_like(free)
    mask[1:1 + N_DF_symb] = free[1:1 + N_DF_symb]
    out = np.nonzero(mask.ravel())[0].astype(np.int64)

    expected = get_N_PDC_subc(N_PACKET_symb, u, N_TS, b * 56)
    assert out.size == expected, (
        f"PDC count mismatch: built {out.size}, formula {expected} "
        f"(u={u} b={b} N_PACKET_symb={N_PACKET_symb} N_TS={N_TS})")
    return out
