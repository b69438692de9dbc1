"""PCC (physical control channel) cell allocation, ETSI TS 103 636-3 5.2.4.

Behavioral parity with reference lib/src/sections_part3/pcc.cpp:110-159: the
"virtual frame" algorithm -- starting at symbol l=1, take all occupied
subcarriers not used by DC/guards/DRS until 98 cells are allocated; if a symbol
has at least as many free cells as still needed, distribute via a 7-row
column-major read and sort.

Copy of `dectnrp_tpu/sections/part3/pcc.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import drs, phyres
from .constants import PCC_CELLS


@lru_cache(maxsize=None)
def pcc_linear_indices(b: int, N_TS: int) -> np.ndarray:
    """Linear cell indices (l*N_b_DFT + k_dft) of the 98 PCC cells, sorted.

    Valid for any packet since PCC lives in symbols 1..4; the DRS pattern in
    that range is identical for all N_PACKET_symb (virtual frame of 20 symbols,
    u=8 as in the reference -- u only affects trailing zero symbols).
    """
    N_PACKET_symb = 20
    u = 8
    N_b_DFT = b * 64
    g_top, g_bot = phyres.guards(b)

    # virtual frame: True = available for PCC
    free = np.ones((N_PACKET_symb, N_b_DFT), dtype=bool)
    free[:, N_b_DFT // 2] = False                      # DC
    free[:, :g_bot] = False                            # bottom guards
    free[:, N_b_DFT - g_top:] = False                  # top guards

    lin = drs.drs_linear_indices(u, b, N_PACKET_symb, N_TS).ravel()
    free.ravel()[lin] = False                          # DRS cells

    k_pcc: list[int] = []
    l = 1
    n_unalloc = PCC_CELLS
    while True:
        avail = np.nonzero(free[l])[0] + l * N_b_DFT
        U = avail.size
        if U < n_unalloc:
            k_pcc.extend(avail.tolist())
            l += 1
            n_unalloc -= U
            continue
        # distribute: fill 7 x (U/7) matrix row-major, read column-major
        R = 7
        assert U % R == 0, "available subcarriers not a multiple of 7"
        C = U // R
        mat = avail.reshape(R, C)
        picked = mat.T.ravel()[:n_unalloc]
        k_pcc.extend(picked.tolist())
        break

    out = np.sort(np.array(k_pcc, dtype=np.int64))
    assert out.size == PCC_CELLS
    return out


@lru_cache(maxsize=None)
def pcc_cells_l_k(b: int, N_TS: int):
    """(l, k_dft) arrays of the 98 PCC cells."""
    lin = pcc_linear_indices(b, N_TS)
    N_b_DFT = b * 64
    return lin // N_b_DFT, lin % N_b_DFT
