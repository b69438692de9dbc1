"""Physical resource grids: occupied-subcarrier index sets k_b_OCC.

Behavioral parity with reference lib/src/sections_part3/physical_resources.cpp:25-70.
Subcarrier indices run -N_b_OCC/2..-1, 1..N_b_OCC/2 (DC excluded).

Copy of `dectnrp_tpu/sections/part3/phyres.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

B_VALUES = (1, 2, 4, 8, 12, 16)
B2IDX = {1: 0, 2: 1, 4: 2, 8: 3, 12: 4, 16: 5}
N_TS_VALUES = (1, 2, 4, 8)
N_TS2IDX = {1: 0, 2: 1, 4: 2, 8: 3}

N_B_OCC_LUT = tuple(b * 56 for b in B_VALUES)
N_B_DFT_LUT = tuple(b * 64 for b in B_VALUES)


@lru_cache(maxsize=None)
def k_b_OCC(b: int) -> np.ndarray:
    """Signed occupied-subcarrier indices for beta=b (DC excluded)."""
    n = b * 56
    return np.concatenate([np.arange(-n // 2, 0), np.arange(1, n // 2 + 1)])


def guards(b: int) -> tuple[int, int]:
    """(top, bottom) guard counts."""
    n_dft = b * 64
    n_occ = b * 56
    top = (n_dft - n_occ) // 2 - 1
    return top, top + 1


def occ_to_dft_index(k: np.ndarray, b: int) -> np.ndarray:
    """Map signed subcarrier index k to centered DFT grid index (DC at N_b_DFT/2)."""
    return k + (b * 64) // 2
