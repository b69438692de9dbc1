"""STF (synchronization training field) frequency-domain sequences, ETSI TS 103 636-3 6.3.5.

Behavioral parity with reference lib/src/sections_part3/stf.cpp:161-270:
- per-b +-1 polarity base sequences, recursive fliplr*(-1)^k extension for b=8/12/16
- values scaled by exp(j*pi/4)*scale on every 4th occupied subcarrier
- cyclic rotation of the polarity sequence by 2*log2(N_eff_TX) signals the stream count
- time-domain cover sequence over 7 (u=1) or 9 (u>=2) pattern repetitions

Copy of `dectnrp_tpu/sections/part3/stf.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import phyres

# base polarity sequences (standard 6.3.5 tables)
_Y_B_1 = np.array([1, -1, 1, 1, -1, 1, 1, -1, 1, 1, 1, -1, -1, -1], dtype=np.float64)
_Y_B_2 = np.array([-1, 1, -1, 1, 1, -1, 1, 1, -1, 1, 1, 1, -1, 1,
                   -1, -1, -1, 1, -1, -1, -1, 1, 1, 1, -1, -1, -1, -1], dtype=np.float64)
_Y_B_4 = np.array([-1, -1, -1, 1, -1, 1, -1, -1, 1, 1, 1, 1, -1, 1,
                   -1, -1, -1, 1, -1, 1, 1, -1, -1, -1, -1, -1, 1, -1,
                   1, 1, 1, -1, 1, -1, 1, 1, -1, -1, -1, -1, 1, -1,
                   -1, -1, -1, 1, -1, 1, 1, -1, -1, -1, -1, -1, 1, -1], dtype=np.float64)

# time-domain cover sequence over STF pattern repetitions (first 7 used for u=1)
COVER_SEQUENCE = np.array([1, -1, 1, 1, -1, -1, -1, -1, -1], dtype=np.float64)


def _fliplr_alt(x: np.ndarray) -> np.ndarray:
    """fliplr followed by elementwise (-1)^k (k counted from 0)."""
    out = x[::-1].copy()
    out[1::2] *= -1.0
    return out


@lru_cache(maxsize=None)
def polarity(b: int) -> np.ndarray:
    """+-1 polarity sequence of length N_b_OCC/4 = 14*b."""
    if b == 1:
        return _Y_B_1
    if b == 2:
        return _Y_B_2
    if b == 4:
        return _Y_B_4
    y8 = np.concatenate([_Y_B_4, _fliplr_alt(_Y_B_4)])
    if b == 8:
        return y8
    y16 = np.concatenate([y8, _fliplr_alt(y8)])
    if b == 16:
        return y16
    # b == 12: central 168 entries of y16, offset 2*14
    return y16[28:28 + 168]


@lru_cache(maxsize=None)
def stf_cell_indices(b: int) -> np.ndarray:
    """Signed subcarrier indices carrying STF cells (every 4th occupied subcarrier).

    Mirrors reference stf.cpp fill_k_i: negative half strided from index 0,
    positive half strided from occupied index N_b_OCC/2+3.
    """
    k = phyres.k_b_OCC(b)
    n = b * 56
    lo = k[0:n // 2:4]                    # N_b_OCC/8 cells
    hi = k[n // 2 + 3::4]                 # N_b_OCC/8 cells
    out = np.concatenate([lo, hi])
    assert out.size == n // 4
    return out


@lru_cache(maxsize=None)
def stf_freq_values(b: int, N_eff_TX: int, scale: float = 1.0) -> np.ndarray:
    """Complex STF cell values (length N_b_OCC/4) for the given stream count."""
    pol = polarity(b)
    n4 = pol.size
    rot = 2 * int(np.log2(N_eff_TX))
    rolled = pol[(np.arange(n4) + rot) % n4]
    fac = scale * np.exp(1j * np.pi / 4.0)
    return (rolled * fac).astype(np.complex128)


@lru_cache(maxsize=None)
def stf_freq_grid(b: int, N_eff_TX: int, scale: float = 1.0) -> np.ndarray:
    """STF on the centered DFT grid [N_b_DFT] (DC at N_b_DFT/2), zeros elsewhere."""
    grid = np.zeros(b * 64, dtype=np.complex128)
    idx = phyres.occ_to_dft_index(stf_cell_indices(b), b)
    grid[idx] = stf_freq_values(b, N_eff_TX, scale)
    return grid


def n_stf_patterns(u: int) -> int:
    return 7 if u == 1 else 9


def cover_sequence(u: int) -> np.ndarray:
    return COVER_SEQUENCE[: n_stf_patterns(u)]
