"""DRS (demodulation reference signal) pilot grids, ETSI TS 103 636-3 5.2.3.

Behavioral parity with reference lib/src/sections_part3/drs.cpp:73-254:
- symbol schedule l = 1 + floor(t/4) + n*N_step, N_step = 5 (N_TS<=2) / 10 (N_TS>=4)
- subcarrier rotation (t + (n%2)*2) mod 4 within each group of 4 occupied subcarriers
- values +-y_b_1[(4i + t mod 4) mod 56], negated for transmit streams t >= 4
  (including the reference's deliberate fix of the standard erratum t<4 vs t<=4)

Copy of `dectnrp_tpu/sections/part3/drs.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from . import phyres

# base DRS sequence (56 entries, +-1), ETSI TS 103 636-3 Table 5.2.3-1
Y_B_1 = np.array([
    1, 1, 1, 1, -1, 1, 1, -1, -1, 1, 1, 1, 1, -1, 1, -1, 1, 1, -1, 1,
    -1, 1, -1, 1, 1, 1, 1, 1, -1, 1,
    -1, -1, 1, 1, -1, -1, -1, -1, 1, -1, -1, -1, -1, -1, 1, 1, 1, -1,
    1, 1, -1, -1, 1, -1, -1, -1,
], dtype=np.float64)
assert Y_B_1.size == 56


def get_N_step(N_TS_or_N_eff_TX: int) -> int:
    return 5 if N_TS_or_N_eff_TX <= 2 else 10


def nof_drs_symbols_per_ts(u: int, N_PACKET_symb: int, N_eff_TX: int) -> int:
    """OFDM symbols carrying DRS per transmit stream.

    Reference lib/src/sections_part3/pdc.cpp:167-201 (incl. the +1 for odd
    multiples of 5 when N_step=10, cf. Figure 4.5-3 d).
    """
    if N_eff_TX == 4 and N_PACKET_symb < 15:
        raise ValueError("N_eff_TX=4 requires N_PACKET_symb >= 15")
    if u == 8 and N_eff_TX == 8 and (N_PACKET_symb < 20 or N_PACKET_symb % 10 != 0):
        raise ValueError("u=8, N_eff_TX=8 requires N_PACKET_symb >= 20 and multiple of 10")
    N_step = get_N_step(N_eff_TX)
    n = N_PACKET_symb // N_step
    if N_step == 10 and N_PACKET_symb % 10 != 0:
        n += 1
    return n


def get_N_DRS_subc(u: int, N_PACKET_symb: int, N_eff_TX: int, N_b_OCC: int) -> int:
    return N_eff_TX * (N_b_OCC // 4) * nof_drs_symbols_per_ts(u, N_PACKET_symb, N_eff_TX)


@lru_cache(maxsize=None)
def drs_cells(u: int, b: int, N_PACKET_symb: int, N_TS: int):
    """Per-TS DRS cell positions and values within the packet grid.

    Returns (l, k_dft, values) arrays each of shape [N_TS, n_symb*N_b_OCC/4]:
      l      -- OFDM symbol index within the packet
      k_dft  -- centered DFT grid subcarrier index (DC at N_b_DFT/2)
      values -- complex pilot values
    """
    k_occ = phyres.k_b_OCC(b)
    n4 = (b * 56) // 4
    N_step = get_N_step(N_TS)
    n_symb = nof_drs_symbols_per_ts(u, N_PACKET_symb, N_TS)

    i = np.arange(n4)
    l_out = np.empty((N_TS, n_symb * n4), dtype=np.int64)
    k_out = np.empty((N_TS, n_symb * n4), dtype=np.int64)
    v_out = np.empty((N_TS, n_symb * n4), dtype=np.complex128)

    for t in range(N_TS):
        sign = 1.0 if t < 4 else -1.0
        vals = sign * Y_B_1[(4 * i + (t % 4)) % 56]
        for n in range(n_symb):
            l = 1 + t // 4 + n * N_step
            k_signed = k_occ[i * 4 + (t + (n % 2) * 2) % 4]
            sl = slice(n * n4, (n + 1) * n4)
            l_out[t, sl] = l
            k_out[t, sl] = phyres.occ_to_dft_index(k_signed, b)
            v_out[t, sl] = vals
    return l_out, k_out, v_out


@lru_cache(maxsize=None)
def drs_linear_indices(u: int, b: int, N_PACKET_symb: int, N_TS: int) -> np.ndarray:
    """Linear indices l*N_b_DFT + k_dft per TS, shape [N_TS, n_cells]."""
    l, k, _ = drs_cells(u, b, N_PACKET_symb, N_TS)
    return l * (b * 64) + k
