"""Transmission modes per ETSI TS 103 636-3 Table 7.2-1.

Behavioral parity with reference lib/src/sections_part3/tm_mode.cpp:27-208.

Copy of `dectnrp_tpu/sections/part3/tm_mode.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class TmMode:
    index: int
    N_eff_TX: int   # effective TX antennas == number of transmit streams N_TS
    N_SS: int       # spatial streams
    cl: bool        # closed loop
    N_TS: int       # transmit streams
    N_TX: int       # physical TX antennas


# (N_eff_TX, N_SS, cl, N_TS, N_TX) per mode index 0..11
_TM_TABLE = (
    (1, 1, False, 1, 1),
    (2, 1, False, 2, 2),
    (2, 2, False, 2, 2),
    (1, 1, True, 1, 2),
    (2, 2, True, 2, 2),
    (4, 1, False, 4, 4),
    (4, 4, False, 4, 4),
    (1, 1, True, 1, 4),
    (2, 2, True, 2, 4),
    (4, 4, True, 4, 4),
    (8, 1, False, 8, 8),
    (8, 8, False, 8, 8),
)


def get_tm_mode(index: int) -> TmMode:
    if not 0 <= index <= 11:
        raise ValueError(f"tm_mode {index} undefined")
    n_eff, n_ss, cl, n_ts, n_tx = _TM_TABLE[index]
    return TmMode(index=index, N_eff_TX=n_eff, N_SS=n_ss, cl=cl, N_TS=n_ts, N_TX=n_tx)


def max_tm_mode_index(N_TX: int) -> int:
    return {1: 0, 2: 4, 4: 9, 8: 11}[N_TX]


def tx_div_mode(N_TX: int) -> int:
    """Transmit-diversity (single spatial stream) mode per antenna count."""
    return {2: 1, 4: 5, 8: 10}[N_TX]


def single_antenna_mode(N_TX: int) -> int:
    return {1: 0, 2: 3, 4: 7}[N_TX]


def equivalent_tm_mode(N_eff_TX: int, N_SS: int) -> int:
    if N_eff_TX == 1:
        return 0
    if N_eff_TX == 2:
        return 1 if N_SS == 1 else 2
    if N_eff_TX == 4:
        return 5 if N_SS == 1 else 6
    return 10 if N_SS == 1 else 11
