"""MCS table per ETSI TS 103 636-3 Annex A (Table A-1).

Behavioral parity with reference lib/src/sections_part3/mcs.cpp:27-131.

Copy of `dectnrp_tpu/sections/part3/mcs.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class Mcs:
    index: int
    N_bps: int          # bits per symbol (modulation order)
    R_numerator: int
    R_denominator: int

    @property
    def rate(self) -> float:
        return self.R_numerator / self.R_denominator


# (N_bps, R_num, R_den) per MCS index 0..11: BPSK..1024QAM
_MCS_TABLE = (
    (1, 1, 2),
    (2, 1, 2),
    (2, 3, 4),
    (4, 1, 2),
    (4, 3, 4),
    (6, 2, 3),
    (6, 3, 4),
    (6, 5, 6),
    (8, 3, 4),
    (8, 5, 6),
    (10, 3, 4),
    (10, 5, 6),
)


def get_mcs(index: int) -> Mcs:
    if not 0 <= index <= 11:
        raise ValueError(f"MCS {index} out of bound")
    n_bps, rn, rd = _MCS_TABLE[index]
    return Mcs(index=index, N_bps=n_bps, R_numerator=rn, R_denominator=rd)
