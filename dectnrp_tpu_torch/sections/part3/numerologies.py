"""Numerologies per ETSI TS 103 636-3 Table 4.3-1.

Behavioral parity with reference lib/src/sections_part3/numerologies.cpp:30-70.

Copy of `dectnrp_tpu/sections/part3/numerologies.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

from . import constants as c


@dataclass(frozen=True)
class Numerology:
    u: int                  # subcarrier scaling factor mu in {1,2,4,8}
    b: int                  # Fourier transform scaling factor beta in {1,2,4,8,12,16}
    delta_u_f: int          # subcarrier spacing [Hz]
    T_u_symb: float         # OFDM symbol duration incl. CP [s]
    N_SLOT_u_symb: int      # OFDM symbols per slot
    N_SLOT_u_subslot: int   # subslots per slot
    B_u_b_DFT: int          # DFT bandwidth == sample rate [Hz]
    N_b_DFT: int            # DFT size
    N_b_CP: int             # cyclic prefix length [samples]
    N_b_OCC: int            # occupied subcarriers (excl. DC)
    N_guards_top: int
    N_guards_bottom: int


@lru_cache(maxsize=None)
def get_numerology(u: int, b: int) -> Numerology:
    if u not in c.ALLOWED_U:
        raise ValueError(f"u={u} undefined")
    if b not in c.ALLOWED_B:
        raise ValueError(f"b={b} undefined")

    delta_u_f = u * c.SUBCARRIER_SPACING_MIN
    N_b_DFT = b * c.N_B_DFT_MIN
    N_b_OCC = b * 56
    N_guards_top = (N_b_DFT - N_b_OCC) // 2 - 1

    return Numerology(
        u=u,
        b=b,
        delta_u_f=delta_u_f,
        T_u_symb=(64.0 + 8.0) / 64.0 / delta_u_f,
        N_SLOT_u_symb=u * 10,
        N_SLOT_u_subslot=u * 2,
        B_u_b_DFT=N_b_DFT * delta_u_f,
        N_b_DFT=N_b_DFT,
        N_b_CP=b * c.N_B_CP_MIN,
        N_b_OCC=N_b_OCC,
        N_guards_top=N_guards_top,
        N_guards_bottom=N_guards_top + 1,
    )


def get_samp_rate(u: int, b: int) -> int:
    """DECT-native sample rate for a numerology: u*b*1.728 Ms/s."""
    return u * b * c.SAMP_RATE_MIN_U_B
