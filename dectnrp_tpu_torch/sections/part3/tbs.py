"""Transport block size derivation per ETSI TS 103 636-3 5.3.

Behavioral parity with reference lib/src/sections_part3/transport_block_size.cpp:27-90.

Copy of `dectnrp_tpu/sections/part3/tbs.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations


def get_G(N_SS: int, N_PDC_subc: int, N_bps: int) -> int:
    """Total PDC soft bits in the packet."""
    return N_SS * N_PDC_subc * N_bps


def get_N_PDC_bits(N_SS: int, N_PDC_subc: int, N_bps: int,
                   R_num: int, R_den: int) -> int:
    return (get_G(N_SS, N_PDC_subc, N_bps) * R_num) // R_den


def get_N_TB_bits(N_SS: int, N_PDC_subc: int, N_bps: int,
                  R_num: int, R_den: int, Z: int) -> int:
    """Transport block size; 0 signals an ill-configured packet."""
    N_PDC_bits = get_N_PDC_bits(N_SS, N_PDC_subc, N_bps, R_num, R_den)

    L = 24
    if N_PDC_bits <= 512:
        M = 8
    elif N_PDC_bits <= 1024:
        M = 16
    elif N_PDC_bits <= 2048:
        M = 32
    else:
        M = 64

    N_M = (N_PDC_bits // M) * M
    if N_M == 0 or N_M <= L:
        return 0

    if N_M <= Z:
        return N_M - L
    C = -(-(N_M - L) // Z)  # ceil
    return N_M - (C + 1) * L
