"""Packet time structure (STF/DF/GI sample counts) per ETSI TS 103 636-3 5.1.

Behavioral parity with reference lib/src/sections_part3/transmission_packet_structure.cpp:28-96.

Copy of `dectnrp_tpu/sections/part3/transmission_packet_structure.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations


def get_N_PACKET_symb(packet_length_type: int, packet_length: int,
                      N_SLOT_u_symb: int, N_SLOT_u_subslot: int) -> int:
    if packet_length_type == 0:  # length in subslots
        return packet_length * N_SLOT_u_symb // N_SLOT_u_subslot
    return packet_length * N_SLOT_u_symb  # length in slots


def get_N_samples_OFDM_symbol(b: int) -> int:
    return 72 * b


def get_N_samples_STF(u: int, b: int) -> int:
    sym = get_N_samples_OFDM_symbol(b)
    if u == 1:
        return (sym * 14) // 9   # 112*b: 7 patterns of 16*b
    return sym * 2               # 144*b: 9 patterns of 16*b


def get_N_samples_STF_CP_only(u: int, b: int) -> int:
    return get_N_samples_STF(u, b) - 64 * b


def get_N_samples_GI(u: int, b: int) -> int:
    sym = get_N_samples_OFDM_symbol(b)
    if u == 1:
        return (sym * 4) // 9    # 32*b
    if u in (2, 4):
        return sym
    return sym * 2               # u == 8


def get_N_DF_symb(u: int, N_PACKET_symb: int) -> int:
    """Data-field symbol count (reference lib/src/sections_part3/pdc.cpp:155-165)."""
    if u == 1:
        return N_PACKET_symb - 2
    if u in (2, 4):
        return N_PACKET_symb - 3
    return N_PACKET_symb - 4
