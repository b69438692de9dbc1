"""LTE pseudo-random (Gold) scrambling sequences, 3GPP TS 36.211 7.2.

Used by DECT NR+ for PCC (g_init = 0x44454354, TS 103 636-3 7.5.4) and PDC
(g_init from the network ID: low 8 bits for PLCF type 1, high 24 bits for
type 2 -- reference lib/src/sections_part3/scrambling_pdc.cpp:36-57).

Copy of `dectnrp_tpu/sections/part3/scrambling.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

_NC = 1600

PCC_G_INIT = 0x44454354


@lru_cache(maxsize=64)
def lte_pr_sequence(length: int, g_init: int) -> np.ndarray:
    """Gold sequence c(n) of the given length, dtype uint8 in {0,1}."""
    n = length + _NC
    x1 = np.zeros(n + 31, dtype=np.uint8)
    x2 = np.zeros(n + 31, dtype=np.uint8)
    x1[0] = 1
    for i in range(31):
        x2[i] = (g_init >> i) & 1
    # advance both LFSRs vectorized in 31-step blocks is possible, but this
    # runs once per (length, g_init) and is cached -- keep it simple
    for i in range(n):
        x1[i + 31] = x1[i + 3] ^ x1[i]
        x2[i + 31] = x2[i + 3] ^ x2[i + 2] ^ x2[i + 1] ^ x2[i]
    return (x1[_NC:_NC + length] ^ x2[_NC:_NC + length]).astype(np.uint8)


def pdc_g_init(network_id: int, plcf_type: int) -> int:
    """Scrambling init for PDC per TS 103 636-3 7.6.6."""
    if plcf_type == 1:
        return network_id & 0xFF
    if plcf_type == 2:
        return network_id >> 8
    raise ValueError("plcf_type must be 1 or 2")
