"""CRC codes used by DECT NR+ (3GPP TS 36.212 5.1.1 generators).

- CRC16 (poly 0x1021) for the PLCF (TS 103 636-3 7.5.2.1)
- CRC24A (0x1864CFB) for the transport block, CRC24B (0x1800063) per codeblock

Besides the host bit-loop implementation we expose GF(2) generator matrices so
the device-side decode path can check CRCs with a single mod-2 matmul
(MXU-friendly), avoiding per-packet host round trips.

Numpy-only copy of `dectnrp_tpu/phy/fec/crc.py`: importing any `dectnrp_tpu.phy`
module loads jax through that package's `__init__`, so the port keeps
its own copy. `tests/test_torch_tables.py` holds it equal to the original.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

POLY_CRC16 = 0x1021
POLY_CRC24A = 0x1864CFB
POLY_CRC24B = 0x1800063

_LEN = {POLY_CRC16: 16, POLY_CRC24A: 24, POLY_CRC24B: 24}


def crc_bits(bits: np.ndarray, poly: int) -> np.ndarray:
    """CRC of an unpacked bit array (MSB-first), returns L bits."""
    L = _LEN[poly]
    reg = 0
    mask = (1 << L) - 1
    top = 1 << (L - 1)
    for b in np.asarray(bits, dtype=np.uint8):
        fb = ((reg >> (L - 1)) & 1) ^ int(b)
        reg = ((reg << 1) & mask) ^ (poly & mask if fb else 0)
    return np.array([(reg >> (L - 1 - i)) & 1 for i in range(L)], dtype=np.uint8)


def attach_crc(bits: np.ndarray, poly: int, mask_bits: np.ndarray | None = None) -> np.ndarray:
    """Append CRC (optionally XOR-masked, e.g. PLCF cl/bf masks)."""
    c = crc_bits(bits, poly)
    if mask_bits is not None:
        c = c ^ mask_bits.astype(np.uint8)
    return np.concatenate([np.asarray(bits, dtype=np.uint8), c])


def check_crc(bits_with_crc: np.ndarray, poly: int) -> bool:
    L = _LEN[poly]
    c = crc_bits(bits_with_crc[:-L], poly)
    return bool(np.all(c == bits_with_crc[-L:]))


def mask_u16_to_bits(mask: int) -> np.ndarray:
    return np.array([(mask >> (15 - i)) & 1 for i in range(16)], dtype=np.uint8)


@lru_cache(maxsize=None)
def crc_matrix(n_payload_bits: int, poly: int) -> np.ndarray:
    """GF(2) matrix M [n_payload_bits, L]: crc(bits) = (bits @ M) % 2.

    Built from powers of x modulo the generator: bit i (MSB-first) contributes
    x^(n-1-i+L) mod g(x).
    """
    L = _LEN[poly]
    mask = (1 << L) - 1
    # x^L mod g
    cur = poly & mask
    powers = np.zeros((n_payload_bits, L), dtype=np.uint8)
    # powers for exponent L + j, j = 0..n-1; bit i uses exponent L + (n-1-i)
    regs = np.empty(n_payload_bits, dtype=np.int64)
    for j in range(n_payload_bits):
        regs[j] = cur
        fb = (cur >> (L - 1)) & 1
        cur = ((cur << 1) & mask) ^ (poly & mask if fb else 0)
    for i in range(n_payload_bits):
        reg = int(regs[n_payload_bits - 1 - i])
        for k in range(L):
            powers[i, k] = (reg >> (L - 1 - k)) & 1
    return powers
