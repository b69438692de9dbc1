"""Numpy reference turbo encoder (3GPP TS 36.212 5.1.3.2, LTE PCCC).

Constituent RSC: G(D) = [1, g1(D)/g0(D)], g0 = 1+D^2+D^3, g1 = 1+D+D^3.
State registers (r1, r2, r3) hold past feedback values a(t-1..t-3):
    a = c XOR r2 XOR r3;  z = a XOR r1 XOR r3;  next state = (a, r1, r2)
Trellis termination: 3 steps per encoder with c chosen so a = 0
(c = r2 XOR r3), producing the 12 interlaced tail bits of 36.212 5.1.3.2.2.

Used as the correctness oracle for the batched encoder/decoder.

Numpy-only copy of `dectnrp_tpu/phy/fec/turbo_np.py` (importing any
`dectnrp_tpu.phy` module loads jax); `tests/test_torch_tables.py` holds it
equal to the original, code for code.
"""
from __future__ import annotations

import numpy as np

from .qpp import interleaver


def _rsc_encode(c: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (z parity bits [K], x_tail [3], z_tail [3])."""
    r1 = r2 = r3 = 0
    z = np.empty(c.size, dtype=np.uint8)
    for k, ck in enumerate(c):
        a = int(ck) ^ r2 ^ r3
        z[k] = a ^ r1 ^ r3
        r1, r2, r3 = a, r1, r2
    x_tail = np.empty(3, dtype=np.uint8)
    z_tail = np.empty(3, dtype=np.uint8)
    for t in range(3):
        ck = r2 ^ r3          # input that forces a = 0
        x_tail[t] = ck
        z_tail[t] = 0 ^ r1 ^ r3
        r1, r2, r3 = 0, r1, r2
    return z, x_tail, z_tail


def turbo_encode(c: np.ndarray) -> np.ndarray:
    """Encode K bits -> d streams [3, K+4] per 36.212 5.1.3.2.2 output mapping."""
    K = c.size
    pi = interleaver(K)
    c = np.asarray(c, dtype=np.uint8)
    cp = c[pi]

    z1, xt1, zt1 = _rsc_encode(c)
    z2, xt2, zt2 = _rsc_encode(cp)

    d = np.zeros((3, K + 4), dtype=np.uint8)
    d[0, :K] = c
    d[1, :K] = z1
    d[2, :K] = z2
    # tail mapping (36.212 Table 5.1.3-2 equivalents):
    # d0: x_K,     z_{K+1},  x'_K,     z'_{K+1}
    # d1: z_K,     x_{K+2},  z'_K,     x'_{K+2}
    # d2: x_{K+1}, z_{K+2},  x'_{K+1}, z'_{K+2}
    d[0, K:] = [xt1[0], zt1[1], xt2[0], zt2[1]]
    d[1, K:] = [zt1[0], xt1[2], zt2[0], xt2[2]]
    d[2, K:] = [xt1[1], zt1[2], xt2[1], zt2[2]]
    return d
