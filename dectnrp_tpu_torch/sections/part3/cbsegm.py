"""Turbo codeblock segmentation (3GPP TS 36.212 5.1.2 with DECT Z=2048 variant).

Behavioral parity with reference lib/src/sections_part3/fix/cbsegm.cpp (the srsRAN
cbsegm with the added Z=2048 code block size limit).

Copy of `dectnrp_tpu/sections/part3/cbsegm.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from functools import lru_cache

# TS 36.212 Table 5.1.3-3: valid turbo interleaver sizes K
TC_CB_SIZES: tuple[int, ...] = tuple(
    list(range(40, 512 + 1, 8))
    + list(range(528, 1024 + 1, 16))
    + list(range(1056, 2048 + 1, 32))
    + list(range(2112, 6144 + 1, 64))
)
assert len(TC_CB_SIZES) == 188

L_CRC = 24  # TB and CB CRC length


def cbsize_index(K: int) -> int:
    """Index of the smallest valid codeblock size >= K (36.212 5.1.2)."""
    i = bisect.bisect_left(TC_CB_SIZES, K)
    if i >= len(TC_CB_SIZES):
        raise ValueError(f"codeblock length {K} too large")
    return i


@dataclass(frozen=True)
class CbSegm:
    tbs: int        # transport block size excl. TB CRC
    Z: int          # max codeblock size (2048 or 6144)
    C: int          # number of codeblocks
    C1: int         # codeblocks of size K1
    K1: int
    K1_idx: int
    C2: int         # codeblocks of size K2 (K2 < K1), processed FIRST (reference order)
    K2: int
    K2_idx: int
    F: int          # filler bits (configs with F>0 are rejected upstream)

    @property
    def cb_sizes(self) -> tuple[int, ...]:
        """Codeblock sizes in processing order: C2 blocks of K2 first, then C1 of K1.

        Matches the reference's modified srsRAN loop
        (lib/src/phy/fec/pdc_enc.cpp:164-169: cb_idx < C2 ? K2 : K1).
        """
        return (self.K2,) * self.C2 + (self.K1,) * self.C1


@lru_cache(maxsize=None)
def cbsegm(tbs: int, Z: int) -> CbSegm:
    if Z not in (2048, 6144):
        raise ValueError("Z must be 2048 or 6144")
    if tbs == 0:
        return CbSegm(0, Z, 0, 0, 0, 0, 0, 0, 0, 0)

    B = tbs + L_CRC
    if B <= Z:
        C, Bp = 1, B
    else:
        C = -(-B // (Z - L_CRC))  # ceil
        Bp = B + L_CRC * C

    idx1 = cbsize_index(-(-Bp // C))  # first K >= ceil(Bp/C)
    K1 = TC_CB_SIZES[idx1]
    if C == 1:
        K2, K2_idx, C2, C1 = 0, 0, 0, 1
    else:
        K2_idx = idx1 - 1
        K2 = TC_CB_SIZES[K2_idx] if idx1 > 0 else 0
        C2 = (C * K1 - Bp) // (K1 - K2) if K1 != K2 else 0
        C1 = C - C2
    F = C1 * K1 + C2 * K2 - Bp
    return CbSegm(tbs=tbs, Z=Z, C=C, C1=C1, K1=K1, K1_idx=idx1,
                  C2=C2, K2=K2, K2_idx=(idx1 - 1 if C > 1 else 0), F=F)
