"""MAC architecture identities, ETSI TS 103 636-4 4.2.3.

Parity: reference lib/src/sections_part4/mac_architecture/identity.cpp.

Copy of `dectnrp_tpu/sections/part4/identity.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass, field

NETWORK_ID_RESERVED = 0
LONG_RDID_RESERVED = 0
LONG_RDID_BACKEND = 0xFFFFFFFE
LONG_RDID_BROADCAST = 0xFFFFFFFF
SHORT_RDID_RESERVED = 0
SHORT_RDID_BROADCAST = 0xFFFF


def full_to_short_network_id(network_id: int) -> int:
    return network_id & 0xFF


def is_valid_network_id(v: int) -> bool:
    return v != NETWORK_ID_RESERVED and 0 <= v <= 0xFFFFFFFF


def is_valid_short_network_id(v: int) -> bool:
    return v != NETWORK_ID_RESERVED and 0 <= v <= 0xFF


def is_valid_long_rdid(v: int) -> bool:
    return v != LONG_RDID_RESERVED and 0 <= v <= 0xFFFFFFFF


def is_valid_short_rdid(v: int) -> bool:
    return v != SHORT_RDID_RESERVED and 0 <= v <= 0xFFFF


@dataclass(frozen=True)
class Identity:
    network_id: int
    long_rdid: int
    short_rdid: int
    short_network_id: int = field(init=False)

    def __post_init__(self):
        if not is_valid_network_id(self.network_id):
            raise ValueError("invalid NetworkID")
        if self.long_rdid in (LONG_RDID_RESERVED, LONG_RDID_BACKEND,
                              LONG_RDID_BROADCAST):
            raise ValueError("invalid LongRadioDeviceID")
        if self.short_rdid in (SHORT_RDID_RESERVED, SHORT_RDID_BROADCAST):
            raise ValueError("invalid ShortRadioDeviceID")
        object.__setattr__(self, "short_network_id",
                           full_to_short_network_id(self.network_id))
