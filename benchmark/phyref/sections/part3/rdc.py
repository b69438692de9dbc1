"""Radio device classes "u.b.N_TX.Z" per ETSI TS 103 636-3 Annex C.

Behavioral parity with reference lib/src/sections_part3/radio_device_class.cpp:27-152
(fixed registry of named classes; the *_min fields follow the standard's
"minimum radio device capability" naming -- they are the device's ceiling).

Copy of `dectnrp_tpu/sections/part3/rdc.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RadioDeviceClass:
    name: str
    u_min: int
    b_min: int
    N_TX_min: int
    mcs_index_min: int
    M_DL_HARQ_min: int
    M_connection_DL_HARQ_min: int
    N_soft_min: int
    Z_min: int
    PacketLength_min: int


def _rdc(name, u, b, n_tx, mcs, n_soft, z, plen) -> RadioDeviceClass:
    return RadioDeviceClass(
        name=name, u_min=u, b_min=b, N_TX_min=n_tx, mcs_index_min=mcs,
        M_DL_HARQ_min=8, M_connection_DL_HARQ_min=2, N_soft_min=n_soft,
        Z_min=z, PacketLength_min=plen)


_REGISTRY = {
    "1.1.1.A": _rdc("1.1.1.A", 1, 1, 1, 7, 25344, 2048, 4),
    "1.1.1.B": _rdc("1.1.1.B", 1, 1, 1, 7, 25344, 6144, 4),
    "8.1.1.A": _rdc("8.1.1.A", 8, 1, 1, 7, 25344, 6144, 4),
    "1.8.1.A": _rdc("1.8.1.A", 1, 8, 1, 7, 25344, 6144, 4),
    "2.8.2.A": _rdc("2.8.2.A", 2, 8, 2, 7, 25344, 6144, 4),
    "2.12.4.A": _rdc("2.12.4.A", 2, 12, 4, 7, 25344, 2048, 4),
    "2.12.4.B": _rdc("2.12.4.B", 2, 12, 4, 7, 25344, 6144, 4),
    "8.12.8.A": _rdc("8.12.8.A", 8, 12, 8, 9, 225344, 6144, 16),
    "8.16.8.A": _rdc("8.16.8.A", 8, 16, 8, 9, 225344, 6144, 16),
}


def get_radio_device_class(s: str) -> RadioDeviceClass:
    try:
        return _REGISTRY[s]
    except KeyError:
        raise ValueError(f"unknown radio device class {s!r}") from None
