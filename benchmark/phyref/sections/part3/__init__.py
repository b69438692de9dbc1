"""ETSI TS 103 636-3 (DECT NR+ PHY) numerology, signals and derivations.

Copy of `dectnrp_tpu/sections/part3/__init__.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from . import (  # noqa: F401
    beamforming,
    cbsegm,
    constants,
    drs,
    mcs,
    numerologies,
    packet_sizes,
    pcc,
    pdc,
    phyres,
    rdc,
    scrambling,
    stf,
    tbs,
    tm_mode,
    transmission_packet_structure,
    tx_div,
)
from .packet_sizes import PacketSizes, PacketSizesDef, get_packet_sizes  # noqa: F401
