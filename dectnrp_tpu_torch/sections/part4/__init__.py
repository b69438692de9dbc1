"""Part 4: MAC layer codecs (PLCF, feedback, MAC PDU, MMIEs).

ETSI TS 103 636-4. Structure mirrors reference lib/src/sections_part4/.

Copy of `dectnrp_tpu/sections/part4/__init__.py`: the port imports nothing
of the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from .identity import Identity
from .plcf import Plcf10, Plcf20, Plcf21, decode_plcf
from .mac_pdu import (MacHeaderType, MacHeaderKind, DataMacPduHeader,
                      BeaconHeader, UnicastHeader, RdBroadcastingHeader,
                      MuxHeader, MacExt, IeType)
from .mac_pdu_decoder import MacPduDecoder, decode_mac_pdu, build_mac_pdu

__all__ = [
    "Identity", "Plcf10", "Plcf20", "Plcf21", "decode_plcf",
    "MacHeaderType", "MacHeaderKind", "DataMacPduHeader", "BeaconHeader",
    "UnicastHeader", "RdBroadcastingHeader", "MuxHeader", "MacExt", "IeType",
    "MacPduDecoder", "decode_mac_pdu", "build_mac_pdu",
]
