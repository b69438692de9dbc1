"""ETSI TS 103 636-4 (DECT NR+ MAC) codecs the port needs so far: the
identities, the PLCF feedback formats and the PLCF codecs.

Copies of `dectnrp_tpu/sections/part4/{identity,feedback_info,plcf}.py`
(held equal by `tests/test_torch_tables.py`). The JAX package's part 4 also
exports the MAC PDU codecs (`mac_pdu`, `mac_pdu_decoder` and the IEs they
pull in); the port copies those when the MAC layer is ported.
"""
from .identity import Identity
from .plcf import Plcf10, Plcf20, Plcf21, decode_plcf

__all__ = ["Identity", "Plcf10", "Plcf20", "Plcf21", "decode_plcf"]
