"""PLCF (physical layer control field) codecs, ETSI TS 103 636-4 6.2.

Type 1 (40 bits, PLCF10) and type 2 (80 bits, PLCF20 header-format 0 with
HARQ fields / PLCF21 header-format 1 without). Parity: reference
lib/src/sections_part4/physical_header_field/plcf_{base,10,20,21}.cpp and
plcf_decoder.cpp (blind-decode candidate handling).

Copy of `dectnrp_tpu/sections/part4/plcf.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .feedback_info import FeedbackInfo, pack_feedback, unpack_feedback
from .identity import is_valid_short_network_id, is_valid_short_rdid

TX_POWER_TABLE = (-40, -30, -20, -16, -12, -8, -4, 0, 4, 7, 10, 13, 16, 19, 21, 23)
N_SS_CODED = {1: 0, 2: 1, 4: 2, 8: 3}
N_SS_DECODED = (1, 2, 4, 8)


def tx_power_to_code(power_dbm: int) -> int:
    """Smallest table entry >= power_dbm (reference set_TransmitPower)."""
    for i, p in enumerate(TX_POWER_TABLE):
        if p >= power_dbm:
            return i
    return len(TX_POWER_TABLE) - 1


@dataclass
class PlcfBase:
    header_format: int = 0
    packet_length_type: int = 0
    packet_length: int = 1          # 1..16 (packed as PacketLength_m1)

    def _base_valid(self) -> bool:
        return (0 <= self.header_format <= 1
                and 0 <= self.packet_length_type <= 1
                and 1 <= self.packet_length <= 16)

    def _pack_base(self, buf: bytearray) -> None:
        buf[0] = (self.header_format << 5) | (self.packet_length_type << 4) \
            | (self.packet_length - 1)

    def _unpack_base(self, buf) -> bool:
        self.header_format = buf[0] >> 5
        self.packet_length_type = (buf[0] >> 4) & 0b1
        self.packet_length = (buf[0] & 0b1111) + 1
        return self.header_format <= 1


@dataclass
class Plcf10(PlcfBase):
    """PLCF type 1 (40 bits): byte0 base, byte1 ShortNetworkID, bytes2-3
    TransmitterIdentity, byte4 = TxPower(4) | Reserved(1) | DFMCS(3)."""
    short_network_id: int = 0
    transmitter_identity: int = 0
    transmit_power: int = 0
    reserved: int = 0
    df_mcs: int = 0

    TYPE = 1
    SIZE_BYTES = 5

    def is_valid(self) -> bool:
        return (self.header_format == 0 and self._base_valid()
                and is_valid_short_network_id(self.short_network_id)
                and is_valid_short_rdid(self.transmitter_identity)
                and 0 <= self.transmit_power <= 15
                and self.reserved == 0
                and 0 <= self.df_mcs <= 7)

    def pack(self) -> bytes:
        assert self.is_valid(), "invalid plcf_10"
        buf = bytearray(self.SIZE_BYTES)
        self._pack_base(buf)
        buf[1] = self.short_network_id
        buf[2] = (self.transmitter_identity >> 8) & 0xFF
        buf[3] = self.transmitter_identity & 0xFF
        buf[4] = (self.transmit_power << 4) | (self.reserved << 3) | self.df_mcs
        return bytes(buf)

    def unpack(self, buf) -> bool:
        if not self._unpack_base(buf):
            return False
        self.short_network_id = buf[1]
        self.transmitter_identity = (buf[2] << 8) | buf[3]
        self.transmit_power = (buf[4] >> 4) & 0b1111
        self.reserved = (buf[4] >> 3) & 0b1
        self.df_mcs = buf[4] & 0b111
        return self.is_valid()


@dataclass
class Plcf20(PlcfBase):
    """PLCF type 2, header format 0 (80 bits, with HARQ fields)."""
    short_network_id: int = 0
    transmitter_identity: int = 0
    transmit_power: int = 0
    df_mcs: int = 0
    receiver_identity: int = 0
    n_ss_coded: int = 0             # coded: 0/1/2/3 -> 1/2/4/8 streams
    df_redundancy_version: int = 0
    df_new_data_indication: int = 0
    df_harq_process_number: int = 0
    feedback_format: int = 0
    feedback: FeedbackInfo | None = None

    TYPE = 2
    SIZE_BYTES = 10

    def is_valid(self) -> bool:
        return (self.header_format == 0 and self._base_valid()
                and is_valid_short_network_id(self.short_network_id)
                and is_valid_short_rdid(self.transmitter_identity)
                and 0 <= self.transmit_power <= 15
                and 0 <= self.df_mcs <= 11
                and is_valid_short_rdid(self.receiver_identity)
                and 0 <= self.n_ss_coded <= 3
                and 0 <= self.df_redundancy_version <= 3
                and 0 <= self.df_new_data_indication <= 1
                and 0 <= self.df_harq_process_number <= 7
                and 0 <= self.feedback_format <= 15)

    @property
    def n_ss(self) -> int:
        return N_SS_DECODED[self.n_ss_coded]

    def set_n_ss(self, n_ss: int) -> None:
        self.n_ss_coded = N_SS_CODED[n_ss]

    def pack(self) -> bytes:
        assert self.is_valid(), "invalid plcf_20"
        buf = bytearray(self.SIZE_BYTES)
        self._pack_base(buf)
        buf[1] = self.short_network_id
        buf[2] = (self.transmitter_identity >> 8) & 0xFF
        buf[3] = self.transmitter_identity & 0xFF
        buf[4] = (self.transmit_power << 4) | self.df_mcs
        buf[5] = (self.receiver_identity >> 8) & 0xFF
        buf[6] = self.receiver_identity & 0xFF
        buf[7] = (self.n_ss_coded << 6) | (self.df_redundancy_version << 4) \
            | (self.df_new_data_indication << 3) | self.df_harq_process_number
        buf[8] = self.feedback_format << 4
        pack_feedback(self.feedback_format, self.feedback, buf, 8)
        return bytes(buf)

    def unpack(self, buf) -> bool:
        if not self._unpack_base(buf):
            return False
        self.short_network_id = buf[1]
        self.transmitter_identity = (buf[2] << 8) | buf[3]
        self.transmit_power = (buf[4] >> 4) & 0b1111
        self.df_mcs = buf[4] & 0b1111
        self.receiver_identity = (buf[5] << 8) | buf[6]
        self.n_ss_coded = (buf[7] >> 6) & 0b11
        self.df_redundancy_version = (buf[7] >> 4) & 0b11
        self.df_new_data_indication = (buf[7] >> 3) & 0b1
        self.df_harq_process_number = buf[7] & 0b111
        self.feedback_format = (buf[8] >> 4) & 0b1111
        self.feedback, ok = unpack_feedback(self.feedback_format, buf, 8)
        return ok and self.is_valid()


@dataclass
class Plcf21(PlcfBase):
    """PLCF type 2, header format 1 (80 bits, no HARQ fields)."""
    header_format: int = 1
    short_network_id: int = 0
    transmitter_identity: int = 0
    transmit_power: int = 0
    df_mcs: int = 0
    receiver_identity: int = 0
    n_ss_coded: int = 0
    reserved: int = 0
    feedback_format: int = 0
    feedback: FeedbackInfo | None = None

    TYPE = 2
    SIZE_BYTES = 10

    def is_valid(self) -> bool:
        return (self.header_format == 1 and self._base_valid()
                and is_valid_short_network_id(self.short_network_id)
                and is_valid_short_rdid(self.transmitter_identity)
                and 0 <= self.transmit_power <= 15
                and 0 <= self.df_mcs <= 11
                and is_valid_short_rdid(self.receiver_identity)
                and 0 <= self.n_ss_coded <= 3
                and self.reserved == 0
                and 0 <= self.feedback_format <= 15)

    @property
    def n_ss(self) -> int:
        return N_SS_DECODED[self.n_ss_coded]

    @property
    def df_redundancy_version(self) -> int:
        return 0

    def pack(self) -> bytes:
        assert self.is_valid(), "invalid plcf_21"
        buf = bytearray(self.SIZE_BYTES)
        self._pack_base(buf)
        buf[1] = self.short_network_id
        buf[2] = (self.transmitter_identity >> 8) & 0xFF
        buf[3] = self.transmitter_identity & 0xFF
        buf[4] = (self.transmit_power << 4) | self.df_mcs
        buf[5] = (self.receiver_identity >> 8) & 0xFF
        buf[6] = self.receiver_identity & 0xFF
        buf[7] = (self.n_ss_coded << 6) | self.reserved
        buf[8] = self.feedback_format << 4
        pack_feedback(self.feedback_format, self.feedback, buf, 8)
        return bytes(buf)

    def unpack(self, buf) -> bool:
        if not self._unpack_base(buf):
            return False
        self.short_network_id = buf[1]
        self.transmitter_identity = (buf[2] << 8) | buf[3]
        self.transmit_power = (buf[4] >> 4) & 0b1111
        self.df_mcs = buf[4] & 0b1111
        self.receiver_identity = (buf[5] << 8) | buf[6]
        self.n_ss_coded = (buf[7] >> 6) & 0b11
        self.reserved = buf[7] & 0b111111
        self.feedback_format = (buf[8] >> 4) & 0b1111
        self.feedback, ok = unpack_feedback(self.feedback_format, buf, 8)
        return ok and self.is_valid()


def bits_to_bytes(bits: np.ndarray) -> bytes:
    """MSB-first bit vector -> bytes (the FEC chain works on bit vectors)."""
    return np.packbits(np.asarray(bits, np.uint8)).tobytes()


def bytes_to_bits(data: bytes, n_bits: int) -> np.ndarray:
    return np.unpackbits(np.frombuffer(data, np.uint8))[:n_bits]


def decode_plcf(plcf_type: int, bits: np.ndarray):
    """Blind-decode helper (reference plcf_decoder_t): try the candidate
    classes of a CRC-passing PLCF of given type; returns instance or None."""
    data = bits_to_bytes(bits)
    if plcf_type == 1:
        c = Plcf10()
        return c if c.unpack(data) else None
    hf = data[0] >> 5
    c = Plcf20() if hf == 0 else Plcf21()
    return c if c.unpack(data) else None
