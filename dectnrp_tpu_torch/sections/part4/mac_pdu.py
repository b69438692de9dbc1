"""MAC PDU headers: header type, common headers, multiplexing header.

ETSI TS 103 636-4 6.3. Parity: reference
lib/src/sections_part4/mac_pdu/{mac_header_type,mac_common_header,
mac_multiplexing_header}.cpp.

Copy of `dectnrp_tpu/sections/part4/mac_pdu.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

from .identity import is_valid_long_rdid


class MacSecurity(IntEnum):
    NOT_USED = 0b00
    USED_NO_IE = 0b01
    USED_WITH_IE = 0b10
    RESERVED = 0b11


class MacHeaderKind(IntEnum):
    DATA_MAC_PDU = 0b0000
    BEACON = 0b0001
    UNICAST = 0b0010
    RD_BROADCASTING = 0b0011
    MCH_EMPTY = 0b0100
    ESCAPE = 0b1111


@dataclass
class MacHeaderType:
    """1 byte: Version(2) | MAC security(2) | MAC header type(4)."""
    version: int = 0
    mac_security: MacSecurity = MacSecurity.NOT_USED
    mac_header_type: MacHeaderKind = MacHeaderKind.DATA_MAC_PDU

    SIZE = 1

    def is_valid(self) -> bool:
        return self.version == 0

    def pack_into(self, buf: bytearray, off: int = 0) -> int:
        assert self.is_valid()
        buf[off] = (self.version << 6) | (int(self.mac_security) << 4) \
            | int(self.mac_header_type)
        return off + 1

    def unpack_from(self, buf, off: int = 0) -> bool:
        self.version = (buf[off] >> 6) & 0b11
        self.mac_security = MacSecurity((buf[off] >> 4) & 0b11)
        try:
            self.mac_header_type = MacHeaderKind(buf[off] & 0b1111)
        except ValueError:
            return False
        return self.is_valid()


@dataclass
class DataMacPduHeader:
    """2 bytes: Reserved(3) | Reset(1) | SN(12)."""
    reset: int = 0
    sequence_number: int = 0

    SIZE = 2
    KIND = MacHeaderKind.DATA_MAC_PDU

    def is_valid(self) -> bool:
        return 0 <= self.reset <= 1 and 0 <= self.sequence_number <= 0xFFF

    def pack_into(self, buf, off):
        assert self.is_valid()
        buf[off] = (self.reset << 4) | (self.sequence_number >> 8)
        buf[off + 1] = self.sequence_number & 0xFF
        return off + 2

    def unpack_from(self, buf, off) -> bool:
        if (buf[off] >> 5) & 0b111:
            return False
        self.reset = (buf[off] >> 4) & 0b1
        self.sequence_number = ((buf[off] & 0b1111) << 8) | buf[off + 1]
        return self.is_valid()


@dataclass
class BeaconHeader:
    """7 bytes: NetworkID 24 LSB (big-endian 3) + TransmitterAddress (4)."""
    network_id_3_lsb: int = 0
    transmitter_address: int = 0

    SIZE = 7
    KIND = MacHeaderKind.BEACON

    def set_network_id(self, network_id: int) -> None:
        self.network_id_3_lsb = network_id & 0xFFFFFF

    def is_valid(self) -> bool:
        return (0 <= self.network_id_3_lsb <= 0xFFFFFF
                and is_valid_long_rdid(self.transmitter_address))

    def pack_into(self, buf, off):
        assert self.is_valid()
        buf[off:off + 3] = self.network_id_3_lsb.to_bytes(3, "big")
        buf[off + 3:off + 7] = self.transmitter_address.to_bytes(4, "big")
        return off + 7

    def unpack_from(self, buf, off) -> bool:
        self.network_id_3_lsb = int.from_bytes(bytes(buf[off:off + 3]), "big")
        self.transmitter_address = int.from_bytes(bytes(buf[off + 3:off + 7]), "big")
        return self.is_valid()


@dataclass
class UnicastHeader:
    """10 bytes: Reserved(3)|Reset(1)|SN(12) + RxAddr(4) + TxAddr(4)."""
    reset: int = 0
    sequence_number: int = 0
    receiver_address: int = 0
    transmitter_address: int = 0

    SIZE = 10
    KIND = MacHeaderKind.UNICAST

    def is_valid(self) -> bool:
        return (0 <= self.reset <= 1 and 0 <= self.sequence_number <= 0xFFF
                and is_valid_long_rdid(self.receiver_address)
                and is_valid_long_rdid(self.transmitter_address))

    def pack_into(self, buf, off):
        assert self.is_valid()
        buf[off] = (self.reset << 4) | (self.sequence_number >> 8)
        buf[off + 1] = self.sequence_number & 0xFF
        buf[off + 2:off + 6] = self.receiver_address.to_bytes(4, "big")
        buf[off + 6:off + 10] = self.transmitter_address.to_bytes(4, "big")
        return off + 10

    def unpack_from(self, buf, off) -> bool:
        if (buf[off] >> 5) & 0b111:
            return False
        self.reset = (buf[off] >> 4) & 0b1
        self.sequence_number = ((buf[off] & 0b1111) << 8) | buf[off + 1]
        self.receiver_address = int.from_bytes(bytes(buf[off + 2:off + 6]), "big")
        self.transmitter_address = int.from_bytes(bytes(buf[off + 6:off + 10]), "big")
        return self.is_valid()


@dataclass
class RdBroadcastingHeader:
    """6 bytes: Reserved(3)|Reset(1)|SN(12) + TxAddr(4)."""
    reset: int = 0
    sequence_number: int = 0
    transmitter_address: int = 0

    SIZE = 6
    KIND = MacHeaderKind.RD_BROADCASTING

    def is_valid(self) -> bool:
        return (0 <= self.reset <= 1 and 0 <= self.sequence_number <= 0xFFF
                and is_valid_long_rdid(self.transmitter_address))

    def pack_into(self, buf, off):
        assert self.is_valid()
        buf[off] = (self.reset << 4) | (self.sequence_number >> 8)
        buf[off + 1] = self.sequence_number & 0xFF
        buf[off + 2:off + 6] = self.transmitter_address.to_bytes(4, "big")
        return off + 6

    def unpack_from(self, buf, off) -> bool:
        if (buf[off] >> 5) & 0b111:
            return False
        self.reset = (buf[off] >> 4) & 0b1
        self.sequence_number = ((buf[off] & 0b1111) << 8) | buf[off + 1]
        self.transmitter_address = int.from_bytes(bytes(buf[off + 2:off + 6]), "big")
        return self.is_valid()


@dataclass
class EmptyHeader:
    SIZE = 0
    KIND = MacHeaderKind.MCH_EMPTY

    def is_valid(self) -> bool:
        return True

    def pack_into(self, buf, off):
        return off

    def unpack_from(self, buf, off) -> bool:
        return True


COMMON_HEADER_CLS = {
    MacHeaderKind.DATA_MAC_PDU: DataMacPduHeader,
    MacHeaderKind.BEACON: BeaconHeader,
    MacHeaderKind.UNICAST: UnicastHeader,
    MacHeaderKind.RD_BROADCASTING: RdBroadcastingHeader,
    MacHeaderKind.MCH_EMPTY: EmptyHeader,
}


class MacExt(IntEnum):
    NO_LENGTH_FIELD = 0b00
    LENGTH_8BIT = 0b01
    LENGTH_16BIT = 0b10
    LENGTH_1BIT = 0b11


class IeType(IntEnum):
    """IE type for mac_ext 00/01/10 (Table 6.3.4-2; + project extensions)."""
    PADDING_IE = 0b0
    HIGHER_LAYER_SIGNALLING_FLOW_1 = 0b1
    HIGHER_LAYER_SIGNALLING_FLOW_2 = 0b10
    USER_PLANE_DATA_FLOW_1 = 0b11
    USER_PLANE_DATA_FLOW_2 = 0b100
    USER_PLANE_DATA_FLOW_3 = 0b101
    USER_PLANE_DATA_FLOW_4 = 0b110
    NETWORK_BEACON_MESSAGE = 0b1000
    CLUSTER_BEACON_MESSAGE = 0b1001
    ASSOCIATION_REQUEST_MESSAGE = 0b1010
    ASSOCIATION_RESPONSE_MESSAGE = 0b1011
    ASSOCIATION_RELEASE_MESSAGE = 0b1100
    RECONFIGURATION_REQUEST_MESSAGE = 0b1101
    RECONFIGURATION_RESPONSE_MESSAGE = 0b1110
    ADDITIONAL_MAC_MESSAGES = 0b1111
    SECURITY_INFO_IE = 0b10000
    ROUTE_INFO_IE = 0b10001
    RESOURCE_ALLOCATION_IE = 0b10010
    RANDOM_ACCESS_RESOURCE_IE = 0b10011
    RD_CAPABILITY_IE = 0b10100
    NEIGHBOURING_IE = 0b10101
    BROADCAST_INDICATION_IE = 0b10110
    GROUP_ASSIGNMENT_IE = 0b10111
    LOAD_INFO_IE = 0b11000
    MEASUREMENT_REPORT_IE = 0b11001
    # project extensions (reference mac_multiplexing_header.hpp:80-81)
    POWER_TARGET_IE = 0b11101
    TIME_ANNOUNCE_IE = 0b11110
    ESCAPE = 0b111110
    IE_TYPE_EXTENSION = 0b111111


class IeTypeShortLen0(IntEnum):
    """IE type for mac_ext 11, payload 0 bytes (Table 6.3.4-3)."""
    PADDING_IE = 0b0
    CONFIGURATION_REQUEST_IE = 0b1
    MAC_SECURITY_INFO_IE = 0b10000
    ESCAPE = 0b11110


class IeTypeShortLen1(IntEnum):
    """IE type for mac_ext 11, payload 1 byte (Table 6.3.4-4)."""
    PADDING_IE = 0b0
    RADIO_DEVICE_STATUS_IE = 0b1
    ESCAPE = 0b11110


@dataclass
class MuxHeader:
    """MAC multiplexing header, Figure 6.3.4-1 options a)-f).

    mac_ext 11: 1-byte header, length in {0,1} encoded in bit 5.
    mac_ext 00: 1-byte header, no length (IE length implied by type/PDU end).
    mac_ext 01/10: 2/3-byte header with 8/16-bit length field.
    """
    mac_ext: MacExt = MacExt.NO_LENGTH_FIELD
    ie_type: int = 0
    length: int | None = None       # payload length when carried in header

    def packed_size(self) -> int:
        if self.mac_ext == MacExt.LENGTH_8BIT:
            return 2
        if self.mac_ext == MacExt.LENGTH_16BIT:
            return 3
        return 1

    def is_valid(self) -> bool:
        if self.mac_ext == MacExt.LENGTH_1BIT:
            if self.length == 0:
                return self.ie_type in IeTypeShortLen0._value2member_map_
            if self.length == 1:
                return self.ie_type in IeTypeShortLen1._value2member_map_
            return False
        if self.mac_ext == MacExt.LENGTH_8BIT and not (
                self.length is not None and self.length <= 0xFF):
            return False
        if self.mac_ext == MacExt.LENGTH_16BIT and not (
                self.length is not None and self.length <= 0xFFFF):
            return False
        return self.ie_type in IeType._value2member_map_

    def pack_into(self, buf, off) -> int:
        assert self.is_valid(), "invalid mux header"
        buf[off] = int(self.mac_ext) << 6
        if self.mac_ext == MacExt.LENGTH_1BIT:
            buf[off] |= (self.length << 5) | self.ie_type
            return off + 1
        buf[off] |= self.ie_type
        if self.mac_ext == MacExt.LENGTH_8BIT:
            buf[off + 1] = self.length & 0xFF
            return off + 2
        if self.mac_ext == MacExt.LENGTH_16BIT:
            buf[off + 1] = (self.length >> 8) & 0xFF
            buf[off + 2] = self.length & 0xFF
            return off + 3
        return off + 1

    def unpack_from(self, buf, off) -> bool:
        """Needs packed_size() bytes; peek 1 byte first to learn the size."""
        self.mac_ext = MacExt((buf[off] >> 6) & 0b11)
        if self.mac_ext == MacExt.LENGTH_1BIT:
            self.length = (buf[off] >> 5) & 0b1
            self.ie_type = buf[off] & 0b11111
            return self.is_valid()
        self.ie_type = buf[off] & 0b111111
        if self.mac_ext == MacExt.LENGTH_8BIT:
            self.length = buf[off + 1]
        elif self.mac_ext == MacExt.LENGTH_16BIT:
            self.length = (buf[off + 1] << 8) | buf[off + 2]
        else:
            self.length = None
        return self.is_valid()
