"""MMIE (MAC messages and information elements) base classes + registry.

ETSI TS 103 636-4 6.4. Parity: reference
lib/src/sections_part4/mac_messages_and_ie/mmie.cpp: packing MMIEs are
self-describing (peek the packed size from the first bytes), flowing MMIEs
(user-plane data, higher-layer signalling) carry their length in the MAC
multiplexing header.

Copy of `dectnrp_tpu/sections/part4/mmie.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .mac_pdu import IeType, IeTypeShortLen0, IeTypeShortLen1, MacExt, MuxHeader


class Mmie:
    """Base for packing MMIEs: fixed IE type, No_Length_Field mux header,
    size recoverable by peeking the packed bytes."""

    IE_TYPE: IeType

    def mux_header(self) -> MuxHeader:
        return MuxHeader(MacExt.NO_LENGTH_FIELD, int(self.IE_TYPE))

    # --- subclass API ------------------------------------------------------
    def is_valid(self) -> bool:
        raise NotImplementedError

    def packed_size(self) -> int:
        raise NotImplementedError

    def pack_into(self, buf: bytearray, off: int) -> int:
        raise NotImplementedError

    def unpack_from(self, buf, off: int) -> bool:
        raise NotImplementedError

    def peek_packed_size(self, buf, off: int) -> int | None:
        """Packed size from the leading bytes (None = malformed)."""
        return self.packed_size()

    PEEK_MIN = 1

    # --- framing helpers ---------------------------------------------------
    def packed_size_mmh_sdu(self) -> int:
        return self.mux_header().packed_size() + self.packed_size()

    def pack_mmh_sdu_into(self, buf: bytearray, off: int) -> int:
        off = self.mux_header().pack_into(buf, off)
        return self.pack_into(buf, off)


class MmieFlowing:
    """Base for flowing MMIEs: opaque payload, length in the mux header."""

    IE_TYPE_BY_FLOW: dict[int, IeType]

    def __init__(self, flow_id: int = 1, data: bytes = b""):
        self.flow_id = flow_id
        self.data = data

    def mux_header(self) -> MuxHeader:
        n = len(self.data)
        ext = MacExt.LENGTH_8BIT if n <= 0xFF else MacExt.LENGTH_16BIT
        return MuxHeader(ext, int(self.IE_TYPE_BY_FLOW[self.flow_id]), n)

    def packed_size(self) -> int:
        return len(self.data)

    def packed_size_mmh_sdu(self) -> int:
        return self.mux_header().packed_size() + len(self.data)

    def pack_mmh_sdu_into(self, buf: bytearray, off: int) -> int:
        off = self.mux_header().pack_into(buf, off)
        buf[off:off + len(self.data)] = self.data
        return off + len(self.data)


# coded TX power for beacons, Table 6.2.1-3b (coded value = index + 3)
CLUSTERS_MAX_TX_POWER_DBM = (-13, -6, -3, 0, 3, 6, 10, 14, 19, 23, 26, 29, 32)


def clusters_max_tx_power_from_dbm(dbm: int) -> int:
    for i, p in enumerate(CLUSTERS_MAX_TX_POWER_DBM):
        if p >= dbm:
            return i + 3
    return len(CLUSTERS_MAX_TX_POWER_DBM) - 1 + 3


def clusters_max_tx_power_to_dbm(coded: int) -> int:
    return CLUSTERS_MAX_TX_POWER_DBM[coded - 3]


NETWORK_BEACON_PERIOD_MS = (50, 100, 500, 1000, 1500, 2000, 4000)
CLUSTER_BEACON_PERIOD_MS = (10, 50, 100, 500, 1000, 1500, 2000, 4000,
                            8000, 16000, 32000)
COUNT_TO_TRIGGER = (1, 2, 3, 4, 5, 6, 7, 8, 16, 24, 32, 40, 48, 56, 64, 128)
QUALITY_THRESHOLD_DB = (0, 3, 6, 9)


def _u16be(buf, off) -> int:
    return (buf[off] << 8) | buf[off + 1]


def _chan13(buf, off) -> int:
    """13-bit absolute channel number from 2 bytes (upper 3 bits dropped)."""
    return ((buf[off] & 0x1F) << 8) | buf[off + 1]


@dataclass
class NetworkBeaconMessage(Mmie):
    """6.4.2.2. Required: periods, next cluster channel, time-to-next;
    optional: clusters max TX power, current cluster channel, up to 3
    additional network beacon channels."""
    network_beacon_period_coded: int = 0
    cluster_beacon_period_coded: int = 0
    next_cluster_channel: int = 0
    time_to_next: int = 0
    has_power_constraints: bool = False
    clusters_max_tx_power_coded: int | None = None
    current_cluster_channel: int | None = None
    network_beacon_channels: tuple[int, ...] = ()

    IE_TYPE = IeType.NETWORK_BEACON_MESSAGE

    def is_valid(self) -> bool:
        from ..part2 import is_absolute_channel_number_in_range as ok_ch
        if self.clusters_max_tx_power_coded is not None and not (
                3 <= self.clusters_max_tx_power_coded <= 15):
            return False
        if self.current_cluster_channel is not None and not ok_ch(self.current_cluster_channel):
            return False
        if len(self.network_beacon_channels) > 3 or any(
                not ok_ch(c) for c in self.network_beacon_channels):
            return False
        return (self.network_beacon_period_coded < len(NETWORK_BEACON_PERIOD_MS)
                and self.cluster_beacon_period_coded < len(CLUSTER_BEACON_PERIOD_MS)
                and ok_ch(self.next_cluster_channel)
                and 0 <= self.time_to_next <= 0xFFFFFFFF)

    def packed_size(self) -> int:
        return (8 + (self.clusters_max_tx_power_coded is not None)
                + (self.current_cluster_channel is not None) * 2
                + len(self.network_beacon_channels) * 2)

    def pack_into(self, buf, off):
        assert self.is_valid(), "network beacon message is not valid"
        buf[off] = ((self.clusters_max_tx_power_coded is not None) << 4) \
            | (self.has_power_constraints << 3) \
            | ((self.current_cluster_channel is not None) << 2) \
            | len(self.network_beacon_channels)
        buf[off + 1] = (self.network_beacon_period_coded << 4) \
            | self.cluster_beacon_period_coded
        buf[off + 2] = self.next_cluster_channel >> 8
        buf[off + 3] = self.next_cluster_channel & 0xFF
        buf[off + 4:off + 8] = self.time_to_next.to_bytes(4, "big")
        o = off + 8
        if self.clusters_max_tx_power_coded is not None:
            buf[o] = self.clusters_max_tx_power_coded
            o += 1
        if self.current_cluster_channel is not None:
            buf[o] = self.current_cluster_channel >> 8
            buf[o + 1] = self.current_cluster_channel & 0xFF
            o += 2
        for c in self.network_beacon_channels:
            buf[o] = c >> 8
            buf[o + 1] = c & 0xFF
            o += 2
        return o

    def unpack_from(self, buf, off) -> bool:
        has_power = (buf[off] >> 4) & 1
        self.has_power_constraints = bool((buf[off] >> 3) & 1)
        has_current = (buf[off] >> 2) & 1
        n_ch = buf[off] & 0b11
        self.network_beacon_period_coded = buf[off + 1] >> 4
        self.cluster_beacon_period_coded = buf[off + 1] & 0b1111
        self.next_cluster_channel = _chan13(buf, off + 2)
        self.time_to_next = int.from_bytes(bytes(buf[off + 4:off + 8]), "big")
        o = off + 8
        self.clusters_max_tx_power_coded = None
        self.current_cluster_channel = None
        if has_power:
            self.clusters_max_tx_power_coded = buf[o] & 0b1111
            o += 1
        if has_current:
            self.current_cluster_channel = _chan13(buf, o)
            o += 2
        chans = []
        for _ in range(n_ch):
            chans.append(_chan13(buf, o))
            o += 2
        self.network_beacon_channels = tuple(chans)
        return self.is_valid()

    def peek_packed_size(self, buf, off):
        return (8 + ((buf[off] >> 4) & 1) + ((buf[off] >> 2) & 1) * 2
                + (buf[off] & 0b11) * 2)


@dataclass
class ClusterBeaconMessage(Mmie):
    """6.4.2.3. mu-dependent frame offset width (1 byte mu<=4, else 2)."""
    system_frame_number: int = 0
    network_beacon_period_coded: int = 0
    cluster_beacon_period_coded: int = 0
    count_to_trigger_coded: int = 0
    rel_quality_coded: int = 0
    min_quality_coded: int = 0
    has_power_constraints: bool = False
    clusters_max_tx_power_coded: int | None = None
    frame_offset: int | None = None
    next_cluster_channel: int | None = None
    time_to_next: int | None = None
    mu: int = 1

    IE_TYPE = IeType.CLUSTER_BEACON_MESSAGE

    def _fo_size(self) -> int:
        return 1 if self.mu <= 4 else 2

    def is_valid(self) -> bool:
        from ..part2 import is_absolute_channel_number_in_range as ok_ch
        if not 0 <= self.system_frame_number <= 0xFF:
            return False
        if self.clusters_max_tx_power_coded is not None and not (
                3 <= self.clusters_max_tx_power_coded <= 15):
            return False
        if self.frame_offset is not None and \
                self.frame_offset >= (1 << (8 * self._fo_size())):
            return False
        if self.next_cluster_channel is not None and not ok_ch(self.next_cluster_channel):
            return False
        return (self.network_beacon_period_coded < len(NETWORK_BEACON_PERIOD_MS)
                and self.cluster_beacon_period_coded < len(CLUSTER_BEACON_PERIOD_MS)
                and self.count_to_trigger_coded < len(COUNT_TO_TRIGGER)
                and self.rel_quality_coded < 4 and self.min_quality_coded < 4)

    def packed_size(self) -> int:
        return (4 + (self.clusters_max_tx_power_coded is not None)
                + (self.frame_offset is not None) * self._fo_size()
                + (self.next_cluster_channel is not None) * 2
                + (self.time_to_next is not None) * 4)

    def pack_into(self, buf, off):
        assert self.is_valid(), "cluster beacon message is not valid"
        buf[off] = self.system_frame_number
        buf[off + 1] = ((self.clusters_max_tx_power_coded is not None) << 4) \
            | (self.has_power_constraints << 3) \
            | ((self.frame_offset is not None) << 2) \
            | ((self.next_cluster_channel is not None) << 1) \
            | (self.time_to_next is not None)
        buf[off + 2] = (self.network_beacon_period_coded << 4) \
            | self.cluster_beacon_period_coded
        buf[off + 3] = (self.count_to_trigger_coded << 4) \
            | (self.rel_quality_coded << 2) | self.min_quality_coded
        o = off + 4
        if self.clusters_max_tx_power_coded is not None:
            buf[o] = self.clusters_max_tx_power_coded
            o += 1
        if self.frame_offset is not None:
            n = self._fo_size()
            buf[o:o + n] = self.frame_offset.to_bytes(n, "big")
            o += n
        if self.next_cluster_channel is not None:
            buf[o] = self.next_cluster_channel >> 8
            buf[o + 1] = self.next_cluster_channel & 0xFF
            o += 2
        if self.time_to_next is not None:
            buf[o:o + 4] = self.time_to_next.to_bytes(4, "big")
            o += 4
        return o

    def unpack_from(self, buf, off) -> bool:
        self.system_frame_number = buf[off]
        b1 = buf[off + 1]
        self.network_beacon_period_coded = buf[off + 2] >> 4
        self.cluster_beacon_period_coded = buf[off + 2] & 0b1111
        self.count_to_trigger_coded = buf[off + 3] >> 4
        self.rel_quality_coded = (buf[off + 3] >> 2) & 0b11
        self.min_quality_coded = buf[off + 3] & 0b11
        self.has_power_constraints = bool((b1 >> 3) & 1)
        o = off + 4
        self.clusters_max_tx_power_coded = None
        self.frame_offset = None
        self.next_cluster_channel = None
        self.time_to_next = None
        if (b1 >> 4) & 1:
            self.clusters_max_tx_power_coded = buf[o] & 0b1111
            o += 1
        if (b1 >> 2) & 1:
            n = self._fo_size()
            self.frame_offset = int.from_bytes(bytes(buf[o:o + n]), "big")
            o += n
        if (b1 >> 1) & 1:
            self.next_cluster_channel = _chan13(buf, o)
            o += 2
        if b1 & 1:
            self.time_to_next = int.from_bytes(bytes(buf[o:o + 4]), "big")
            o += 4
        return self.is_valid()

    PEEK_MIN = 2

    def peek_packed_size(self, buf, off):
        b1 = buf[off + 1]
        return (4 + ((b1 >> 4) & 1) + ((b1 >> 2) & 1) * self._fo_size()
                + ((b1 >> 1) & 1) * 2 + (b1 & 1) * 4)


class MmiePoolTx:
    """Reusable pool of TX-side MMIE instances (reference mmie_pool_tx.cpp):
    one (or more) preallocated instance per codec type, fetched by class for
    filling and packing without per-packet allocation; unused tail bytes are
    filled with padding IEs (the first padding IE ends RX parsing, 6.4.3.8).
    """

    def __init__(self):
        self._pool: dict[type, list] = {}
        from .mac_pdu_decoder import FLOWING_REGISTRY, MMIE_REGISTRY
        for cls in MMIE_REGISTRY.values():
            self.set_nof_elements(cls, 1)
        for cls, _flow in set(FLOWING_REGISTRY.values()):
            self.set_nof_elements(cls, 1)

    def set_nof_elements(self, cls: type, n: int) -> None:
        assert n > 0, "each MMIE must be contained at least once in the pool"
        vec = self._pool.setdefault(cls, [])
        while len(vec) < n:
            vec.append(cls())
        del vec[n:]

    def get_nof_elements(self, cls: type) -> int:
        return len(self._pool.get(cls, ()))

    @property
    def nof_mmie(self) -> int:
        return len(self._pool)

    def get(self, cls: type, i: int = 0, mu: int | None = None):
        """Fetch instance i of a codec type, reset to defaults (the
        reference's get<T>() returns the reusable element; firmware fills
        every field before packing)."""
        inst = self._pool[cls][i]
        fresh = cls()                     # dataclass defaults = zero()
        inst.__dict__.update(fresh.__dict__)
        if mu is not None:
            inst.mu = mu                  # mu_depending_t analog
        return inst

    @staticmethod
    def fill_with_padding_ies(buf: bytearray, off: int, n_bytes: int) -> int:
        """Fill [off, off+n_bytes) with padding IEs
        (reference mmie_pool_tx_t::fill_with_padding_ies)."""
        from .ies import PaddingIE
        if n_bytes <= 0:
            return off
        return PaddingIE(n_bytes).pack_mmh_sdu_into(buf, off)
