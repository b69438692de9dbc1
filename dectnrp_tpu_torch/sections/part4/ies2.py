"""MAC IEs continued: group assignment, load info, measurement report,
neighbouring, and the project-extension IEs (power target, time announce).

Parity: reference lib/src/sections_part4/mac_messages_and_ie/
{group_assignment_ie,load_info_ie,measurement_report_ie,neighbouring_ie}.cpp
and extension/{power_target_ie,time_announce_ie}.cpp. Two reference packing
quirks are deliberately fixed here (noted inline): neighbouring_ie packs the
channel's high byte as value>>5 but unpacks bits 12:8, and reads the network
beacon period without the >>4 shift -- both round-trip inconsistently in the
reference; we use the symmetric encoding.

Copy of `dectnrp_tpu/sections/part4/ies2.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..part2 import is_absolute_channel_number_in_range as _ok_ch
from .mac_pdu import IeType, MacExt, MuxHeader
from .mmie import CLUSTER_BEACON_PERIOD_MS, Mmie, NETWORK_BEACON_PERIOD_MS


@dataclass
class GroupAssignmentIE(Mmie):
    """6.4.3.11: Single(1) | GroupID(7), then per assignment Direct(1)|Tag(7).
    Length is NOT self-describing -- carried in the mux header (8-bit len)."""
    single: bool = True
    group_id: int = 0
    assignments: tuple[tuple[int, int], ...] = ((0, 0),)  # (direct, tag)

    IE_TYPE = IeType.GROUP_ASSIGNMENT_IE

    def mux_header(self) -> MuxHeader:
        return MuxHeader(MacExt.LENGTH_8BIT, int(self.IE_TYPE), self.packed_size())

    def is_valid(self) -> bool:
        if self.single and len(self.assignments) != 1:
            return False
        if not self.single and len(self.assignments) < 2:
            return False
        return (0 <= self.group_id <= 0x7F
                and all(d <= 1 and 0 <= t <= 0x7F for d, t in self.assignments))

    def packed_size(self) -> int:
        return 1 + len(self.assignments)

    def pack_into(self, buf, off):
        assert self.is_valid()
        buf[off] = (int(self.single) << 7) | self.group_id
        o = off + 1
        for d, t in self.assignments:
            buf[o] = (d << 7) | t
            o += 1
        return o

    def unpack_from(self, buf, off, length: int | None = None) -> bool:
        assert length is not None, "group assignment needs mux-header length"
        self.single = bool(buf[off] >> 7)
        self.group_id = buf[off] & 0x7F
        self.assignments = tuple((buf[off + i] >> 7, buf[off + i] & 0x7F)
                                 for i in range(1, length))
        return self.is_valid()


@dataclass
class LoadInfoIE(Mmie):
    """6.4.3.10; reference load_info_ie.cpp."""
    max_assoc_16bit: bool = False
    traffic_load_percentage: int = 0
    max_nof_associated_rd: int = 0
    rd_ft_load_percentage: int = 0
    rd_pt_load_percentage: int | None = None
    rach_load_percentage: int | None = None
    channel_load: tuple[int, int] | None = None   # (free%, busy%) in subslots

    IE_TYPE = IeType.LOAD_INFO_IE

    def is_valid(self) -> bool:
        lim = 0xFFFF if self.max_assoc_16bit else 0xFF
        for v in (self.rd_pt_load_percentage, self.rach_load_percentage):
            if v is not None and not 0 <= v <= 0xFF:
                return False
        if self.channel_load is not None and not all(
                0 <= v <= 0xFF for v in self.channel_load):
            return False
        return (0 <= self.traffic_load_percentage <= 0xFF
                and 0 <= self.max_nof_associated_rd <= lim
                and 0 <= self.rd_ft_load_percentage <= 0xFF)

    def packed_size(self) -> int:
        return ((5 if self.max_assoc_16bit else 4)
                + (self.rd_pt_load_percentage is not None)
                + (self.rach_load_percentage is not None)
                + (self.channel_load is not None) * 2)

    def pack_into(self, buf, off):
        assert self.is_valid()
        buf[off] = (self.max_assoc_16bit << 3) \
            | ((self.rd_pt_load_percentage is not None) << 2) \
            | ((self.rach_load_percentage is not None) << 1) \
            | (self.channel_load is not None)
        buf[off + 1] = self.traffic_load_percentage
        nb = 2 if self.max_assoc_16bit else 1
        buf[off + 2:off + 2 + nb] = self.max_nof_associated_rd.to_bytes(nb, "big")
        o = off + 2 + nb
        buf[o] = self.rd_ft_load_percentage
        o += 1
        if self.rd_pt_load_percentage is not None:
            buf[o] = self.rd_pt_load_percentage
            o += 1
        if self.rach_load_percentage is not None:
            buf[o] = self.rach_load_percentage
            o += 1
        if self.channel_load is not None:
            buf[o] = self.channel_load[0]
            buf[o + 1] = self.channel_load[1]
            o += 2
        return o

    def unpack_from(self, buf, off) -> bool:
        self.max_assoc_16bit = bool((buf[off] >> 3) & 1)
        self.traffic_load_percentage = buf[off + 1]
        nb = 2 if self.max_assoc_16bit else 1
        self.max_nof_associated_rd = int.from_bytes(bytes(buf[off + 2:off + 2 + nb]), "big")
        o = off + 2 + nb
        self.rd_ft_load_percentage = buf[o]
        o += 1
        self.rd_pt_load_percentage = None
        if (buf[off] >> 2) & 1:
            self.rd_pt_load_percentage = buf[o]
            o += 1
        self.rach_load_percentage = None
        if (buf[off] >> 1) & 1:
            self.rach_load_percentage = buf[o]
            o += 1
        self.channel_load = None
        if buf[off] & 1:
            self.channel_load = (buf[o], buf[o + 1])
            o += 2
        return self.is_valid()

    def peek_packed_size(self, buf, off):
        return ((5 if (buf[off] >> 3) & 1 else 4) + ((buf[off] >> 2) & 1)
                + ((buf[off] >> 1) & 1) + (buf[off] & 1) * 2)


@dataclass
class MeasurementReportIE(Mmie):
    """6.4.3.12; reference measurement_report_ie.cpp."""
    rach: int = 0
    snr: int | None = None
    rssi_2: int | None = None
    rssi_1: int | None = None
    tx_count: int | None = None

    IE_TYPE = IeType.MEASUREMENT_REPORT_IE

    def is_valid(self) -> bool:
        return all(v is None or 0 <= v <= 0xFF
                   for v in (self.snr, self.rssi_2, self.rssi_1, self.tx_count)) \
            and self.rach <= 1

    def packed_size(self) -> int:
        return 1 + sum(v is not None
                       for v in (self.snr, self.rssi_2, self.rssi_1, self.tx_count))

    def pack_into(self, buf, off):
        assert self.is_valid()
        buf[off] = ((self.snr is not None) << 4) | ((self.rssi_2 is not None) << 3) \
            | ((self.rssi_1 is not None) << 2) | ((self.tx_count is not None) << 1) \
            | self.rach
        o = off + 1
        for v in (self.snr, self.rssi_2, self.rssi_1, self.tx_count):
            if v is not None:
                buf[o] = v
                o += 1
        return o

    def unpack_from(self, buf, off) -> bool:
        self.rach = buf[off] & 1
        o = off + 1
        vals = []
        for bit in (4, 3, 2, 1):
            if (buf[off] >> bit) & 1:
                vals.append(buf[o])
                o += 1
            else:
                vals.append(None)
        self.snr, self.rssi_2, self.rssi_1, self.tx_count = vals
        return self.is_valid()

    def peek_packed_size(self, buf, off):
        return 1 + sum((buf[off] >> b) & 1 for b in (4, 3, 2, 1))


@dataclass
class NeighbouringIE(Mmie):
    """6.4.3.14; reference neighbouring_ie.cpp (with the two encoding quirks
    fixed, see module docstring)."""
    short_rd_id: int = 1
    has_power_constraints: bool = False
    network_beacon_period_coded: int = 0
    cluster_beacon_period_coded: int = 0
    radio_device_class: tuple[int, int] | None = None    # (mu_coded, beta_coded)
    snr: int | None = None
    rssi_2: int | None = None
    next_cluster_channel: int | None = None
    time_to_next: int | None = None

    IE_TYPE = IeType.NEIGHBOURING_IE
    PEEK_MIN = 3

    def is_valid(self) -> bool:
        if not 0 <= self.short_rd_id <= 0xFFFF:
            return False
        for v in (self.snr, self.rssi_2):
            if v is not None and not 0 <= v <= 0xFF:
                return False
        if self.next_cluster_channel is not None and not _ok_ch(self.next_cluster_channel):
            return False
        return (self.network_beacon_period_coded < len(NETWORK_BEACON_PERIOD_MS)
                and self.cluster_beacon_period_coded < len(CLUSTER_BEACON_PERIOD_MS))

    def packed_size(self) -> int:
        return (4 + (self.radio_device_class is not None)
                + (self.snr is not None) + (self.rssi_2 is not None)
                + (self.next_cluster_channel is not None) * 2
                + (self.time_to_next is not None) * 4)

    def pack_into(self, buf, off):
        assert self.is_valid()
        buf[off:off + 2] = self.short_rd_id.to_bytes(2, "big")
        buf[off + 2] = ((self.radio_device_class is not None) << 5) \
            | ((self.snr is not None) << 4) | ((self.rssi_2 is not None) << 3) \
            | (self.has_power_constraints << 2) \
            | ((self.next_cluster_channel is not None) << 1) \
            | (self.time_to_next is not None)
        buf[off + 3] = (self.network_beacon_period_coded << 4) \
            | self.cluster_beacon_period_coded
        o = off + 4
        if self.next_cluster_channel is not None:
            buf[o] = self.next_cluster_channel >> 8
            buf[o + 1] = self.next_cluster_channel & 0xFF
            o += 2
        if self.time_to_next is not None:
            buf[o:o + 4] = self.time_to_next.to_bytes(4, "big")
            o += 4
        if self.rssi_2 is not None:
            buf[o] = self.rssi_2
            o += 1
        if self.snr is not None:
            buf[o] = self.snr
            o += 1
        if self.radio_device_class is not None:
            buf[o] = (self.radio_device_class[0] << 5) | (self.radio_device_class[1] << 1)
            o += 1
        return o

    def unpack_from(self, buf, off) -> bool:
        self.short_rd_id = int.from_bytes(bytes(buf[off:off + 2]), "big")
        b2 = buf[off + 2]
        self.has_power_constraints = bool((b2 >> 2) & 1)
        self.network_beacon_period_coded = buf[off + 3] >> 4
        self.cluster_beacon_period_coded = buf[off + 3] & 0xF
        o = off + 4
        self.next_cluster_channel = self.time_to_next = None
        self.rssi_2 = self.snr = self.radio_device_class = None
        if (b2 >> 1) & 1:
            self.next_cluster_channel = ((buf[o] & 0x1F) << 8) | buf[o + 1]
            o += 2
        if b2 & 1:
            self.time_to_next = int.from_bytes(bytes(buf[o:o + 4]), "big")
            o += 4
        if (b2 >> 3) & 1:
            self.rssi_2 = buf[o]
            o += 1
        if (b2 >> 4) & 1:
            self.snr = buf[o]
            o += 1
        if (b2 >> 5) & 1:
            self.radio_device_class = ((buf[o] >> 5) & 0b111, (buf[o] >> 1) & 0xF)
            o += 1
        return self.is_valid()

    def peek_packed_size(self, buf, off):
        b2 = buf[off + 2]
        return (4 + ((b2 >> 5) & 1) + ((b2 >> 4) & 1) + ((b2 >> 3) & 1)
                + ((b2 >> 1) & 1) * 2 + (b2 & 1) * 4)


@dataclass
class PowerTargetIE(Mmie):
    """Project extension (not in the standard): RX power target at the FT.
    Coded value = dBm + 100, valid -55..-40 dBm (coded 45..60)."""
    power_target_dbm_coded: int = 45

    IE_TYPE = IeType.POWER_TARGET_IE

    def is_valid(self) -> bool:
        return 45 <= self.power_target_dbm_coded <= 60

    def packed_size(self) -> int:
        return 1

    def pack_into(self, buf, off):
        buf[off] = self.power_target_dbm_coded
        return off + 1

    def unpack_from(self, buf, off) -> bool:
        self.power_target_dbm_coded = buf[off]
        return self.is_valid()


@dataclass
class TimeAnnounceIE(Mmie):
    """Project extension: announce full-second time (TAI/UTC) N frames ahead.
    11 bytes: type(1) + N_frames(1) + full_sec(8) + tai_minus_utc(1)."""
    time_type: int = 0
    n_frames_until_full_sec: int = 0
    full_sec: int = 0
    tai_minus_utc_seconds: int = 0

    IE_TYPE = IeType.TIME_ANNOUNCE_IE

    def is_valid(self) -> bool:
        return (0 <= self.time_type <= 2
                and 0 <= self.n_frames_until_full_sec <= 255
                and self.full_sec >= 0
                and 0 <= self.tai_minus_utc_seconds <= 255)

    def packed_size(self) -> int:
        return 11

    def pack_into(self, buf, off):
        buf[off] = self.time_type
        buf[off + 1] = self.n_frames_until_full_sec
        buf[off + 2:off + 10] = self.full_sec.to_bytes(8, "big")
        buf[off + 10] = self.tai_minus_utc_seconds
        return off + 11

    def unpack_from(self, buf, off) -> bool:
        self.time_type = buf[off]
        self.n_frames_until_full_sec = buf[off + 1]
        self.full_sec = int.from_bytes(bytes(buf[off + 2:off + 10]), "big")
        self.tai_minus_utc_seconds = buf[off + 10]
        return self.is_valid()
