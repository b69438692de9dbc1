"""MAC information elements, ETSI TS 103 636-4 6.4.3.

Parity: reference lib/src/sections_part4/mac_messages_and_ie/*.cpp
(one class per IE; see each docstring for the source file).

Copy of `dectnrp_tpu/sections/part4/ies.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal but for
`PaddingIE.mux_header`, which also takes the 16-bit length form (its
DEPARTURES; `tests/test_torch_wideband.py` holds that function).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..part2 import is_absolute_channel_number_in_range as _ok_ch
from .mac_pdu import (IeType, IeTypeShortLen0, IeTypeShortLen1, MacExt,
                      MuxHeader)
from .mmie import Mmie, MmieFlowing

LENGTH_IN_SUBSLOTS = 0
LENGTH_IN_SLOTS = 1

REPEAT_SINGLE = 0
REPEAT_FRAMES = 1
REPEAT_SUBSLOTS = 2
REPEAT_FRAMES_SPECIFIC = 3
REPEAT_SUBSLOTS_SPECIFIC = 4


@dataclass
class Allocation:
    """start subslot + length (subslots or slots), resource_allocation_ie.hpp."""
    start_subslot: int = 0
    length_type: int = LENGTH_IN_SUBSLOTS
    length: int = 1

    def is_valid(self, mu: int) -> bool:
        lim = 0xFF if mu <= 4 else 0xFFFF
        return 0 <= self.start_subslot <= lim and 0 <= self.length <= 0x7F


@dataclass
class RepeatInfo:
    repeat_type: int = REPEAT_FRAMES    # REPEAT_FRAMES or REPEAT_SUBSLOTS
    allow_specific_repeated_resources: bool = False
    repetition: int = 1
    validity: int = 0

    def is_valid(self) -> bool:
        return 1 <= self.repetition <= 0xFF and 0 <= self.validity <= 0xFF

    def coded_repeat(self) -> int:
        base = (REPEAT_FRAMES if self.repeat_type == REPEAT_FRAMES
                else REPEAT_SUBSLOTS)
        if self.allow_specific_repeated_resources:
            base += 2
        return base


@dataclass
class ResourceAllocationIE(Mmie):
    """6.4.3.3; reference resource_allocation_ie.cpp. Packed size and the
    start-subslot width depend on mu (mu<=4: 1 byte, else 2)."""
    allocation_dl: Allocation | None = None
    allocation_ul: Allocation | None = None
    is_additional_allocation: bool = False
    short_rd_id: int | None = None
    repeat_info: RepeatInfo | None = None
    sfn_offset: int | None = None
    channel: int | None = None
    dect_scheduled_resource_failure_coded: int | None = None
    mu: int = 1

    IE_TYPE = IeType.RESOURCE_ALLOCATION_IE
    PEEK_MIN = 2

    @property
    def release_all(self) -> bool:
        return self.allocation_dl is None and self.allocation_ul is None

    def is_valid(self) -> bool:
        if self.release_all:
            return True
        for a in (self.allocation_dl, self.allocation_ul):
            if a is not None and not a.is_valid(self.mu):
                return False
        if self.short_rd_id is not None and not 0 <= self.short_rd_id <= 0xFFFF:
            return False
        if self.repeat_info is not None and not self.repeat_info.is_valid():
            return False
        if self.sfn_offset is not None and not 0 <= self.sfn_offset <= 0xFF:
            return False
        if self.channel is not None and not _ok_ch(self.channel):
            return False
        if self.dect_scheduled_resource_failure_coded is not None and not (
                1 <= self.dect_scheduled_resource_failure_coded <= 11):
            return False
        return True

    def _alloc_bytes(self) -> int:
        return (1 if self.mu <= 4 else 2) + 1

    def packed_size(self) -> int:
        if self.release_all:
            return 1
        n = 2
        if self.allocation_dl is not None:
            n += self._alloc_bytes()
        if self.allocation_ul is not None:
            n += self._alloc_bytes()
        n += (self.short_rd_id is not None) * 2
        n += (self.repeat_info is not None) * 2
        n += self.sfn_offset is not None
        n += (self.channel is not None) * 2
        n += self.dect_scheduled_resource_failure_coded is not None
        return n

    def pack_into(self, buf, off):
        assert self.is_valid(), "resource allocation IE is not valid"
        buf[off] = ((self.allocation_ul is not None) << 7) \
            | ((self.allocation_dl is not None) << 6)
        if self.release_all:
            return off + 1
        buf[off] |= (self.is_additional_allocation << 5) \
            | ((self.short_rd_id is not None) << 4) \
            | ((self.repeat_info.coded_repeat() if self.repeat_info else 0) << 1) \
            | (self.sfn_offset is not None)
        buf[off + 1] = ((self.channel is not None) << 7) \
            | ((self.dect_scheduled_resource_failure_coded is not None) << 6)
        o = off + 2
        nss = 1 if self.mu <= 4 else 2
        for a in (self.allocation_dl, self.allocation_ul):
            if a is None:
                continue
            buf[o:o + nss] = a.start_subslot.to_bytes(nss, "big")
            buf[o + nss] = (a.length_type << 7) | a.length
            o += nss + 1
        if self.short_rd_id is not None:
            buf[o:o + 2] = self.short_rd_id.to_bytes(2, "big")
            o += 2
        if self.repeat_info is not None:
            buf[o] = self.repeat_info.repetition
            buf[o + 1] = self.repeat_info.validity
            o += 2
        if self.sfn_offset is not None:
            buf[o] = self.sfn_offset
            o += 1
        if self.channel is not None:
            buf[o] = self.channel >> 8
            buf[o + 1] = self.channel & 0xFF
            o += 2
        if self.dect_scheduled_resource_failure_coded is not None:
            buf[o] = self.dect_scheduled_resource_failure_coded
            o += 1
        return o

    def unpack_from(self, buf, off) -> bool:
        kind = buf[off] >> 6
        self.allocation_dl = self.allocation_ul = None
        if kind == 0:
            return True
        o = off + 2
        nss = 1 if self.mu <= 4 else 2

        def rd_alloc(o):
            ss = int.from_bytes(bytes(buf[o:o + nss]), "big")
            lt = buf[o + nss] >> 7
            ln = buf[o + nss] & 0x7F
            return Allocation(ss, lt, ln), o + nss + 1

        # kind bits: b7=ul, b6=dl (allocation_type_t: 1=dl, 2=ul, 3=both)
        if kind & 0b01:          # dl
            self.allocation_dl, o = rd_alloc(o)
        if kind & 0b10:          # ul
            self.allocation_ul, o = rd_alloc(o)
        self.is_additional_allocation = bool((buf[off] >> 5) & 1)
        self.short_rd_id = None
        if (buf[off] >> 4) & 1:
            self.short_rd_id = int.from_bytes(bytes(buf[o:o + 2]), "big")
            o += 2
        rep = (buf[off] >> 1) & 0b111
        self.repeat_info = None
        if rep != REPEAT_SINGLE:
            if rep > REPEAT_SUBSLOTS_SPECIFIC:
                return False
            self.repeat_info = RepeatInfo(
                REPEAT_FRAMES if rep in (REPEAT_FRAMES, REPEAT_FRAMES_SPECIFIC)
                else REPEAT_SUBSLOTS,
                rep >= REPEAT_FRAMES_SPECIFIC, buf[o], buf[o + 1])
            o += 2
        self.sfn_offset = None
        if buf[off] & 1:
            self.sfn_offset = buf[o]
            o += 1
        self.channel = None
        if buf[off + 1] >> 7:
            self.channel = ((buf[o] << 8) | buf[o + 1]) & 0x1FFF
            o += 2
        self.dect_scheduled_resource_failure_coded = None
        if (buf[off + 1] >> 6) & 1:
            self.dect_scheduled_resource_failure_coded = buf[o] & 0xF
            o += 1
        return self.is_valid()

    def peek_packed_size(self, buf, off):
        kind = buf[off] >> 6
        if kind == 0:
            return 1
        ab = (1 if self.mu <= 4 else 2) + 1
        size = 2 + ab * (1 if kind in (1, 2) else 2)
        size += ((buf[off] >> 4) & 1) * 2
        rep = (buf[off] >> 1) & 0b111
        if rep > REPEAT_SUBSLOTS_SPECIFIC:
            return None
        if rep != REPEAT_SINGLE:
            size += 2
        size += buf[off] & 1
        size += (buf[off + 1] >> 7) * 2
        size += (buf[off + 1] >> 6) & 1
        return size


@dataclass
class RandomAccessResourceIE(Mmie):
    """6.4.3.4; reference random_access_resource_ie.cpp."""
    allocation: Allocation = field(default_factory=Allocation)
    max_rach_length_type: int = LENGTH_IN_SUBSLOTS
    max_rach_length: int = 0           # 4 bits
    cw_min_coded: int = 0              # 0..7 -> 0,8,16,...
    dect_delay: int = 0
    response_window_length: int = 0    # 4 bits
    cw_max_coded: int = 0
    repeat_info: RepeatInfo | None = None
    sfn_offset: int | None = None
    channel: int | None = None
    channel_2: int | None = None
    mu: int = 1

    IE_TYPE = IeType.RANDOM_ACCESS_RESOURCE_IE

    def is_valid(self) -> bool:
        if self.repeat_info is not None and not self.repeat_info.is_valid():
            return False
        if self.sfn_offset is not None and not 0 <= self.sfn_offset <= 0xFF:
            return False
        for c in (self.channel, self.channel_2):
            if c is not None and not _ok_ch(c):
                return False
        return (self.allocation.is_valid(self.mu)
                and 0 <= self.max_rach_length <= 0xF
                and 0 <= self.cw_min_coded <= 7
                and 0 <= self.response_window_length <= 0xF
                and 0 <= self.cw_max_coded <= 7)

    def packed_size(self) -> int:
        return ((5 if self.mu <= 4 else 6)
                + (self.repeat_info is not None) * 2
                + (self.sfn_offset is not None)
                + (self.channel is not None) * 2
                + (self.channel_2 is not None) * 2)

    def pack_into(self, buf, off):
        assert self.is_valid(), "random access resource IE is not valid"
        rep = self.repeat_info.coded_repeat() if self.repeat_info else 0
        # repeat field here is 2 bits: single / frames / subslots
        rep2 = {REPEAT_SINGLE: 0, REPEAT_FRAMES: 1, REPEAT_SUBSLOTS: 2,
                REPEAT_FRAMES_SPECIFIC: 1, REPEAT_SUBSLOTS_SPECIFIC: 2}[rep]
        buf[off] = (rep2 << 3) | ((self.sfn_offset is not None) << 2) \
            | ((self.channel is not None) << 1) | (self.channel_2 is not None)
        nss = 1 if self.mu <= 4 else 2
        buf[off + 1:off + 1 + nss] = self.allocation.start_subslot.to_bytes(nss, "big")
        o = off + 1 + nss
        buf[o] = (self.allocation.length_type << 7) | self.allocation.length
        o += 1
        buf[o] = (self.max_rach_length_type << 7) | (self.max_rach_length << 3) \
            | self.cw_min_coded
        o += 1
        buf[o] = (self.dect_delay << 7) | (self.response_window_length << 3) \
            | self.cw_max_coded
        o += 1
        if self.repeat_info is not None:
            buf[o] = self.repeat_info.repetition
            buf[o + 1] = self.repeat_info.validity
            o += 2
        if self.sfn_offset is not None:
            buf[o] = self.sfn_offset
            o += 1
        for c in (self.channel, self.channel_2):
            if c is not None:
                buf[o] = c >> 8
                buf[o + 1] = c & 0xFF
                o += 2
        return o

    def unpack_from(self, buf, off) -> bool:
        nss = 1 if self.mu <= 4 else 2
        ss = int.from_bytes(bytes(buf[off + 1:off + 1 + nss]), "big")
        o = off + 1 + nss
        self.allocation = Allocation(ss, buf[o] >> 7, buf[o] & 0x7F)
        o += 1
        self.max_rach_length_type = buf[o] >> 7
        self.max_rach_length = (buf[o] >> 3) & 0xF
        self.cw_min_coded = buf[o] & 0b111
        o += 1
        self.dect_delay = buf[o] >> 7
        self.response_window_length = (buf[o] >> 3) & 0xF
        self.cw_max_coded = buf[o] & 0b111
        o += 1
        rep = (buf[off] >> 3) & 0b11
        self.repeat_info = None
        if rep == 3:
            return False
        if rep != 0:
            self.repeat_info = RepeatInfo(
                REPEAT_FRAMES if rep == 1 else REPEAT_SUBSLOTS,
                False, buf[o], buf[o + 1])
            o += 2
        self.sfn_offset = None
        if (buf[off] >> 2) & 1:
            self.sfn_offset = buf[o]
            o += 1
        self.channel = self.channel_2 = None
        if (buf[off] >> 1) & 1:
            self.channel = ((buf[o] & 0x1F) << 8) | buf[o + 1]
            o += 2
        if buf[off] & 1:
            self.channel_2 = ((buf[o] & 0x1F) << 8) | buf[o + 1]
            o += 2
        return self.is_valid()

    def peek_packed_size(self, buf, off):
        size = 5 if self.mu <= 4 else 6
        rep = (buf[off] >> 3) & 0b11
        if rep == 3:
            return None
        if rep != 0:
            size += 2
        size += (buf[off] >> 2) & 1
        size += ((buf[off] >> 1) & 1) * 2
        size += (buf[off] & 1) * 2
        return size


@dataclass
class PhyCapability:
    """4-byte PHY capability block of the RD capability IE (6.4.3.5)."""
    rd_power_class: int = 1
    max_nss_for_rx: int = 0
    rx_for_tx_diversity: int = 0
    rx_gain_index: int = 0
    max_mcs: int = 0
    soft_buffer_size: int = 0
    nof_harq_processes: int = 0
    harq_feedback_delay: int = 0

    def is_valid(self) -> bool:
        return (0 <= self.rd_power_class <= 7 and 0 <= self.max_nss_for_rx <= 3
                and 0 <= self.rx_for_tx_diversity <= 3
                and 0 <= self.rx_gain_index <= 15 and 0 <= self.max_mcs <= 15
                and 0 <= self.soft_buffer_size <= 15
                and 0 <= self.nof_harq_processes <= 3
                and 0 <= self.harq_feedback_delay <= 15)

    def pack_into(self, buf, off) -> int:
        buf[off] = (self.rd_power_class << 4) | (self.max_nss_for_rx << 2) \
            | self.rx_for_tx_diversity
        buf[off + 1] = (self.rx_gain_index << 4) | self.max_mcs
        buf[off + 2] = (self.soft_buffer_size << 4) | (self.nof_harq_processes << 2)
        buf[off + 3] = self.harq_feedback_delay << 4
        return off + 4

    def unpack_from(self, buf, off) -> int:
        self.rd_power_class = (buf[off] >> 4) & 0b111
        self.max_nss_for_rx = (buf[off] >> 2) & 0b11
        self.rx_for_tx_diversity = buf[off] & 0b11
        self.rx_gain_index = buf[off + 1] >> 4
        self.max_mcs = buf[off + 1] & 0xF
        self.soft_buffer_size = buf[off + 2] >> 4
        self.nof_harq_processes = (buf[off + 2] >> 2) & 0b11
        self.harq_feedback_delay = buf[off + 3] >> 4
        return off + 4


@dataclass
class AdditionalPhyCapability(PhyCapability):
    mu_coded: int = 0       # subcarrier width code
    beta_coded: int = 0     # DFT size code


@dataclass
class RdCapabilityIE(Mmie):
    """6.4.3.5; reference rd_capability_ie.cpp: 7 bytes + 5 per additional."""
    release: int = 1
    operating_modes: int = 0
    supports_mesh: bool = False
    supports_scheduled: bool = False
    mac_security: int = 0
    dlc_service_type: int = 0
    phy_capability: PhyCapability = field(default_factory=PhyCapability)
    additional: tuple[AdditionalPhyCapability, ...] = ()

    IE_TYPE = IeType.RD_CAPABILITY_IE

    def is_valid(self) -> bool:
        return (len(self.additional) <= 7 and 0 <= self.release <= 31
                and 0 <= self.operating_modes <= 3
                and 0 <= self.mac_security <= 7
                and 0 <= self.dlc_service_type <= 7
                and self.phy_capability.is_valid()
                and all(a.is_valid() for a in self.additional))

    def packed_size(self) -> int:
        return 7 + len(self.additional) * 5

    def pack_into(self, buf, off):
        assert self.is_valid(), "RD capability IE is not valid"
        buf[off] = (len(self.additional) << 5) | self.release
        buf[off + 1] = (self.operating_modes << 2) | (self.supports_mesh << 1) \
            | self.supports_scheduled
        buf[off + 2] = (self.mac_security << 5) | (self.dlc_service_type << 2)
        o = self.phy_capability.pack_into(buf, off + 3)
        for a in self.additional:
            buf[o] = (a.mu_coded << 5) | (a.beta_coded << 1)
            o = a.pack_into(buf, o + 1)
        return o

    def unpack_from(self, buf, off) -> bool:
        n_add = buf[off] >> 5
        self.release = buf[off] & 0b11111
        self.operating_modes = (buf[off + 1] >> 2) & 0b11
        self.supports_mesh = bool(buf[off + 1] & 0b10)
        self.supports_scheduled = bool(buf[off + 1] & 1)
        self.mac_security = buf[off + 2] >> 5
        self.dlc_service_type = (buf[off + 2] >> 2) & 0b111
        self.phy_capability = PhyCapability()
        o = self.phy_capability.unpack_from(buf, off + 3)
        add = []
        for _ in range(n_add):
            a = AdditionalPhyCapability()
            a.mu_coded = buf[o] >> 5
            a.beta_coded = (buf[o] >> 1) & 0xF
            o = a.unpack_from(buf, o + 1)
            add.append(a)
        self.additional = tuple(add)
        return self.is_valid()

    def peek_packed_size(self, buf, off):
        return 7 + (buf[off] >> 5) * 5


@dataclass
class BroadcastIndicationIE(Mmie):
    """6.4.3.7; reference broadcast_indication_ie.cpp."""
    indication_type: int = 0          # 0 paging, 1 random access response
    id_type: int = 0                  # 0 short RDID, 1 long RDID
    rd_id: int = 1
    resource_allocation_ie_follows: bool = False
    ack_nack: int | None = None       # only for random access response
    feedback: int = 0                 # 0 none, 1 mcs, 2 mimo2, 3 mimo4
    mcs_feedback: int | None = None   # channel quality code (feedback=1)
    mimo_nof_layers: int | None = None
    mimo_codebook_index: int | None = None

    IE_TYPE = IeType.BROADCAST_INDICATION_IE

    _CBI_MAX = {(2, 0): 5, (2, 1): 2, (3, 0): 27, (3, 1): 21, (3, 2): 13}

    def is_valid(self) -> bool:
        if self.indication_type > 1 or self.id_type > 1:
            return False
        if self.id_type == 0 and not 0 <= self.rd_id <= 0xFFFF:
            return False
        if self.indication_type == 1:
            if self.id_type != 0 or self.ack_nack is None:
                return False
            if self.feedback == 1:
                return self.mcs_feedback is not None and 1 <= self.mcs_feedback <= 15
            if self.feedback in (2, 3):
                key = (self.feedback, self.mimo_nof_layers)
                return (key in self._CBI_MAX
                        and self.mimo_codebook_index is not None
                        and self.mimo_codebook_index <= self._CBI_MAX[key])
        return True

    def packed_size(self) -> int:
        n = 3 if self.id_type == 0 else 5
        if self.indication_type == 1 and self.feedback != 0:
            n += 1
        return n

    def pack_into(self, buf, off):
        assert self.is_valid(), "broadcast indication IE is not valid"
        buf[off] = (self.indication_type << 5) | (self.id_type << 4) \
            | self.resource_allocation_ie_follows
        nb = 2 if self.id_type == 0 else 4
        buf[off + 1:off + 1 + nb] = self.rd_id.to_bytes(nb, "big")
        o = off + 1 + nb
        if self.indication_type == 1:
            buf[off] |= (self.ack_nack << 3) | (self.feedback << 1)
            if self.feedback == 1:
                buf[o] = self.mcs_feedback
                o += 1
            elif self.feedback in (2, 3):
                shift = 3 if self.feedback == 2 else 6
                buf[o] = (self.mimo_nof_layers << shift) | self.mimo_codebook_index
                o += 1
        return o

    def unpack_from(self, buf, off) -> bool:
        self.indication_type = buf[off] >> 5
        self.id_type = (buf[off] >> 4) & 1
        self.resource_allocation_ie_follows = bool(buf[off] & 1)
        nb = 2 if self.id_type == 0 else 4
        self.rd_id = int.from_bytes(bytes(buf[off + 1:off + 1 + nb]), "big")
        o = off + 1 + nb
        self.ack_nack = None
        self.feedback = 0
        self.mcs_feedback = self.mimo_nof_layers = self.mimo_codebook_index = None
        if self.indication_type == 1:
            self.ack_nack = (buf[off] >> 3) & 1
            self.feedback = (buf[off] >> 1) & 0b11
            if self.feedback == 1:
                self.mcs_feedback = buf[o] & 0xF
                o += 1
            elif self.feedback == 2:
                self.mimo_nof_layers = (buf[o] >> 3) & 1
                self.mimo_codebook_index = buf[o] & 0b111
                o += 1
            elif self.feedback == 3:
                self.mimo_nof_layers = buf[o] >> 6
                self.mimo_codebook_index = buf[o] & 0b111111
                o += 1
        return self.is_valid()

    def peek_packed_size(self, buf, off):
        if (buf[off] >> 5) > 1:
            return None
        size = 3 if ((buf[off] >> 4) & 1) == 0 else 5
        if (buf[off] >> 5) == 1 and (buf[off] & 0b110) != 0:
            size += 1
        return size


@dataclass
class RouteInfoIE(Mmie):
    """6.4.3.9; reference route_info_ie.cpp: 6 bytes fixed."""
    sink_address: int = 0
    route_cost: int = 0
    application_sequence_number: int = 0

    IE_TYPE = IeType.ROUTE_INFO_IE

    def is_valid(self) -> bool:
        return (0 <= self.route_cost <= 0xFF
                and 0 <= self.application_sequence_number <= 0xFF)

    def packed_size(self) -> int:
        return 6

    def pack_into(self, buf, off):
        buf[off:off + 4] = self.sink_address.to_bytes(4, "big")
        buf[off + 4] = self.route_cost
        buf[off + 5] = self.application_sequence_number
        return off + 6

    def unpack_from(self, buf, off) -> bool:
        self.sink_address = int.from_bytes(bytes(buf[off:off + 4]), "big")
        self.route_cost = buf[off + 4]
        self.application_sequence_number = buf[off + 5]
        return True


@dataclass
class MacSecurityInfoIE(Mmie):
    """6.4.3.1; reference mac_security_info_ie.cpp: 5 bytes fixed."""
    version: int = 0
    key_index: int = 0
    security_iv_type: int = 0     # 0 one-time HPC, 1 resync, 2 with request
    hpc: int = 0

    IE_TYPE = IeType.SECURITY_INFO_IE

    def is_valid(self) -> bool:
        return (self.version == 0 and 0 <= self.key_index <= 3
                and 0 <= self.security_iv_type <= 2)

    def packed_size(self) -> int:
        return 5

    def pack_into(self, buf, off):
        buf[off] = (self.version << 6) | (self.key_index << 4) | self.security_iv_type
        buf[off + 1:off + 5] = self.hpc.to_bytes(4, "big")
        return off + 5

    def unpack_from(self, buf, off) -> bool:
        if buf[off] >> 6 != 0:
            return False
        self.key_index = (buf[off] >> 4) & 0b11
        self.security_iv_type = buf[off] & 0xF
        self.hpc = int.from_bytes(bytes(buf[off + 1:off + 5]), "big")
        return self.is_valid()


@dataclass
class RadioDeviceStatusIE(Mmie):
    """6.4.3.13; 1-byte IE carried with the short mux header (len=1)."""
    status_flag: int = 2          # 1 memory full, 2 normal operation
    duration_coded: int = 0

    def mux_header(self) -> MuxHeader:
        return MuxHeader(MacExt.LENGTH_1BIT,
                         int(IeTypeShortLen1.RADIO_DEVICE_STATUS_IE), 1)

    def is_valid(self) -> bool:
        return 1 <= self.status_flag <= 2 and 0 <= self.duration_coded <= 15

    def packed_size(self) -> int:
        return 1

    def pack_into(self, buf, off):
        buf[off] = (self.status_flag << 4) | self.duration_coded
        return off + 1

    def unpack_from(self, buf, off) -> bool:
        self.status_flag = (buf[off] >> 4) & 0b11
        self.duration_coded = buf[off] & 0xF
        return self.is_valid()


@dataclass
class ConfigurationRequestIE(Mmie):
    """0-byte IE (mac_ext 11, len 0): request for configuration."""

    def mux_header(self) -> MuxHeader:
        return MuxHeader(MacExt.LENGTH_1BIT,
                         int(IeTypeShortLen0.CONFIGURATION_REQUEST_IE), 0)

    def is_valid(self) -> bool:
        return True

    def packed_size(self) -> int:
        return 0

    def pack_into(self, buf, off):
        return off

    def unpack_from(self, buf, off) -> bool:
        return True


class PaddingIE:
    """6.4.3.8; reference padding_ie.cpp: total padding of N bytes including
    its own mux header. N=1: 1-byte header; N=2: 1-byte header + 1 byte;
    N>2: 2-byte header + N-2 bytes. At RX a padding IE ends MAC PDU parsing."""

    def __init__(self, n_bytes: int = 1):
        assert n_bytes >= 1
        self.n_bytes = n_bytes

    def mux_header(self) -> MuxHeader:
        """The 1-bit and 8-bit length forms up to N = 257; above, the 16-bit
        form (MAC_Ext 10, 6.3.4): a 3-byte header + N-3 bytes, which the TB
        of a wide band (b >= 12) needs to pad a beacon."""
        if self.n_bytes == 1:
            return MuxHeader(MacExt.LENGTH_1BIT, int(IeTypeShortLen0.PADDING_IE), 0)
        if self.n_bytes == 2:
            return MuxHeader(MacExt.LENGTH_1BIT, int(IeTypeShortLen1.PADDING_IE), 1)
        if self.n_bytes <= 257:
            return MuxHeader(MacExt.LENGTH_8BIT, int(IeType.PADDING_IE),
                             self.n_bytes - 2)
        return MuxHeader(MacExt.LENGTH_16BIT, int(IeType.PADDING_IE),
                         self.n_bytes - 3)

    def packed_size_mmh_sdu(self) -> int:
        return self.n_bytes

    def pack_mmh_sdu_into(self, buf, off) -> int:
        h = self.mux_header()
        o = h.pack_into(buf, off)
        n_pad = self.n_bytes - (o - off)
        buf[o:o + n_pad] = bytes(n_pad)
        return o + n_pad


class UserPlaneData(MmieFlowing):
    """User plane data flows 1-4 (flowing MMIE; reference user_plane_data.cpp)."""
    IE_TYPE_BY_FLOW = {1: IeType.USER_PLANE_DATA_FLOW_1,
                       2: IeType.USER_PLANE_DATA_FLOW_2,
                       3: IeType.USER_PLANE_DATA_FLOW_3,
                       4: IeType.USER_PLANE_DATA_FLOW_4}


class HigherLayerSignalling(MmieFlowing):
    """Higher layer signalling flows 1-2 (reference higher_layer_signalling.cpp)."""
    IE_TYPE_BY_FLOW = {1: IeType.HIGHER_LAYER_SIGNALLING_FLOW_1,
                       2: IeType.HIGHER_LAYER_SIGNALLING_FLOW_2}
