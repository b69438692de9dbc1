"""Association request / response / release messages, ETSI TS 103 636-4 6.4.2.4-6.

Parity: reference lib/src/sections_part4/mac_messages_and_ie/
association_{request,response,release}_message.cpp.

Copy of `dectnrp_tpu/sections/part4/association.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..part2 import is_absolute_channel_number_in_range as _ok_ch
from .mac_pdu import IeType
from .mmie import CLUSTER_BEACON_PERIOD_MS, Mmie, NETWORK_BEACON_PERIOD_MS

# Table 6.4.2.4-1, MAX HARQ RE-TX/RE-RX delay codes
MAX_HARQ_RETX_DELAY = (
    "105us", "200us", "400us", "800us", "1ms", "2ms", "4ms", "6ms", "8ms",
    "10ms", "20ms", "30ms", "40ms", "50ms", "60ms", "70ms", "80ms", "90ms",
    "100ms", "120ms", "140ms", "160ms", "180ms", "200ms", "240ms", "280ms",
    "320ms", "360ms", "400ms", "450ms", "500ms")

SETUP_CAUSES = ("initial", "new_flows", "mobility", "error",
                "channel_changed", "mode_changed", "other")
RELEASE_CAUSES = ("connection_termination", "mobility", "long_inactivity",
                  "incompatible_configuration", "no_hw_memory", "no_radio",
                  "bad_radio_quality", "security_error", "other_error",
                  "other_reason")
REJECT_CAUSES = ("radio_capacity", "hw_capacity", "conflicting_short_rd_id",
                 "not_secure", "other")
REJECT_TIME_S = (0, 5, 10, 30, 60, 120, 180, 300, 600)

NOF_FLOWS_NONE = 0
NOF_FLOWS_AS_INCLUDED = 1
NOF_FLOWS_AS_REQUESTED = 0b111


@dataclass
class HarqConfig:
    n_processes: int = 0
    max_retx_delay_coded: int = 0

    def is_valid(self) -> bool:
        return (0 <= self.n_processes <= 7
                and 0 <= self.max_retx_delay_coded < len(MAX_HARQ_RETX_DELAY))


@dataclass
class FtConfiguration:
    network_beacon_period_coded: int = 0
    cluster_beacon_period_coded: int = 0
    next_cluster_channel: int = 0
    time_to_next: int = 0

    def is_valid(self) -> bool:
        return (self.network_beacon_period_coded < len(NETWORK_BEACON_PERIOD_MS)
                and self.cluster_beacon_period_coded < len(CLUSTER_BEACON_PERIOD_MS)
                and _ok_ch(self.next_cluster_channel))


@dataclass
class AssociationRequestMessage(Mmie):
    setup_cause: int = 0
    flow_ids: tuple[int, ...] = (3,)       # 1..6 per Table 6.3.4-2
    has_power_constraints: bool = False
    harq_tx: HarqConfig = field(default_factory=HarqConfig)
    harq_rx: HarqConfig = field(default_factory=HarqConfig)
    ft_configuration: FtConfiguration | None = None
    current_cluster_channel: int | None = None

    IE_TYPE = IeType.ASSOCIATION_REQUEST_MESSAGE
    PEEK_MIN = 2

    def is_valid(self) -> bool:
        if not (0 <= self.setup_cause < len(SETUP_CAUSES)):
            return False
        if not self.flow_ids or len(self.flow_ids) > 6 or any(
                not 1 <= f <= 6 for f in self.flow_ids):
            return False
        if self.ft_configuration is not None and not self.ft_configuration.is_valid():
            return False
        if self.current_cluster_channel is not None and not _ok_ch(self.current_cluster_channel):
            return False
        return self.harq_tx.is_valid() and self.harq_rx.is_valid()

    def packed_size(self) -> int:
        return (4 + len(self.flow_ids)
                + (self.ft_configuration is not None) * 7
                + (self.current_cluster_channel is not None) * 2)

    def pack_into(self, buf, off):
        assert self.is_valid(), "association request message is not valid"
        buf[off] = (self.setup_cause << 5) | (len(self.flow_ids) << 2) \
            | (self.has_power_constraints << 1) \
            | (self.ft_configuration is not None)
        buf[off + 1] = (self.current_cluster_channel is not None) << 7
        buf[off + 2] = (self.harq_tx.n_processes << 5) | self.harq_tx.max_retx_delay_coded
        buf[off + 3] = (self.harq_rx.n_processes << 5) | self.harq_rx.max_retx_delay_coded
        o = off + 4
        for f in self.flow_ids:
            buf[o] = f
            o += 1
        if self.ft_configuration is not None:
            ft = self.ft_configuration
            buf[o] = (ft.network_beacon_period_coded << 4) | ft.cluster_beacon_period_coded
            buf[o + 1] = ft.next_cluster_channel >> 8
            buf[o + 2] = ft.next_cluster_channel & 0xFF
            buf[o + 3:o + 7] = ft.time_to_next.to_bytes(4, "big")
            o += 7
        if self.current_cluster_channel is not None:
            buf[o] = self.current_cluster_channel >> 8
            buf[o + 1] = self.current_cluster_channel & 0xFF
            o += 2
        return o

    def unpack_from(self, buf, off) -> bool:
        self.setup_cause = buf[off] >> 5
        n_flows = (buf[off] >> 2) & 0b111
        self.has_power_constraints = bool(buf[off] & 0b10)
        in_ft_mode = bool(buf[off] & 1)
        has_current = bool(buf[off + 1] >> 7)
        self.harq_tx = HarqConfig(buf[off + 2] >> 5, buf[off + 2] & 0b11111)
        self.harq_rx = HarqConfig(buf[off + 3] >> 5, buf[off + 3] & 0b11111)
        o = off + 4
        self.flow_ids = tuple(buf[o + i] & 0b111111 for i in range(n_flows))
        o += n_flows
        self.ft_configuration = None
        self.current_cluster_channel = None
        if in_ft_mode:
            self.ft_configuration = FtConfiguration(
                buf[o] >> 4, buf[o] & 0b1111,
                ((buf[o + 1] & 0x1F) << 8) | buf[o + 2],
                int.from_bytes(bytes(buf[o + 3:o + 7]), "big"))
            o += 7
        if has_current:
            self.current_cluster_channel = ((buf[o] & 0x1F) << 8) | buf[o + 1]
            o += 2
        return self.is_valid()

    def peek_packed_size(self, buf, off):
        n_flows = (buf[off] >> 2) & 0b111
        if n_flows == 0b111:
            return None                     # reserved (reference peek_errc)
        return 4 + n_flows + (buf[off] & 1) * 7 + (buf[off + 1] >> 7) * 2


@dataclass
class AssociationResponseMessage(Mmie):
    """ACK/NACK branch: reject_info set = NACK (2 bytes), else ACK."""
    reject_cause: int | None = None
    reject_time_coded: int | None = None
    harq_configuration: tuple[HarqConfig, HarqConfig] | None = None  # (rx, tx)
    nof_flows_accepted: int = NOF_FLOWS_AS_REQUESTED
    flow_ids: tuple[int, ...] = ()
    group_info: tuple[int, int] | None = None   # (group_id, resource_tag)
    tx_power: bool = False

    IE_TYPE = IeType.ASSOCIATION_RESPONSE_MESSAGE

    @property
    def rejected(self) -> bool:
        return self.reject_cause is not None

    def is_valid(self) -> bool:
        if self.rejected:
            return (self.reject_cause < len(REJECT_CAUSES)
                    and self.reject_time_coded is not None
                    and self.reject_time_coded < len(REJECT_TIME_S))
        if self.harq_configuration is not None and not all(
                h.is_valid() for h in self.harq_configuration):
            return False
        if self.nof_flows_accepted == NOF_FLOWS_AS_INCLUDED and not self.flow_ids:
            return False
        if self.nof_flows_accepted not in (NOF_FLOWS_NONE, NOF_FLOWS_AS_INCLUDED,
                                           NOF_FLOWS_AS_REQUESTED):
            return False
        if any(not 1 <= f <= 6 for f in self.flow_ids):
            return False
        if self.group_info is not None and not all(0 <= v <= 0x7F for v in self.group_info):
            return False
        return True

    def packed_size(self) -> int:
        if self.rejected:
            return 2
        return (1 + (self.harq_configuration is not None) * 2
                + len(self.flow_ids) + (self.group_info is not None) * 2)

    def pack_into(self, buf, off):
        assert self.is_valid(), "association response message is not valid"
        if self.rejected:
            buf[off] = 0
            buf[off + 1] = (self.reject_cause << 4) | self.reject_time_coded
            return off + 2
        n_flows = (len(self.flow_ids)
                   if self.nof_flows_accepted == NOF_FLOWS_AS_INCLUDED
                   else self.nof_flows_accepted)
        buf[off] = (1 << 7) | ((self.harq_configuration is not None) << 5) \
            | (n_flows << 2) | ((self.group_info is not None) << 1) \
            | self.tx_power
        o = off + 1
        if self.harq_configuration is not None:
            for h in self.harq_configuration:       # rx first, then tx
                buf[o] = (h.n_processes << 5) | h.max_retx_delay_coded
                o += 1
        for f in self.flow_ids:
            buf[o] = f
            o += 1
        if self.group_info is not None:
            buf[o] = self.group_info[0]
            buf[o + 1] = self.group_info[1]
            o += 2
        return o

    def unpack_from(self, buf, off) -> bool:
        if not (buf[off] >> 7):
            self.reject_cause = buf[off + 1] >> 4
            self.reject_time_coded = buf[off + 1] & 0b1111
            return self.is_valid()
        self.reject_cause = self.reject_time_coded = None
        o = off + 1
        self.harq_configuration = None
        if (buf[off] >> 5) & 1:
            rx = HarqConfig(buf[o] >> 5, buf[o] & 0b11111)
            tx = HarqConfig(buf[o + 1] >> 5, buf[o + 1] & 0b11111)
            self.harq_configuration = (rx, tx)
            o += 2
        n_flows = (buf[off] >> 2) & 0b111
        self.flow_ids = ()
        if n_flows in (NOF_FLOWS_NONE, NOF_FLOWS_AS_REQUESTED):
            self.nof_flows_accepted = n_flows
        else:
            self.nof_flows_accepted = NOF_FLOWS_AS_INCLUDED
            self.flow_ids = tuple(buf[o + i] & 0b111111 for i in range(n_flows))
            o += n_flows
        self.group_info = None
        if buf[off] & 0b10:
            self.group_info = (buf[o] & 0x7F, buf[o + 1] & 0x7F)
            o += 2
        self.tx_power = bool(buf[off] & 1)
        return self.is_valid()

    def peek_packed_size(self, buf, off):
        if not (buf[off] >> 7):
            return 2
        size = 1 + ((buf[off] >> 5) & 1) * 2
        n_flows = (buf[off] >> 2) & 0b111
        if n_flows != NOF_FLOWS_AS_REQUESTED:
            size += n_flows
        size += ((buf[off] >> 1) & 1) * 2
        return size


@dataclass
class AssociationReleaseMessage(Mmie):
    release_cause: int = 0

    IE_TYPE = IeType.ASSOCIATION_RELEASE_MESSAGE

    def is_valid(self) -> bool:
        return 0 <= self.release_cause < len(RELEASE_CAUSES)

    def packed_size(self) -> int:
        return 1

    def pack_into(self, buf, off):
        assert self.is_valid()
        buf[off] = self.release_cause << 4
        return off + 1

    def unpack_from(self, buf, off) -> bool:
        self.release_cause = buf[off] >> 4
        return self.is_valid()


@dataclass
class FlowChange:
    """Setup/release entry of a reconfiguration (6.4.2.7: release bit +
    6-bit flow id)."""
    flow_id: int = 1
    is_released: bool = False

    def is_valid(self) -> bool:
        return 1 <= self.flow_id <= 6


@dataclass
class ReconfigurationRequestMessage(Mmie):
    """6.4.2.7; reference reconfiguration_request_message.cpp: octet 0 =
    harq_tx?|harq_rx?|rd_capability_follows|n_flows(3b)|radio_resource_change
    (2b), then optional HARQ TX/RX octets and one octet per flow change."""
    harq_tx: HarqConfig | None = None
    harq_rx: HarqConfig | None = None
    rd_capability_ie_follows: bool = False
    flows: tuple[FlowChange, ...] = ()
    radio_resource_change: int = 0    # 0 none, 1 reduced, 2 increased

    IE_TYPE = IeType.RECONFIGURATION_REQUEST_MESSAGE

    def is_valid(self) -> bool:
        for h in (self.harq_tx, self.harq_rx):
            if h is not None and not h.is_valid():
                return False
        if len(self.flows) > 6 or any(not f.is_valid() for f in self.flows):
            return False
        return 0 <= self.radio_resource_change <= 0b11

    def packed_size(self) -> int:
        return (1 + (self.harq_tx is not None) + (self.harq_rx is not None)
                + len(self.flows))

    def pack_into(self, buf, off):
        assert self.is_valid(), "reconfiguration request message is not valid"
        buf[off] = ((self.harq_tx is not None) << 7
                    | (self.harq_rx is not None) << 6
                    | self.rd_capability_ie_follows << 5
                    | len(self.flows) << 2
                    | self.radio_resource_change)
        o = off + 1
        for h in (self.harq_tx, self.harq_rx):
            if h is not None:
                buf[o] = (h.n_processes << 5) | h.max_retx_delay_coded
                o += 1
        for f in self.flows:
            buf[o] = (f.is_released << 7) | f.flow_id
            o += 1
        return o

    def unpack_from(self, buf, off) -> bool:
        o = off + 1
        self.harq_tx = self.harq_rx = None
        if buf[off] >> 7:
            self.harq_tx = HarqConfig(buf[o] >> 5, buf[o] & 0b11111)
            o += 1
        if (buf[off] >> 6) & 1:
            self.harq_rx = HarqConfig(buf[o] >> 5, buf[o] & 0b11111)
            o += 1
        self.rd_capability_ie_follows = bool((buf[off] >> 5) & 1)
        n_flows = (buf[off] >> 2) & 0b111
        if n_flows == 0b111:
            return False                    # reserved
        self.flows = tuple(
            FlowChange(buf[o + i] & 0b111111, bool(buf[o + i] >> 7))
            for i in range(n_flows))
        o += n_flows
        self.radio_resource_change = buf[off] & 0b11
        return self.is_valid()

    def peek_packed_size(self, buf, off) -> int | None:
        n_flows = (buf[off] >> 2) & 0b111
        if n_flows == 0b111:
            return None                     # reserved (reference peek_errc)
        return 1 + (buf[off] >> 7) + ((buf[off] >> 6) & 1) + n_flows


@dataclass
class ReconfigurationResponseMessage(Mmie):
    """6.4.2.8; reference reconfiguration_response_message.cpp: same layout
    as the request, but the 3-bit field counts ACCEPTED flows (0b111 = all
    as requested, with no flow octets)."""
    harq_tx: HarqConfig | None = None
    harq_rx: HarqConfig | None = None
    rd_capability_ie_follows: bool = False
    flows: tuple[FlowChange, ...] = ()
    accept_all_flows: bool = True           # 0b111 "as requested"
    radio_resource_change: int = 0

    IE_TYPE = IeType.RECONFIGURATION_RESPONSE_MESSAGE

    def is_valid(self) -> bool:
        for h in (self.harq_tx, self.harq_rx):
            if h is not None and not h.is_valid():
                return False
        if self.accept_all_flows and self.flows:
            return False
        if len(self.flows) > 6 or any(not f.is_valid() for f in self.flows):
            return False
        return 0 <= self.radio_resource_change <= 0b11

    def packed_size(self) -> int:
        return (1 + (self.harq_tx is not None) + (self.harq_rx is not None)
                + len(self.flows))

    def pack_into(self, buf, off):
        assert self.is_valid(), "reconfiguration response message is not valid"
        n_field = NOF_FLOWS_AS_REQUESTED if self.accept_all_flows \
            else len(self.flows)
        buf[off] = ((self.harq_tx is not None) << 7
                    | (self.harq_rx is not None) << 6
                    | self.rd_capability_ie_follows << 5
                    | n_field << 2
                    | self.radio_resource_change)
        o = off + 1
        for h in (self.harq_tx, self.harq_rx):
            if h is not None:
                buf[o] = (h.n_processes << 5) | h.max_retx_delay_coded
                o += 1
        for f in self.flows:
            buf[o] = (f.is_released << 7) | f.flow_id
            o += 1
        return o

    def unpack_from(self, buf, off) -> bool:
        o = off + 1
        self.harq_tx = self.harq_rx = None
        if buf[off] >> 7:
            self.harq_tx = HarqConfig(buf[o] >> 5, buf[o] & 0b11111)
            o += 1
        if (buf[off] >> 6) & 1:
            self.harq_rx = HarqConfig(buf[o] >> 5, buf[o] & 0b11111)
            o += 1
        self.rd_capability_ie_follows = bool((buf[off] >> 5) & 1)
        n_field = (buf[off] >> 2) & 0b111
        self.accept_all_flows = n_field == NOF_FLOWS_AS_REQUESTED
        n_flows = 0 if self.accept_all_flows else n_field
        self.flows = tuple(
            FlowChange(buf[o + i] & 0b111111, bool(buf[o + i] >> 7))
            for i in range(n_flows))
        o += n_flows
        self.radio_resource_change = buf[off] & 0b11
        return self.is_valid()

    def peek_packed_size(self, buf, off) -> int | None:
        n_field = (buf[off] >> 2) & 0b111
        n_flows = 0 if n_field == NOF_FLOWS_AS_REQUESTED else n_field
        return 1 + (buf[off] >> 7) + ((buf[off] >> 6) & 1) + n_flows
