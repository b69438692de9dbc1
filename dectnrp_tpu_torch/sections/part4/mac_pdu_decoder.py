"""Incremental MAC PDU decoder state machine, ETSI TS 103 636-4 6.4.3.8.

Parity: reference lib/src/sections_part4/mac_pdu/mac_pdu_decoder.cpp -- a
byte-driven machine (MAC_HEADER_TYPE -> MAC_COMMON_HEADER -> loop(MUX_HEADER
peek -> MMIE unpack) -> DONE / PREMATURE_ABORT) re-invoked by the FEC after
each decoded codeblock with the current write counter. A padding IE
terminates MMIE parsing (6.4.3.8). User-plane / higher-layer-signalling
payloads are captured as bytes.

Copy of `dectnrp_tpu/sections/part4/mac_pdu_decoder.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum, auto

from .association import (AssociationReleaseMessage, AssociationRequestMessage,
                          AssociationResponseMessage,
                          ReconfigurationRequestMessage,
                          ReconfigurationResponseMessage)
from .ies import (BroadcastIndicationIE, ConfigurationRequestIE,
                  HigherLayerSignalling, MacSecurityInfoIE,
                  RandomAccessResourceIE, RadioDeviceStatusIE,
                  RdCapabilityIE, ResourceAllocationIE, RouteInfoIE,
                  UserPlaneData)
from .ies2 import (GroupAssignmentIE, LoadInfoIE, MeasurementReportIE,
                   NeighbouringIE, PowerTargetIE, TimeAnnounceIE)
from .mac_pdu import (COMMON_HEADER_CLS, IeType, IeTypeShortLen0,
                      IeTypeShortLen1, MacExt, MacHeaderKind, MacHeaderType,
                      MuxHeader)
from .mmie import ClusterBeaconMessage, NetworkBeaconMessage

# IE type -> MMIE class (the RX activation registry; reference
# mac_multiplexing_header.cpp ACTIVATE_* blocks)
MMIE_REGISTRY = {
    IeType.NETWORK_BEACON_MESSAGE: NetworkBeaconMessage,
    IeType.CLUSTER_BEACON_MESSAGE: ClusterBeaconMessage,
    IeType.ASSOCIATION_REQUEST_MESSAGE: AssociationRequestMessage,
    IeType.ASSOCIATION_RESPONSE_MESSAGE: AssociationResponseMessage,
    IeType.ASSOCIATION_RELEASE_MESSAGE: AssociationReleaseMessage,
    IeType.RECONFIGURATION_REQUEST_MESSAGE: ReconfigurationRequestMessage,
    IeType.RECONFIGURATION_RESPONSE_MESSAGE: ReconfigurationResponseMessage,
    IeType.SECURITY_INFO_IE: MacSecurityInfoIE,
    IeType.ROUTE_INFO_IE: RouteInfoIE,
    IeType.RESOURCE_ALLOCATION_IE: ResourceAllocationIE,
    IeType.RANDOM_ACCESS_RESOURCE_IE: RandomAccessResourceIE,
    IeType.RD_CAPABILITY_IE: RdCapabilityIE,
    IeType.NEIGHBOURING_IE: NeighbouringIE,
    IeType.BROADCAST_INDICATION_IE: BroadcastIndicationIE,
    IeType.GROUP_ASSIGNMENT_IE: GroupAssignmentIE,
    IeType.LOAD_INFO_IE: LoadInfoIE,
    IeType.MEASUREMENT_REPORT_IE: MeasurementReportIE,
    IeType.POWER_TARGET_IE: PowerTargetIE,
    IeType.TIME_ANNOUNCE_IE: TimeAnnounceIE,
}
FLOWING_REGISTRY = {
    IeType.USER_PLANE_DATA_FLOW_1: (UserPlaneData, 1),
    IeType.USER_PLANE_DATA_FLOW_2: (UserPlaneData, 2),
    IeType.USER_PLANE_DATA_FLOW_3: (UserPlaneData, 3),
    IeType.USER_PLANE_DATA_FLOW_4: (UserPlaneData, 4),
    IeType.HIGHER_LAYER_SIGNALLING_FLOW_1: (HigherLayerSignalling, 1),
    IeType.HIGHER_LAYER_SIGNALLING_FLOW_2: (HigherLayerSignalling, 2),
}
# mu-dependent MMIEs (field widths depend on subcarrier scaling factor)
_MU_DEPENDING = (ClusterBeaconMessage, ResourceAllocationIE,
                 RandomAccessResourceIE)


class DecoderState(Enum):
    MAC_HEADER_TYPE = auto()
    MAC_COMMON_HEADER = auto()
    MUX_HEADER_PEEK = auto()
    MUX_HEADER_LENGTH = auto()
    MMIE_PEEK = auto()
    MMIE_UNPACK = auto()
    DONE = auto()
    ABORTED = auto()


class MacPduDecoder:
    """Feed with (buf, n_written) as bytes arrive; inspect .mmies when done.

    One instance per transport block; a padding IE or the TB end completes
    parsing. Premature abort (malformed input) leaves already-decoded MMIEs
    available, matching the reference's keep-what-parsed behavior.
    """

    def __init__(self, tb_size_bytes: int, mu: int = 1):
        self.tb_size = tb_size_bytes
        self.mu = mu
        self.state = DecoderState.MAC_HEADER_TYPE
        self.r = 0
        self.header_type: MacHeaderType | None = None
        self.common_header = None
        self.mmies: list = []
        self._mmh: MuxHeader | None = None
        self._mmie = None
        self._need = MacHeaderType.SIZE

    @property
    def finished(self) -> bool:
        return self.state in (DecoderState.DONE, DecoderState.ABORTED)

    @property
    def aborted(self) -> bool:
        return self.state == DecoderState.ABORTED

    def feed(self, buf, written: int) -> None:
        """Advance as far as `written` decoded bytes allow."""
        while not self.finished:
            if self.r + self._need > self.tb_size:
                self.state = DecoderState.ABORTED
                return
            if written - self.r < self._need:
                return                        # wait for more bytes
            handler = getattr(self, "_st_" + self.state.name.lower())
            handler(buf)

    # --- states ------------------------------------------------------------
    def _st_mac_header_type(self, buf):
        mht = MacHeaderType()
        if not mht.unpack_from(buf, self.r):
            self.state = DecoderState.ABORTED
            return
        self.header_type = mht
        self.r += 1
        cls = COMMON_HEADER_CLS.get(mht.mac_header_type)
        if cls is None:
            self.state = DecoderState.ABORTED
            return
        self.common_header = cls()
        self._need = cls.SIZE
        self.state = DecoderState.MAC_COMMON_HEADER

    def _st_mac_common_header(self, buf):
        if not self.common_header.unpack_from(buf, self.r):
            self.common_header = None
            self.state = DecoderState.ABORTED
            return
        self.r += self.common_header.SIZE
        self._to_next_mux()

    def _to_next_mux(self):
        if self.r >= self.tb_size:
            self.state = DecoderState.DONE
            return
        self._need = 1
        self.state = DecoderState.MUX_HEADER_PEEK

    def _st_mux_header_peek(self, buf):
        mmh = MuxHeader()
        # full header size is known from byte 0; may need 1-2 more bytes
        ext = MacExt((buf[self.r] >> 6) & 0b11)
        size = {MacExt.LENGTH_8BIT: 2, MacExt.LENGTH_16BIT: 3}.get(ext, 1)
        if size > 1:
            self._need = size
            self.state = DecoderState.MUX_HEADER_LENGTH
            return
        self._finish_mux_header(buf, mmh)

    def _st_mux_header_length(self, buf):
        self._finish_mux_header(buf, MuxHeader())

    def _finish_mux_header(self, buf, mmh: MuxHeader):
        if not mmh.unpack_from(buf, self.r):
            self.state = DecoderState.ABORTED
            return
        # padding terminates MMIE parsing (6.4.3.8)
        if mmh.mac_ext == MacExt.LENGTH_1BIT:
            if (mmh.length == 0 and mmh.ie_type == int(IeTypeShortLen0.PADDING_IE)) \
               or (mmh.length == 1 and mmh.ie_type == int(IeTypeShortLen1.PADDING_IE)):
                self.state = DecoderState.DONE
                return
        elif mmh.ie_type == int(IeType.PADDING_IE):
            self.state = DecoderState.DONE
            return
        self.r += mmh.packed_size()
        self._mmh = mmh
        if mmh.mac_ext == MacExt.LENGTH_1BIT:
            if mmh.length == 1 and mmh.ie_type == int(
                    IeTypeShortLen1.RADIO_DEVICE_STATUS_IE):
                self._mmie = RadioDeviceStatusIE()
                self._need = 1
                self.state = DecoderState.MMIE_UNPACK
                return
            if mmh.length == 0 and mmh.ie_type == int(
                    IeTypeShortLen0.CONFIGURATION_REQUEST_IE):
                self.mmies.append(ConfigurationRequestIE())
                self._to_next_mux()
                return
            self.state = DecoderState.ABORTED
            return
        try:
            ie_type = IeType(mmh.ie_type)
        except ValueError:
            self.state = DecoderState.ABORTED
            return
        if ie_type in FLOWING_REGISTRY:
            if mmh.length is None:
                self.state = DecoderState.ABORTED
                return
            cls, flow = FLOWING_REGISTRY[ie_type]
            self._mmie = cls(flow)
            self._need = mmh.length
            self.state = DecoderState.MMIE_UNPACK
            return
        cls = MMIE_REGISTRY.get(ie_type)
        if cls is None:
            self.state = DecoderState.ABORTED
            return
        self._mmie = cls()
        if cls in _MU_DEPENDING:
            self._mmie.mu = self.mu
        if mmh.length is not None:
            self._need = mmh.length
            self.state = DecoderState.MMIE_UNPACK
        else:
            self._need = self._mmie.PEEK_MIN
            self.state = DecoderState.MMIE_PEEK

    def _st_mmie_peek(self, buf):
        size = self._mmie.peek_packed_size(buf, self.r)
        if size is None:
            self.state = DecoderState.ABORTED
            return
        self._need = size
        self.state = DecoderState.MMIE_UNPACK

    def _st_mmie_unpack(self, buf):
        m = self._mmie
        if isinstance(m, (UserPlaneData, HigherLayerSignalling)):
            m.data = bytes(buf[self.r:self.r + self._need])
            ok = True
        elif isinstance(m, GroupAssignmentIE):
            ok = m.unpack_from(buf, self.r, self._need)
        else:
            ok = m.unpack_from(buf, self.r)
        if not ok:
            self.state = DecoderState.ABORTED
            return
        self.mmies.append(m)
        self.r += self._need
        self._mmie = None
        self._to_next_mux()


def decode_mac_pdu(data: bytes, mu: int = 1) -> MacPduDecoder:
    """One-shot convenience: decode a complete MAC PDU byte string."""
    dec = MacPduDecoder(len(data), mu)
    dec.feed(data, len(data))
    return dec


def build_mac_pdu(header_type: MacHeaderType, common_header, mmies,
                  tb_size_bytes: int | None = None) -> bytes:
    """Pack header + common header + MMIEs (+ padding to tb_size if given)."""
    from .ies import PaddingIE
    n = MacHeaderType.SIZE + common_header.SIZE \
        + sum(m.packed_size_mmh_sdu() for m in mmies)
    total = tb_size_bytes if tb_size_bytes is not None else n
    assert total >= n, "MAC PDU exceeds transport block"
    buf = bytearray(total)
    off = header_type.pack_into(buf, 0)
    off = common_header.pack_into(buf, off)
    for m in mmies:
        off = m.pack_mmh_sdu_into(buf, off)
    if total > off:
        PaddingIE(total - off).pack_mmh_sdu_into(buf, off)
    return bytes(buf)
