"""DLC + CVG layers, ETSI TS 103 636-5 (reference lib/*/sections_part5_dlc
+ sections_part5_cvg, ~200 LoC of skeletal headers — the layers are declared
"future work" in README.md:215; lib/src/cvg/test/cvg.cpp exercises the stub).

Here the part the reference stubs is made functional at codec level: the
DLC PDU header formats (service type 0 transparent / type 1 with sequence
number and segmentation, 5.3.2/5.3.3) with a reassembly engine, and the
CVG header (6.3). ARQ/flow-control procedures stay out of scope, matching
the reference.

Copy of `dectnrp_tpu/sections/part5.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum


class DlcIeType(IntEnum):
    """DLC IE type (Table 5.3.1-1)."""
    DATA_TYPE_0 = 0b0000           # transparent, no SN
    DATA_TYPE_1 = 0b0001           # with SN + segmentation
    DATA_TYPE_2 = 0b0010           # type 0 + routing header
    DATA_TYPE_3 = 0b0011           # type 1 + routing header
    TIMERS_CONFIG = 0b0100


class SegmentationIndication(IntEnum):
    """SI field (Table 5.3.3-1)."""
    COMPLETE = 0b00
    FIRST = 0b01
    LAST = 0b10
    MIDDLE = 0b11


@dataclass
class DlcPdu:
    """DLC data PDU: type 0 = 1-byte header; type 1 = 2-byte header
    (IEType(4)|SI(2)|SN(10)) + 2-byte segmentation offset for LAST/MIDDLE."""
    ie_type: DlcIeType = DlcIeType.DATA_TYPE_0
    si: SegmentationIndication = SegmentationIndication.COMPLETE
    sequence_number: int = 0       # 10 bits
    segmentation_offset: int = 0   # 16 bits (bytes), LAST/MIDDLE only
    data: bytes = b""

    @property
    def has_sn(self) -> bool:
        return self.ie_type in (DlcIeType.DATA_TYPE_1, DlcIeType.DATA_TYPE_3)

    @property
    def has_offset(self) -> bool:
        return self.has_sn and self.si in (SegmentationIndication.LAST,
                                           SegmentationIndication.MIDDLE)

    def header_size(self) -> int:
        if not self.has_sn:
            return 1
        return 4 if self.has_offset else 2

    def pack(self) -> bytes:
        assert 0 <= self.sequence_number <= 0x3FF
        assert 0 <= self.segmentation_offset <= 0xFFFF
        if not self.has_sn:
            return bytes([int(self.ie_type) << 4]) + self.data
        b0 = (int(self.ie_type) << 4) | (int(self.si) << 2) \
            | (self.sequence_number >> 8)
        hdr = bytes([b0, self.sequence_number & 0xFF])
        if self.has_offset:
            hdr += self.segmentation_offset.to_bytes(2, "big")
        return hdr + self.data

    @classmethod
    def unpack(cls, buf: bytes) -> "DlcPdu | None":
        if not buf:
            return None
        try:
            ie = DlcIeType(buf[0] >> 4)
        except ValueError:
            return None
        p = cls(ie_type=ie)
        if not p.has_sn:
            p.data = bytes(buf[1:])
            return p
        if len(buf) < 2:
            return None
        p.si = SegmentationIndication((buf[0] >> 2) & 0b11)
        p.sequence_number = ((buf[0] & 0b11) << 8) | buf[1]
        off = 2
        if p.has_offset:
            if len(buf) < 4:
                return None
            p.segmentation_offset = int.from_bytes(buf[2:4], "big")
            off = 4
        p.data = bytes(buf[off:])
        return p


def segment_sdu(sdu: bytes, max_pdu_bytes: int,
                sn: int) -> list[DlcPdu]:
    """Split one higher-layer SDU into DLC type-1 PDUs of at most
    max_pdu_bytes (header included), 5.3.3 segmentation."""
    assert max_pdu_bytes >= 8
    if len(sdu) + 2 <= max_pdu_bytes:
        return [DlcPdu(DlcIeType.DATA_TYPE_1,
                       SegmentationIndication.COMPLETE, sn, 0, sdu)]
    out: list[DlcPdu] = []
    pos = 0
    first_payload = max_pdu_bytes - 2
    out.append(DlcPdu(DlcIeType.DATA_TYPE_1, SegmentationIndication.FIRST,
                      sn, 0, sdu[:first_payload]))
    pos = first_payload
    payload = max_pdu_bytes - 4
    while pos < len(sdu):
        last = pos + payload >= len(sdu)
        si = SegmentationIndication.LAST if last \
            else SegmentationIndication.MIDDLE
        out.append(DlcPdu(DlcIeType.DATA_TYPE_1, si, sn, pos,
                          sdu[pos:pos + payload]))
        pos += payload
    return out


class Reassembler:
    """Per-SN reassembly of segmented DLC type-1 PDUs (receive side of
    5.3.3). Out-of-order tolerant; returns the SDU when complete."""

    def __init__(self):
        self._parts: dict[int, dict] = {}

    def push(self, pdu: DlcPdu) -> bytes | None:
        if pdu.si is SegmentationIndication.COMPLETE:
            return pdu.data
        st = self._parts.setdefault(
            pdu.sequence_number, {"segs": {}, "total": None})
        off = 0 if pdu.si is SegmentationIndication.FIRST \
            else pdu.segmentation_offset
        st["segs"][off] = pdu.data
        if pdu.si is SegmentationIndication.LAST:
            st["total"] = off + len(pdu.data)
        if st["total"] is not None:
            have = sorted(st["segs"].items())
            buf = bytearray(st["total"])
            covered = 0
            for o, d in have:
                buf[o:o + len(d)] = d
                covered += len(d)
            if covered >= st["total"]:
                del self._parts[pdu.sequence_number]
                return bytes(buf)
        return None


class CvgIeType(IntEnum):
    """CVG IE type (Table 6.3.2-1)."""
    DATA = 0b0000
    DATA_EP = 0b0001               # with endpoint mux
    TX_SERVICES = 0b0010


@dataclass
class CvgHeader:
    """CVG header (6.3): IEType(4)|Reserved(2)|EP-present(1)|SN-present(1)
    [+ EP byte][+ 2-byte SN]. The reference's cvg layer forwards payloads
    transparently; so does this codec."""
    ie_type: CvgIeType = CvgIeType.DATA
    endpoint: int | None = None
    sequence_number: int | None = None

    def pack(self) -> bytes:
        b0 = (int(self.ie_type) << 4) \
            | ((self.endpoint is not None) << 1) \
            | (self.sequence_number is not None)
        out = bytearray([b0])
        if self.endpoint is not None:
            out.append(self.endpoint & 0xFF)
        if self.sequence_number is not None:
            out += int(self.sequence_number).to_bytes(2, "big")
        return bytes(out)

    @classmethod
    def unpack(cls, buf: bytes) -> "tuple[CvgHeader, int] | None":
        if not buf:
            return None
        try:
            ie = CvgIeType(buf[0] >> 4)
        except ValueError:
            return None
        h = cls(ie_type=ie)
        off = 1
        if (buf[0] >> 1) & 1:
            h.endpoint = buf[off]
            off += 1
        if buf[0] & 1:
            h.sequence_number = int.from_bytes(buf[off:off + 2], "big")
            off += 2
        return h, off
