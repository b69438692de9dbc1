"""sections/part5 (DLC / CVG codecs and segmentation) and the common
infrastructure (watch, JSON export, logging, TCP scope), mirrored on the
port's copies (tests/test_part5_common.py). The codec cases also hold the
port's wire bytes equal to the JAX package's.

Oracles: ETSI TS 103 636-5 header layouts; reference lib/src/cvg/test/
cvg.cpp (round trip), common/json/json_export.hpp (batching).
"""
import json
import os
import socket
import time

import numpy as np
import pytest

from dectnrp_tpu.sections import part5 as J
from dectnrp_tpu_torch.sections.part5 import (CvgHeader, CvgIeType, DlcIeType,
                                              DlcPdu, Reassembler,
                                              SegmentationIndication,
                                              segment_sdu)


def test_dlc_type0_roundtrip():
    p = DlcPdu(DlcIeType.DATA_TYPE_0, data=b"hello world")
    q = DlcPdu.unpack(p.pack())
    assert q.ie_type is DlcIeType.DATA_TYPE_0 and q.data == b"hello world"
    assert p.header_size() == 1
    assert p.pack() == J.DlcPdu(J.DlcIeType.DATA_TYPE_0, data=b"hello world").pack()


def test_dlc_type1_roundtrip_all_si():
    for si in SegmentationIndication:
        p = DlcPdu(DlcIeType.DATA_TYPE_1, si, sequence_number=0x2AB,
                   segmentation_offset=0x1234, data=b"\x01\x02\x03")
        q = DlcPdu.unpack(p.pack())
        assert q.si is si and q.sequence_number == 0x2AB
        assert q.data == b"\x01\x02\x03"
        if p.has_offset:
            assert q.segmentation_offset == 0x1234
        assert p.pack() == J.DlcPdu(
            J.DlcIeType.DATA_TYPE_1, J.SegmentationIndication[si.name],
            sequence_number=0x2AB, segmentation_offset=0x1234,
            data=b"\x01\x02\x03").pack()


@pytest.mark.parametrize("n", [10, 100, 1000, 5000])
def test_dlc_segmentation_reassembly(n):
    rng = np.random.default_rng(n)
    sdu = rng.integers(0, 256, n).astype(np.uint8).tobytes()
    pdus = segment_sdu(sdu, max_pdu_bytes=128, sn=7)
    assert [p.pack() for p in pdus] == [
        p.pack() for p in J.segment_sdu(sdu, max_pdu_bytes=128, sn=7)]
    pdus = [DlcPdu.unpack(p.pack()) for p in pdus]
    r = Reassembler()
    got = None
    order = list(range(len(pdus)))
    rng.shuffle(order)                    # delivered out of order
    for i in order:
        res = r.push(pdus[i])
        if res is not None:
            got = res
    assert got == sdu


def test_cvg_header_roundtrip():
    for h in (CvgHeader(CvgIeType.DATA),
              CvgHeader(CvgIeType.DATA_EP, endpoint=5),
              CvgHeader(CvgIeType.DATA, endpoint=3, sequence_number=999)):
        packed = h.pack() + b"payload"
        h2, off = CvgHeader.unpack(packed)
        assert h2.ie_type is h.ie_type
        assert h2.endpoint == h.endpoint
        assert h2.sequence_number == h.sequence_number
        assert packed[off:] == b"payload"
        assert h.pack() == J.CvgHeader(J.CvgIeType[h.ie_type.name], h.endpoint,
                                       h.sequence_number).pack()


def test_watch():
    from dectnrp_tpu_torch.common import Watch

    w = Watch()
    assert w.get_elapsed_ns() >= 0
    assert not w.is_elapsed(10.0)
    assert Watch.tai_now_ns() > time.time_ns()          # TAI ahead of UTC
    assert Watch.next_full_second_ns(1_500_000_000, 1) == 2_000_000_000


def test_json_export(tmp_path):
    from dectnrp_tpu_torch.common import JsonExport

    ex = JsonExport(str(tmp_path), "rec", batch_len=3)
    for i in range(7):
        ex.append({"i": i, "arr": np.arange(2), "c": np.array([1 + 2j])})
    ex.flush()
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 3             # 3 + 3 + 1
    with open(tmp_path / files[0]) as f:
        recs = json.load(f)
    assert recs[0]["i"] == 0 and recs[0]["arr"] == [0, 1]
    assert recs[0]["c"] == {"re": [1.0], "im": [2.0]}
    assert ex.written == 7


def test_logging(tmp_path):
    from dectnrp_tpu_torch.common import logging as dlog

    p = str(tmp_path / "log.txt")
    dlog.log_setup(p)
    dlog.log_inf("hello %d", 42)
    dlog.log_wrn("warn")
    dlog.log_save()
    text = open(p).read()
    assert "hello 42" in text and "warn" in text
    with pytest.raises(dlog.DectAssertError, match="bad x=3"):
        dlog.dectnrp_assert(False, "bad x=%d", 3)


def test_tcp_scope():
    """The scope listens on an ephemeral port: a push before a client is
    dropped, the next after it arrives is delivered bit for bit."""
    from dectnrp_tpu_torch.common.tcp_scope import TcpScope

    sc = TcpScope()
    try:
        assert sc.port > 0
        iq = (np.arange(8) + 1j * np.arange(8)).astype(np.complex64)
        assert not sc.push(iq)             # no client yet -> dropped
        cli = socket.create_connection(("127.0.0.1", sc.port))
        assert sc.push(iq)                 # accepted on this push
        got = b""
        while len(got) < iq.nbytes:
            got += cli.recv(4096)
        assert np.array_equal(np.frombuffer(got, np.complex64), iq)
        cli.close()
    finally:
        sc.close()
