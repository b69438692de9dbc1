"""The port's real-IQ ingress end to end (tests/test_iq_ingress.py mirrored):
a cf32 file at the SDR rate (1.92 Ms/s) -> native producer thread -> native
ring -> the port's NodeRuntime on the CPU (the streaming 9/10 polyphase
front end) -> sync -> decode; the paced UDP egress looped back into the UDP
ingress; and the parity case: the JAX package's HwIqStream + NodeRuntime and
the port's decide alike on the same recorded file (equal RuntimeStats,
detection times and TBs).

Every UDP port is an ephemeral one (`on_free_port`), and every loop has a
wall-clock deadline. The paced loopback asserts only what does not depend on
the runtime's speed: the wire (each burst in the ring bit for bit at its
scheduled time, no malformed datagram, no late burst); the decode of the
same samples runs on a free-running stream.
"""
import time

import numpy as np
import pytest
import torch

from dectnrp_tpu_torch.common.native import native_available
from dectnrp_tpu_torch.iq_check import (IDENT, RATE, drain, ingress_stream,
                                        on_free_port, packet_bursts, run_file)
from dectnrp_tpu_torch.runtime_check import RxCounter
from dectnrp_tpu_torch.upper.runtime import NodeRuntime, ResampledFrontEnd

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _toolchain():
    if not native_available():
        pytest.skip("native runtime unavailable (no g++)")


def jax_counter(payloads):
    """runtime_check.RxCounter's records on the JAX package's tpoint."""
    from dectnrp_tpu.upper import tpoint as tp

    class Counter(tp.Tpoint):
        def __init__(self):
            super().__init__()
            self.tb_match = 0
            self.detection_times, self.tbs = [], []

        def work_pcc(self, phy_maclow):
            self.detection_times.append(phy_maclow.sync_report.fine_peak_time)
            rep = phy_maclow.pcc_report
            if rep.plcf is None or \
                    rep.plcf.transmitter_identity != IDENT.short_rdid:
                return tp.MacLowPhy()
            return self.worksub_pcc2pdc(phy_maclow, rep.plcf_type,
                                        IDENT.network_id)

        def work_pdc(self, phy_machigh):
            got = phy_machigh.pdc_report.tb_bits
            self.tbs.append(got)
            self.tb_match += any(np.array_equal(got, p) for p in payloads)
            return tp.MacHighPhy()
    return Counter()


def record_file(tmp_path):
    """The ingress file (iq_check.ingress_stream: three packets at 25 dB,
    the port's TX and 10/9 resampler on the CPU): (path, payloads, total)."""
    from dectnrp_tpu_torch.radio.hw_iq import write_iq_file

    stream, payloads = ingress_stream(device="cpu")
    path = tmp_path / "ingress_1p92.cf32"
    write_iq_file(path, stream, spp=2048)
    return path, payloads, stream.shape[-1]


def test_iq_file_ingress_decodes(tmp_path):
    path, payloads, total = record_file(tmp_path)
    hw, rt, fw = run_file(path, payloads, "cpu")
    assert isinstance(rt.front_end, ResampledFrontEnd)     # 10/9 resampler
    assert hw.eof
    assert hw.rx_time_passed >= total - 2048    # producer delivered the file
    assert fw.tb_match == len(payloads), \
        (fw.pdc, fw.tb_match, rt.stats, hw.read_overruns)
    assert hw.read_overruns == 0


def drain_jax(rt, hw, timeout_s: float = 120.0) -> None:
    """The JAX runtime over a free-running stream until it is read and
    decoded (tests/test_iq_ingress.py's loop: one JAX process() call
    consumes all that arrives while it runs)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        eof = hw.eof
        rt.process()
        if eof and rt._dect_time_passed - rt._processed < 4096 \
                and not rt._pending and not rt._pending_pdc:
            return
        time.sleep(0.002)
    raise RuntimeError(f"stream not drained in {timeout_s} s ({rt.stats})")


def test_iq_file_ingress_decides_as_jax(tmp_path):
    """The JAX package's HwIqStream + NodeRuntime and the port's on the
    same recorded file: equal RuntimeStats, detection times and TBs."""
    from dectnrp_tpu.radio.hw_iq import HwIqStream as JHw
    from dectnrp_tpu.upper.runtime import NodeRuntime as JRt
    from dectnrp_tpu_torch.radio.hw_iq import HwIqStream

    path, payloads, _ = record_file(tmp_path)
    runs = []
    for hw_cls, rt_cls, fw_cls, kw, run in (
            (JHw, JRt, jax_counter, {}, drain_jax),
            (HwIqStream, NodeRuntime, RxCounter, {"device": "cpu"}, drain)):
        hw = hw_cls(path, samp_rate=RATE, spp=2048, realtime=False)
        fw = fw_cls(payloads)
        rt = rt_cls(hw, fw, IDENT.network_id, hw_samp_rate=RATE, **kw)
        try:
            run(rt, hw)
        finally:
            hw.close()
        assert hw.read_overruns == 0
        runs.append((rt, fw))
    (rj, fj), (rt, ft) = runs
    assert vars(rt.stats) == vars(rj.stats)
    assert rt.stats.pdc_ok == ft.tb_match == len(payloads), rt.stats
    assert ft.detection_times == fj.detection_times
    assert len(ft.tbs) == len(fj.tbs)
    for a, b in zip(ft.tbs, fj.tbs):
        np.testing.assert_array_equal(a, b)


def test_iq_producer_realtime_pacing(tmp_path):
    """Paced mode: delivery takes about file_len/rate seconds and counts few
    late chunks on an idle consumer."""
    from dectnrp_tpu_torch.radio.hw_iq import HwIqStream, write_iq_file

    n = 384_000                             # 0.2 s of IQ
    rng = np.random.default_rng(0)
    iq = (rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n)))
    path = tmp_path / "pace.cf32"
    write_iq_file(path, iq.astype(np.complex64), spp=2048)
    hw = HwIqStream(path, samp_rate=RATE, spp=2048, realtime=True)
    t0 = time.time()
    while not hw.eof and time.time() - t0 < 10.0:
        time.sleep(0.01)
    dt = time.time() - t0
    assert hw.eof
    assert dt >= 0.15, f"paced delivery finished too fast ({dt:.3f}s)"
    # late chunks are telemetry: each stall of a loaded host counts once
    assert hw.late_chunks <= 20, hw.late_chunks
    hw.close()


def test_ring_overrun_recovery(tmp_path):
    """A producer that laps the reader must not kill the port's runtime:
    _pump skips to the oldest sample still in the ring, zero-fills the lost
    span, counts read_overruns and keeps consuming (the reference's
    overflow recovery, hw_usrp.cpp:1093-1219)."""
    from dectnrp_tpu_torch.radio.hw_iq import HwIqStream, write_iq_file

    n = 768_000                             # 0.4 s of IQ
    rng = np.random.default_rng(3)
    iq = (rng.standard_normal((1, n)) + 1j * rng.standard_normal((1, n)))
    path = tmp_path / "overrun.cf32"
    write_iq_file(path, 0.01 * iq.astype(np.complex64), spp=2048)
    # paced producer + tiny ring (wraps every ~8.5 ms) + reader that sleeps
    # 100 ms before its first read: the overrun is guaranteed
    hw = HwIqStream(path, samp_rate=RATE, spp=2048, ring_len=16384,
                    realtime=True)
    rt = NodeRuntime(hw, RxCounter([]), IDENT.network_id, hw_samp_rate=RATE,
                     device="cpu")
    try:
        time.sleep(0.1)
        deadline = time.time() + 60.0
        while time.time() < deadline:
            eof = hw.eof
            rt.process()                    # must never raise on overrun
            if rt.caught_up(eof):
                break
            time.sleep(0.002)
        assert hw.eof
        assert hw.read_overruns > 0, "test did not exercise the overrun path"
        assert rt.caught_up(True), rt.stats
        assert hw.rx_time_passed == n, hw.rx_time_passed
        assert rt.stats.chunks > 0
    finally:
        hw.close()


def test_socket_egress_loopback_decodes(tmp_path):
    """Full-duplex network radio: three bursts through the paced TX egress
    over a UDP socket, looped back into the UDP ingress (the wire is the
    ether). The wire is checked on the ring: each burst bit for bit at its
    scheduled time, nothing malformed, nothing late. The runtime then
    decodes those samples, the ring's span fed to a free-running
    HwIqStream: what a paced runtime decodes depends on its speed, what it
    decides does not."""
    from dectnrp_tpu_torch.radio.hw_iq import (HwIqSocket, HwIqStream,
                                               write_iq_file)

    bursts, payloads, _ = packet_bursts(3, 11, "cpu")
    n_up = bursts[0].shape[-1]
    hw = on_free_port(lambda p: HwIqSocket(
        rx_port=p, samp_rate=RATE, tx_sink=f"udp:{p}", ring_len=1 << 20))
    try:
        # in order, spaced, ~0.3 s ahead of the egress cursor
        base = hw.tx_time_emitted + int(0.3 * RATE)
        gap = 16384
        times = [base + i * (n_up + gap) for i in range(len(bursts))]
        for t, b in zip(times, bursts):
            hw.tx_schedule(t, b)
        end = times[-1] + n_up + gap
        deadline = time.time() + 30.0
        while hw.rx_time_passed < end and time.time() < deadline:
            time.sleep(0.01)
        assert hw.rx_time_passed >= end, (hw.rx_time_passed, end)
        assert hw.producer.malformed == 0
        assert hw.txc.late_bursts == 0, hw.txc.late_bursts
        assert hw.txc.send_errors == 0
        t0 = times[0] - 2 * gap
        span = hw.get_rx_stream(t0, end - t0)
    finally:
        hw.close()
    for t, b in zip(times, bursts):
        np.testing.assert_array_equal(span[:, t - t0:t - t0 + n_up], b)
    # the same samples, free-running, through the runtime
    path = tmp_path / "wire.cf32"
    write_iq_file(path, span, spp=2048)
    hs = HwIqStream(path, samp_rate=RATE, spp=2048, realtime=False)
    fw = RxCounter(payloads)
    rt = NodeRuntime(hs, fw, IDENT.network_id, hw_samp_rate=RATE, device="cpu")
    try:
        drain(rt, hs)
    finally:
        hs.close()
    assert fw.tb_match == len(payloads), (fw.tb_match, rt.stats)


def test_udp_egress_multiant_chunk_split():
    """A 4-antenna spp=2048 TX chunk is 65536 B, over the 65507 B UDP
    payload maximum: the egress splits chunks into whole-sample datagrams
    in the ingress layout ([ant][n][2]) so nothing is lost to EMSGSIZE."""
    from dectnrp_tpu_torch.common.native import (NativeIqSocketProducer,
                                                 NativeRingBuffer,
                                                 NativeTxConsumer)

    n_ant, spp = 4, 2048
    ring = NativeRingBuffer(1 << 20, n_ant)
    prod, port = on_free_port(lambda p: (NativeIqSocketProducer(
        ring, p, max_samples_per_dgram=4096), p))
    # deferred start: the emit clock begins only at txc.start(), so the
    # burst scheduled at t0 cannot race the free-running cursor
    txc = NativeTxConsumer(f"udp:{port}", n_ant=n_ant, spp=spp,
                           rate_hz=1_000_000.0, deferred_start=True)
    try:
        rng = np.random.default_rng(5)
        n = 3000                           # burst spans two chunks
        burst = (rng.standard_normal((n_ant, n))
                 + 1j * rng.standard_normal((n_ant, n))).astype(np.complex64)
        t0 = 2048
        txc.schedule(0, t0, burst)
        txc.start()
        deadline = time.time() + 10.0
        while time.time() < deadline and ring.time < t0 + n + spp:
            time.sleep(0.02)
        assert ring.time >= t0 + n, f"ingress saw only {ring.time} samples"
        got = ring.read(t0, n)
        assert txc.send_errors == 0
        assert prod.malformed == 0
        np.testing.assert_array_equal(got, burst)
    finally:
        txc.close()
        ring.close()
