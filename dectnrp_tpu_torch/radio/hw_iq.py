"""Real-IQ ingress radio: recorded/streamed cf32 files through the native
ring into the runtime (a copy of dectnrp_tpu/radio/hw_iq.py; its rings
stay on the host, and NodeRuntime moves each block to its device).

The missing `hw_usrp_t` analog for this environment (no RF hardware): where
the reference's USRP RX streamer thread fills `buffer_rx_t`
(lib/src/radio/hw_usrp.cpp:1093-1219), `HwIqStream` runs the native
IqProducer thread (native/dectnrp_rt.cc iqp_*) which paces a cf32 file into
the native C++ ring at the SDR sample rate; `NodeRuntime` consumes it
through the standard `get_rx_stream`/`rx_time_passed` radio interface (and
resamples SDR->DECT in `_pump` exactly as for `HwSimulator`).

TX side: scheduled bursts are recorded (`tx_bursts`) and optionally appended
to an output cf32 file — the loop-less analog of timed TX bursts
(hw_usrp.cpp:867-877); there is no RF loopback here, the ingress file IS the
RX reality.

File format: chunks of `spp` samples; per chunk, n_ant blocks of
interleaved float32 re/im pairs (SISO: a plain cf32 stream).
`write_iq_file` produces it.
"""
from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from ..common.native import NativeIqProducer, NativeRingBuffer
from .hw import Hw


def write_iq_file(path: str | Path, iq: np.ndarray, spp: int = 2048) -> int:
    """Write iq [n_ant, n] complex64 as an ingress file; returns n chunks.

    The tail that does not fill a whole chunk is zero-padded.
    """
    iq = np.asarray(iq, np.complex64)
    if iq.ndim == 1:
        iq = iq[None, :]
    n_ant, n = iq.shape
    n_chunks = -(-n // spp)
    pad = n_chunks * spp - n
    if pad:
        iq = np.pad(iq, ((0, 0), (0, pad)))
    with open(path, "wb") as f:
        for c in range(n_chunks):
            f.write(np.ascontiguousarray(
                iq[:, c * spp:(c + 1) * spp]).tobytes())
    return n_chunks


class HwIqStream(Hw):
    """Radio fed by a native file-producer thread at a paced sample rate."""

    def __init__(self, path: str | Path, samp_rate: int, n_ant: int = 1,
                 spp: int = 2048, ring_len: int = 1 << 20,
                 realtime: bool = False, name: str = "iq_stream"):
        super().__init__(name, n_ant_max=n_ant, calibration="simulator")
        self.n_ant = n_ant
        self.samp_rate = samp_rate
        self.rx_ring_len = ring_len
        self.ring = NativeRingBuffer(ring_len, n_ant)
        self.producer = NativeIqProducer(
            self.ring, str(path), spp=spp,
            rate_hz=float(samp_rate) if realtime else 0.0)
        self.tx_bursts: list[tuple[int, np.ndarray]] = []
        self._order_cnt = 0
        self.read_overruns = 0      # reader fell behind the ring (overflow)

    # --- radio interface consumed by NodeRuntime -------------------------
    @property
    def rx_time(self) -> int:
        """Oldest sample still in the ring (window origin)."""
        return max(0, self.ring.time - self.rx_ring_len)

    @property
    def rx_time_passed(self) -> int:
        return self.ring.time

    def get_rx_stream(self, t0: int, n: int) -> np.ndarray:
        try:
            return self.ring.read(t0, n)
        except ValueError:
            self.read_overruns += 1
            raise

    def wait_until(self, target: int, timeout_us: int = -1) -> int:
        return self.ring.wait_until_nto(target, timeout_us)

    def tx_schedule(self, tx_time: int, iq: np.ndarray) -> int:
        oid = self._order_cnt
        self._order_cnt += 1
        self.tx_bursts.append((tx_time, np.asarray(iq, np.complex64)))
        return oid

    @property
    def eof(self) -> bool:
        return self.producer.eof

    @property
    def late_chunks(self) -> int:
        return self.producer.late_chunks

    def close(self) -> None:
        self.producer.close()


class HwIqSocket(Hw):
    """Full-duplex network radio: UDP IQ ingress + paced TX egress.

    The complete hw_usrp_t analog for a NIC-fed SDR: RX datagrams (cf32,
    per antenna interleaved re/im) arrive on a loopback UDP port into the
    native ring (reference recv loop, hw_usrp.cpp:1093-1219); TX bursts
    scheduled through `tx_schedule` drain through the native paced
    TxConsumer in strict order-id sequence at the sample rate toward
    `tx_sink` ("udp:<port>" or a cf32 file path), zeros between bursts
    (timed TX bursts, hw_usrp.cpp:867-877; in-order pool,
    buffer_tx_pool.cpp:69-135).
    """

    def __init__(self, rx_port: int, samp_rate: int, n_ant: int = 1,
                 ring_len: int = 1 << 20, tx_sink: str | None = None,
                 spp: int = 2048, name: str = "iq_socket"):
        super().__init__(name, n_ant_max=n_ant, calibration="simulator")
        from ..common.native import (NativeIqSocketProducer, NativeRingBuffer,
                                     NativeTxConsumer)
        self.n_ant = n_ant
        self.samp_rate = samp_rate
        self.rx_ring_len = ring_len
        self.ring = NativeRingBuffer(ring_len, n_ant)
        self.producer = NativeIqSocketProducer(self.ring, rx_port)
        # deferred start: the TX pacer's sample-0 instant is pinned to the
        # FIRST RX sample, so the RX ingress clock and the TX emit cursor
        # share an origin (they always shared a rate). A free-running pacer
        # leads a late-starting external sender by the startup gap forever,
        # silently truncating every burst scheduled per tx_earliest.
        self.txc = NativeTxConsumer(tx_sink, n_ant, spp, float(samp_rate),
                                    deferred_start=True) if tx_sink else None
        self._tx_started = False
        self._tx_grace_deadline = time.monotonic() + 0.25
        self.tx_bursts: list[tuple[int, np.ndarray]] = []
        self._order_cnt = 0
        self.read_overruns = 0

    def _maybe_start_tx(self, force: bool = False) -> None:
        """Pin TX sample 0 to the first RX sample (origin alignment). Two
        fallbacks keep self-loopback alive (where RX is fed by our own TX
        and would otherwise deadlock the deferred pacer): the first
        tx_schedule force-starts the clock, and an idle radio self-starts
        after a short grace period (emitting zeros). A sender that only
        appears after the grace is still protected by tx_earliest checking
        BOTH clocks."""
        if self._tx_started or self.txc is None:
            return
        if force or self.ring.time > 0 \
                or time.monotonic() >= self._tx_grace_deadline:
            self.txc.start()
            self._tx_started = True

    @property
    def rx_time(self) -> int:
        return max(0, self.ring.time - self.rx_ring_len)

    @property
    def rx_time_passed(self) -> int:
        self._maybe_start_tx()
        return self.ring.time

    @property
    def tx_earliest(self) -> int:
        """Against BOTH clocks: the RX write head (the documented invariant)
        and the TX emit cursor (which can lead it by residual pacing skew) —
        a burst at `tx_earliest` is guaranteed schedulable in full."""
        head = max(self.ring.time, self.tx_time_emitted)
        return head + max(self.tmin.turnaround, 512)

    def get_rx_stream(self, t0: int, n: int) -> np.ndarray:
        try:
            return self.ring.read(t0, n)
        except ValueError:
            self.read_overruns += 1
            raise

    def wait_until(self, target: int, timeout_us: int = -1) -> int:
        return self.ring.wait_until_nto(target, timeout_us)

    @property
    def tx_time_emitted(self) -> int:
        """TX-side emit cursor (samples already sent to the sink)."""
        return self.txc.emitted if self.txc else 0

    def tx_schedule(self, tx_time: int, iq: np.ndarray) -> int:
        oid = self._order_cnt
        self._order_cnt += 1
        iq = np.asarray(iq, np.complex64)
        if self.txc is not None:
            self._maybe_start_tx(force=True)
            self.txc.schedule(oid, tx_time, iq[:self.n_ant])
        else:
            self.tx_bursts.append((tx_time, iq))
        return oid

    def close(self) -> None:
        self.producer.close()
        if self.txc is not None:
            self.txc.close()
