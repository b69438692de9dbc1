"""The real-IQ radio checks on the port (radio/hw_iq.py over the native host
runtime, common/native.py), at the committed socket_radio configuration's
sizes: 1.92 Ms/s, spp 2048, a 1 Mi-sample ring, u = 1, b = 1, one antenna.

  ingress   three packets of PSDEF (PLCF type 1) from the port's TX and
            10/9 resampler, embedded in noise at 25 dB and written as a cf32
            file (tests/test_iq_ingress.py's layout), read free-running by a
            HwIqStream into a NodeRuntime: the decode does not depend on the
            runtime's speed;
  loopback  the same bursts through a HwIqSocket's paced TX egress over a
            UDP port looped into its own UDP ingress, the runtime decoding
            as the samples arrive (what it decodes there depends on its
            speed; the wire does not).

`free_udp_port` / `on_free_port` hand a native UDP producer a port that no
socket holds (the producer binds the port it is given and cannot report
one it picked).
"""
from __future__ import annotations

import socket
import time

import numpy as np
import torch

from .runtime_check import IDENT, RxCounter
from .sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from .sections.part4.plcf import Plcf10, bytes_to_bits
from .upper.runtime import NodeRuntime, _min_len_psdef, _module

PSDEF = PacketSizesDef(1, 1, 0, 2, 0, 2, 6144)
RATE, SPP, RING = 1_920_000, 2048, 1 << 20
GAP = 8192                  # noise between two packets of the ingress file


def free_udp_port() -> int:
    """A UDP port no socket holds right now (bound to 0, read, released)."""
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def on_free_port(make, tries: int = 8):
    """make(port) on a free UDP port; another process may take the port
    between its release and the native bind (PortInUse): retry that, and
    only that."""
    from .common.native import PortInUse

    for i in range(tries):
        try:
            return make(free_udp_port())
        except PortInUse:
            if i == tries - 1:
                raise


def packet_bursts(n: int, seed: int, device: torch.device | str = "cuda"):
    """n packets of PSDEF with random TBs, synthesized and resampled 10/9
    to 1.92 Ms/s by the port on `device`: (bursts [1, n_up] complex64 on
    the host, payloads, the generator after the TBs)."""
    from .phy.resampler import ResamplerPlan, build_resampler
    from .phy.tx import build_tx

    ps = get_packet_sizes(PSDEF)
    tx = build_tx(PSDEF, IDENT.network_id, 1, device=device)
    up = build_resampler(ResamplerPlan(10, 9), ps.N_samples_packet, device=device)
    rng = np.random.default_rng(seed)
    plcf = Plcf10(packet_length_type=PSDEF.PacketLengthType,
                  packet_length=PSDEF.PacketLength,
                  short_network_id=IDENT.short_network_id,
                  transmitter_identity=IDENT.short_rdid,
                  transmit_power=7, df_mcs=PSDEF.mcs_index)
    plcf_bits = torch.from_numpy(bytes_to_bits(plcf.pack(), 40).astype(np.uint8))
    fl = torch.zeros((1,), dtype=torch.bool, device=device)
    payloads, bursts = [], []
    for _ in range(n):
        tb = rng.integers(0, 2, ps.N_TB_bits).astype(np.uint8)
        payloads.append(tb)
        iq = tx(plcf_bits[None].to(device), torch.from_numpy(tb)[None].to(device),
                fl, fl)[0]
        bursts.append(up(iq).cpu().numpy())
    return bursts, payloads, rng


def ingress_stream(device: torch.device | str = "cuda"):
    """The ingress file's samples: 2 GAP of noise, 3 packets GAP apart, 2
    GAP of noise, the noise 25 dB below a packet's power: (stream
    [1, total] complex64, payloads)."""
    n, snr_db = 3, 25.0
    bursts, payloads, rng = packet_bursts(n, 5, device)
    n_up = bursts[0].shape[-1]
    total = n * (n_up + GAP) + 4 * GAP
    nv = float(np.mean(np.abs(bursts[0]) ** 2)) / 10 ** (snr_db / 10)
    stream = (rng.standard_normal((1, total))
              + 1j * rng.standard_normal((1, total))) * np.sqrt(nv / 2)
    for i, b in enumerate(bursts):
        off = 2 * GAP + i * (n_up + GAP)
        stream[:, off:off + n_up] += b
    return stream.astype(np.complex64), payloads


def drain(rt: NodeRuntime, hw, timeout_s: float = 120.0) -> None:
    """process() until a free-running stream is read, resampled and
    decoded (NodeRuntime.caught_up)."""
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        eof = hw.eof
        rt.process()
        if rt.caught_up(eof):
            return
        time.sleep(0.002)
    raise RuntimeError(f"stream not drained in {timeout_s} s ({rt.stats})")


def run_file(path, payloads, device: torch.device | str = "cuda"):
    """A free-running HwIqStream over the file at `path` into a NodeRuntime
    on `device`, drained: (radio, runtime, firmware); the radio is closed."""
    from .radio.hw_iq import HwIqStream

    hw = HwIqStream(path, samp_rate=RATE, spp=SPP, ring_len=RING, realtime=False)
    fw = RxCounter(payloads)
    rt = NodeRuntime(hw, fw, IDENT.network_id, hw_samp_rate=RATE, device=device)
    try:
        drain(rt, hw)
    finally:
        hw.close()
    return hw, rt, fw


def prewarm(device: torch.device | str = "cuda") -> None:
    """Build every PHY module a 1.92 Ms/s runtime of PSDEF packets uses and
    run each once, before a paced wire starts (a first call builds the
    kernels and cuFFT's plans: seconds, while the ring holds 0.55 s)."""
    from .phy.resampler import ResamplerPlan

    c64, dev = torch.complex64, torch.device(device)
    n_sync = 2048 + 4 * 112
    _module("sync", (1, 1, n_sync), str(dev), max_peaks=4)(
        torch.zeros((1, 1, n_sync), dtype=c64, device=dev))
    step = _module("resampler_stream", (ResamplerPlan(9, 10), 512 * 10), str(dev))
    step(torch.zeros((1, 512 * 10), dtype=c64, device=dev),
         torch.zeros((1, step.H), dtype=c64, device=dev))
    ps_min = _min_len_psdef(1, 1, 0)
    for p in (ps_min, PSDEF):
        n = get_packet_sizes(p).N_samples_packet
        _module("rx_stream", (p, IDENT.network_id, 1, n), str(dev))(
            torch.zeros((1, 1, n), dtype=c64, device=dev),
            torch.zeros(1, dtype=torch.int64, device=dev),
            torch.zeros(1, device=dev), torch.tensor(1e-3, device=dev))
    if dev.type == "cuda":
        torch.cuda.synchronize()


def socket_loopback(bursts, payloads,
                    device: torch.device | str = "cuda") -> dict:
    """The bursts through a HwIqSocket's paced egress, 0.3 s ahead of its
    cursor and 16,384 samples apart (tests/test_iq_ingress.py's schedule),
    looped over a free UDP port into its own ingress, a NodeRuntime
    decoding as they arrive, until every payload is decoded or 20 s have
    passed. Returns the wire's counters and what the runtime decoded; the
    radio is closed."""
    lead_s, gap, timeout_s = 0.3, 16384, 20.0
    from .radio.hw_iq import HwIqSocket

    hw = on_free_port(lambda p: HwIqSocket(rx_port=p, samp_rate=RATE,
                                           tx_sink=f"udp:{p}", ring_len=RING))
    try:
        fw = RxCounter(payloads)
        rt = NodeRuntime(hw, fw, IDENT.network_id, hw_samp_rate=RATE,
                         device=device)
        n_up = bursts[0].shape[-1]
        base = hw.tx_time_emitted + int(lead_s * RATE)
        for i, b in enumerate(bursts):
            hw.tx_schedule(base + i * (n_up + gap), b)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout_s \
                and fw.tb_match < len(payloads):
            rt.process()
            time.sleep(0.002)
        return {"tb_decoded": fw.tb_match, "bursts": len(bursts),
                "seconds": time.perf_counter() - t0,
                "read_overruns": hw.read_overruns,
                "malformed": hw.producer.malformed,
                "late_bursts": hw.txc.late_bursts,
                "send_errors": hw.txc.send_errors,
                "order_violations": hw.txc.order_violations,
                "stats": vars(rt.stats)}
    finally:
        hw.close()
