"""The port's application layer (tests/test_application.py mirrored on
dectnrp_tpu_torch/application, apps/rtt.py and apps/sync_gen.py): datagram
queue semantics, the UDP socket server/client loopback, the deadline-
scheduled generator, the TUN gate and the rtt datagram pipe over the air
through the real application layer (SocketServer -> TfwRtt -> air -> echo
-> SocketClient -> apps/rtt).

The parity cases run the three copied firmwares that no other test drives
over NodeRuntime through the JAX package's runtime and the port's, one node
hearing itself through 20 dB of TX leakage (tests/test_application.py's
_leak_node), the port's ether handed JAX's draws each tick
(`jax_tick_draws`): TfwTxrxDelay, TfwChscanner, and TfwTxrxAgc fed
datagrams through a SocketServer on each side. Ephemeral ports throughout.
"""
import threading
import time

import numpy as np
import pytest
import torch

from dectnrp_tpu_torch.application.queue import DatagramQueue
from dectnrp_tpu_torch.application.socket_app import SocketClient, SocketServer
from dectnrp_tpu_torch.apps.rtt import run_rtt
from dectnrp_tpu_torch.apps.sync_gen import StreamConfig, run_sync
from dectnrp_tpu_torch.radio import hw_simulator as Ths
from dectnrp_tpu_torch.radio.hw_simulator import HwSimulator, SimDriver
from dectnrp_tpu_torch.simulation import topology as Ttop
from dectnrp_tpu_torch.simulation import vspace as Tvs
from dectnrp_tpu_torch.simulation.topology import Position, Trajectory
from dectnrp_tpu_torch.simulation.vspace import VNodeConfig, VSpaceConfig
from dectnrp_tpu_torch.upper import misc as Tmisc
from dectnrp_tpu_torch.upper.misc import TfwRtt
from dectnrp_tpu_torch.upper.runtime import NodeRuntime
from test_torch_vspace import jax_tick_draws

torch.set_num_threads(1)

NET = 0x12345678


def test_datagram_queue():
    q = DatagramQueue(nof_datagrams=3, datagram_max_bytes=8)
    assert q.write(b"a") and q.write(b"bb") and q.write(b"ccc")
    assert not q.write(b"overflow")          # full -> drop
    assert q.dropped == 1
    assert not q.write(b"123456789")         # oversized -> drop
    assert q.read() == b"a"                  # FIFO
    assert q.read_all() == [b"bb", b"ccc"]
    assert q.read() is None and len(q) == 0


def test_socket_server_client_loopback():
    srv = SocketServer([0, 0])               # ephemeral ports
    try:
        ports = srv.bound_ports
        cli = SocketClient(ports)
        cli.write(b"hello", 0)
        cli.write(b"world", 1)
        for _ in range(50):
            if srv.poll(timeout=0.02) and sum(
                    len(q) for q in srv.queues.values()) >= 2:
                break
        got = srv.read_all()
        assert sorted(got) == [b"hello", b"world"]
        cli.close()
    finally:
        srv.stop()


def test_sync_generator():
    srv = SocketServer([0])
    try:
        port = srv.bound_ports[0]
        counts = run_sync([StreamConfig(port, period_s=0.005)],
                          duration_s=0.06)
        assert counts[0] >= 8
        time.sleep(0.05)
        srv.poll(timeout=0.1)
        got = srv.read_all()
        assert len(got) >= 8
        seqs = [int.from_bytes(d[:4], "big") for d in got]
        assert seqs == sorted(seqs)          # numbered in order
    finally:
        srv.stop()


def test_vnic_gated():
    from dectnrp_tpu_torch.application.vnic import tun_available
    if not tun_available():
        pytest.skip("no /dev/net/tun access")
    import socket

    from dectnrp_tpu_torch.application.vnic import VnicServer
    v = VnicServer(ifname="tun_dect_p", ip="172.99.8.1", peer_ip="172.99.8.2")
    try:
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        s.sendto(b"x" * 16, ("172.99.8.2", 9999))
        s.close()
        ipv4 = None
        for _ in range(100):
            for d in v.read_all():
                if d and d[0] >> 4 == 4:     # skip kernel IPv6 chatter
                    ipv4 = d
                    break
            if ipv4:
                break
            time.sleep(0.01)
        assert ipv4, "no IPv4 datagram read from TUN"
        assert ipv4[9] == 17                 # protocol UDP
        assert ipv4[16:20] == bytes([172, 99, 8, 2])
    finally:
        v.close()


def test_rtt_over_the_air():
    """apps/rtt -> UDP -> node 0's firmware -> air -> node 1's echo -> air
    -> node 0 -> UDP -> apps/rtt, on the CPU."""
    hws = [HwSimulator(1), HwSimulator(1)]
    cfg = VSpaceConfig(samp_rate=1_728_000.0, spp_len=2048, freq_hz=1.9e9,
                       noise_var=1e-8)
    nodes = [VNodeConfig(1, Trajectory(Position(0, 0, 0))),
             VNodeConfig(1, Trajectory(Position(1.0, 0, 0)))]
    drv = SimDriver(cfg, hws, nodes, "cpu")
    srv = SocketServer([0])                  # firmware ingress
    out_srv = SocketServer([0])              # rtt app's echo listener
    try:
        fw0 = TfwRtt(NET, 0x2222)
        fw1 = TfwRtt(NET, 0x3333, echo=True)
        rt0 = NodeRuntime(hws[0], fw0, NET, app_server=srv,
                          app_client=SocketClient(out_srv.bound_ports),
                          device="cpu")
        rt1 = NodeRuntime(hws[1], fw1, NET, device="cpu")
        result = {}

        def app():
            result["res"] = run_rtt(srv.bound_ports[0], out_srv.bound_ports[0],
                                    n=2, payload_bytes=24, timeout_s=30.0)

        th = threading.Thread(target=app)
        th.start()
        deadline = time.time() + 120.0
        for _ in range(400):
            drv.tick()
            rt0.process()
            rt1.process()
            if not th.is_alive() or time.time() > deadline:
                break
        th.join(timeout=35.0)
        res = result.get("res")
        assert res is not None and res.n >= 1, \
            (fw0.stats, fw1.stats, rt0.stats, rt1.stats)
    finally:
        srv.stop()
        out_srv.stop()


# --------------------------------------------------------------- parity

SPP, NOISE = 1024, 1e-9


def _leak_nodes(make_fw, noise_var=NOISE, regular_period=16384, **rt_kw):
    """One node hearing itself through 20 dB of TX leakage in each package
    (tests/test_application.py::_leak_node): {pkg: (driver, hw, fw, rt)};
    rt_kw[pkg] holds extra NodeRuntime arguments of that package's node."""
    from dectnrp_tpu.radio import hw_simulator as Jhs
    from dectnrp_tpu.simulation import topology as Jtop
    from dectnrp_tpu.simulation import vspace as Jvs
    from dectnrp_tpu.upper import misc as Jmisc
    from dectnrp_tpu.upper.runtime import NodeRuntime as JRt

    out = {}
    for pkg, hs, top, vs, misc, rt_cls, dev in (
            ("jax", Jhs, Jtop, Jvs, Jmisc, JRt, {}),
            ("torch", Ths, Ttop, Tvs, Tmisc, NodeRuntime, {"device": "cpu"})):
        hw = hs.HwSimulator(1)
        cfg = vs.VSpaceConfig(samp_rate=1_728_000.0, spp_len=SPP,
                              noise_var=noise_var)
        nodes = [vs.VNodeConfig(1, top.Trajectory(top.Position(0, 0, 0)),
                                tx_leakage_db=20.0)]
        drv = hs.SimDriver(cfg, [hw], nodes, **dev)
        fw = make_fw(misc)
        rt = rt_cls(hw, fw, NET, regular_period=regular_period,
                    **rt_kw.get(pkg, {}), **dev)
        out[pkg] = (drv, hw, fw, rt)
    return out


def _tick(pkg, drv, rt, noise_var=NOISE):
    if pkg == "jax":
        drv.tick()
    else:
        drv.tick(jax_tick_draws(0, drv.now, 1, 1, SPP, noise_var=noise_var))
    rt.process()


def test_txrxdelay_decides_as_jax():
    """TfwTxrxDelay (80 ticks): equal RuntimeStats, scheduled and measured
    times; the simulator's loopback delay is 0 (README.md:282-301)."""
    runs = _leak_nodes(lambda m: m.TfwTxrxDelay(NET, 0x2222))
    for _ in range(80):
        for pkg, (drv, _, _, rt) in runs.items():
            _tick(pkg, drv, rt)
    (_, _, fj, rj), (_, _, ft, rt) = runs["jax"], runs["torch"]
    assert vars(rt.stats) == vars(rj.stats)
    assert ft.stats == fj.stats
    assert ft.scheduled == fj.scheduled and ft.measured == fj.measured
    assert len(ft.delays()) >= 2 and all(abs(d) <= 2 for d in ft.delays()), \
        (ft.delays(), rt.stats)


def test_chscanner_decides_as_jax():
    """TfwChscanner (40 ticks, a strong burst at tick 10): equal
    RuntimeStats and scan results, the RMS within 1e-5 relative; windows
    that overlap the burst are much louder than noise."""
    runs = _leak_nodes(lambda m: m.TfwChscanner(window=2048, n_partial=2),
                       noise_var=1e-6, regular_period=8192)
    for i in range(40):
        for pkg, (drv, hw, _, rt) in runs.items():
            if i == 10:
                hw.tx_schedule(hw.rx_time_passed + 2048,
                               0.5 * np.ones((1, 8192), np.complex64))
            _tick(pkg, drv, rt, noise_var=1e-6)
    (_, _, fj, rj), (_, _, ft, rt) = runs["jax"], runs["torch"]
    assert vars(rt.stats) == vars(rj.stats)
    assert len(ft.results) == len(fj.results) >= 3
    for a, b in zip(ft.results, fj.results):
        assert (a.t_start, a.t_end, a.n_partial) == (b.t_start, b.t_end,
                                                     b.n_partial)
        np.testing.assert_allclose(np.asarray(a.rms_ant, np.float64),
                                   np.asarray(b.rms_ant, np.float64), rtol=1e-5)
    rms = np.array([float(r.rms_ant[0]) for r in ft.results])
    assert rms.max() > 10 * rms.min()


def test_txrxagc_with_socket_datagrams_decides_as_jax():
    """TfwTxrxAgc fed three datagrams through a SocketServer on each side
    (one before ticks 2, 12 and 22): each goes out as a data packet, the
    node hears it through the leakage and steps its RX gain; equal
    RuntimeStats, firmware stats and gain steps."""
    servers = {"jax": SocketServer([0]), "torch": SocketServer([0])}
    try:
        runs = _leak_nodes(lambda m: m.TfwTxrxAgc(NET, 0x2222),
                           **{"jax": {"app_server": servers["jax"]},
                              "torch": {"app_server": servers["torch"]}})
        clients = {k: SocketClient(s.bound_ports) for k, s in servers.items()}
        for i in range(40):
            for pkg, (drv, _, _, rt) in runs.items():
                if i in (2, 12, 22):
                    clients[pkg].write(i.to_bytes(4, "big") + bytes(20))
                    # the datagram is in the server's queue before the tick
                    deadline = time.time() + 5.0
                    while not len(servers[pkg].queues[servers[pkg].ports[0]]) \
                            and time.time() < deadline:
                        servers[pkg].poll(timeout=0.1)
                _tick(pkg, drv, rt)
        for c in clients.values():
            c.close()
    finally:
        for s in servers.values():
            s.stop()
    (_, hj, fj, rj), (_, ht, ft, rt) = runs["jax"], runs["torch"]
    assert ft.stats == fj.stats and ft.stats["tx"] == 3, ft.stats
    assert vars(rt.stats) == vars(rj.stats)
    assert rt.stats.tx_packets == 3 and rt.stats.pcc_ok >= 3, rt.stats
    assert ft.gain_log, "the AGC never stepped"
    np.testing.assert_allclose(ft.gain_log, fj.gain_log, rtol=1e-6)
