"""The port's node runtime (tests/test_runtime.py mirrored) and its parity
with the JAX package's: firmware-driven TX -> vspace -> sync -> decode ->
firmware callbacks over the virtual ether.

The five cases of tests/test_runtime.py run on the port, on the CPU, with
their assertions. The parity cases run the two-node beacon exchange of
tools/run_tpu_runtime_check.py (spp 2048, 4 beacons, 40 ticks) through
JAX's NodeRuntime / SimDriver and through the port's
(dectnrp_tpu_torch.runtime_check), the port's vspace handed JAX's draws
each tick: equal RuntimeStats on both nodes, equal detection times and
decoded TBs, SNR estimates within 1e-3 dB; at the DECT rate and at
1.92 Ms/s, where the resampler front end is in the loop.
"""
import json
import os

import numpy as np
import pytest
import torch

from dectnrp_tpu_torch import runtime_check as rc
from dectnrp_tpu_torch.radio.hw_simulator import HwSimulator, SimDriver
from dectnrp_tpu_torch.sections.part3.packet_sizes import (PacketSizesDef,
                                                           get_packet_sizes)
from dectnrp_tpu_torch.sections.part4.identity import Identity
from dectnrp_tpu_torch.sections.part4.plcf import Plcf10
from dectnrp_tpu_torch.simulation.topology import Position, Trajectory
from dectnrp_tpu_torch.simulation.vspace import VNodeConfig, VSpaceConfig
from dectnrp_tpu_torch.upper.runtime import NodeRuntime
from dectnrp_tpu_torch.upper.tpoint import (MacHighPhy, MacLowPhy, Tpoint,
                                            TxDescriptor)
from test_torch_vspace import jax_tick_draws

torch.set_num_threads(1)

IDENT = Identity(0x12345678, 0x2222, 0x3333)
PSDEF = PacketSizesDef(1, 1, 0, 2, 0, 2, 6144)


class TxBeacon(Tpoint):
    """Transmits one packet per regular callback, 2000 samples ahead."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self.sent = 0
        self.payloads = []

    def work_regular(self, now):
        ps = get_packet_sizes(PSDEF)
        rng = np.random.default_rng(self.sent)
        tb = rng.integers(0, 2, ps.N_TB_bits).astype(np.uint8)
        self.payloads.append(tb)
        self.sent += 1
        plcf = Plcf10(packet_length_type=PSDEF.PacketLengthType,
                      packet_length=PSDEF.PacketLength,
                      short_network_id=IDENT.short_network_id,
                      transmitter_identity=IDENT.short_rdid,
                      transmit_power=7, df_mcs=PSDEF.mcs_index)
        td = TxDescriptor(psdef=PSDEF, plcf=plcf, tb_bits=tb,
                          network_id=IDENT.network_id, tx_time=now + 2000)
        out = MacHighPhy()
        out.tx_descriptors.append(td)
        return out


class RxCounter(Tpoint):
    def __init__(self, **kw):
        super().__init__(**kw)
        self.pcc = 0
        self.pdc = 0
        self.tbs = []

    def work_pcc(self, phy_maclow):
        self.pcc += 1
        rep = phy_maclow.pcc_report
        if rep.plcf is None or rep.plcf.transmitter_identity != IDENT.short_rdid:
            return MacLowPhy()
        return self.worksub_pcc2pdc(phy_maclow, rep.plcf_type,
                                    IDENT.network_id)

    def work_pdc(self, phy_machigh):
        self.pdc += 1
        self.tbs.append(phy_machigh.pdc_report.tb_bits)
        return MacHighPhy()


def _two_nodes(noise_var=1e-8, spp=512):
    hws = [HwSimulator(1), HwSimulator(1)]
    cfg = VSpaceConfig(samp_rate=1_728_000.0, spp_len=spp, freq_hz=1.9e9,
                       noise_var=noise_var)
    nodes = [VNodeConfig(1, Trajectory(Position(0, 0, 0))),
             VNodeConfig(1, Trajectory(Position(1.0, 0, 0)))]
    return hws, SimDriver(cfg, hws, nodes, "cpu")


def test_two_node_runtime_end_to_end():
    hws, drv = _two_nodes()
    tx_fw, rx_fw = TxBeacon(), RxCounter()
    rt_tx = NodeRuntime(hws[0], tx_fw, IDENT.network_id, regular_period=8192,
                        device="cpu")
    rt_rx = NodeRuntime(hws[1], rx_fw, IDENT.network_id, device="cpu")
    for _ in range(120):
        drv.tick()
        rt_tx.process()
        rt_rx.process()
    assert tx_fw.sent >= 4, tx_fw.sent
    assert rx_fw.pdc >= 3, (tx_fw.sent, rx_fw.pcc, rx_fw.pdc, rt_rx.stats)
    for got in rx_fw.tbs:
        assert any(np.array_equal(got, p) for p in tx_fw.payloads)
    assert rt_rx.stats.pdc_err == 0


def test_self_loopback_via_leakage():
    """The loopback firmware's mechanism: own TX heard through the
    intra-node leakage channel."""
    hw = HwSimulator(1)
    cfg = VSpaceConfig(samp_rate=1_728_000.0, spp_len=512, noise_var=1e-9)
    nodes = [VNodeConfig(1, Trajectory(Position(0, 0, 0)), tx_leakage_db=20.0)]
    drv = SimDriver(cfg, [hw], nodes, "cpu")
    tx_fw, rx_cnt = TxBeacon(), RxCounter()

    class Both(Tpoint):
        work_regular = staticmethod(tx_fw.work_regular)
        work_pcc = staticmethod(rx_cnt.work_pcc)
        work_pdc = staticmethod(rx_cnt.work_pdc)

    rt = NodeRuntime(hw, Both(), IDENT.network_id, regular_period=8192,
                     device="cpu")
    for _ in range(80):
        drv.tick()
        rt.process()
    assert rx_cnt.pdc >= 2, (tx_fw.sent, rx_cnt.pcc, rx_cnt.pdc, rt.stats)


def test_two_packets_one_chunk():
    """Two packets 1.5 packet-lengths apart (both inside one 2048-sample
    sync chunk) are both decoded: multi-peak sync through the runtime."""
    psdef = PacketSizesDef(1, 1, 0, 1, 0, 2, 6144)     # 360-sample packet
    ps = get_packet_sizes(psdef)
    n_pkt = ps.N_samples_packet

    class TxPair(Tpoint):
        def __init__(self):
            super().__init__()
            self.sent = 0
            self.payloads = []

        def work_regular(self, now):
            out = MacHighPhy()
            if self.sent >= 8:          # stop early so the tail drains
                return out
            for j in range(2):
                rng = np.random.default_rng(100 * self.sent + j)
                tb = rng.integers(0, 2, ps.N_TB_bits).astype(np.uint8)
                self.payloads.append(tb)
                plcf = Plcf10(packet_length_type=psdef.PacketLengthType,
                              packet_length=psdef.PacketLength,
                              short_network_id=IDENT.short_network_id,
                              transmitter_identity=IDENT.short_rdid,
                              transmit_power=7, df_mcs=psdef.mcs_index)
                out.tx_descriptors.append(TxDescriptor(
                    psdef=psdef, plcf=plcf, tb_bits=tb,
                    network_id=IDENT.network_id,
                    tx_time=now + 2000 + j * int(1.5 * n_pkt)))
            self.sent += 2
            return out

    hws, drv = _two_nodes()
    tx_fw, rx_fw = TxPair(), RxCounter()
    rt_tx = NodeRuntime(hws[0], tx_fw, IDENT.network_id, regular_period=8192,
                        device="cpu")
    rt_rx = NodeRuntime(hws[1], rx_fw, IDENT.network_id, device="cpu")
    for _ in range(100):
        drv.tick()
        rt_tx.process()
        rt_rx.process()
    assert tx_fw.sent >= 4
    assert rx_fw.pdc >= tx_fw.sent - 2, (tx_fw.sent, rx_fw.pdc, rt_rx.stats)
    for got in rx_fw.tbs:
        assert any(np.array_equal(got, p) for p in tx_fw.payloads)


def test_pcc_first_fires_before_packet_tail():
    """Streaming PCC-first decode: work_pcc fires while most of a long
    packet is still on the air, work_pdc only once its tail has arrived."""
    long_psdef = PacketSizesDef(1, 1, 1, 16, 0, 1, 6144)   # 16 slots
    ps_long = get_packet_sizes(long_psdef)
    n_long = ps_long.N_samples_packet
    assert n_long > 10000

    class LongTx(TxBeacon):
        def work_regular(self, now):
            if self.sent >= 1:
                return MacHighPhy()
            tb = np.random.default_rng(0).integers(
                0, 2, ps_long.N_TB_bits).astype(np.uint8)
            self.payloads.append(tb)
            self.sent += 1
            plcf = Plcf10(packet_length_type=long_psdef.PacketLengthType,
                          packet_length=long_psdef.PacketLength,
                          short_network_id=IDENT.short_network_id,
                          transmitter_identity=IDENT.short_rdid,
                          transmit_power=7, df_mcs=long_psdef.mcs_index)
            out = MacHighPhy()
            out.tx_descriptors.append(TxDescriptor(
                psdef=long_psdef, plcf=plcf, tb_bits=tb,
                network_id=IDENT.network_id,
                tx_time=max(now + 2000, self.lower.tx_earliest)))
            return out

    class LatencyRx(RxCounter):
        def __init__(self, rt_ref):
            super().__init__()
            self.rt_ref = rt_ref
            self.pcc_at = self.pdc_at = self.pkt_t0 = None

        def work_pcc(self, phy_maclow):
            self.pcc_at = self.rt_ref[0].front_end.end
            self.pkt_t0 = phy_maclow.sync_report.fine_peak_time
            return super().work_pcc(phy_maclow)

        def work_pdc(self, phy_machigh):
            self.pdc_at = self.rt_ref[0].front_end.end
            return super().work_pdc(phy_machigh)

    hws, drv = _two_nodes()
    tx_fw, rt_ref = LongTx(), []
    rx_fw = LatencyRx(rt_ref)
    rt_tx = NodeRuntime(hws[0], tx_fw, IDENT.network_id, regular_period=8192,
                        device="cpu")
    rt_rx = NodeRuntime(hws[1], rx_fw, IDENT.network_id, device="cpu")
    rt_ref.append(rt_rx)
    for _ in range(150):
        drv.tick()
        rt_tx.process()
        rt_rx.process()
        if rx_fw.pdc >= 1:
            break
    assert rx_fw.pdc == 1 and rx_fw.pcc >= 1, (tx_fw.sent, rt_rx.stats)
    pkt_end = rx_fw.pkt_t0 + n_long
    assert rx_fw.pcc_at < rx_fw.pkt_t0 + 0.5 * n_long, \
        (rx_fw.pcc_at - rx_fw.pkt_t0, n_long)
    assert rx_fw.pdc_at >= pkt_end, (rx_fw.pdc_at, pkt_end)
    assert rx_fw.pdc_at <= pkt_end + 2 * (rt_rx.chunk_len + rt_rx.overlap)
    assert np.array_equal(rx_fw.tbs[0], tx_fw.payloads[0])


def test_json_export_wiring(tmp_path):
    """NodeRuntime(json_export_dir=...) writes one record per received
    packet."""
    hws, drv = _two_nodes()
    tx_fw, rx_fw = TxBeacon(), RxCounter()
    rt_tx = NodeRuntime(hws[0], tx_fw, IDENT.network_id, regular_period=8192,
                        device="cpu")
    out_dir = str(tmp_path / "packets")
    rt_rx = NodeRuntime(hws[1], rx_fw, IDENT.network_id,
                        json_export_dir=out_dir, device="cpu")
    for _ in range(120):
        drv.tick()
        rt_tx.process()
        rt_rx.process()
    assert rx_fw.pdc >= 3
    rt_rx.json_export.flush()
    files = sorted(os.listdir(out_dir))
    assert files, "no packet records written"
    recs = []
    for f in files:
        with open(os.path.join(out_dir, f)) as fh:
            recs.extend(json.load(fh))
    assert len(recs) >= rx_fw.pdc
    r = next(rec for rec in recs if "pdc" in rec)
    assert r["pcc"]["crc_ok"] and r["pdc"]["crc_ok"]
    assert r["sync"]["N_eff_TX"] == 1
    assert isinstance(r["pcc"]["plcf_hex"], str)
    assert "snr_db" in r and "cfo_rad_per_sample" in r["sync"]


def test_application_layer_not_ported():
    """The application layer is ported (the name is kept from when it was
    not): a datagram sent to node 0's app_server (a SocketServer) goes over
    the air as its TfwRtt's data packet, node 1 echoes it, and node 0's
    app_client sends it on to a UDP listener, as the JAX runtime does."""
    import time

    from dectnrp_tpu_torch.application.socket_app import SocketClient, SocketServer
    from dectnrp_tpu_torch.upper.misc import TfwRtt

    hws, drv = _two_nodes(spp=2048)
    srv, out_srv = SocketServer([0]), SocketServer([0])
    try:
        fw0 = TfwRtt(IDENT.network_id, 0x2222)
        fw1 = TfwRtt(IDENT.network_id, 0x3333, echo=True)
        cli = SocketClient(out_srv.bound_ports)
        rt0 = NodeRuntime(hws[0], fw0, IDENT.network_id, app_server=srv,
                          app_client=cli, device="cpu")
        rt1 = NodeRuntime(hws[1], fw1, IDENT.network_id, device="cpu")
        probe = b"\x00\x00\x00\x07" + bytes(20)
        sender = SocketClient(srv.bound_ports)
        sender.write(probe)
        sender.close()
        got, deadline = [], time.time() + 60.0
        for _ in range(60):
            drv.tick()
            rt0.process()
            rt1.process()
            out_srv.poll(timeout=0.0)
            got += out_srv.read_all()
            if got or time.time() > deadline:
                break
        cli.close()
    finally:
        srv.stop()
        out_srv.stop()
    assert got == [probe], (fw0.stats, fw1.stats, rt0.stats, rt1.stats)
    assert fw0.stats == fw1.stats == {"tx": 1, "rx": 1}
    assert fw0.app_rx == []                  # handed on to the app client


class _OutrunningRadio:
    """A radio whose write head moves on by twice what each read takes: a
    paced radio faster than the runtime, without a clock."""
    n_ant, rx_ring_len = 1, 1 << 20

    def __init__(self, samp_rate, head):
        self.samp_rate, self.head, self.reads = samp_rate, head, 0

    @property
    def rx_time(self):
        return max(0, self.head - self.rx_ring_len)

    @property
    def rx_time_passed(self):
        return self.head

    def get_rx_stream(self, t0, n):
        self.reads += 1
        assert self.reads < 500, "process() is chasing the radio's head"
        self.head += 2 * n
        return np.zeros((1, n), np.complex64)


@pytest.mark.parametrize("rate", [1_728_000, 1_920_000], ids=["dect", "sdr"])
def test_process_returns_over_a_radio_that_outruns_it(rate):
    """One process() call resamples and syncs what had arrived when it
    began, so a real-IQ radio faster than the runtime cannot keep the call
    from returning; the next call takes up what arrived meanwhile."""
    hw = _OutrunningRadio(rate, 4 * 5120)
    rt = NodeRuntime(hw, Tpoint(), IDENT.network_id, hw_samp_rate=rate,
                     device="cpu")
    for _ in range(2):
        head = hw.head
        rt.process()
        if rate == 1_728_000:           # the DECT rate: chunks off the ring
            assert rt._processed + rt.overlap <= head \
                < rt._processed + rt.chunk_len + rt.overlap
        else:                           # 9/10 front end, 1,280-sample steps
            assert rt.front_end.consumed == head
    assert rt.stats.chunks > 0


# --------------------------------------------------------------- parity


def _jax_exchange(kind):
    """The exchange of tools/run_tpu_runtime_check.py on the JAX package,
    its receiver recording what runtime_check.RxCounter records."""
    from dectnrp_tpu.radio.hw_simulator import HwSimulator as JHw, SimDriver as JDrv
    from dectnrp_tpu.sections.part3.packet_sizes import (
        PacketSizesDef as JPs, get_packet_sizes as j_sizes)
    from dectnrp_tpu.sections.part4.plcf import Plcf10 as JPlcf10
    from dectnrp_tpu.simulation.topology import Position as JPos, Trajectory as JTr
    from dectnrp_tpu.simulation.vspace import VNodeConfig as JNode, VSpaceConfig as JCfg
    from dectnrp_tpu.upper.runtime import NodeRuntime as JRt
    from dectnrp_tpu.upper.tpoint import (MacHighPhy as JHigh, MacLowPhy as JLow,
                                          Tpoint as JTpoint, TxDescriptor as JTd)

    k = rc.KINDS[kind]
    n_ant, rate, n_max, seed0 = k.n_ant, k.rate, k.n_max, k.seed0
    psdef = JPs(*vars(k.psdef).values())

    class Tx(JTpoint):
        def __init__(self):
            super().__init__()
            self.sent, self.payloads = 0, []

        def work_regular(self, now):
            out = JHigh()
            if self.sent >= n_max:
                return out
            tb = np.random.default_rng(seed0 + self.sent).integers(
                0, 2, j_sizes(psdef).N_TB_bits).astype(np.uint8)
            self.payloads.append(tb)
            self.sent += 1
            plcf = JPlcf10(packet_length_type=psdef.PacketLengthType,
                           packet_length=psdef.PacketLength,
                           short_network_id=IDENT.short_network_id,
                           transmitter_identity=IDENT.short_rdid,
                           transmit_power=7, df_mcs=psdef.mcs_index)
            out.tx_descriptors.append(JTd(
                psdef=psdef, plcf=plcf, tb_bits=tb, network_id=IDENT.network_id,
                tx_time=max(now + 2000, self.lower.tx_earliest)))
            return out

    class Rx(JTpoint):
        def __init__(self):
            super().__init__()
            self.detection_times, self.pcc_snr_db = [], []
            self.pdc_snr_db, self.tbs = [], []

        def work_pcc(self, phy_maclow):
            rep = phy_maclow.pcc_report
            self.detection_times.append(phy_maclow.sync_report.fine_peak_time)
            self.pcc_snr_db.append(rep.snr_db)
            if rep.plcf is None or \
                    rep.plcf.transmitter_identity != IDENT.short_rdid:
                return JLow()
            return self.worksub_pcc2pdc(phy_maclow, rep.plcf_type,
                                        IDENT.network_id)

        def work_pdc(self, phy_machigh):
            self.tbs.append(phy_machigh.pdc_report.tb_bits)
            self.pdc_snr_db.append(phy_machigh.pdc_report.snr_db)
            return JHigh()

    hws = [JHw(n_ant), JHw(n_ant)]
    drv = JDrv(JCfg(samp_rate=float(rate), spp_len=k.spp, noise_var=rc.NOISE_VAR),
               hws, [JNode(n_ant, JTr(JPos(0, 0, 0))),
                     JNode(n_ant, JTr(JPos(1.0, 0, 0)))])
    tx_fw, rx_fw = Tx(), Rx()
    geo = dict(u=psdef.u, b=psdef.b, chunk_len=k.spp, hw_samp_rate=rate)
    rt_tx = JRt(hws[0], tx_fw, IDENT.network_id, regular_period=4 * k.spp,
                **geo)
    rt_rx = JRt(hws[1], rx_fw, IDENT.network_id, **geo)
    for rt in (rt_tx, rt_rx):
        _port_front_end_step(rt)
    return drv, tx_fw, rx_fw, rt_tx, rt_rx


def _port_front_end_step(jrt) -> None:
    """Give a JAX runtime off the DECT rate the port's front-end step (a
    quarter of JAX's 512 L hw samples, upper/runtime.py), so both resample
    and sync the same samples in the same process() calls."""
    if jrt.plan_tx.identity:
        return
    from dectnrp_tpu.common.cplx import cwrap_cached
    from dectnrp_tpu.phy.resampler import build_resampler_stream as j_stream

    port = NodeRuntime(HwSimulator(1), Tpoint(), IDENT.network_id,
                       hw_samp_rate=jrt.dect_rate * jrt.plan_tx.L
                       // jrt.plan_tx.M, device="cpu")
    jrt._chunk_pump = port.front_end.chunk
    step, jrt._rx_H = j_stream(jrt.plan_rx, jrt._chunk_pump)
    jrt._rx_step = cwrap_cached(step)


@pytest.mark.parametrize("kind", ["dect", "sdr", "rdc_2124a"])
def test_exchange_decides_as_jax(kind):
    k = rc.KINDS[kind]
    n_ticks = k.t_min
    drv, tx_j, rx_j, rtx_j, rrx_j = _jax_exchange(kind)
    for _ in range(n_ticks):
        drv.tick()
        rtx_j.process()
        rrx_j.process()
    ex = rc.build(kind, "cpu")
    got = rc.run(ex, ticks=n_ticks, draws=lambda now: jax_tick_draws(
        0, now, 2, k.n_ant, k.spp, noise_var=rc.NOISE_VAR))
    assert got["ok"] and got["tb_payload_match"] == tx_j.sent == k.n_max, got
    assert vars(ex.rt_rx.stats) == vars(rrx_j.stats)
    assert vars(ex.rt_tx.stats) == vars(rtx_j.stats)
    assert ex.rx_fw.detection_times == rx_j.detection_times
    assert len(ex.rx_fw.tbs) == len(rx_j.tbs) == k.n_max
    for a, b in zip(ex.rx_fw.tbs, rx_j.tbs):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(ex.rx_fw.pcc_snr_db, rx_j.pcc_snr_db, atol=1e-3)
    np.testing.assert_allclose(ex.rx_fw.pdc_snr_db, rx_j.pdc_snr_db, atol=1e-3)


def test_entry_points_default_to_the_card():
    """NodeRuntime, SimDriver, VSpace, build_scenario, the runtime
    exchanges and the CLI's --device run on "cuda" unless asked; with
    device="cpu" the runtime's PHY modules and the ether live on the CPU."""
    import inspect

    from dectnrp_tpu_torch import config
    from dectnrp_tpu_torch.apps import dectnrp_main
    from dectnrp_tpu_torch.simulation.vspace import VSpace

    for f in (NodeRuntime, SimDriver, VSpace, config.build_scenario, rc.build):
        assert inspect.signature(f).parameters["device"].default == "cuda", f
    assert "--device" in inspect.getsource(dectnrp_main.run) and \
        'default="cuda"' in inspect.getsource(dectnrp_main.run)
    ex = rc.build("sdr", "cpu")
    for rt in (ex.rt_tx, ex.rt_rx):
        for m in (rt._sync, rt.front_end.step):
            bufs = list(m.buffers())
            assert bufs and all(b.device.type == "cpu" for b in bufs), type(m)
    assert ex.drv.vspace.generator.device.type == "cpu"
