"""Miscellaneous firmwares (reference lib/src/upper/{basic,rtt,txrxagc,
txrxdelay,chscanner}/): the empty skeleton, the UDP round-trip datagram
pipe, the software-AGC exerciser, the TX->RX delay calibrator and the
channel-occupancy scanner.

Copy of `dectnrp_tpu/upper/misc.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..phy.agc import AgcConfig, AgcRx
from ..phy.chscan import Chscan, Chscanner
from ..sections.part3.packet_sizes import get_packet_sizes
from ..sections.part4.ies import UserPlaneData
from ..sections.part4.mac_pdu import (DataMacPduHeader, MacHeaderKind,
                                      MacHeaderType)
from ..sections.part4.mac_pdu_decoder import build_mac_pdu, decode_mac_pdu
from ..sections.part4.plcf import Plcf10, bits_to_bytes, bytes_to_bits
from .p2p import psdef_for_bytes
from .tpoint import (IrregularReport, MacHighPhy, MacLowPhy, PhyMacHigh,
                     PhyMacLow, Tpoint, TxDescriptor)


class TfwBasic(Tpoint):
    """Empty skeleton, the recommended firmware starting point
    (reference upper/basic/tfw_basic.cpp)."""
    NAME = "basic"


class _DatagramPipe(Tpoint):
    """Shared machinery: app datagrams <-> broadcast data packets."""

    def __init__(self, network_id: int, short_rdid: int,
                 u: int = 1, b: int = 1, mcs: int = 2,
                 tx_ahead: int = 4096, **kw):
        super().__init__(**kw)
        self.network_id = network_id
        self.short_rdid = short_rdid
        self.u, self.b, self.mcs = u, b, mcs
        self.tx_ahead = tx_ahead
        self.lower = None
        self.app_rx: list[bytes] = []
        self.sn = 0
        self.stats = {"tx": 0, "rx": 0}

    def _data_td(self, data: bytes, tx_time: int) -> TxDescriptor | None:
        mmie = UserPlaneData(1, data)
        n = MacHeaderType.SIZE + DataMacPduHeader.SIZE \
            + mmie.packed_size_mmh_sdu()
        psdef = psdef_for_bytes(self.u, self.b, 0, self.mcs, n)
        if psdef is None:
            return None
        ps = get_packet_sizes(psdef)
        hdr = DataMacPduHeader(sequence_number=self.sn)
        self.sn = (self.sn + 1) & 0xFFF
        pdu = build_mac_pdu(
            MacHeaderType(mac_header_type=MacHeaderKind.DATA_MAC_PDU),
            hdr, [mmie], ps.N_TB_bits // 8)
        plcf = Plcf10(packet_length_type=psdef.PacketLengthType,
                      packet_length=psdef.PacketLength,
                      short_network_id=self.network_id & 0xFF,
                      transmitter_identity=self.short_rdid,
                      transmit_power=7, df_mcs=psdef.mcs_index)
        return TxDescriptor(psdef=psdef, plcf=plcf,
                            tb_bits=bytes_to_bits(pdu, ps.N_TB_bits),
                            network_id=self.network_id, tx_time=tx_time)

    def work_application(self, datagrams: list[bytes]) -> MacHighPhy:
        out = MacHighPhy()
        t = (self.lower.rx_time_passed if self.lower is not None else 0) \
            + self.tx_ahead
        for d in datagrams:
            td = self._data_td(d, t)
            if td is not None:
                out.tx_descriptors.append(td)
                self.stats["tx"] += 1
                t += get_packet_sizes(td.psdef).N_samples_packet + 512
        return out

    def work_pcc(self, phy_maclow: PhyMacLow) -> MacLowPhy:
        rep = phy_maclow.pcc_report
        if rep.plcf is None or \
                rep.plcf.short_network_id != (self.network_id & 0xFF):
            return MacLowPhy()
        if rep.plcf.transmitter_identity == self.short_rdid:
            return MacLowPhy()               # ignore own transmissions
        return self.worksub_pcc2pdc(phy_maclow, rep.plcf_type,
                                    self.network_id)

    def work_pdc(self, phy_machigh: PhyMacHigh) -> MacHighPhy:
        tb = phy_machigh.pdc_report.tb_bits
        out = MacHighPhy()
        if tb is None:
            return out
        dec = decode_mac_pdu(bits_to_bytes(tb), self.u)
        for m in dec.mmies:
            if isinstance(m, UserPlaneData):
                self.stats["rx"] += 1
                self.on_datagram(m.data, out)
        return out

    def on_datagram(self, data: bytes, out: MacHighPhy) -> None:
        self.app_rx.append(data)


class TfwRtt(_DatagramPipe):
    """UDP round-trip firmware (reference upper/rtt/tfw_rtt.cpp, pairs with
    apps/rtt): datagrams from the app go over the air; with echo=True the
    peer side bounces every received datagram straight back."""
    NAME = "rtt"

    def __init__(self, *a, echo: bool = False, **kw):
        super().__init__(*a, **kw)
        self.echo = echo

    def on_datagram(self, data: bytes, out: MacHighPhy) -> None:
        if self.echo:
            t = (self.lower.rx_time_passed if self.lower is not None else 0) \
                + self.tx_ahead
            td = self._data_td(data, t)
            if td is not None:
                out.tx_descriptors.append(td)
                self.stats["tx"] += 1
        else:
            self.app_rx.append(data)


class TfwTxrxDelay(_DatagramPipe):
    """TX->RX loopback-delay calibration (reference upper/txrxdelay/,
    README.md:282-301): transmit to itself through the simulator's TX->RX
    leakage and compare scheduled vs detected packet time."""
    NAME = "txrxdelay"

    def __init__(self, *a, period: int = 16384, **kw):
        super().__init__(*a, **kw)
        self.period = period
        self.scheduled: list[int] = []
        self.measured: list[int] = []

    def work_regular(self, now: int) -> MacHighPhy:
        out = MacHighPhy()
        td = self._data_td(b"\xA5" * 8,
                           self.now_plus_ahead())
        if td is not None:
            self.scheduled.append(td.tx_time)
            out.tx_descriptors.append(td)
            self.stats["tx"] += 1
        return out

    def now_plus_ahead(self) -> int:
        return (self.lower.rx_time_passed if self.lower else 0) + self.tx_ahead

    def work_pcc(self, phy_maclow: PhyMacLow) -> MacLowPhy:
        # own packets are the point here: record the measured arrival
        rep = phy_maclow.pcc_report
        if rep.plcf is not None and \
                rep.plcf.transmitter_identity == self.short_rdid:
            self.measured.append(phy_maclow.sync_report.fine_peak_time)
        return MacLowPhy()

    def delays(self) -> list[int]:
        """Measured arrival - scheduled TX time, per packet (samples)."""
        return [m - s for s, m in zip(self.scheduled, self.measured)]


class TfwTxrxAgc(_DatagramPipe):
    """Software-AGC exerciser (reference upper/txrxagc/): on every sync the
    RX gain steps toward the RMS target via agc_rx, applied through the
    hw's timed commands."""
    NAME = "txrxagc"

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.agc_rx = AgcRx(AgcConfig())
        self.gain_log: list[float] = []

    def work_pcc(self, phy_maclow: PhyMacLow) -> MacLowPhy:
        rms = np.asarray([phy_maclow.sync_report.rms], np.float32)
        if self.lower is not None:
            cur = np.asarray([getattr(self.lower, "rx_power_0dBFS", 0.0)],
                             np.float32)
            step = self.agc_rx.get_gain_step_db(cur, rms)
            if abs(float(step[0])) > 0:
                new = self.lower.adjust_rx_power_ant_0dBFS_tc(
                    float(cur[0] + step[0]))
                self.gain_log.append(new)
        return super().work_pcc(phy_maclow)


class TfwChscanner(Tpoint):
    """Channel-occupancy scanning firmware (reference upper/chscanner/):
    requests a chscan per regular callback and records RMS history."""
    NAME = "chscanner"

    def __init__(self, window: int = 4096, n_partial: int = 4, **kw):
        super().__init__(**kw)
        self.window = window
        self.n_partial = n_partial
        self.lower = None
        self.results: list[Chscan] = []
        self._scanner: Chscanner | None = None

    def work_regular(self, now: int) -> MacHighPhy:
        if self._scanner is None:
            self._scanner = Chscanner(self.lower)
        cs = Chscan(max(0, now - self.window), now, self.n_partial)
        done = self._scanner.scan(cs)
        if done is not None:
            self.results.append(done)
        return MacHighPhy()
