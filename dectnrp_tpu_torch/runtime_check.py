"""The runtime exchanges of tools/run_tpu_runtime_check.py, rebuilt on the
port: two nodes over the virtual ether, each with its own NodeRuntime.

  dect   beacons (psdef (1, 1, 0, 2, 0, 2), PLCF type 1) from node 0 to
         node 1 at the DECT rate, 1.728 Ms/s;
  sdr    the same with both radios at 1.92 Ms/s, so the streaming 9/10
         resampler front end and the 10/9 TX resampler are in the loop;
  mimo   2 x 2 antennas, tm 2 (N_SS = 2 spatial multiplexing), PLCF type 2
         carrying n_ss = 2: the receiver derives tm 2 from the detected
         N_eff_TX and the PLCF and decodes both streams by MMSE;
  rdc_2124a  radio device class 2.12.4.A (TS 103 636-3 Annex C): 4 x 4
         antennas, u = 2, b = 12 at the DECT rate 41.472 Ms/s, tm 5 (4-TX
         transmit diversity) packets of 3 subslots at MCS 2, two code
         blocks of a TB: the receiver derives tm 5 from N_eff_TX = 4.

spp and sync chunks of 2048 b samples (a beacon every 4 spp), noise
variance 1e-8, the nodes 1 m apart. `build` makes an
exchange on a device; `run` drives it tick by tick and returns its
counters; the exchange keeps every tick's host time and what the receiver
saw (detection times, SNR estimates, decoded TBs). `run` takes the vspace draws of each
tick from a callable when given one, so two runs (the card and the CPU, or
the JAX package and the port) can share them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from .radio.hw_simulator import HwSimulator, SimDriver
from .sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from .sections.part4.identity import Identity
from .sections.part4.plcf import Plcf10, Plcf20
from .simulation.topology import Position, Trajectory
from .simulation.vspace import VNodeConfig, VSpaceConfig, draw_tick
from .upper.runtime import NodeRuntime, ResampledFrontEnd
from .upper.tpoint import MacHighPhy, MacLowPhy, Tpoint, TxDescriptor

IDENT = Identity(0x12345678, 0x2222, 0x3333)
SPP, NOISE_VAR, DECT_RATE, SDR_RATE = 2048, 1e-8, 1_728_000, 1_920_000


class Kind(NamedTuple):
    psdef: PacketSizesDef
    n_ant: int
    rate: int                   # the radios' rate
    n_max: int                  # beacons sent
    seed0: int                  # the first TB's seed
    t_min: int                  # ticks at least
    t_max: int                  # ticks at most

    @property
    def spp(self) -> int:
        """Samples a tick, and of a sync chunk: 2048 b."""
        return SPP * self.psdef.b


KINDS = {
    "dect": Kind(PacketSizesDef(1, 1, 0, 2, 0, 2, 6144), 1, DECT_RATE, 4, 0, 40, 120),
    "sdr": Kind(PacketSizesDef(1, 1, 0, 2, 0, 2, 6144), 1, SDR_RATE, 4, 0, 40, 120),
    "mimo": Kind(PacketSizesDef(1, 1, 0, 2, 2, 2, 6144), 2, DECT_RATE, 2, 100, 20, 80),
    "rdc_2124a": Kind(PacketSizesDef(2, 12, 0, 3, 5, 2, 6144), 4, 41_472_000,
                      2, 200, 16, 40),
}


class TxBeacon(Tpoint):
    """Sends `n_max` beacons, one a regular call, each 2000 samples ahead
    of the MAC's clock and never behind the radio's earliest TX time."""

    def __init__(self, psdef: PacketSizesDef, n_max: int, seed0: int):
        super().__init__()
        self.psdef, self.n_max, self.seed0 = psdef, n_max, seed0
        self.sent = 0
        self.payloads: list[np.ndarray] = []

    def work_regular(self, now):
        out = MacHighPhy()
        if self.sent >= self.n_max:          # stop early so the tail drains
            return out
        p = self.psdef
        ps = get_packet_sizes(p)
        tb = np.random.default_rng(self.seed0 + self.sent).integers(
            0, 2, ps.N_TB_bits).astype(np.uint8)
        self.payloads.append(tb)
        self.sent += 1
        kw = dict(packet_length_type=p.PacketLengthType,
                  packet_length=p.PacketLength,
                  short_network_id=IDENT.short_network_id,
                  transmitter_identity=IDENT.short_rdid,
                  transmit_power=7, df_mcs=p.mcs_index)
        if p.tm_mode_index == 2:
            plcf = Plcf20(**kw, receiver_identity=0x4444)
            plcf.set_n_ss(2)
        else:
            plcf = Plcf10(**kw)
        out.tx_descriptors.append(TxDescriptor(
            psdef=p, plcf=plcf, tb_bits=tb, network_id=IDENT.network_id,
            tx_time=max(now + 2000, self.lower.tx_earliest)))
        return out


class RxCounter(Tpoint):
    """Continues with the PDC of every packet from IDENT and records what
    it saw: detection times, PCC and PDC SNR estimates, TBs, n_ss."""

    def __init__(self, payload_ref: list):
        super().__init__()
        self.payload_ref = payload_ref
        self.pdc = 0
        self.tb_match = 0
        self.n_ss_seen = 0
        self.detection_times: list[int] = []
        self.pcc_snr_db: list[float] = []
        self.pdc_snr_db: list[float] = []
        self.tbs: list[np.ndarray] = []

    def work_pcc(self, phy_maclow):
        rep = phy_maclow.pcc_report
        self.detection_times.append(phy_maclow.sync_report.fine_peak_time)
        self.pcc_snr_db.append(rep.snr_db)
        if rep.plcf is None or \
                rep.plcf.transmitter_identity != IDENT.short_rdid:
            return MacLowPhy()
        self.n_ss_seen = max(self.n_ss_seen, getattr(rep.plcf, "n_ss", 1))
        return self.worksub_pcc2pdc(phy_maclow, rep.plcf_type,
                                    IDENT.network_id)

    def work_pdc(self, phy_machigh):
        self.pdc += 1
        got = phy_machigh.pdc_report.tb_bits
        self.tbs.append(got)
        self.pdc_snr_db.append(phy_machigh.pdc_report.snr_db)
        if any(np.array_equal(got, p) for p in self.payload_ref):
            self.tb_match += 1
        return MacHighPhy()


@dataclass
class Exchange:
    kind: str
    drv: SimDriver
    tx_fw: TxBeacon
    rx_fw: RxCounter
    rt_tx: NodeRuntime
    rt_rx: NodeRuntime
    tick_ms: list = field(default_factory=list)      # host time a tick


def build(kind: str, device: torch.device | str = "cuda") -> Exchange:
    """The exchange `kind` (KINDS) with its ether and PHY on `device`."""
    k = KINDS[kind]
    hws = [HwSimulator(k.n_ant), HwSimulator(k.n_ant)]
    cfg = VSpaceConfig(samp_rate=float(k.rate), spp_len=k.spp, noise_var=NOISE_VAR)
    nodes = [VNodeConfig(k.n_ant, Trajectory(Position(0, 0, 0))),
             VNodeConfig(k.n_ant, Trajectory(Position(1.0, 0, 0)))]
    drv = SimDriver(cfg, hws, nodes, device)
    tx_fw = TxBeacon(k.psdef, k.n_max, k.seed0)
    rx_fw = RxCounter(tx_fw.payloads)
    geo = dict(u=k.psdef.u, b=k.psdef.b, chunk_len=k.spp, hw_samp_rate=k.rate,
               device=device)
    rt_tx = NodeRuntime(hws[0], tx_fw, IDENT.network_id,
                        regular_period=4 * k.spp, **geo)
    rt_rx = NodeRuntime(hws[1], rx_fw, IDENT.network_id, **geo)
    return Exchange(kind, drv, tx_fw, rx_fw, rt_tx, rt_rx)


def done(ex: Exchange) -> bool:
    """Every beacon sent so far decoded with its payload, nothing pending."""
    return ex.rx_fw.tb_match >= ex.tx_fw.sent and not ex.rt_rx._pending \
        and not ex.rt_rx._pending_pdc


def run(ex: Exchange, draws=None, ticks: int | None = None,
        sync=None) -> dict:
    """Drive the exchange: `ticks` ticks, or as the tool does, until every
    beacon is decoded once the least number of ticks has passed (at most
    the kind's most). `draws(now)` gives each tick's vspace draws; `sync`
    (e.g. torch.cuda.synchronize) ends each tick's host time."""
    k = KINDS[ex.kind]
    n = 0
    while n < (ticks or k.t_max):
        t0 = time.perf_counter()
        ex.drv.tick(draws(ex.drv.now) if draws is not None else None)
        ex.rt_tx.process()
        ex.rt_rx.process()
        if sync is not None:
            sync()
        ex.tick_ms.append((time.perf_counter() - t0) * 1e3)
        n += 1
        if ticks is None and n >= k.t_min and done(ex):
            break
    return summary(ex)


def summary(ex: Exchange) -> dict:
    """Counters and the gate of the tool: every sent beacon decoded with its
    payload, none scheduled late (and n_ss = 2 seen in the mimo exchange)."""
    n_max = KINDS[ex.kind].n_max
    ok = ex.tx_fw.sent >= n_max and ex.rx_fw.tb_match == ex.tx_fw.sent \
        and ex.rt_tx.stats.tx_late == 0
    if ex.kind == "mimo":
        ok = ok and ex.rx_fw.n_ss_seen == 2
    engaged = isinstance(ex.rt_rx.front_end, ResampledFrontEnd)
    return {"kind": ex.kind, "resampler_engaged": engaged,
            "tx_sent": ex.tx_fw.sent, "pdc_decoded": ex.rx_fw.pdc,
            "tb_payload_match": ex.rx_fw.tb_match,
            "n_ss_from_plcf": ex.rx_fw.n_ss_seen,
            "tx_late": ex.rt_tx.stats.tx_late, "ticks": len(ex.tick_ms),
            "rx_stats": vars(ex.rt_rx.stats), "tx_stats": vars(ex.rt_tx.stats),
            "detection_times": list(ex.rx_fw.detection_times), "ok": bool(ok)}


def cpu_draws(ex: Exchange, seed: int = 0):
    """draws(now) for `run`: each tick's vspace draws made on the CPU from
    a generator seeded by (seed, now), moved to the exchange's device. Two
    exchanges (the card's and the CPU's) handed these see the same ether."""
    vs = ex.drv.vspace
    c = vs.cfg

    def draws(now: int) -> dict:
        g = torch.Generator().manual_seed(seed * (1 << 40) + now)
        d = draw_tick(g, vs.N, vs.A, c.spp_len, c.channel_inter, c.samp_rate,
                      c.noise_var, "cpu")
        return {k: v.to(vs.device) for k, v in d.items()}
    return draws


def differences(a: Exchange, b: Exchange) -> list[str]:
    """Where two runs of one exchange decided differently: RuntimeStats of
    either node, detection times, decoded TBs (empty when they agree)."""
    out = []
    for name in ("rt_tx", "rt_rx"):
        if vars(getattr(a, name).stats) != vars(getattr(b, name).stats):
            out.append(f"{name} stats {vars(getattr(a, name).stats)} != "
                       f"{vars(getattr(b, name).stats)}")
    if a.rx_fw.detection_times != b.rx_fw.detection_times:
        out.append(f"detection times {a.rx_fw.detection_times} != "
                   f"{b.rx_fw.detection_times}")
    if len(a.rx_fw.tbs) != len(b.rx_fw.tbs) or not all(
            np.array_equal(x, y) for x, y in zip(a.rx_fw.tbs, b.rx_fw.tbs)):
        out.append("decoded TBs differ")
    return out
