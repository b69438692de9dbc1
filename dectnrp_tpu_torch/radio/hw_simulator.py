"""Simulated radio: a node in the virtual space (port of
dectnrp_tpu/radio/hw_simulator.py; reference lib/src/radio/hw_simulator.cpp).

The reference runs TX/RX pthreads that exchange one spp per tick with
vspace_t in lock-step; here `SimDriver.tick()` advances all nodes
synchronously: each node's TX spp is assembled from its scheduled bursts
(zeros in between, like work_tx sending zeros until tx_time_64,
hw_simulator.cpp:370-619), pushed through the vspace superposition on the
space's device, and the result is appended to each node's RX ring.

The RX ring (reference buffer_rx_t: one shared ring, global time IS the
sample counter) is a true ring on the host, `common/ring.MirroredRing`:
sample t at column t mod C and again at t mod C + C of twice the capacity
C, so every window of the last C samples is one contiguous view and a push
writes only its own samples, twice (counter `sim.rx_ring_bytes`); no
stored sample ever moves. Each tick moves the [N, A, spp] TX block to the device and the
RX block back, once each. A tick is the span `sim.tick`,
with the children `sim.assemble` (the TX block on the host), `sim.ether`
(the copy, the space's tick, the read back) and `sim.deliver` (the RX
rings and the radios' timed commands).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..common.ring import MirroredRing
from ..common.trace import d2h, h2d, span
from ..simulation.vspace import VNodeConfig, VSpace, VSpaceConfig
from .hw import Hw


@dataclass
class TxBurst:
    tx_time: int               # global sample count of first sample
    iq: np.ndarray             # [A, n]
    order_id: int = 0


class HwSimulator(Hw):
    """One simulated node; TX bursts in, RX ring out. `device` is where
    its samples are processed (set by SimDriver to the space's device)."""

    def __init__(self, n_ant: int = 1, rx_ring_len: int = 1 << 20,
                 name: str = "simulator"):
        super().__init__(name, n_ant_max=n_ant, calibration="simulator")
        self.n_ant = n_ant
        self._bursts: list[TxBurst] = []
        self._order_cnt = 0
        self.rx_ring_len = rx_ring_len
        self._ring = MirroredRing(n_ant, rx_ring_len, "sim.rx_ring_bytes")
        self.device = torch.device("cuda")

    # --- TX side ------------------------------------------------------------
    def tx_schedule(self, tx_time: int, iq: np.ndarray) -> int:
        """Schedule a burst; returns its tx_order_id (buffer_tx_meta_t)."""
        assert iq.ndim == 2 and iq.shape[0] == self.n_ant
        oid = self._order_cnt
        self._order_cnt += 1
        self._bursts.append(TxBurst(tx_time, np.asarray(iq, np.complex64), oid))
        return oid

    def assemble_tx_spp(self, t0: int, spp: int) -> np.ndarray:
        """[A, spp] samples for global window [t0, t0+spp): scheduled bursts
        over zeros; fully-transmitted bursts are retired."""
        out = np.zeros((self.n_ant, spp), np.complex64)
        keep = []
        for b in self._bursts:
            n = b.iq.shape[1]
            s = max(b.tx_time, t0)
            e = min(b.tx_time + n, t0 + spp)
            if s < e:
                out[:, s - t0:e - t0] += b.iq[:, s - b.tx_time:e - b.tx_time]
            if b.tx_time + n > t0 + spp:
                keep.append(b)
        self._bursts = keep
        return out

    # --- RX side ------------------------------------------------------------
    def push_rx_spp(self, spp_iq: np.ndarray) -> None:
        """Append [A, n] samples, n <= C: the oldest n fall out of the ring."""
        self._ring.push(spp_iq)

    @property
    def rx_time_passed(self) -> int:
        """Global time of the next sample pushed."""
        return self._ring.end

    @property
    def rx_time(self) -> int:
        """Global time of the oldest sample held."""
        return self._ring.start

    def get_rx_stream(self, t0: int, n: int) -> np.ndarray:
        """[A, n] samples for global window [t0, t0+n) (must be in the ring):
        a view, never a copy."""
        return self._ring.window(t0, n)


class SimDriver:
    """Lock-steps N HwSimulator nodes through a VSpace on `device`."""

    def __init__(self, cfg: VSpaceConfig, hws: list[HwSimulator],
                 node_cfgs: list[VNodeConfig] | None = None,
                 device: torch.device | str = "cuda"):
        self.hws = hws
        node_cfgs = node_cfgs or [VNodeConfig(n_ant=h.n_ant) for h in hws]
        self.vspace = VSpace(cfg, node_cfgs, device)
        self.spp = cfg.spp_len
        for h in hws:
            h.samp_rate = int(cfg.samp_rate)
            h.device = self.vspace.device

    @property
    def now(self) -> int:
        return self.vspace.now

    def tick(self, draws: dict | None = None) -> None:
        """One spp period; `draws` (vspace.draw_tick's dict) replaces the
        space's own draws for this tick."""
        with span("sim.tick"):
            t0 = self.vspace.now
            A = self.vspace.A
            with span("sim.assemble"):
                tx = np.zeros((len(self.hws), A, self.spp), np.complex64)
                for i, h in enumerate(self.hws):
                    tx[i, :h.n_ant] = h.assemble_tx_spp(t0, self.spp)
            with span("sim.ether"):
                h2d(tx.nbytes)
                rx = self.vspace.tick(torch.from_numpy(tx).to(self.vspace.device),
                                      draws)
                d2h(rx.numel() * rx.element_size())
                rx = rx.cpu().numpy()
            with span("sim.deliver"):
                for i, h in enumerate(self.hws):
                    h.push_rx_spp(rx[i, :h.n_ant])
                    h.now = self.vspace.now
                    h.apply_due_commands(self.vspace.now)

    def run_until(self, t: int) -> None:
        while self.vspace.now < t:
            self.tick()
