"""Radio hardware abstraction.

Counterpart of reference lib/include/dectnrp/radio/hw.hpp:58-313: antenna and
sample-rate negotiation, timed commands in sample-count time, TX/RX power at
0 dBFS via the gain LUT, settling times, PPS. Instead of UHD streamer threads
and ring buffers, this Hw exposes batched IQ exchange: `rx_collect`
returns the next spp block, `tx_schedule` registers (tx_time, iq) bursts the
backend mixes into its output stream.

Copy of `dectnrp_tpu/radio/hw.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass, field

import numpy as np

from ..phy.resampler import VERIFIED_HW_RATES
from .gain_lut import CALIBRATION_REGISTRY, GainLut


@dataclass(frozen=True)
class Tmin:
    """Settling times in samples (reference tmin_t::{freq,gain,turnaround})."""
    freq: int = 0
    gain: int = 0
    turnaround: int = 0


@dataclass
class TimedCommand:
    time: int                  # sample count; <=0 means now
    kind: str                  # "freq" | "tx_power" | "rx_power" | "gpio"
    value: float


class Hw:
    """Base radio device in sample-count time."""

    #: supported hardware rates (Hz) -> implied resampler L/M
    RATES = tuple(sorted({r for r, _, _ in VERIFIED_HW_RATES}))

    def __init__(self, name: str, n_ant_max: int = 1,
                 calibration: str = "simulator"):
        self.name = name
        self.n_ant_max = n_ant_max
        self.n_ant = 1
        self.samp_rate = 0
        self.freq_hz = 0.0
        self.tx_power_ant_0dBFS = np.zeros(n_ant_max)
        self.rx_power_ant_0dBFS = np.zeros(n_ant_max)
        self.gain_lut = GainLut(CALIBRATION_REGISTRY[calibration])
        self.tmin = Tmin()
        self.time_advance_fpga2ant_samples = 0
        self._cmds: list[TimedCommand] = []
        self.now = 0

    @property
    def tx_earliest(self) -> int:
        """Earliest sample-count time a newly scheduled TX burst is
        guaranteed to reach the antenna in full (reference: hardware
        turnaround tmin_t::turnaround honored by
        allocation_pt_t::get_tx_opportunity(..., tx_earliest)). The radio's
        write head plus the turnaround margin; schedule at or after this."""
        return self.rx_time_passed + max(self.tmin.turnaround, 512)

    # --- negotiation (reference phy.cpp:46-86 wiring) ----------------------
    def set_nof_antennas(self, n: int) -> int:
        self.n_ant = min(n, self.n_ant_max)
        return self.n_ant

    def set_samp_rate(self, dect_rate: int) -> int:
        """Pick the smallest supported hw rate >= dect_rate."""
        i = bisect.bisect_left(self.RATES, dect_rate)
        if i == len(self.RATES):
            raise ValueError(f"no hw rate >= {dect_rate}")
        self.samp_rate = self.RATES[i]
        return self.samp_rate

    # --- timed commands ----------------------------------------------------
    def set_command_time(self, time: int = 0) -> None:
        self._cmd_time = time

    def set_freq_tc(self, freq_hz: float) -> None:
        self._push("freq", freq_hz)

    def adjust_tx_power_ant_0dBFS_tc(self, power_dbm: float) -> float:
        apg = self.gain_lut.get_achievable_power_gain_tx(power_dbm, self.freq_hz or 1e9)
        self._push("tx_power", apg.power_dbm)
        return apg.power_dbm

    def adjust_rx_power_ant_0dBFS_tc(self, power_dbm: float) -> float:
        apg = self.gain_lut.get_achievable_power_gain_rx(power_dbm, self.freq_hz or 1e9)
        self._push("rx_power", apg.power_dbm)
        return apg.power_dbm

    def toggle_gpio_tc(self) -> None:
        self._push("gpio", 1.0)

    def _push(self, kind: str, value: float) -> None:
        t = getattr(self, "_cmd_time", 0)
        self._cmds.append(TimedCommand(t, kind, value))
        self._cmd_time = 0

    def apply_due_commands(self, now: int) -> None:
        due = [c for c in self._cmds if c.time <= now]
        self._cmds = [c for c in self._cmds if c.time > now]
        for c in due:
            if c.kind == "freq":
                self.freq_hz = c.value
            elif c.kind == "tx_power":
                self.tx_power_ant_0dBFS[:self.n_ant] = c.value
            elif c.kind == "rx_power":
                self.rx_power_ant_0dBFS[:self.n_ant] = c.value

    # --- PPS ----------------------------------------------------------------
    def pps_set_full_sec_at_next_pps(self) -> int:
        """Returns the sample count of the next full second."""
        sec = self.samp_rate or 1
        return ((self.now // sec) + 1) * sec
