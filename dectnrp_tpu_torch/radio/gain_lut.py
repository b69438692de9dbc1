"""Gain <-> power-at-0dBFS lookup with frequency interpolation.

Counterpart of reference lib/src/radio/gain_lut.cpp: per device a table of
(freqs x gain steps) measured TX/RX powers; a requested power at a given
frequency interpolates between the two nearest calibration frequencies and
the two nearest power points, then snaps the gain to the device's gain step.

Calibration data: the simulator device uses the reference's exact idealized
2-point table (cal_simulator.hpp); USRP devices carry the reference's
frequency grids and power ranges with per-device endpoint anchors -- real
deployments re-measure them with the txrxagc calibration firmware
(reference README.md:282-301), which is the supported workflow here too.

Copy of `dectnrp_tpu/radio/gain_lut.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class CalibrationTable:
    """Per-device measured gain->power curves, one row per frequency."""
    name: str
    freqs_hz: tuple[float, ...]
    gains_tx_db: tuple[tuple[float, ...], ...]
    powers_tx_dbm: tuple[tuple[float, ...], ...]
    gains_tx_step: float
    gains_rx_db: tuple[tuple[float, ...], ...]
    powers_rx_dbm: tuple[tuple[float, ...], ...]
    gains_rx_step: float


def _ramp(lo, hi, n):
    return tuple(float(v) for v in np.linspace(lo, hi, n))


_USRP_FREQS = tuple(0.5e9 * i for i in range(1, 13))

CAL_SIMULATOR = CalibrationTable(
    "simulator", (0.1e9, 6.0e9),
    ((0.0, 60.0),) * 2, ((-40.0, 20.0),) * 2, 1.0,
    ((70.0, 0.0),) * 2, ((-60.0, 10.0),) * 2, 1.0)

# USRP devices: reference frequency grid, endpoint-anchored curves
CAL_USRP_B210 = CalibrationTable(
    "b210", _USRP_FREQS,
    (_ramp(27.0, 90.0, 12),) * 12, (_ramp(-45.0, 16.0, 12),) * 12, 1.0,
    ((76.0, 0.0),) * 12, ((-60.0, 15.0),) * 12, 1.0)
CAL_USRP_N310 = CalibrationTable(
    "n310", _USRP_FREQS,
    (_ramp(0.0, 55.0, 12),) * 12, (_ramp(-40.0, 15.0, 12),) * 12, 1.0,
    ((75.0, 0.0),) * 12, ((-36.0, 39.0),) * 12, 1.0)
CAL_USRP_N320 = CalibrationTable(
    "n320", _USRP_FREQS,
    (_ramp(0.0, 60.0, 13),) * 12, (_ramp(-38.0, 18.0, 13),) * 12, 1.0,
    ((60.0, 0.0),) * 12, ((-42.0, 18.0),) * 12, 1.0)
CAL_USRP_X410 = CalibrationTable(
    "x410", _USRP_FREQS,
    (_ramp(0.0, 60.0, 13),) * 12, (_ramp(-40.0, 17.0, 13),) * 12, 1.0,
    ((60.0, 0.0),) * 12, ((-55.0, 20.0),) * 12, 1.0)

CALIBRATION_REGISTRY = {t.name: t for t in
                        (CAL_SIMULATOR, CAL_USRP_B210, CAL_USRP_N310,
                         CAL_USRP_N320, CAL_USRP_X410)}


@dataclass(frozen=True)
class AchievablePowerGain:
    power_dbm: float
    gain_db: float


def _interp_points(vec: np.ndarray, value: float):
    """Indices + weights of the two nearest grid points (clamped)."""
    if value <= vec[0]:
        return 0, 0, 1.0, 0.0
    if value >= vec[-1]:
        n = len(vec) - 1
        return n, n, 1.0, 0.0
    r = int(np.searchsorted(vec, value))
    l = r - 1
    wr = (value - vec[l]) / (vec[r] - vec[l])
    return l, r, 1.0 - wr, wr


class GainLut:
    """reference gain_lut_t::get_achievable_power_gain_{tx,rx}."""

    def __init__(self, cal: CalibrationTable):
        self.cal = cal

    def _achievable(self, gains, powers, step, power_dbm, freq_hz):
        freqs = np.asarray(self.cal.freqs_hz)
        fl, fr, wl, wr = _interp_points(freqs, freq_hz)

        def row_gain(row):
            g = np.asarray(gains[row], float)
            p = np.asarray(powers[row], float)
            # powers may be descending for RX tables; make ascending
            if p[0] > p[-1]:
                p, g = p[::-1], g[::-1]
            pl, pr, a, b = _interp_points(p, power_dbm)
            return a * g[pl] + b * g[pr], a * p[pl] + b * p[pr]

        g_l, p_l = row_gain(fl)
        g_r, p_r = row_gain(fr)
        gain = wl * g_l + wr * g_r
        # snap to the device gain step; recompute the power it achieves
        gain_q = round(gain / step) * step
        power = wl * p_l + wr * p_r + (gain_q - gain) * _slope_sign(gains, powers)
        return AchievablePowerGain(float(power), float(gain_q))

    def get_achievable_power_gain_tx(self, power_dbm: float,
                                     freq_hz: float) -> AchievablePowerGain:
        return self._achievable(self.cal.gains_tx_db, self.cal.powers_tx_dbm,
                                self.cal.gains_tx_step, power_dbm, freq_hz)

    def get_achievable_power_gain_rx(self, power_dbm: float,
                                     freq_hz: float) -> AchievablePowerGain:
        return self._achievable(self.cal.gains_rx_db, self.cal.powers_rx_dbm,
                                self.cal.gains_rx_step, power_dbm, freq_hz)


def _slope_sign(gains, powers) -> float:
    """Approximate dBm-per-dB-gain slope sign (+1 TX-like, -1 RX-like)."""
    g = gains[0]
    p = powers[0]
    return 1.0 if (g[-1] - g[0]) * (p[-1] - p[0]) >= 0 else -1.0
