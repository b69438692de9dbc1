"""Slow software AGC: per-antenna gain steps toward an RMS target.

Counterpart of reference lib/src/phy/agc/{agc,agc_rx,agc_tx,roundrobin}.cpp:
measured RMS (from sync reports) drives quantized gain steps toward
rms_target, per-antenna or collectively, with a sensitivity-spread cap and
round-robin application across antennas.

Copy of `dectnrp_tpu/phy/agc.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

OFDM_AMPLITUDE_FACTOR = {0: 1.0, 3: 0.707945784, 6: 0.501187233,
                         10: 0.316227766, 15: 0.177827941, 20: 0.1}


def mag2db(x: float) -> float:
    return 20.0 * np.log10(max(x, 1e-12))


@dataclass
class AgcConfig:
    nof_antennas: int = 1
    gain_step_db_min: float = 1.0       # quantization step
    gain_step_db_max: float = 12.0      # slew limit per update
    roundrobin: bool = False            # apply one antenna per update


class Agc:
    def __init__(self, cfg: AgcConfig):
        self.cfg = cfg
        self._rr = 0

    def _quantize_limit(self, step: np.ndarray) -> np.ndarray:
        q = self.cfg.gain_step_db_min
        s = np.round(step / q) * q
        s = np.clip(s, -self.cfg.gain_step_db_max, self.cfg.gain_step_db_max)
        return s

    def _apply_rr(self, step: np.ndarray) -> np.ndarray:
        if not self.cfg.roundrobin or self.cfg.nof_antennas == 1:
            return step
        out = np.zeros_like(step)
        out[self._rr] = step[self._rr]
        self._rr = (self._rr + 1) % self.cfg.nof_antennas
        return out


class AgcRx(Agc):
    """rms measured -> dB gain steps for rx_power_ant_0dBFS adjustment."""

    def __init__(self, cfg: AgcConfig, rms_target: float = 0.316227766,
                 sensitivity_offset_max_db: float = 12.0,
                 tune_individually: bool = True):
        super().__init__(cfg)
        assert 0.1 <= rms_target <= 1.0
        assert 0.0 <= sensitivity_offset_max_db <= 20.0
        self.rms_target = rms_target
        self.sensitivity_offset_max_db = sensitivity_offset_max_db
        self.tune_individually = tune_individually

    def get_gain_step_db(self, rx_power_ant_0dBFS: np.ndarray,
                         rms_measured: np.ndarray) -> np.ndarray:
        a = float(np.max(rx_power_ant_0dBFS))
        b = a - self.sensitivity_offset_max_db
        if self.tune_individually:
            step = np.empty(self.cfg.nof_antennas)
            for i in range(self.cfg.nof_antennas):
                c = mag2db(rms_measured[i] / self.rms_target) \
                    if rms_measured[i] > 0 else a - rx_power_ant_0dBFS[i]
                d = b - rx_power_ant_0dBFS[i]
                step[i] = max(c, d)
        else:
            i = int(np.argmax(rms_measured))
            c = mag2db(rms_measured[i] / self.rms_target)
            d = b - rx_power_ant_0dBFS[i]
            step = np.full(self.cfg.nof_antennas, max(c, d))
        return self._apply_rr(self._quantize_limit(step))


class AgcTx(Agc):
    """TX counterpart: step toward a requested TX power change (reference
    agc_tx_t: driven by PLCF TransmitPower feedback)."""

    def get_gain_step_db(self, tx_power_ant_0dBFS: np.ndarray,
                         tx_power_target_dbm: float) -> np.ndarray:
        step = tx_power_target_dbm - np.asarray(tx_power_ant_0dBFS, float)
        return self._apply_rr(self._quantize_limit(step))
