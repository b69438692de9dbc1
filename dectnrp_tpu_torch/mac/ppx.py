"""PPS-like pulse scheduling phase-locked to beacons.

Counterpart of reference lib/src/mac/ppx/ppx.cpp:29-96: a rising-edge
estimate advanced by a (drift-warped) period, corrected toward each observed
beacon time snapped to the beacon raster.

Copy of `dectnrp_tpu/mac/ppx.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class PulseConfig:
    """Rising/falling edge sample times (reference radio/pulse_config_t)."""
    rising_edge: int
    falling_edge: int


class Ppx:
    def __init__(self, ppx_period: int, ppx_length: int,
                 ppx_time_advance: int, beacon_period: int,
                 time_deviation_max: int):
        assert ppx_length < ppx_period
        assert ppx_time_advance < ppx_period
        assert beacon_period <= ppx_period
        assert ppx_period % beacon_period == 0
        self.ppx_period = ppx_period
        self.ppx_length = ppx_length
        self.ppx_time_advance = ppx_time_advance
        self.beacon_period = beacon_period
        self.time_deviation_max = time_deviation_max
        self.ppx_period_warped = ppx_period
        self._edge = -1

    def set_ppx_rising_edge(self, t: int) -> None:
        assert self._edge < 0, "already initialized"
        assert t > 0
        self._edge = t

    @property
    def rising_edge_estimation(self) -> int:
        return self._edge

    def extrapolate_next_rising_edge(self) -> None:
        self._edge += self.ppx_period_warped

    def set_warp_factor(self, warp: float) -> None:
        self.ppx_period_warped = int(round(self.ppx_period * warp))

    @staticmethod
    def _determine_offset(ref: int, raster: int, t: int) -> int:
        n = round((t - ref) / raster)
        return t - (ref + n * raster)

    def provide_beacon_time(self, beacon_time: int,
                            beacon_period_custom: int | None = None) -> None:
        assert self._edge >= 0, "not initialized yet"
        raster = beacon_period_custom or self.beacon_period
        dev = self._determine_offset(self._edge, raster, beacon_time)
        assert abs(dev) <= self.time_deviation_max, "synchronization lost"
        self._edge += dev

    def get_ppx_imminent(self) -> PulseConfig:
        a = self._edge + self.ppx_period_warped
        return PulseConfig(a, a + self.ppx_length)

    def get_time_of_preparation(self) -> int:
        return self._edge + self.ppx_period_warped - self.ppx_time_advance
