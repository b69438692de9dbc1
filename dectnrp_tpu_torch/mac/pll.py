"""Clock-drift estimation from beacon arrival times.

Counterpart of reference lib/src/mac/pll/pll.cpp:32-118: a ring of accepted
beacon times; each new beacon paired with the oldest known yields a warp
factor (observed span / nominal span), smoothed by an EMA; ppm = (warp-1)e6.

Copy of `dectnrp_tpu/mac/pll.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

UNDEFINED_EARLY = -(2 ** 62)


class Pll:
    def __init__(self, beacon_period: int, samp_rate: int,
                 dist_min_accept_ms: int = 100, dist_min_ms: int = 1000,
                 dist_min_to_max_in_beacon_periods: int = 16,
                 ema_alpha: float = 0.1, ppm_out_of_sync: float = 100.0):
        self.beacon_period = beacon_period
        self.dist_min_accept = samp_rate * dist_min_accept_ms // 1000
        self.dist_min = samp_rate * dist_min_ms // 1000
        self.dist_max = self.dist_min + beacon_period * dist_min_to_max_in_beacon_periods
        n = max(2, self.dist_min // max(1, self.dist_min_accept))
        self._ring = [UNDEFINED_EARLY] * n
        self._idx = 0
        self._alpha = ema_alpha
        self._warp = 1.0
        self.ppm_out_of_sync = ppm_out_of_sync

    def _next_idx(self) -> int:
        return (self._idx + 1) % len(self._ring)

    @property
    def beacon_time_last_known(self) -> int:
        prev = (self._idx - 1) % len(self._ring)
        return self._ring[prev]

    def provide_beacon_time(self, beacon_time: int) -> None:
        if beacon_time - self.beacon_time_last_known < self.dist_min_accept:
            return
        self._ring[self._idx] = beacon_time
        oldest = self._ring[self._next_idx()]
        if oldest < 0:
            self._idx = self._next_idx()
            return
        dist = self._ring[self._idx] - oldest
        self._idx = self._next_idx()
        if dist > self.dist_max:
            return
        n_periods = round(dist / self.beacon_period)
        if n_periods == 0:
            return
        warp = dist / (n_periods * self.beacon_period)
        if abs(warp - 1.0) * 1e6 > self.ppm_out_of_sync:
            return
        self._warp += self._alpha * (warp - self._warp)

    @property
    def warp_factor(self) -> float:
        return self._warp

    @property
    def ppm(self) -> float:
        return (self._warp - 1.0) * 1e6

    def reset(self) -> None:
        self._ring = [UNDEFINED_EARLY] * len(self._ring)
        self._idx = 0
        self._warp = 1.0
