"""Steady/TAI clock utilities (reference common/thread/watch.hpp:
watch_t with steady or TAI base, sleep_until, busywait_until).

Copy of `dectnrp_tpu/common/watch.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

import time

# TAI-UTC offset (s); Linux CLOCK_TAI uses the kernel's notion when set,
# the reference assumes a correctly configured host (watch.hpp comments)
TAI_UTC_OFFSET_S = 37


class Watch:
    """Elapsed-time watch over the monotonic clock."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = time.monotonic_ns()

    def get_elapsed_ns(self) -> int:
        return time.monotonic_ns() - self._t0

    def get_elapsed_s(self) -> float:
        return self.get_elapsed_ns() / 1e9

    def is_elapsed(self, duration_s: float) -> bool:
        return self.get_elapsed_s() >= duration_s

    # --- absolute-time helpers (sleep/busywait, watch.hpp) -----------------
    @staticmethod
    def sleep_until_monotonic(t_ns: int) -> None:
        d = t_ns - time.monotonic_ns()
        if d > 0:
            time.sleep(d / 1e9)

    @staticmethod
    def busywait_until_monotonic(t_ns: int) -> None:
        while time.monotonic_ns() < t_ns:
            pass

    @staticmethod
    def tai_now_ns() -> int:
        """TAI epoch time; falls back to UTC + fixed offset when the kernel
        TAI clock is unavailable/unset."""
        try:
            t = time.clock_gettime_ns(time.CLOCK_TAI)
            # unconfigured kernels report TAI == UTC; apply offset then
            if abs(t - time.time_ns()) < 1_000_000_000:
                return time.time_ns() + TAI_UTC_OFFSET_S * 10 ** 9
            return t
        except (AttributeError, OSError):
            return time.time_ns() + TAI_UTC_OFFSET_S * 10 ** 9

    @staticmethod
    def next_full_second_ns(now_ns: int, extra_s: int = 1) -> int:
        """Start of the next full second (+extra), for PPS-aligned starts
        (reference pps_set_full_sec_at_next_pps...)."""
        return (now_ns // 10 ** 9 + extra_s) * 10 ** 9
