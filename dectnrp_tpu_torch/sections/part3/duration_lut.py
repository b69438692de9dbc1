"""Symbolic-unit sample durations at arbitrary sample rates.

Counterpart of reference sections_part3/derivative/{duration,duration_lut}
(duration_lut.hpp:31-73, duration.cpp:28-80): every symbolic duration (ms,
second, slot, u-subslot) divides one second without remainder, so a duration
in samples is samp_rate / divisor. The MAC uses these to place beacons on the
second raster and allocations on the subslot raster at any hardware rate.

Copy of `dectnrp_tpu/sections/part3/duration_lut.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import Enum


class DurationEc(Enum):
    """Symbolic duration unit (reference duration_ec.hpp): value = per-second
    count (reference constants.hpp:39-47)."""
    MS = 1000
    S = 1
    SLOT = 2400
    SUBSLOT_U1 = 4800
    SUBSLOT_U2 = 9600
    SUBSLOT_U4 = 19200
    SUBSLOT_U8 = 38400


def subslot_ec(u: int) -> DurationEc:
    """reference get_duration_ec_depending_on_mu (duration_ec.cpp:27-40)."""
    return {1: DurationEc.SUBSLOT_U1, 2: DurationEc.SUBSLOT_U2,
            4: DurationEc.SUBSLOT_U4, 8: DurationEc.SUBSLOT_U8}[u]


@dataclass(frozen=True)
class DurationLut:
    """Per-sample-rate conversion table (reference duration_lut_t)."""
    samp_rate: int

    def get_N_samples_from_duration(self, ec: DurationEc, mult: int = 1) -> int:
        assert self.samp_rate % ec.value == 0, \
            f"{self.samp_rate} not a multiple of {ec}"
        return (self.samp_rate // ec.value) * mult

    def get_N_samples_from_subslots(self, u: int, mult: int = 1) -> int:
        return self.get_N_samples_from_duration(subslot_ec(u), mult)

    def get_N_samples_at_last_full_second(self, t: int) -> int:
        return (t // self.samp_rate) * self.samp_rate

    def get_N_samples_at_next_full_second(self, t: int) -> int:
        return -(-t // self.samp_rate) * self.samp_rate

    def get_N_ns_from_samples(self, n: int) -> int:
        a, b = divmod(n, self.samp_rate)
        return a * 1_000_000_000 + b * 1_000_000_000 // self.samp_rate

    def get_N_us_from_samples(self, n: int) -> int:
        return self.get_N_ns_from_samples(n) // 1000

    def get_N_duration_in_second(self, ec: DurationEc, mult: int = 1) -> int:
        n = self.get_N_samples_from_duration(ec, mult)
        assert self.samp_rate % n == 0, "second not a multiple of duration"
        return self.samp_rate // n
