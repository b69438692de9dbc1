"""Beacon-period resource allocation grid for FT and PT.

Counterpart of reference lib/src/mac/allocation/: resources are (offset,
length) sample windows within the beacon period; UL/DL sets must be mutually
orthogonal; `get_tx_opportunity` picks the next valid slot after tx_earliest
honoring hardware turnaround and validity windows (allocation_pt.cpp:32-150+).

Copy of `dectnrp_tpu/mac/allocation.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import Enum

UNDEFINED_EARLY = -(2 ** 62)


class Direction(Enum):
    UL = "ul"
    DL = "dl"


@dataclass(frozen=True)
class Resource:
    """Offset + length in samples within the beacon period."""
    offset: int
    length: int

    @property
    def last_sample(self) -> int:
        return self.offset + self.length - 1

    def is_orthogonal(self, other: "Resource") -> bool:
        return self.offset + self.length <= other.offset or \
            other.offset + other.length <= self.offset


@dataclass(frozen=True)
class TxOpportunity:
    tx_time: int = -1
    n_samples: int = -1

    @property
    def valid(self) -> bool:
        return self.tx_time >= 0

    @property
    def end(self) -> int:
        return self.tx_time + self.n_samples


class AllocationPt:
    """PT-side allocation: mirrors the FT's beacon grid.

    FTs request DL opportunities, PTs request UL opportunities.
    """

    def __init__(self, beacon_period: int,
                 validity_after_beacon: int,
                 validity_after_now: int,
                 turnaround_time: int):
        self.beacon_period = beacon_period
        self.validity_after_beacon = validity_after_beacon
        self.validity_after_now = validity_after_now
        self.turnaround_time = turnaround_time
        self.beacon_time_last_known = UNDEFINED_EARLY
        self._res: dict[Direction, list[Resource]] = {
            Direction.UL: [], Direction.DL: []}

    def add_resource(self, direction: Direction, offset: int, length: int) -> None:
        r = Resource(offset, length)
        assert r.last_sample < self.beacon_period, "outside of beacon period"
        assert all(r.is_orthogonal(x) for x in self._res[direction]), \
            "resource not orthogonal"
        self._res[direction].append(r)
        self._res[direction].sort(key=lambda x: x.offset)

    def add_resource_regular(self, direction: Direction, offset: int,
                             length: int, stride: int, n: int) -> None:
        for i in range(n):
            self.add_resource(direction, offset + stride * i, length)

    def clear(self) -> None:
        self._res = {Direction.UL: [], Direction.DL: []}

    def resources(self, direction: Direction) -> list[Resource]:
        return list(self._res[direction])

    def get_tx_opportunity(self, direction: Direction, now: int,
                           tx_earliest: int) -> TxOpportunity:
        if self.beacon_time_last_known == UNDEFINED_EARLY:
            return TxOpportunity()
        rvec = self._res[direction]
        if not rvec:
            return TxOpportunity()
        earliest = max(tx_earliest, now + self.turnaround_time)
        if direction is Direction.UL:
            latest = min(
                self.beacon_time_last_known + self.validity_after_beacon,
                now + self.validity_after_now)
        else:
            latest = self.beacon_time_last_known + self.beacon_period
        if earliest > latest:
            return TxOpportunity()
        # walk beacon periods from the one containing `earliest`
        k = max(0, (earliest - self.beacon_time_last_known) // self.beacon_period)
        for period in (k, k + 1, k + 2):
            base = self.beacon_time_last_known + period * self.beacon_period
            for r in rvec:
                t = base + r.offset
                if t >= earliest and t + r.length - 1 <= latest:
                    return TxOpportunity(t, r.length)
        return TxOpportunity()

    def get_ul_time_closest(self, reference_time: int) -> int:
        """Signed distance of reference_time to the closest UL slot start."""
        if self.beacon_time_last_known == UNDEFINED_EARLY:
            return UNDEFINED_EARLY
        best = UNDEFINED_EARLY
        for r in self._res[Direction.UL]:
            a = reference_time - (self.beacon_time_last_known + r.offset)
            if abs(a) < abs(best):
                best = a
        return best


class AllocationFt:
    """FT-side: owns the beacon-period grid over all its PTs.

    (reference allocation_ft_t: orthogonality across ALL allocated
    resources, per-PT views are AllocationPt-shaped.)
    """

    def __init__(self, beacon_period: int):
        self.beacon_period = beacon_period
        self._all: list[Resource] = []
        self.per_pt: dict[int, dict[Direction, list[Resource]]] = {}

    def allocate(self, pt_id: int, direction: Direction, offset: int,
                 length: int) -> Resource:
        r = Resource(offset, length)
        assert r.last_sample < self.beacon_period, "outside of beacon period"
        assert all(r.is_orthogonal(x) for x in self._all), "overlapping resource"
        self._all.append(r)
        self.per_pt.setdefault(pt_id, {Direction.UL: [], Direction.DL: []})[
            direction].append(r)
        return r

    def release_pt(self, pt_id: int) -> None:
        for rs in self.per_pt.pop(pt_id, {}).values():
            for r in rs:
                self._all.remove(r)

    def find_free(self, length: int, after_offset: int = 0) -> int | None:
        """Smallest orthogonal offset >= after_offset, or None."""
        occupied = sorted((r.offset, r.offset + r.length) for r in self._all)
        t = after_offset
        for s, e in occupied:
            if t + length <= s:
                break
            t = max(t, e)
        if t + length > self.beacon_period:
            return None
        return t
