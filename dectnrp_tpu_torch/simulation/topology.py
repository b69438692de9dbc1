"""Node positions and trajectories for the virtual space.

Parity: reference lib/src/simulation/topology/{position,trajectory}.cpp --
point (static), linear (ping-pong between offset and a target) and circular
trajectories, evaluated at arbitrary simulation times.

Copy of `dectnrp_tpu/simulation/topology.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class Position:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0

    def distance(self, other: "Position") -> float:
        return math.sqrt((self.x - other.x) ** 2 + (self.y - other.y) ** 2
                         + (self.z - other.z) ** 2)


@dataclass
class Trajectory:
    """shape: 'point' | 'circle' | 'line'.

    circle: radius around offset at angular speed speed/radius.
    line: ping-pong from offset towards `target` and back at `speed` m/s.
    """
    offset: Position = field(default_factory=Position)
    shape: str = "point"
    speed: float = 0.0
    radius: float = 0.0
    target: Position | None = None

    def position_at(self, t_s: float) -> Position:
        if self.shape == "point" or self.speed == 0.0:
            return self.offset
        if self.shape == "circle":
            ang = self.speed / self.radius * t_s
            return Position(self.offset.x + self.radius * math.cos(ang),
                            self.offset.y + self.radius * math.sin(ang),
                            self.offset.z)
        if self.shape == "line":
            assert self.target is not None
            d = self.offset.distance(self.target)
            if d == 0.0:
                return self.offset
            # ping-pong parameterization in [0, 2d)
            s = (self.speed * t_s) % (2.0 * d)
            frac = s / d if s <= d else 2.0 - s / d
            return Position(
                self.offset.x + (self.target.x - self.offset.x) * frac,
                self.offset.y + (self.target.y - self.offset.y) * frac,
                self.offset.z + (self.target.z - self.offset.z) * frac)
        raise ValueError(f"unknown trajectory shape {self.shape}")


def fspl_db(d_m: float, f_hz: float) -> float:
    """Free-space path loss (reference pathloss.cpp: floor at 0 dB)."""
    if d_m <= 0.0 or f_hz <= 0.0:
        return 0.0
    v = 20.0 * math.log10(d_m) + 20.0 * math.log10(f_hz) - 147.55
    return max(v, 0.0)
