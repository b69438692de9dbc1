"""Antenna array geometry + steering vectors.

Counterpart of reference radio/antenna_array.hpp (arrangement linear /
linear_uneven / circle with spacings in meters) — extended with the parts
the reference leaves unused: element positions and narrowband steering
vectors, which feed the AoA estimator (phy/mimo.py estimate_aoa; the
reference's estimator_aoa_t is a 39-LoC stub).

Copy of `dectnrp_tpu/radio/antenna_array.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

C0 = 299_792_458.0


@dataclass(frozen=True)
class AntennaArray:
    """Array geometry: element positions in the horizontal plane (meters).

    arrangement: "linear" (even spacing along x), "linear_uneven" (explicit
    inter-element spacings), "circle" (evenly on a circle of radius
    spacing[0]).
    """
    arrangement: str = "linear"
    n_ant: int = 1
    spacing: tuple[float, ...] = (0.05,)

    def positions(self) -> np.ndarray:
        """[n_ant, 2] element xy positions in meters."""
        if self.arrangement == "linear":
            x = np.arange(self.n_ant) * self.spacing[0]
            return np.stack([x, np.zeros_like(x)], axis=1)
        if self.arrangement == "linear_uneven":
            assert len(self.spacing) >= self.n_ant - 1
            x = np.concatenate([[0.0], np.cumsum(self.spacing[: self.n_ant - 1])])
            return np.stack([x, np.zeros_like(x)], axis=1)
        if self.arrangement == "circle":
            ang = 2 * np.pi * np.arange(self.n_ant) / max(self.n_ant, 1)
            r = self.spacing[0]
            return np.stack([r * np.cos(ang), r * np.sin(ang)], axis=1)
        raise ValueError(f"unknown arrangement {self.arrangement!r}")

    def steering(self, azimuth_rad: np.ndarray, freq_hz: float) -> np.ndarray:
        """Narrowband steering vectors a(theta) [n_theta, n_ant].

        Plane wave from azimuth theta (x axis = 0): phase
        exp(-j 2 pi f/c * (px cos th + py sin th)).
        """
        pos = self.positions()                                # [A, 2]
        k = 2 * np.pi * freq_hz / C0
        d = (pos[None, :, 0] * np.cos(azimuth_rad)[:, None]
             + pos[None, :, 1] * np.sin(azimuth_rad)[:, None])
        return np.exp(-1j * k * d)
