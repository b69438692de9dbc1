"""SNR -> MCS mapping (CQI).

Counterpart of reference lib/src/phy/indicators/cqi_lut.cpp with its
snr_required table (cqi_lut.hpp:49-60).

Copy of `dectnrp_tpu/mac/cqi.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

SNR_REQUIRED_DB = (-1.0, 1.0, 4.0, 7.0, 11.0, 14.0, 15.0, 17.5,
                   21.0, 24.0, 27.0, 30.0)   # MCS 0..11


class CqiLut:
    def __init__(self, mcs_min: int = 0, mcs_max: int = 11,
                 snr_offset_db: float = 0.0):
        assert mcs_min <= mcs_max < len(SNR_REQUIRED_DB)
        assert snr_offset_db >= 0.0, "offset should be pessimistic"
        self.mcs_min = mcs_min
        self.mcs_max = mcs_max
        self.snr_offset_db = snr_offset_db

    def get_highest_mcs_possible(self, snr_db: float) -> int:
        snr = snr_db - self.snr_offset_db
        ret = self.mcs_min
        for m in range(self.mcs_min + 1, self.mcs_max + 1):
            if SNR_REQUIRED_DB[m] <= snr:
                ret = m
            else:
                break
        return ret

    def clamp_mcs(self, mcs: int) -> int:
        return max(self.mcs_min, min(self.mcs_max, mcs))

    @property
    def snr_at_mcs_min(self) -> float:
        return SNR_REQUIRED_DB[self.mcs_min]

    @property
    def snr_at_mcs_max(self) -> float:
        return SNR_REQUIRED_DB[self.mcs_max]
