"""Part 2: radio reception/transmission requirements -- pure band/channel tables.

ETSI TS 103 636-2. Parity: reference lib/src/sections_part2/
{channel_arrangement,channel_bandwidth,operating_bands,
radio_device_measurement,reference_time,transmitter_power}.cpp.

Copy of `dectnrp_tpu/sections/part2.py`: the port imports nothing of the JAX
package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

# band -> (n_min, n_max); spacing is 2 for all bands (Table 5.4.2-1)
_ACFN = {
    1: (1657, 1677), 2: (1680, 1700), 3: (2258, 2352), 4: (524, 552),
    5: (1, 22), 6: (288, 411), 7: (309, 321), 8: (1137, 1234),
    9: (1691, 1711), 10: (1806, 1822), 11: (2142, 2256), 12: (2374, 2511),
    13: (3126, 3183), 14: (3184, 3298), 15: (3299, 3356), 16: (3994, 4103),
    17: (4392, 4466), 18: (4105, 4203), 19: (4265, 4391),
}

# band -> (f_low_MHz, f_high_MHz) (Table 5.1-1)
_OPERATING_BANDS = {
    1: (1880.0, 1900.0), 2: (1900.0, 1920.0), 3: (2400.0, 2483.5),
    4: (902.0, 928.0), 5: (450.0, 470.0), 6: (698.0, 806.0),
    7: (716.0, 728.0), 8: (1432.0, 1517.0), 9: (1910.0, 1930.0),
    10: (2010.0, 2025.0), 11: (2300.0, 2400.0), 12: (2500.0, 2620.0),
    13: (3300.0, 3400.0), 14: (3400.0, 3600.0), 15: (3600.0, 3700.0),
    16: (4800.0, 4990.0), 17: (5725.0, 5875.0),
}


@dataclass(frozen=True)
class AbsoluteChannelFrequencyNumbering:
    band_number: int
    n_min: int
    n_max: int
    n_spacing: int = 2


@dataclass(frozen=True)
class CenterFrequency:
    acfn: AbsoluteChannelFrequencyNumbering
    n: int
    F0_hz: int
    channel_spacing_hz: int
    FC_hz: int


def get_absolute_channel_frequency_numbering(band_number: int) -> AbsoluteChannelFrequencyNumbering:
    if band_number not in _ACFN:
        raise ValueError(f"band number {band_number} unknown")
    n_min, n_max = _ACFN[band_number]
    return AbsoluteChannelFrequencyNumbering(band_number, n_min, n_max)


def get_center_frequency(band_number: int, n: int) -> CenterFrequency:
    acfn = get_absolute_channel_frequency_numbering(band_number)
    if not (acfn.n_min <= n <= acfn.n_max):
        raise ValueError(f"channel {n} out of range for band {band_number}")
    if 1 <= band_number <= 12:
        f0, spacing, offset = 450_144_000, 864_000, 0
    elif 13 <= band_number <= 16:
        f0, spacing, offset = 3_000_596_000, 1_728_000, 2952
    else:
        f0, spacing, offset = 5_150_000_000, 2_000_000, 4104
    return CenterFrequency(acfn, n, f0, spacing, f0 + (n - offset) * spacing)


def is_absolute_channel_number_in_range(n: int) -> bool:
    """13-bit signalled channel number, in range of any band (Table 5.4.2-1)."""
    if not 0 <= n <= 0x1FFF:
        return False
    return any(lo <= n <= hi for lo, hi in _ACFN.values())


@dataclass(frozen=True)
class ChannelBandwidth:
    operating_channel_bandwidth_index: int
    nominal_channel_bandwidth_hz: float
    transmission_channel_bandwidth_hz: float


def get_channel_bandwidth(index: int) -> ChannelBandwidth:
    table = {1: (1728.0, 1512.0), 2: (3456.0, 3024.0), 3: (6912.0, 6048.0)}
    if index not in table:
        raise ValueError("operating channel bandwidth index must be 1, 2 or 3")
    nom, tx = table[index]
    return ChannelBandwidth(index, nom * 1e6, tx * 1e6)


@dataclass(frozen=True)
class OperatingBand:
    band_number: int
    f_low_hz: float
    f_high_hz: float


def get_operating_band(band_number: int) -> OperatingBand:
    if band_number not in _OPERATING_BANDS:
        raise ValueError("band number must be between 1 and 17")
    lo, hi = _OPERATING_BANDS[band_number]
    return OperatingBand(band_number, lo * 1e6, hi * 1e6)


def rssi_measurement_report(measured_dbm: float) -> int:
    """RSSI-x coded report (Table in part 2 8.x)."""
    if measured_dbm > -20.5:
        return 1
    return min(2 + int(math.floor((-20.5 - measured_dbm) / 0.5)), 182)


def snr_measurement_report(measured_db: float) -> int:
    if measured_db < -4.75:
        return 1
    return min(2 + int(math.floor((4.75 + measured_db) / 0.25)), 201)


def reference_time_accuracy_ppm(extreme_condition: bool) -> int:
    return 15 if extreme_condition else 10


@dataclass(frozen=True)
class MaximumOutputPower:
    operating_channel_bandwidth_hz: int
    rd_power_class: int
    measurement_bandwidth_hz: int
    output_power_dbm: int
    tolerance_db: int = 2


def get_maximum_output_power(bw_hz: int, rd_power_class: int) -> MaximumOutputPower:
    meas = {1_728_000: 1_512_000, 3_456_000: 3_024_000, 6_912_000: 6_048_000}
    if bw_hz not in meas:
        raise ValueError("incorrect operating channel bandwidth")
    power = {1: 23, 2: 19, 3: 10}
    if rd_power_class not in power:
        raise ValueError("RD power class must be 1, 2 or 3")
    return MaximumOutputPower(bw_hz, rd_power_class, meas[bw_hz], power[rd_power_class])


MINIMUM_OUTPUT_POWER_DBM = -40
