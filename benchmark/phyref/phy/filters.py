"""FIR design: Kaiser-windowed sinc LPF (+ raised-cosine window helper).

Behavioral parity with reference lib/src/phy/filter/{kaiser,rectangular}.cpp:
standard Kaiser-order estimate (A-7.95)/(2.285*2*pi*b), beta from stopband
attenuation, odd tap count, cutoff centered between passband and stopband,
DC-normalized. Pure numpy -- filters are designed offline at build time.

Copy of `dectnrp_tpu/phy/filters.py`: importing any `dectnrp_tpu.phy` module
loads jax through that package's `__init__`, so the port keeps its own copy.
`tests/test_torch_tables.py` holds the code equal (the float64 design must
match to the last bit, or the resampler's taps differ).
"""
from __future__ import annotations

import numpy as np


def kaiser_beta(A: float) -> float:
    if A > 50.0:
        return 0.1102 * (A - 8.7)
    if A >= 21.0:
        return 0.5842 * (A - 21.0) ** 0.4 + 0.07886 * (A - 21.0)
    return 0.0


def kaiser_lpf(f_pass: float, f_stop: float,
               passband_ripple_db: float = 100.0,
               stopband_att_db: float = 20.0,
               force_odd: bool = True) -> np.ndarray:
    """Kaiser-windowed sinc lowpass; frequencies normalized to fs=1."""
    assert 0.0 < f_pass < f_stop < 0.5
    delta = min(10.0 ** (-stopband_att_db / 20.0),
                10.0 ** (passband_ripple_db / 20.0) - 1.0)
    A = -20.0 * np.log10(delta)
    beta = kaiser_beta(A)
    b = f_stop - f_pass
    order = (A - 7.95) / (2.285 * 2.0 * np.pi * b)
    N = int(np.ceil(order + 1.0))
    if force_odd and N % 2 == 0:
        N += 1
    n = np.arange(N)
    w = np.i0(beta * np.sqrt(np.clip(1.0 - (2.0 * n / (N - 1) - 1.0) ** 2, 0, 1))) / np.i0(beta)
    f_c = f_pass + b / 2.0
    h = 2.0 * f_c * np.sinc(2.0 * f_c * (n - (N - 1) / 2.0))
    h = h * w
    return (h / np.sum(h)).astype(np.float64)


def raised_cosine_window(n_flat: int, n_ramp: int) -> np.ndarray:
    """Symmetric raised-cosine edge window for OFDM symbol TX windowing
    (reference lib/src/phy/dft/windowing)."""
    ramp = 0.5 * (1.0 - np.cos(np.pi * (np.arange(n_ramp) + 0.5) / n_ramp))
    return np.concatenate([ramp, np.ones(n_flat), ramp[::-1]])
