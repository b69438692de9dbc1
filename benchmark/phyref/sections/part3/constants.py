"""DECT NR+ (ETSI TS 103 636-3) fixed constants.

Behavioral parity with the reference SDR's constants table
(reference: lib/include/dectnrp/constants.hpp:26-85), re-derived from the standard.

Copy of `dectnrp_tpu/sections/part3/constants.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""

# Table 4.3-1: FFT size and cyclic prefix per beta unit
N_B_DFT_MIN = 64          # N_b_DFT for b=1
N_B_CP_MIN = 8            # N_b_CP for b=1 (12.5 % of DFT length)
N_B_DFT_CP_MIN = N_B_DFT_MIN + N_B_CP_MIN  # 72 samples per OFDM symbol at b=1

SAMP_RATE_MIN_U_B = 1_728_000   # base DECT sample rate for u=1, b=1
SUBCARRIER_SPACING_MIN = 27_000  # Hz, scaled by u

SLOTS_PER_10MS = 24
SLOTS_PER_SEC = 2400

# STF structure: repeated 16*b-sample patterns (u=1: 7 patterns, u>=2: 9 patterns)
N_STF_PATTERN_U1 = 7
N_STF_PATTERN_U248 = 9
N_SAMPLES_STF_PATTERN = 16  # at b=1, scales with b

# STF occupies every 4th occupied subcarrier -> 14*b cells
N_STF_CELLS_B1 = 14
N_STF_CELLS_SPACING = 4

N_TS_MAX = 8

# PLCF (physical layer control field) sizes, 7.5.2.1: CRC16 appended
PLCF_TYPE_1_BIT = 40
PLCF_TYPE_2_BIT = 80
PCC_BITS = 196   # PCC always QPSK over 98 cells
PCC_CELLS = 98

RV_MAX = 3

ALLOWED_U = (1, 2, 4, 8)
ALLOWED_B = (1, 2, 4, 8, 12, 16)
