"""Beamforming / antenna-port-mapping codebooks W, ETSI TS 103 636-3 6.3.4.

Behavioral parity with reference lib/src/sections_part3/beamforming_and_antenna_port_mapping.cpp
(Tables 6.3.4-1..6): W maps N_TS transmit streams to N_TX antennas,
y_TX = scale * W @ x_TS, scale = 1/sqrt(nnz(W)).

Copy of `dectnrp_tpu/sections/part3/beamforming.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

_J = 1j

# flattened row-major [N_TX, N_TS] matrices per (N_TS, N_TX) codebook
_W_RAW = {
    (1, 1): [[1]],
    (1, 2): [[1, 0], [0, 1], [1, 1], [1, -1], [1, _J], [1, -_J]],
    (1, 4): [
        [1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1],
        [1, 0, 1, 0], [1, 0, -1, 0], [1, 0, _J, 0], [1, 0, -_J, 0],
        [0, 1, 0, 1], [0, 1, 0, -1], [0, 1, 0, _J], [0, 1, 0, -_J],
        [1, 1, 1, 1], [1, 1, _J, _J], [1, 1, -1, -1], [1, 1, -_J, -_J],
        [1, _J, 1, _J], [1, _J, _J, -1], [1, _J, -1, -_J], [1, _J, -_J, 1],
        [1, -1, 1, -1], [1, -1, _J, -_J], [1, -1, -1, 1], [1, -1, -_J, _J],
        [1, -_J, 1, -_J], [1, -_J, _J, 1], [1, -_J, -1, _J], [1, -_J, -_J, -1],
    ],
    (2, 2): [[1, 0, 0, 1], [1, 1, 1, -1], [1, 1, _J, -_J]],
    (2, 4): [
        [1, 0, 0, 1, 0, 0, 0, 0], [1, 0, 0, 0, 0, 1, 0, 0], [1, 0, 0, 0, 0, 0, 0, 1],
        [0, 0, 1, 0, 0, 1, 0, 0], [0, 0, 1, 0, 0, 0, 0, 1], [0, 0, 0, 0, 1, 0, 0, 1],
        [1, 0, 0, 1, 1, 0, 0, -_J], [1, 0, 0, 1, 1, 0, 0, _J], [1, 0, 0, 1, -_J, 0, 0, 1],
        [1, 0, 0, 1, -_J, 0, 0, -1], [1, 0, 0, 1, -1, 0, 0, -_J], [1, 0, 0, 1, -1, 0, 0, _J],
        [1, 0, 0, 1, _J, 0, 0, 1], [1, 0, 0, 1, _J, 0, 0, -1],
        [1, 1, 1, 1, 1, -1, 1, -1], [1, 1, 1, 1, _J, -_J, _J, -_J],
        [1, 1, _J, _J, 1, -1, _J, -_J], [1, 1, _J, _J, _J, -_J, -1, 1],
        [1, 1, -1, -1, 1, -1, -1, 1], [1, 1, -1, -1, _J, -_J, -_J, _J],
        [1, 1, -_J, -_J, 1, -1, -_J, _J], [1, 1, -_J, -_J, _J, -_J, 1, -1],
    ],
    (4, 4): [
        [1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1],
        [1, 1, 0, 0, 0, 0, 1, 1, 1, -1, 0, 0, 0, 0, 1, -1],
        [1, 1, 0, 0, 0, 0, 1, 1, _J, -_J, 0, 0, 0, 0, _J, -_J],
        [1, 1, 1, 1, 1, -1, 1, -1, 1, 1, -1, -1, 1, -1, -1, 1],
        [1, 1, 1, 1, 1, -1, 1, -1, _J, _J, -_J, -_J, _J, -_J, -_J, _J],
    ],
    (8, 8): [list(np.eye(8).ravel())],
}

CODEBOOK_SIZES = {k: len(v) for k, v in _W_RAW.items()}


@lru_cache(maxsize=None)
def get_W(N_TS: int, N_TX: int, codebook_idx: int) -> np.ndarray:
    """Beamforming matrix [N_TX, N_TS], power-normalized (scale 1/sqrt(nnz))."""
    mats = _W_RAW[(N_TS, N_TX)]
    if codebook_idx >= len(mats):
        raise ValueError(
            f"codebook index {codebook_idx} out of range for N_TS={N_TS}, N_TX={N_TX}")
    w = np.array(mats[codebook_idx], dtype=np.complex128).reshape(N_TX, N_TS)
    nnz = np.count_nonzero(w)
    return w / np.sqrt(nnz)


def clamp_codebook_index(N_TS: int, N_TX: int, codebook_idx: int) -> int:
    return min(codebook_idx, CODEBOOK_SIZES[(N_TS, N_TX)] - 1)


@lru_cache(maxsize=None)
def get_all_W(N_TS: int, N_TX: int) -> np.ndarray:
    """All codebook matrices stacked [n_codebooks, N_TX, N_TS] (for exhaustive search)."""
    n = CODEBOOK_SIZES[(N_TS, N_TX)]
    return np.stack([get_W(N_TS, N_TX, i) for i in range(n)])
