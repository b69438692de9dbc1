"""Transmit diversity (Alamouti space-frequency) precoding, ETSI TS 103 636-3 6.3.3.2.

Behavioral parity with reference lib/src/sections_part3/transmit_diversity_precoding.cpp:34-95:
per consecutive cell pair (x0, x1) of the single spatial stream, transmit-stream
pair (ta, tb) carries
    ta: ( x0,  x1) / sqrt(2)
    tb: (-x1*, x0*) / sqrt(2)
The TS pair used rotates through an index matrix with period 1 (N_TS=2),
6 (N_TS=4) or 12 (N_TS=8) cell pairs.

Copy of `dectnrp_tpu/sections/part3/tx_div.py`: the port imports nothing of
the JAX package. `tests/test_torch_tables.py` holds the code equal.
"""
from __future__ import annotations

import numpy as np

# TS pair schedule per N_TS (reference index_N_TS_x tables)
TS_PAIRS = {
    2: np.array([[0, 1]]),
    4: np.array([[0, 1], [2, 3], [0, 2], [1, 3], [0, 3], [1, 2]]),
    8: np.array([[0, 1], [2, 3], [4, 5], [6, 7],
                 [0, 4], [1, 5], [2, 6], [3, 7],
                 [0, 2], [1, 3], [4, 6], [5, 7]]),
}


def get_modulo(N_TS: int) -> int:
    return {2: 1, 4: 6, 8: 12}[N_TS]


def alamouti_map(x: np.ndarray, N_TS: int, pair_offset: int = 0) -> np.ndarray:
    """Map a single-spatial-stream cell vector x [n_cells] (n_cells even) to
    transmit streams, shape [N_TS, n_cells]. numpy reference implementation;
    the jit TX path mirrors this with static index arrays.

    pair_offset: index of the first cell pair within the TS-pair rotation
    (used to continue the rotation across symbols).
    """
    n = x.size
    assert n % 2 == 0
    n_pairs = n // 2
    pairs = TS_PAIRS[N_TS]
    mod = get_modulo(N_TS)

    out = np.zeros((N_TS, n), dtype=np.complex128)
    x0 = x[0::2]
    x1 = x[1::2]
    s = 1.0 / np.sqrt(2.0)
    for p in range(n_pairs):
        ta, tb = pairs[(pair_offset + p) % mod]
        out[ta, 2 * p] = s * x0[p]
        out[ta, 2 * p + 1] = s * x1[p]
        out[tb, 2 * p] = -s * np.conj(x1[p])
        out[tb, 2 * p + 1] = s * np.conj(x0[p])
    return out
