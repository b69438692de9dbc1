"""Turbo rate matching, 3GPP TS 36.212 5.1.4.1 (as used by DECT NR+ 6.1.5).

All index LUTs are precomputed per (K, E, rv) with numpy and cached; on device
both directions are pure gathers/scatter-adds:
    TX: e = d_flat[sel_idx]
    RX: d_llr = zeros(3*(K+4)).at[sel_idx].add(e_llr)   (soft combining)

Numpy-only copy of `dectnrp_tpu/phy/fec/rate_match.py`: importing any `dectnrp_tpu.phy`
module loads jax through that package's `__init__`, so the port keeps
its own copy. `tests/test_torch_tables.py` holds it equal to the original.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

# sub-block interleaver column permutation pattern
_PERM = np.array([0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
                  1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31],
                 dtype=np.int64)
_C_SB = 32


@lru_cache(maxsize=None)
def _w_to_d(K: int) -> np.ndarray:
    """Map circular-buffer index -> flat d index (stream*(K+4)+pos), -1 = dummy.

    Flat d layout: d.reshape(3*(K+4)) with stream-major ordering.
    """
    D = K + 4
    R = -(-D // _C_SB)
    Kp = R * _C_SB
    nd = Kp - D

    # v0/v1: pad with nd dummies, fill R x 32 row-major, permute columns, read col-major
    padded = np.concatenate([np.full(nd, -1, dtype=np.int64), np.arange(D)])
    mat = padded.reshape(R, _C_SB)
    v01 = mat[:, _PERM].T.ravel()  # read column-by-column (after permutation)

    # v2: pi(k) = (P[k//R] + 32*(k%R) + 1) mod Kp on the padded sequence
    k = np.arange(Kp)
    pi2 = (_PERM[k // R] + _C_SB * (k % R) + 1) % Kp
    v2 = padded[pi2]

    w = np.empty(3 * Kp, dtype=np.int64)
    w[:Kp] = np.where(v01 >= 0, v01, -1)                      # stream 0
    w1 = np.where(v01 >= 0, v01 + D, -1)                      # stream 1
    w2 = np.where(v2 >= 0, v2 + 2 * D, -1)                    # stream 2
    w[Kp::2] = w1
    w[Kp + 1::2] = w2
    return w


@lru_cache(maxsize=None)
def sel_indices(K: int, E: int, rv: int) -> np.ndarray:
    """Indices into flat d [3*(K+4)] selecting the E transmitted soft bits."""
    w = _w_to_d(K)
    Ncb = w.size
    R = -(-(K + 4) // _C_SB)
    k0 = R * (2 * (-(-Ncb // (8 * R))) * rv + 2)

    order = w[(k0 + np.arange(Ncb)) % Ncb]
    real = order[order >= 0]          # one full pass over non-dummy positions
    n_real = real.size
    assert n_real == 3 * (K + 4)
    reps = -(-E // n_real)
    return np.tile(real, reps)[:E].astype(np.int32)


def tx_rate_match(d: np.ndarray, E: int, rv: int) -> np.ndarray:
    """d [3, K+4] bits -> e [E] bits (numpy reference path)."""
    K = d.shape[1] - 4
    return d.reshape(-1)[sel_indices(K, E, rv)]


def rx_rate_dematch(e_llr: np.ndarray, K: int, rv: int) -> np.ndarray:
    """e [E] LLRs -> d [3, K+4] LLRs with soft combining (numpy reference path)."""
    sel = sel_indices(K, e_llr.size, rv)
    d = np.zeros(3 * (K + 4), dtype=np.float64)
    np.add.at(d, sel, e_llr)
    return d.reshape(3, K + 4)


def cb_e_sizes(G: int, Qm: int, C: int) -> list[int]:
    """Per-codeblock rate-matching output sizes.

    Reference lib/src/phy/fec/pdc_enc.cpp:151-177: Gp = G/Qm, gamma = Gp mod C;
    codeblock cb gets Qm*floor(Gp/C) bits for cb <= C-gamma-1 else Qm*ceil(Gp/C).
    """
    Gp = G // Qm
    gamma = Gp % C if C > 0 else Gp
    out = []
    for cb in range(C):
        if cb <= C - gamma - 1:
            out.append(Qm * (Gp // C))
        else:
            out.append(Qm * (-(-Gp // C)))
    assert sum(out) == G
    return out
