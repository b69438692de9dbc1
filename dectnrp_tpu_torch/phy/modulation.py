"""Constellation mapping & max-log soft demapping (ETSI TS 103 636-3 6.2).

Port of dectnrp_tpu/phy/modulation.py. DECT NR+ uses the LTE gray
constellations (BPSK..1024QAM): separable in I/Q for QPSK and higher, even
bit indices drive I, odd drive Q, with the recursive gray amplitude pattern.
BPSK maps to (1+j)/sqrt(2) polarity. LLR convention L = log P(1)/P(0).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# normalization 1/sqrt(E) per modulation order
_NORM = {1: np.sqrt(2.0), 2: np.sqrt(2.0), 4: np.sqrt(10.0),
         6: np.sqrt(42.0), 8: np.sqrt(170.0), 10: np.sqrt(682.0)}


@lru_cache(maxsize=None)
def _axis_levels(m_half: int):
    """Gray amplitude levels for one axis driven by m_half bits.

    Returns (levels [2**m_half] float, bits [2**m_half, m_half] uint8)
    following the recursive LTE pattern (copy of the JAX builder).
    """
    n = 1 << m_half
    levels = np.empty(n)
    bits = np.empty((n, m_half), dtype=np.uint8)
    for v in range(n):
        bs = [(v >> (m_half - 1 - i)) & 1 for i in range(m_half)]
        a = 1.0
        for i in range(m_half - 1, 0, -1):
            a = (1 << (m_half - i)) - (1 - 2 * bs[i]) * a
        a = (1 - 2 * bs[0]) * a if m_half > 1 else (1 - 2 * bs[0])
        levels[v] = a
        bits[v] = bs
    return levels, bits


def map_bits(bits: torch.Tensor, n_bps: int) -> torch.Tensor:
    """Map bits [..., n_sym*n_bps] -> complex64 symbols [..., n_sym]."""
    b = bits.reshape(*bits.shape[:-1], -1, n_bps).to(torch.float32)
    s = 1.0 - 2.0 * b                     # bit 0 -> +1
    norm = float(np.float32(_NORM[n_bps]))
    if n_bps == 1:
        return torch.complex(s[..., 0] / norm, s[..., 0] / norm)
    if n_bps == 2:
        return torch.complex(s[..., 0] / norm, s[..., 1] / norm)
    m_half = n_bps // 2

    def axis(sgn):                        # sgn [..., m_half] of +-1
        a = torch.ones_like(sgn[..., 0])
        for i in range(m_half - 1, 0, -1):
            a = (1 << (m_half - i)) - sgn[..., i] * a
        return sgn[..., 0] * a

    return torch.complex(axis(s[..., 0::2]) / norm, axis(s[..., 1::2]) / norm)


def demap_llr(y: torch.Tensor, csi: torch.Tensor, n_bps: int,
              noise_var=1.0) -> torch.Tensor:
    """Max-log LLRs [..., n_sym*n_bps] (f32) for equalized symbols y.

    csi [..., n_sym] is the real effective channel quality |h_eff|^2.
    """
    norm = float(np.float32(_NORM[n_bps]))
    if n_bps == 1:
        proj = (y.real + y.imag) / norm * 2.0
        llr1 = -2.0 * proj * csi / noise_var
        return llr1[..., None].reshape(*y.shape[:-1], -1)

    m_half = n_bps // 2
    levels, bits = _axis_levels(m_half)
    lv = torch.as_tensor((levels / _NORM[n_bps]).astype(np.float32),
                         device=y.device)
    bmask = torch.as_tensor(bits.astype(bool), device=y.device)
    inf = torch.tensor(float("inf"), device=y.device)

    def axis_llrs(r):
        d2 = (r[..., None] - lv) ** 2
        return [torch.where(~bmask[:, i], d2, inf).amin(-1)
                - torch.where(bmask[:, i], d2, inf).amin(-1)
                for i in range(m_half)]

    li = axis_llrs(y.real)
    lq = axis_llrs(y.imag)
    scale = csi / noise_var
    inter = []
    for i in range(m_half):
        inter.append(li[i] * scale)
        inter.append(lq[i] * scale)
    return torch.stack(inter, -1).reshape(*y.shape[:-1], -1)


def hard_decision(y: torch.Tensor, n_bps: int) -> torch.Tensor:
    """Nearest-constellation-point slicer (same normalization as map_bits)."""
    norm = float(np.float32(_NORM[n_bps]))
    if n_bps == 1:
        s = torch.sign(y.real + y.imag) / norm
        return torch.complex(s, s)
    levels, _ = _axis_levels(n_bps // 2)
    lv = torch.as_tensor((np.sort(levels) / _NORM[n_bps]).astype(np.float32),
                         device=y.device)

    def slice_axis(r):
        return lv[((r[..., None] - lv) ** 2).argmin(-1)]

    return torch.complex(slice_axis(y.real), slice_axis(y.imag))
