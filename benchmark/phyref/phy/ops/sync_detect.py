"""Smoothed, gated STF detection metric: the plain twin only.

Frozen copy of the port's `phy/ops/sync_detect.py` (its `detect_sm_plain`
and the helpers it uses); `detect_sm` runs the plain twin on every device,
so the reference never reaches a kernel.
"""
import math
from functools import lru_cache

import numpy as np
import torch


def _prefix0(x: torch.Tensor, blk: int = 512) -> torch.Tensor:
    """Exclusive prefix sum along the last axis, blocked two-level form
    (port of dectnrp_tpu/phy/sync.py::_prefix0): concat([0, cumsum(x)])."""
    T = x.shape[-1]
    nb = -(-T // blk)
    xb = torch.cat([x, x.new_zeros((*x.shape[:-1], nb * blk - T))], -1)
    xb = xb.reshape(*x.shape[:-1], nb, blk)
    local = torch.cumsum(xb, -1)
    totals = local[..., -1]
    base = torch.cumsum(totals, -1) - totals
    incl = (local + base[..., None]).reshape(*x.shape[:-1], nb * blk)[..., :T]
    return torch.cat([torch.zeros_like(incl[..., :1]), incl], -1)


def detect_metric_plain(iq: torch.Tensor, P: int, w: torch.Tensor):
    """(metric [B, n_t], Cs [B, n_t], P2s [B, n_t]) by prefix sums."""
    n_pat = w.numel() + 1
    T = iq.shape[-1]
    L = n_pat * P
    n_t = T - L - P
    p = iq[..., :-P] * torch.conj(iq[..., P:])
    Sp = _prefix0(p)
    C = sum(w[j] * (Sp[..., (j + 1) * P:(j + 1) * P + n_t]
                    - Sp[..., j * P:j * P + n_t]) for j in range(n_pat - 1))
    Sw = _prefix0(iq.abs() ** 2)
    P2 = Sw[..., L:L + n_t] - Sw[..., :n_t]
    Cs, P2s = C.sum(1), P2.sum(1)
    metric = n_pat / (n_pat - 1) * Cs.abs() / P2s.clamp_min(1e-20)
    return metric, Cs, P2s


def detect_rms(P2s: torch.Tensor, n_lr: int) -> torch.Tensor:
    """The RMS gate's statistic sqrt(P2 / n_lr), n_lr = L R samples, as an
    IEEE division (by a tensor: torch multiplies by the reciprocal of a
    Python scalar on the card) and a square root, as JAX computes it."""
    return torch.sqrt(P2s / torch.full_like(P2s, float(n_lr)))


@lru_cache(maxsize=None)
def rms_gate_bounds(rms_min: float, rms_max: float, n_lr: int) -> tuple[float, float]:
    """(p2_lo, p2_hi): the float32 P2 for which rms = sqrt(P2 / n_lr), a
    float32 IEEE division and square root as JAX and the twins compute it,
    lies in (rms_min, rms_max) (as float32) are exactly [p2_lo, p2_hi].
    Both operations are monotone, so that set is an interval of P2; its
    ends are found by bisection over the bit patterns of the float32 values
    from 0 to inf (a NaN end: no P2 passes)."""
    n, r_lo, r_hi = np.float32(n_lr), np.float32(rms_min), np.float32(rms_max)

    def f32(bits):
        return np.array(bits, np.int32).view(np.float32)

    def first(pred):
        """Smallest bit pattern in [0, inf + 1] where the monotone pred holds."""
        a, b = 0, 0x7F800001
        while a < b:
            m = (a + b) // 2
            a, b = (a, m) if pred(np.sqrt(f32(m) / n)) else (m + 1, b)
        return a
    return (float(f32(first(lambda r: r > r_lo))),
            float(f32(first(lambda r: not r < r_hi) - 1)))


def detect_sm_plain(iq: torch.Tensor, P: int, w: torch.Tensor, sl: int,
                    sr: int, thr: float, mmax: float, *, rms_min: float = 0.0,
                    rms_max: float = math.inf) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: iq complex64 [B, R, T] -> sm [B, n_t]."""
    metric, _, P2s = detect_metric_plain(iq, P, w)
    gate = (metric > thr) & (metric < mmax)
    if rms_min > 0.0:
        rms = detect_rms(P2s, (w.numel() + 1) * P * iq.shape[1])
        gate &= (rms > rms_min) & (rms < rms_max)
    g = torch.where(gate, metric, torch.zeros_like(metric))
    k = sl + sr + 1
    Sm = _prefix0(torch.nn.functional.pad(g, (sl, sr)))
    return (Sm[..., k:] - Sm[..., :-k]) / k



def detect_sm(iq: torch.Tensor, P: int, w: torch.Tensor, sl: int, sr: int,
              thr: float, mmax: float, *, rms_min: float = 0.0,
              rms_max: float = math.inf) -> torch.Tensor:
    """Smoothed gated metric sm [B, n_t] of iq complex64 [B, R, T], plain."""
    return detect_sm_plain(iq, P, w, sl, sr, thr, mmax, rms_min=rms_min,
                           rms_max=rms_max)
