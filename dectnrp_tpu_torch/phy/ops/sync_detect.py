"""Smoothed, gated STF detection metric: CUDA kernel wrapper and plain twin.

Port of dectnrp_tpu/phy/ops/sync_detect.py::build_sync_sm (the TPU kernel
chosen at dectnrp_tpu/phy/sync.py:148-151). For an IQ stream x [B, R, T]
with STF pattern length P = 16 b and n_pat patterns (L = n_pat P):

  C[t]  = sum_j w_j * sum_{i=t+jP}^{t+(j+1)P-1} x[i] conj(x[i+P])
  P2[t] = sum_{i=t}^{t+L-1} |x[i]|^2            (both summed over R antennas)
  metric = n_pat/(n_pat-1) * |C| / P2, gated to (thr, mmax), zero outside
  [0, n_t) with n_t = T - L - P, box-smoothed over [t-sl, t+sr] / k.

`detect_sm` launches the kernel (csrc/sync_detect.cu) for CUDA tensors and
runs `detect_sm_plain` (the `sm` of phy/sync.py::_detect_xla, T-long
blocked float32 prefix sums) for CPU tensors; any other device raises.
Unlike the TPU kernel (P % 128 == 0, b in {8, 16}) both serve every b.
"""
from __future__ import annotations

import torch

launches = 0          # kernel launches made by detect_sm


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


def detect_sm_plain(iq: torch.Tensor, P: int, w: torch.Tensor, sl: int,
                    sr: int, thr: float, mmax: float) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: iq complex64 [B, R, T] -> sm [B, n_t]."""
    metric, _, _ = detect_metric_plain(iq, P, w)
    g = torch.where((metric > thr) & (metric < mmax), metric,
                    torch.zeros_like(metric))
    k = sl + sr + 1
    Sm = _prefix0(torch.nn.functional.pad(g, (sl, sr)))
    return (Sm[..., k:] - Sm[..., :-k]) / k


def gate_tie_mask(metric: torch.Tensor, thr: float, mmax: float, sl: int,
                  sr: int, eps: float) -> torch.Tensor:
    """[B, n_t] True where no sample in the smoothing window [t-sl, t+sr]
    has a metric within eps of a gate edge.

    Two correct float32 implementations may gate such a sample differently
    (a tie), which moves sm by metric/k over the window; outside these
    windows the two must agree to rounding.
    """
    tie = (((metric - thr).abs() < eps) | ((metric - mmax).abs() < eps))
    k = sl + sr + 1
    S = _prefix0(torch.nn.functional.pad(tie.to(torch.float32), (sl, sr)))
    return (S[..., k:] - S[..., :-k]) == 0


def detect_sm(iq: torch.Tensor, P: int, w: torch.Tensor, sl: int, sr: int,
              thr: float, mmax: float) -> torch.Tensor:
    """Smoothed gated metric sm [B, n_t] of iq complex64 [B, R, T].

    w: float32 [n_pat-1] pairwise cover weights, on iq's device.
    CUDA tensors launch the kernel; CPU tensors run the plain twin.
    """
    if iq.device.type == "cpu":
        return detect_sm_plain(iq, P, w, sl, sr, thr, mmax)
    if iq.device.type != "cuda":
        raise ValueError(f"detect_sm: unsupported device {iq.device}")
    if iq.dtype != torch.complex64 or iq.dim() != 3 or not iq.is_contiguous():
        raise ValueError("detect_sm: iq must be contiguous complex64 [B, R, T]")
    if w.dtype != torch.float32 or w.device != iq.device or not w.is_contiguous():
        raise ValueError("detect_sm: w must be contiguous float32 on iq's device")
    B, R, T = iq.shape
    n_pat = w.numel() + 1
    n_t = T - n_pat * P - P
    if n_t <= 0:
        raise ValueError("detect_sm: stream shorter than STF + one pattern")
    from ... import kernels

    lib = kernels.load()
    sm = torch.empty((B, n_t), dtype=torch.float32, device=iq.device)
    err = lib.sync_detect_sm(torch.view_as_real(iq).data_ptr(), w.data_ptr(),
                             sm.data_ptr(), B, R, T, P, n_pat, sl, sr,
                             float(thr), float(mmax),
                             kernels.stream_ptr(iq.device))
    kernels.check(err, "sync_detect_sm")
    global launches
    launches += 1
    return sm
