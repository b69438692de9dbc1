"""Polyphase fractional resampler, plain: the DECT (n x 1.728 Ms/s) <->
SDR (n x 1.92 Ms/s family) rate bridge of the benchmark's reference.

Frozen copy of the port's `phy/resampler.py` (`ResamplerPlan`, `_design`,
`stream_input_lag`, `Resampler`, `ResamplerStream`) with its FIR, the
kernel B3 (`ops/polyphase.polyphase_fir`), replaced by the kernel's plain
twin (`polyphase_fir_plain`, frames gathered by a static index, then one
einsum with the taps) on every device, in float32 taps and complex64
samples. TF32 is off, so the einsum's products are full float32.

Departures from upstream's `lib/src/phy/resample/resampler.cpp`, which the
port follows: the filter is the same merged anti-image / anti-alias Kaiser
low-pass (f_pass, f_stop and attenuation per oversampling factor from
`resampler_param.hpp:53-88`, scaled by max(L, M), taps scaled by L), laid
out as L phases over one window of W input samples a frame instead of
upstream's per-input-phase subfilter schedules and unrolled 10/9 and 9/10
loops; the output is delay-free (y[k] at input time k M / L, the filter
delay skipped as upstream's N_skip_input_samples_front); a one-shot call
flushes its tail with zeros (upstream's resample_final_samples), and a
stream carries H input samples of history across steps (overlap-save,
`resampler.cpp:234-242, 312-431`). Upstream sums in a different order
(VOLK dot products), so its float32 results differ from these by rounding.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch

from .filters import kaiser_lpf
from .plan import register_tables

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

# filter specs per oversampling factor (reference resampler_param.hpp:53-88)
F_PASS_NORM = {1: 0.48, 2: 0.30, 4: 0.20, 8: 0.15}
F_STOP_NORM = 0.499
F_STOP_ATT_DB = {1: 14.0, 2: 20.0, 4: 20.0, 8: 20.0}


@dataclass(frozen=True)
class ResamplerPlan:
    L: int
    M: int
    os: int = 1

    @property
    def identity(self) -> bool:
        return self.L == self.M == 1


@lru_cache(maxsize=None)
def _design(plan: ResamplerPlan):
    """Returns (G [L, W], first_frame_m0, W): G row l holds subfilter
    phase(l) at its input-window offset; y[gL+l] = sum_w G[l,w] x[gM+m0+w]."""
    L, M = plan.L, plan.M
    big = max(L, M)
    h = kaiser_lpf(F_PASS_NORM[plan.os] / big, F_STOP_NORM / big,
                   stopband_att_db=F_STOP_ATT_DB[plan.os]) * L
    fd = (h.size - 1) // 2
    n_sub = -(-h.size // L)
    h = np.pad(h, (0, n_sub * L - h.size))
    m0 = (0 * M + fd) // L - (n_sub - 1)          # leftmost input tap of y[0]
    m_hi = ((L - 1) * M + fd) // L                # rightmost input tap of y[L-1]
    W = m_hi - m0 + 1
    G = np.zeros((L, W), dtype=np.float32)
    for l in range(L):
        p = (l * M + fd) % L
        mm = (l * M + fd) // L
        for t in range(n_sub):
            G[l, mm - t - m0] = h[p + t * L]
    return G, m0, W


def _out_len(n_in: int, L: int, M: int) -> int:
    return -(-n_in * L // M)


def stream_input_lag(plan: ResamplerPlan) -> int:
    """Input-sample lag D_in of the streaming resampler: chained steps over
    x equal Resampler(concat([zeros(D_in), x]))."""
    if plan.identity:
        return 0
    G, m0, W = _design(plan)
    return max(0, W + m0 - plan.M)


def polyphase_fir_plain(x: torch.Tensor, taps: torch.Tensor, L: int, M: int,
                        m0: int, n_out: int) -> torch.Tensor:
    """y[..., gL + l] = sum_w taps[l, w] x[..., gM + m0 + w], x zero outside
    [0, n_in): x complex64 [..., n_in] -> [..., n_out]."""
    n_in, W = x.shape[-1], taps.shape[1]
    n_frames = -(-n_out // L)
    pad_l = max(0, -m0)
    pad_r = max(0, (n_frames - 1) * M + m0 + W - n_in)
    xp = torch.nn.functional.pad(x, (pad_l, pad_r))
    fidx = (torch.arange(n_frames, device=x.device)[:, None] * M + m0 + pad_l
            + torch.arange(W, device=x.device)[None, :])          # [n_frames, W]
    frames = xp[..., fidx]                                        # [..., n_frames, W]
    y = torch.einsum("...fw,lw->...fl", frames, taps.to(x.dtype))
    return y.reshape(*x.shape[:-1], n_frames * L)[..., :n_out]


class Resampler(torch.nn.Module):
    """resample(x complex64 [..., n_in]) -> [..., ceil(n_in L / M)],
    delay-free, the tail flushed with zeros."""

    def __init__(self, plan: ResamplerPlan, n_in: int):
        super().__init__()
        self.plan, self.n_in = plan, n_in
        self.n_out = _out_len(n_in, plan.L, plan.M)
        if not plan.identity:
            G, self.m0, _ = _design(plan)
            register_tables(self, {"G": G})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.plan.identity:
            return x
        if x.shape[-1] != self.n_in:
            raise ValueError(f"resampler: expected {self.n_in} input samples, "
                             f"got {x.shape[-1]}")
        return polyphase_fir_plain(x.contiguous(), self.G, self.plan.L,
                                   self.plan.M, self.m0, self.n_out)


class ResamplerStream(torch.nn.Module):
    """step(x complex64 [..., chunk_in], hist [..., H]) -> (y [..., chunk_in
    L / M], hist' [..., H]); hist starts as zeros (overlap-save)."""

    def __init__(self, plan: ResamplerPlan, chunk_in: int):
        super().__init__()
        self.plan, self.chunk_in = plan, chunk_in
        if plan.identity:
            self.H = 0
            return
        if chunk_in % plan.M:
            raise ValueError("chunk length must be a multiple of M")
        G, m0, W = _design(plan)
        pad_l = max(0, -m0)
        self.H = pad_l + max(0, W + m0 - plan.M)  # history carried across chunks
        self.off = m0 + pad_l                     # frame g reads hist+x from g*M + off
        self.n_out = chunk_in // plan.M * plan.L
        register_tables(self, {"G": G})

    def forward(self, x: torch.Tensor, hist: torch.Tensor):
        if self.plan.identity:
            return x, hist
        xp = torch.cat([hist, x], -1)
        y = polyphase_fir_plain(xp, self.G, self.plan.L, self.plan.M, self.off,
                                self.n_out)
        return y, xp[..., self.chunk_in:]


def build_resampler(plan: ResamplerPlan, n_in: int,
                    device: torch.device | str = "cuda") -> Resampler:
    return Resampler(plan, n_in).to(device)


def build_resampler_stream(plan: ResamplerPlan, chunk_in: int,
                           device: torch.device | str = "cuda") -> ResamplerStream:
    return ResamplerStream(plan, chunk_in).to(device)
