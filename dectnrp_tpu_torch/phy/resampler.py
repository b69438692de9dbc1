"""Polyphase fractional resampler: the DECT (n x 1.728 Ms/s) <-> SDR
(n x 1.92 / 30.72M-family) rate bridge (port of dectnrp_tpu/phy/resampler.py).

Reference: lib/src/phy/resample/resampler.cpp. The same merged
anti-image/anti-alias Kaiser LPF (f_pass/f_stop/att specs from
resampler_param.hpp:53-88, scaled by max(L, M), coefficients scaled by L) and
the same delay-free output alignment (filter delay skipped, y[k] ~ x(k*M/L)).
Every group of L outputs is one frame: y[gL + l] = sum_w G[l, w] x[gM + m0 + w]
with the L polyphase subfilters embedded in G [L, W] at their window offsets
(`_design`, copied table for table). The FIR runs in ops/polyphase.py: the
CUDA kernel on the card, its plain twin on CPU. Streaming carries a history
of W - M input samples across chunks (overlap-save, reference
resampler.cpp:234-242, 312-431) and calls the same FIR on history + chunk.

The JAX module's TPU-only choices (`_resolve_impl`'s pallas / xla_sf /
gather, the super-frame and lane-aligned designs) have no counterpart here.
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from functools import lru_cache

import numpy as np
import torch

from .filters import kaiser_lpf
from .ops.polyphase import polyphase_fir
from .plan import register_tables

# filter specs per oversampling factor (reference resampler_param.hpp:53-88)
F_PASS_NORM = {1: 0.48, 2: 0.30, 4: 0.20, 8: 0.15}
F_STOP_NORM = 0.499
F_STOP_ATT_DB = {1: 14.0, 2: 20.0, 4: 20.0, 8: 20.0}

# verified (hw_samp_rate, L, M) table (reference phy_config.cpp:32-67);
# dect_rate * L / M == hw_samp_rate * os_implied
VERIFIED_HW_RATES: tuple[tuple[int, int, int], ...] = (
    # native DECT rates, no resampling
    *(((r, 1, 1)) for r in (1728000, 3456000, 6912000, 13824000, 20736000,
                            27648000, 41472000, 55296000, 82944000,
                            110592000, 165888000, 221184000,
                            331776000, 442368000)),
    # LTE 30.72 MHz family
    (1920000, 10, 9), (3840000, 10, 9), (7680000, 10, 9), (15360000, 10, 9),
    (30720000, 40, 27), (30720000, 10, 9), (61440000, 40, 27),
    (61440000, 10, 9), (122880000, 40, 27), (122880000, 10, 9),
    (245760000, 40, 27), (245760000, 10, 9),
    (491520000, 40, 27), (491520000, 10, 9),
)


def get_resampler_fraction(dect_rate: int, hw_rate: int) -> tuple[int, int]:
    """L/M with hw_rate = dect_rate * L / M (TX direction), reduced."""
    f = Fraction(hw_rate, dect_rate)
    L, M = f.numerator, f.denominator
    if (L, M) not in {(1, 1), (10, 9), (40, 27), (20, 9), (80, 27), (2, 1)}:
        raise ValueError(f"unsupported resampling ratio {L}/{M} "
                         f"({dect_rate} -> {hw_rate})")
    return L, M


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
    """Returns (G [L, W], first_frame_m0): G row l holds subfilter phase(l)
    at its input-window offset; y[gL+l] = sum_w G[l,w] * x[gM + m0 + w]."""
    L, M = plan.L, plan.M
    big = max(L, M)
    h = kaiser_lpf(F_PASS_NORM[plan.os] / big, F_STOP_NORM / big,
                   stopband_att_db=F_STOP_ATT_DB[plan.os]) * L
    fd = (h.size - 1) // 2
    n_sub = -(-h.size // L)
    h = np.pad(h, (0, n_sub * L - h.size))
    # y[k] = sum_t h[p_k + t*L] * x[m_max_k - t],  m_max_k = (k*M + fd) // L
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
    """Input-sample lag D_in of the streaming resampler: chaining
    build_resampler_stream steps over x equals build_resampler applied to
    concat([zeros(D_in), x]). Output sample k therefore corresponds to input
    time k*M/L - D_in (the time-mapping constant for RX pacing)."""
    if plan.identity:
        return 0
    G, m0, W = _design(plan)
    return max(0, W + m0 - plan.M)


class Resampler(torch.nn.Module):
    """resample(x complex64 [..., n_in]) -> [..., ceil(n_in L / M)].

    Delay-free: y[k] lands at input time k*M/L (the filter group delay is
    absorbed, reference N_skip_input_samples_front). The tail is flushed
    with zeros (reference resample_final_samples).
    """

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
        return polyphase_fir(x.contiguous(), self.G, self.plan.L, self.plan.M,
                             self.m0, self.n_out)


class ResamplerStream(torch.nn.Module):
    """step(x complex64 [..., chunk_in], hist [..., H]) -> (y [..., chunk_in L / M],
    hist' [..., H]); hist starts as zeros (overlap-save).

    Because a frame may need samples past the chunk end, the streamed output
    lags by D_in = H - pad_l input samples: chaining steps over chunks of x
    yields exactly Resampler(concat([zeros(D_in), x])) trimmed to the
    emitted length (`stream_input_lag`).
    """

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
        y = polyphase_fir(xp, self.G, self.plan.L, self.plan.M, self.off,
                          self.n_out)
        return y, xp[..., self.chunk_in:]


def build_resampler(plan: ResamplerPlan, n_in: int,
                    device: torch.device | str = "cuda") -> Resampler:
    """One-shot resampler module (dectnrp_tpu/phy/resampler.py:136)."""
    return Resampler(plan, n_in).to(device)


def build_resampler_stream(plan: ResamplerPlan, chunk_in: int,
                           device: torch.device | str = "cuda") -> ResamplerStream:
    """Streaming resampler module (dectnrp_tpu/phy/resampler.py:203); its
    history length is `.H`. chunk_in must be a multiple of M so the
    polyphase pattern tiles across chunks."""
    return ResamplerStream(plan, chunk_in).to(device)
