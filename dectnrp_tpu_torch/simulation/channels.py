"""Channel models of the port: AWGN, flat fading, doubly-selective Rayleigh
(port of dectnrp_tpu/simulation/channels.py).

Reference: lib/src/simulation/wireless/channel_{awgn,flat,doubly}.cpp and
link.cpp:39-199 (scaled ITU PDP taps, sum-of-sinusoids Doppler).

Every random channel is split into a draw and an apply. `draw_*` takes an
explicit `torch.Generator` on the stream's device and returns the channel's
random numbers (`H`, or the Jakes angles `theta` and phases `phi`); `apply_*`
is a pure function of its inputs. jax.random's streams cannot be reproduced
in torch, so a parity test hands the JAX package's own draws to an apply.
The composed `awgn` and `doubly_selective` draw and apply in one call.

Noise has unit total variance per complex sample (1/2 per real dimension)
and is scaled by sqrt(noise_var); the JAX package scales a draw of two unit
normals by sqrt(noise_var / 2), so its noise divided by sqrt(2) is this
convention's.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# ITU pedestrian/vehicular-style power delay profiles (delay ns, power dB),
# as the JAX package's table: the tap families the reference scales by tau_rms
PDP_TABLE = {
    0: (np.array([0.0, 110.0, 190.0, 410.0]),
        np.array([0.0, -9.7, -19.2, -22.8])),                 # ITU Ped A
    1: (np.array([0.0, 200.0, 800.0, 1200.0, 2300.0, 3700.0]),
        np.array([0.0, -0.9, -4.9, -8.0, -7.8, -23.9])),      # ITU Ped B
    2: (np.array([0.0, 310.0, 710.0, 1090.0, 1730.0, 2510.0]),
        np.array([0.0, -1.0, -9.0, -10.0, -15.0, -20.0])),    # ITU Veh A
}


def draw_noise(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Unit-variance complex white Gaussian noise, complex64 `shape`."""
    return torch.randn(shape, dtype=torch.complex64, device=device,
                       generator=generator)


def apply_awgn(iq: torch.Tensor, noise_var, noise: torch.Tensor) -> torch.Tensor:
    """iq + sqrt(noise_var) * noise (noise of unit variance; noise_var a
    float or a 0-dim tensor on iq's device)."""
    return iq + (noise_var ** 0.5) * noise


def awgn(iq: torch.Tensor, noise_var, generator: torch.Generator) -> torch.Tensor:
    """Add complex white Gaussian noise of per-sample variance noise_var."""
    return apply_awgn(iq, noise_var, draw_noise(generator, iq.shape, iq.device))


def noise_var_for_snr(signal_power, snr_db):
    """Per-sample noise variance for a target in-band SNR (signal is in-band)."""
    return signal_power / (10.0 ** (snr_db / 10.0))


def draw_flat_fading(generator: torch.Generator, B: int, n_rx: int, n_tx: int,
                     device) -> torch.Tensor:
    """H complex64 [B, n_rx, n_tx] with E|h|^2 = 1."""
    return draw_noise(generator, (B, n_rx, n_tx), device)


def apply_flat_fading(iq: torch.Tensor, H: torch.Tensor) -> torch.Tensor:
    """iq [B, N_TX, n], H [B, n_rx, N_TX] -> y [B, n_rx, n]."""
    return torch.einsum("brt,btn->brn", H.to(torch.complex64), iq)


@lru_cache(maxsize=None)
def tap_table(samp_rate: float, tau_rms_s: float, pdp_idx: int,
              n_taps_max: int = 16) -> tuple[np.ndarray, np.ndarray]:
    """(active, amps): the integer sample delays of the live taps of PDP
    `pdp_idx` scaled to `tau_rms_s` at `samp_rate` (taps on the same sample
    merged, delays clipped to n_taps_max - 1) and their amplitudes, total
    power 1."""
    delays_ns, powers_db = PDP_TABLE[pdp_idx]
    ref_rms = float(np.sqrt(
        np.average(delays_ns**2, weights=10**(powers_db / 10))
        - np.average(delays_ns, weights=10**(powers_db / 10)) ** 2)) * 1e-9
    delays_s = delays_ns * 1e-9 * (tau_rms_s / ref_rms)
    tap_idx = np.round(delays_s * samp_rate).astype(int)
    tap_idx = np.minimum(tap_idx, n_taps_max - 1)
    p_lin = 10 ** (powers_db / 10)
    p_lin = p_lin / p_lin.sum()
    tap_pow = np.zeros(n_taps_max)
    for t, p in zip(tap_idx, p_lin):
        tap_pow[t] += p
    active = np.nonzero(tap_pow)[0]
    return active, np.sqrt(tap_pow[active])


def draw_doubly(generator: torch.Generator, B: int, n_rx: int, n_tx: int,
                n_taps: int, n_sin: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(theta, phi) float32 [B, n_rx, n_tx, n_taps, n_sin], uniform in
    [0, 2 pi): each tap's Jakes arrival angles and phases."""
    shape = (B, n_rx, n_tx, n_taps, n_sin)
    theta = torch.rand(shape, generator=generator, device=device) * (2 * np.pi)
    phi = torch.rand(shape, generator=generator, device=device) * (2 * np.pi)
    return theta, phi


def _taps(theta: torch.Tensor, phi: torch.Tensor, n: int, samp_rate: float,
          doppler_hz: float, amps: np.ndarray) -> torch.Tensor:
    """The taps' time-varying gains h [B, R, T, L, n]:
    h[..., l, t] = amp_l / sqrt(n_sin) * sum_s exp(j (2 pi fD cos(theta_s) t
    + phi_s)). The [B, R, T, L, n_sin, n] phase tensor is built whole."""
    n_sin = theta.shape[-1]
    t = torch.arange(n, dtype=torch.float32, device=theta.device) / samp_rate
    fd = 2 * np.pi * doppler_hz * torch.cos(theta)               # [...,L,S]
    ph = fd[..., None] * t + phi[..., None]                      # [...,L,S,n]
    h = torch.polar(torch.ones_like(ph), ph).sum(-2) / np.sqrt(n_sin)
    return h * torch.as_tensor(amps.astype(np.complex64), device=h.device)[:, None]


def _tap_delay_line(iq: torch.Tensor, h: torch.Tensor,
                    active: np.ndarray) -> torch.Tensor:
    """Tap-delay-line convolution y[r, m] = sum_t sum_l h[r, t, l, m]
    x[t, m - d_l]: iq [B, N_TX, n], h [B, R, N_TX, L, n] -> y [B, R, n]."""
    B, n = iq.shape[0], iq.shape[-1]
    y = torch.zeros((B, h.shape[1], n), dtype=torch.complex64, device=iq.device)
    for li, d in enumerate(active):
        d = int(d)
        x_shift = torch.nn.functional.pad(iq, (d, 0))[..., :n]   # x[t, m-d]
        y = y + torch.einsum("brtn,btn->brn", h[:, :, :, li], x_shift)
    return y


def _doubly(iq, theta, phi, samp_rate, tau_rms_s, doppler_hz, pdp_idx,
            n_taps_max):
    """(y [B, n_rx, n], h [B, n_rx, N_TX, L, n], active delays)."""
    active, amps = tap_table(samp_rate, tau_rms_s, pdp_idx, n_taps_max)
    h = _taps(theta, phi, iq.shape[-1], samp_rate, doppler_hz, amps)
    return _tap_delay_line(iq, h, active), h, active


def apply_doubly(iq: torch.Tensor, theta: torch.Tensor, phi: torch.Tensor,
                 samp_rate: float, tau_rms_s: float = 363e-9,
                 doppler_hz: float = 222.0, pdp_idx: int = 0,
                 n_taps_max: int = 16) -> torch.Tensor:
    """Doubly-selective Rayleigh channel on given draws: iq [B, N_TX, n],
    theta / phi [B, n_rx, N_TX, L, n_sin] -> y [B, n_rx, n]."""
    return _doubly(iq, theta, phi, samp_rate, tau_rms_s, doppler_hz, pdp_idx,
                   n_taps_max)[0]


def apply_doubly_genie(iq: torch.Tensor, theta: torch.Tensor, phi: torch.Tensor,
                       samp_rate: float, sym_centers: tuple[int, ...],
                       k_occ: tuple[int, ...], N: int,
                       tau_rms_s: float = 363e-9, doppler_hz: float = 222.0,
                       pdp_idx: int = 0, n_taps_max: int = 16):
    """apply_doubly and the TRUE per-symbol frequency response:
    (y [B, n_rx, n], H [B, n_rx, N_TX, S, N_occ]) with
    H[..., s, k] = sum_l h_l(t = sym_centers[s]) exp(-j 2 pi k_occ[k] d_l / N)."""
    y, h, active = _doubly(iq, theta, phi, samp_rate, tau_rms_s, doppler_hz,
                           pdp_idx, n_taps_max)
    hs = h[..., torch.as_tensor(sym_centers, device=h.device)]   # [B,R,T,L,S]
    ph = np.exp(-2j * np.pi * np.asarray(k_occ)[None, :]
                * np.asarray(active)[:, None] / N).astype(np.complex64)
    H = torch.einsum("brtls,lk->brtsk", hs, torch.as_tensor(ph, device=h.device))
    return y, H


def doubly_selective(iq: torch.Tensor, n_rx: int, samp_rate: float,
                     generator: torch.Generator, tau_rms_s: float = 363e-9,
                     doppler_hz: float = 222.0, pdp_idx: int = 0,
                     n_taps_max: int = 16, n_sin: int = 8) -> torch.Tensor:
    """Doubly-selective Rayleigh channel (tap-delay line + sum of
    sinusoids): iq [B, N_TX, n] -> y [B, n_rx, n]."""
    L = tap_table(samp_rate, tau_rms_s, pdp_idx, n_taps_max)[0].size
    theta, phi = draw_doubly(generator, iq.shape[0], n_rx, iq.shape[1], L, n_sin,
                             iq.device)
    return apply_doubly(iq, theta, phi, samp_rate, tau_rms_s, doppler_hz,
                        pdp_idx, n_taps_max)
