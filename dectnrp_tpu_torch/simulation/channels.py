"""Channel models of the port (dectnrp_tpu/simulation/channels.py).

Reference: lib/src/simulation/wireless/channel_awgn.cpp. Noise comes from an
explicit `torch.Generator` on the stream's device; its numbers differ from
jax.random's, so parity tests draw noise with numpy and add it on both sides.
"""
from __future__ import annotations

import torch


def awgn(iq: torch.Tensor, noise_var: float, generator: torch.Generator) -> torch.Tensor:
    """Add complex white Gaussian noise of per-sample variance noise_var.

    iq complex64; the complex normal draw has unit total variance (1/2 per
    real dimension), so the scale is sqrt(noise_var).
    """
    n = torch.randn(iq.shape, dtype=torch.complex64, device=iq.device,
                    generator=generator)
    return iq + (noise_var ** 0.5) * n
