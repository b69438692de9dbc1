"""Simulated hardware effects: clipping and quantization (port of
dectnrp_tpu/simulation/hardware.py).

Reference: lib/src/simulation/hardware/{clip,quantize}.cpp and the
simulator's clip_and_quantize (radio/hw_simulator.hpp:80-92). Plain torch on
complex64 tensors, on the tensor's device.
"""
from __future__ import annotations

import torch


def clip(iq: torch.Tensor, limit: float = 1.0) -> torch.Tensor:
    """Clip I and Q independently to [-limit, limit] (ADC/DAC rails)."""
    return torch.complex(iq.real.clamp(-limit, limit), iq.imag.clamp(-limit, limit))


def quantize(iq: torch.Tensor, n_bits: int, limit: float = 1.0) -> torch.Tensor:
    """Uniform mid-rise quantization of I/Q to n_bits over [-limit, limit]."""
    step = 2.0 * limit / (2 ** n_bits)

    def q(x):
        return (torch.floor(x / step) + 0.5) * step
    return torch.complex(q(iq.real), q(iq.imag))


def clip_and_quantize(iq: torch.Tensor, n_bits: int = 12,
                      limit: float = 1.0) -> torch.Tensor:
    return quantize(clip(iq, limit), n_bits, limit)
