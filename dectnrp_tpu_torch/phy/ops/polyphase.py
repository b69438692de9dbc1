"""Polyphase fractional-resampler FIR: CUDA kernel wrapper and plain twin.

Port of dectnrp_tpu/phy/ops/polyphase.py::_pallas_call (the TPU kernel behind
`polyphase_fir_pallas`, chosen by dectnrp_tpu/phy/resampler.py::_resolve_impl).
For complex rows x [..., n_in], the real polyphase bank G [L, W] of
phy/resampler.py::_design (row l: phase l at its input-window offset) and the
input index m0 of frame 0's first tap:

    y[..., g L + l] = sum_w G[l, w] x[..., g M + m0 + w],   g < ceil(n_out / L),

with x zero outside [0, n_in), trimmed to n_out outputs. This is the function
of the JAX resampler's gather path (resampler.py:175-188); the TPU kernel's
block-Toeplitz super-frame matmul and its split into real and imaginary rows
are MXU and lane layouts, not part of it.

`polyphase_fir` launches the kernel (csrc/polyphase.cu) for CUDA tensors and
runs `polyphase_fir_plain` (frames gathered by a static index, then one
einsum with G) for CPU tensors; any other device raises. Both serve every
ratio the resampler takes (`RATIOS`).
"""
from __future__ import annotations

import torch

launches = 0          # kernel launches made by polyphase_fir

#: the (L, M) of dectnrp_tpu/phy/resampler.py::get_resampler_fraction's set
#: (TX direction) and their inverses (RX direction); 1/1 needs no FIR
RATIOS = frozenset({(10, 9), (40, 27), (20, 9), (80, 27), (2, 1),
                    (9, 10), (27, 40), (9, 20), (27, 80), (1, 2)})


def _check(x: torch.Tensor, taps: torch.Tensor, L: int, M: int, n_out: int):
    if (L, M) not in RATIOS:
        raise ValueError(f"polyphase_fir: unsupported ratio {L}/{M}")
    if x.dtype != torch.complex64 or x.dim() < 1 or not x.is_contiguous():
        raise ValueError("polyphase_fir: x must be contiguous complex64 [..., n_in]")
    if (taps.dtype != torch.float32 or taps.dim() != 2 or taps.shape[0] != L
            or taps.device != x.device or not taps.is_contiguous()):
        raise ValueError("polyphase_fir: taps must be contiguous float32 [L, W] "
                         "on x's device")
    if x.shape[-1] <= 0 or n_out <= 0:
        raise ValueError("polyphase_fir: empty input or output")


def polyphase_fir_plain(x: torch.Tensor, taps: torch.Tensor, L: int, M: int,
                        m0: int, n_out: int) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: x complex64 [..., n_in] -> [..., n_out]."""
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


def polyphase_fir(x: torch.Tensor, taps: torch.Tensor, L: int, M: int,
                  m0: int, n_out: int) -> torch.Tensor:
    """L/M polyphase FIR of x complex64 [..., n_in] -> [..., n_out].

    taps: float32 [L, W] on x's device. CUDA tensors launch the kernel; CPU
    tensors run the plain twin.
    """
    _check(x, taps, L, M, n_out)
    if x.device.type == "cpu":
        return polyphase_fir_plain(x, taps, L, M, m0, n_out)
    if x.device.type != "cuda":
        raise ValueError(f"polyphase_fir: unsupported device {x.device}")
    from ... import kernels

    lib = kernels.load()
    n_in = x.shape[-1]
    rows = x.numel() // n_in
    y = torch.empty((*x.shape[:-1], n_out), dtype=torch.complex64, device=x.device)
    err = lib.polyphase_fir(torch.view_as_real(x).data_ptr(), taps.data_ptr(),
                            torch.view_as_real(y).data_ptr(), rows, n_in, n_out,
                            L, M, taps.shape[1], m0, kernels.stream_ptr(x.device))
    kernels.check(err, "polyphase_fir")
    global launches
    launches += 1
    return y
