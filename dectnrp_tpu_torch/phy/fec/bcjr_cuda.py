"""Sliding-window max-log-MAP BCJR: CUDA kernel wrapper and its plain twin.

Port of dectnrp_tpu/phy/fec/bcjr_pallas.py::_pallas_bcjr_call (entry
`bcjr_posterior_pallas_cm`). Column-major layout: Lsys (systematic +
a-priori) and Lp are float32 [K+3, B] (trellis step x codeblock), the
posterior is [K, B]. Windows of Lw = 128 steps acquire their boundary
metrics over D = 32 extra steps on each side; the trellis ends start in the
zero state, window boundaries uniform; steps outside [0, K+3) leave the
metrics unchanged. Metrics are renormalized every step (subtract the max),
as in turbo_jax._bcjr_posterior_windowed; the max-difference posterior
cancels the offset either way.

`bcjr_posterior_cm` launches the kernel (csrc/bcjr.cu) for CUDA tensors and
runs `bcjr_windowed_cm_plain` for CPU tensors; any other device raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..plan import device_tables

NEG = -1e30

launches = 0          # kernel launches made by bcjr_posterior_cm


def trellis_tables():
    """Trellis LUTs and branch-metric signs of the 8-state RSC (turbo.py)."""
    from .turbo import NEXT, OUT_Z, PRED_C, PRED_S
    return {"nxt": NEXT, "pred_s": PRED_S, "pred_c": PRED_C,
            "sgn_c": np.array([-1.0, 1.0], np.float32),
            "sgn_z": (2.0 * OUT_Z - 1.0).astype(np.float32)}


def bcjr_windowed_cm_plain(Lsys: torch.Tensor, Lp: torch.Tensor, K: int,
                           Lw: int = 128, D: int = 32) -> torch.Tensor:
    """Plain PyTorch twin of the kernel: [K+3, B] x2 -> posterior [K, B].

    Windows run in parallel (a leading window axis); each step gathers its
    two LLR rows per window and recomputes the branch metrics
    gamma = 0.5 * (sgn_c * Lsys + sgn_z * Lp), the same arithmetic as
    turbo_jax._bcjr_posterior_windowed.
    """
    tb = device_tables(trellis_tables, (), Lsys.device)
    nxt, pred_s, pred_c = tb["nxt"], tb["pred_s"], tb["pred_c"]
    sgn_c, sgn_z = tb["sgn_c"], tb["sgn_z"]
    Kt, B = Lsys.shape
    W = -(-Kt // Lw)
    dev, dt = Lsys.device, Lsys.dtype
    w_idx = torch.arange(W, device=dev)

    def gamma_at(pos):                     # pos [W] -> [W, B, 8, 2]
        p = pos.clamp(0, Kt - 1)
        return 0.5 * (Lsys[p][..., None, None] * sgn_c
                      + Lp[p][..., None, None] * sgn_z)

    zero_state = torch.full((8,), NEG, dtype=dt, device=dev)
    zero_state[0] = 0.0
    uniform = torch.zeros((8,), dtype=dt, device=dev)

    a = torch.where((w_idx == 0)[:, None], zero_state, uniform)
    a = a[:, None, :].expand(W, B, 8)
    alphas = []
    for t in range(D + Lw):
        pos = w_idx * Lw - D + t
        valid = ((pos >= 0) & (pos < Kt))[:, None, None]
        if t >= D:
            alphas.append(a)
        g = gamma_at(pos)
        anew = (a[..., pred_s] + g[..., pred_s, pred_c]).amax(-1)
        anew = anew - anew.amax(-1, keepdim=True)
        a = torch.where(valid, anew, a)

    reaches_end = (w_idx + 1) * Lw + D >= Kt
    b = torch.where(reaches_end[:, None], zero_state, uniform)
    b = b[:, None, :].expand(W, B, 8)
    betas = [None] * Lw                   # betas[k] = beta_{w*Lw+k+1}
    for t in range(Lw + D):
        pos = (w_idx + 1) * Lw + D - 1 - t
        valid = ((pos >= 0) & (pos < Kt))[:, None, None]
        if t >= D:
            betas[Lw - 1 - (t - D)] = b
        bnew = (b[..., nxt] + gamma_at(pos)).amax(-1)
        bnew = bnew - bnew.amax(-1, keepdim=True)
        b = torch.where(valid, bnew, b)

    a_k = torch.stack(alphas, 1).reshape(W * Lw, B, 8)[:K]
    b_k1 = torch.stack(betas, 1).reshape(W * Lw, B, 8)[:K]
    g_k = 0.5 * (Lsys[:K, :, None, None] * sgn_c
                 + Lp[:K, :, None, None] * sgn_z)                 # [K,B,8,2]
    metric = a_k[..., None] + g_k + b_k1[..., nxt]
    return metric[..., 1].amax(-1) - metric[..., 0].amax(-1)


def bcjr_posterior_cm(Lsys: torch.Tensor, Lp: torch.Tensor, K: int,
                      Lw: int = 128, D: int = 32) -> torch.Tensor:
    """Column-major windowed BCJR: Lsys, Lp float32 [K+3, B] -> [K, B].

    CUDA tensors launch the kernel; CPU tensors run the plain twin.
    """
    if Lsys.device.type == "cpu":
        return bcjr_windowed_cm_plain(Lsys, Lp, K, Lw, D)
    if Lsys.device.type != "cuda":
        raise ValueError(f"bcjr_posterior_cm: unsupported device {Lsys.device}")
    Kt, B = Lsys.shape
    if Kt != K + 3 or Lp.shape != Lsys.shape:
        raise ValueError(f"bcjr_posterior_cm: shapes {tuple(Lsys.shape)}, "
                         f"{tuple(Lp.shape)} for K={K}")
    for x in (Lsys, Lp):
        if x.dtype != torch.float32 or not x.is_contiguous() \
                or x.device != Lsys.device:
            raise ValueError("bcjr_posterior_cm: inputs must be contiguous "
                             "float32 on one device")
    from ... import kernels

    lib = kernels.load()
    post = torch.empty((K, B), dtype=torch.float32, device=Lsys.device)
    err = lib.bcjr_posterior_cm(Lsys.data_ptr(), Lp.data_ptr(),
                                post.data_ptr(), K, B, Lw, D,
                                kernels.stream_ptr(Lsys.device))
    kernels.check(err, "bcjr_posterior_cm")
    global launches
    launches += 1
    return post
