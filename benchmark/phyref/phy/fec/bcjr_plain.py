"""Sliding-window max-log-MAP BCJR: the plain twins only.

Frozen copy of the port's `phy/fec/bcjr_cuda.py` without its kernel
wrappers: `bcjr_windowed_cm_plain` (float32, the float32 kernel's twin, bit
for bit) and `bcjr_windowed_cm_bf16_plain` (bf16 state metrics, the bf16
kernel's twin), column-major [K+3, B] -> posterior [K, B].
"""
from __future__ import annotations

import numpy as np
import torch

from ..plan import device_tables

NEG = -1e30


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


def bcjr_windowed_cm_bf16_plain(Lsys: torch.Tensor, Lp: torch.Tensor, K: int,
                                Lw: int = 128, D: int = 32) -> torch.Tensor:
    """Plain PyTorch twin of the bf16 kernel: [K+3, B] float32 x2 ->
    posterior float32 [K, B], step for step as
    bcjr_pallas._pallas_bcjr_call_bf16 (its sublane packing of two
    codeblock groups aside: here one codeblock per column).

    - branch metrics 0.5 * (sgn_c * Lsys + sgn_z * Lp) in float32, rounded to
      bf16; the alpha side indexes them by the destination's two incoming
      edges, the beta side by (state, input bit) (the parity-sign form);
    - alpha and beta updates: max of two bf16 sums, kept where the step lies
      inside [0, K+3); the alpha at window step t >= D is stored before its
      update;
    - after every group of 4 steps, in both passes, the state-0 metric is
      subtracted; the beta groups run t = T-4-4i+k for k = 3..0, T = Lw + 2D;
    - posterior ((alpha + gamma) + beta) in bf16, cast to float32, max over
      the 8 states per input bit, hi - lo in float32.

    Every bf16 op rounds once (torch computes in float32 and rounds to
    nearest even, which for one add of two bf16 values is the correctly
    rounded bf16 sum), so the kernel's __hadd2 / __hmax2 match it bit for
    bit. The TPU kernel's last D beta steps (t < D) update a beta that no
    output reads; the twin and the kernel stop at t = D.
    """
    T = Lw + 2 * D
    if T % 4 or (D + Lw) % 4:
        raise ValueError(f"bf16 BCJR: Lw + 2D = {T} and D + Lw = {D + Lw} "
                         "must be multiples of 4")
    tb = device_tables(trellis_tables, (), Lsys.device)
    nxt, pred_s, pred_c = tb["nxt"], tb["pred_s"], tb["pred_c"]
    sgn_c, sgn_z = tb["sgn_c"], tb["sgn_z"]
    Kt, B = Lsys.shape
    W = -(-Kt // Lw)
    dev, bf = Lsys.device, torch.bfloat16
    w_idx = torch.arange(W, device=dev)

    def gamma_at(pos):                     # pos [W] -> bf16 [W, B, 8, 2]
        p = pos.clamp(0, Kt - 1)
        return (0.5 * (Lsys[p][..., None, None] * sgn_c
                       + Lp[p][..., None, None] * sgn_z)).to(bf)

    def renorm(x):
        return x - x[..., :1]

    zero_state = torch.full((8,), NEG, device=dev).to(bf)
    zero_state[0] = 0.0
    uniform = torch.zeros((8,), dtype=bf, device=dev)

    a = torch.where((w_idx == 0)[:, None], zero_state, uniform)
    a = a[:, None, :].expand(W, B, 8)
    alphas = []
    for t in range(D + Lw):
        pos = w_idx * Lw - D + t
        valid = ((pos >= 0) & (pos < Kt))[:, None, None]
        if t >= D:
            alphas.append(a)
        g = gamma_at(pos)[..., pred_s, pred_c]
        a = torch.where(valid, (a[..., pred_s] + g).amax(-1), a)
        if t % 4 == 3:
            a = renorm(a)

    reaches_end = (w_idx + 1) * Lw + D >= Kt
    b = torch.where(reaches_end[:, None], zero_state, uniform)
    b = b[:, None, :].expand(W, B, 8)
    betas = [None] * Lw                   # betas[k] = beta_{w*Lw+k+1}
    for t in range(T - 1, D - 1, -1):
        pos = w_idx * Lw - D + t
        valid = ((pos >= 0) & (pos < Kt))[:, None, None]
        if t < D + Lw:
            betas[t - D] = b
        b = torch.where(valid, (b[..., nxt] + gamma_at(pos)).amax(-1), b)
        if t % 4 == 0:
            b = renorm(b)

    a_k = torch.stack(alphas, 1).reshape(W * Lw, B, 8)[:K]
    b_k1 = torch.stack(betas, 1).reshape(W * Lw, B, 8)[:K]
    g_k = (0.5 * (Lsys[:K, :, None, None] * sgn_c
                  + Lp[:K, :, None, None] * sgn_z)).to(bf)        # [K,B,8,2]
    metric = ((a_k[..., None] + g_k) + b_k1[..., nxt]).float()
    return metric[..., 1].amax(-1) - metric[..., 0].amax(-1)


