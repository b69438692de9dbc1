"""Sliding-window max-log-MAP BCJR: CUDA kernel wrappers and their plain twins.

Two kernels, both column-major: Lsys (systematic + a-priori) and Lp are
float32 [K+3, B] (trellis step x codeblock), the posterior is float32
[K, B]. Windows of Lw = 128 steps acquire their boundary metrics over D = 32
extra steps on each side; the trellis ends start in the zero state, window
boundaries uniform; steps outside [0, K+3) leave the metrics unchanged.

- `bcjr_posterior_cm` (csrc/bcjr.cu) ports
  dectnrp_tpu/phy/fec/bcjr_pallas.py::_pallas_bcjr_call: float32 metrics,
  renormalized every step (subtract the max), as in
  turbo_jax._bcjr_posterior_windowed; the max-difference posterior cancels
  the offset either way. One thread per (codeblock, window) with the 8
  metrics in registers; bound by the latency of a thread's serial chain of
  trellis steps, so the LLR rows are fetched 8 steps ahead of the chain, the
  loops run over valid positions only, and only every 8th alpha
  vector is kept in shared memory (the backward pass recomputes the others
  bit for bit), which lets several warps share an SM. Called with ONE
  window (Lw >= K+3, e.g. Lw = K+3 and D = 0) it is the unwindowed BCJR
  `turbo._bcjr_posterior`, bit for bit: the decoder sends every unwindowed
  decode of CUDA tensors this way, the PCC's K = 56 / 96 among them, and
  `launches_one_window` counts them.
- `bcjr_posterior_cm_bf16` (csrc/bcjr_bf16.cu) ports `_pallas_bcjr_call_bf16`:
  bf16 state metrics, branch metrics computed in float32 and rounded to
  bf16, renormalized every 4 steps by subtracting state 0, the posterior's
  max-difference taken in float32. Built as the float32 kernel is (rows
  ahead of the chain, every 8th alpha vector kept, valid positions only);
  `bcjr_windowed_cm_bf16_ckpt` walks its order in plain torch.

`turbo.turbo_decode(_early)` reach them through `impl="cuda"` /
`impl="cuda_bf16"` (see `turbo._resolve_bcjr`; `"auto"` picks the float32
kernel for every decode on the card that it can carry). Each wrapper
launches its kernel for CUDA tensors and runs its plain twin for CPU
tensors; any other device, and a window that does not fit the kernel's
shared memory, raises.
"""
from __future__ import annotations

import numpy as np
import torch

from ..plan import device_tables

NEG = -1e30

launches = 0             # kernel launches made by bcjr_posterior_cm
launches_one_window = 0  # those of them that ran the trellis as one window
launches_bf16 = 0        # kernel launches made by bcjr_posterior_cm_bf16

# The float32 kernel keeps every 8th alpha vector of a window (1 KB for a
# 32-thread block) in the 232,448 bytes of shared memory a block may ask for
# on sm_90, so the longest window is 227 * 8 = 1816 steps (as one window:
# K <= 1813).
LW_MAX = 232448 // (8 * 32 * 4) * 8
# The bf16 kernel keeps every 8th alpha vector as four bf16 pairs (512 bytes
# for a 32-thread block): its longest window is 454 * 8 = 3632 steps.
LW_MAX_BF16 = 232448 // (4 * 32 * 4) * 8


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


def bcjr_windowed_cm_bf16_ckpt(Lsys: torch.Tensor, Lp: torch.Tensor, K: int,
                               Lw: int = 128, D: int = 32) -> torch.Tensor:
    """The bf16 kernel's own walk (csrc/bcjr_bf16.cu) in plain torch, window
    by window, its codeblocks (threads) on the last axis: [K+3, B] float32
    x2 -> posterior float32 [K, B], bit for bit
    `bcjr_windowed_cm_bf16_plain`.

    - only the windows with outputs (w Lw < K) are walked, none of tail
      steps only;
    - LLR rows are taken in chunks of CH = 8 from the first valid position; a
      row outside the range the kernel loads reads as NaN, so a row the
      kernel never uses cannot reach an output unseen (the kernel reads 0);
    - the forward pass runs from max(0, w Lw - D) to the window's last
      checkpoint and keeps every C-th alpha vector (C = 8, at w Lw + kC);
    - the backward pass runs from min((w+1) Lw + D, K+3) down to w Lw in
      chunks of CH from w Lw, in groups of C; a group with outputs takes its
      checkpoint and recomputes the C - 1 alphas after it;
    - renormalisation by position: after pos = 3 (mod 4) forward, after
      pos = 0 (mod 4) backward; a chunk starts at pos = 0 (mod 4), which the
      kernel relies on to fix the phase at compile time.

    Every output position is written once (the result starts as NaN).
    """
    T = Lw + 2 * D
    if T % 4 or (D + Lw) % 4:
        raise ValueError(f"bf16 BCJR: Lw + 2D = {T} and D + Lw = {D + Lw} "
                         "must be multiples of 4")
    C = CH = 8                             # as in csrc/bcjr_bf16.cu
    tb = device_tables(trellis_tables, (), Lsys.device)
    nxt, pred_s, pred_c = tb["nxt"], tb["pred_s"], tb["pred_c"]
    sgn_c, sgn_z = tb["sgn_c"], tb["sgn_z"]
    Kt, B = Lsys.shape
    dev, bf = Lsys.device, torch.bfloat16
    nan = torch.tensor(float("nan"), device=dev)
    zero_state = torch.full((8,), NEG, device=dev).to(bf)
    zero_state[0] = 0.0

    def init(zero):                        # [B, 8]
        v = zero_state if zero else torch.zeros((8,), dtype=bf, device=dev)
        return v.expand(B, 8)

    def rows(pos0, lo, hi):                # CH rows of (Lsys, Lp), [CH, B] each
        assert pos0 % 4 == 0
        pos = torch.arange(pos0, pos0 + CH, device=dev)
        ok = ((pos >= lo) & (pos < hi))[:, None]
        p = pos.clamp(0, Kt - 1)
        return torch.where(ok, Lsys[p], nan), torch.where(ok, Lp[p], nan)

    def gam(ls, lp):                       # [B] x2 -> bf16 [B, 8, 2]
        return (0.5 * (ls[:, None, None] * sgn_c
                       + lp[:, None, None] * sgn_z)).to(bf)

    def alpha_step(a, ls, lp):
        return (a[..., pred_s] + gam(ls, lp)[..., pred_s, pred_c]).amax(-1)

    def renorm(x):
        return x - x[..., :1]

    post = torch.full((K, B), float("nan"), device=dev)
    for w0 in range(0, K, Lw):
        oe = min(w0 + Lw, K)
        fs, be = max(0, w0 - D), min(w0 + Lw + D, Kt)
        fe = w0 + (oe - 1 - w0) // C * C + 1
        a, ck = init(w0 == 0), {}
        for p in range(fs, fe, CH):
            s, l = rows(p, fs, fe)
            for i in range(min(CH, fe - p)):
                k = p + i - w0
                if k >= 0 and k % C == 0:
                    ck[k // C] = a
                a = alpha_step(a, s[i], l[i])
                if (p + i) % 4 == 3:
                    a = renorm(a)
        b = init(w0 + Lw + D >= Kt)
        for base in range(w0 + (be - 1 - w0) // CH * CH, w0 - 1, -CH):
            s, l = rows(base, w0, be)
            for j in range(CH // C - 1, -1, -1):
                gp = base + j * C
                if gp < oe:
                    ar = [ck[(gp - w0) // C]]
                    for i in range(1, C):
                        x = alpha_step(ar[-1], s[j * C + i - 1], l[j * C + i - 1])
                        ar.append(renorm(x) if (gp + i - 1) % 4 == 3 else x)
                for i in range(C - 1, -1, -1):
                    pos = gp + i
                    if pos >= be:
                        continue
                    g = gam(s[j * C + i], l[j * C + i])
                    if pos < oe:       # b holds beta_{pos+1}, ar[i] alpha_pos
                        m = ((ar[i][..., None] + g) + b[..., nxt]).float()
                        post[pos] = m[..., 1].amax(-1) - m[..., 0].amax(-1)
                    b = (b[..., nxt] + g).amax(-1)
                    if pos % 4 == 0:
                        b = renorm(b)
    return post


def _check_inputs(name: str, Lsys: torch.Tensor, Lp: torch.Tensor, K: int):
    """The kernels take contiguous float32 [K+3, B] pairs on one card."""
    if Lsys.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {Lsys.device}")
    Kt, B = Lsys.shape
    if Kt != K + 3 or Lp.shape != Lsys.shape:
        raise ValueError(f"{name}: shapes {tuple(Lsys.shape)}, "
                         f"{tuple(Lp.shape)} for K={K}")
    for x in (Lsys, Lp):
        if x.dtype != torch.float32 or not x.is_contiguous() \
                or x.device != Lsys.device:
            raise ValueError(f"{name}: inputs must be contiguous float32 on "
                             "one device")


def bcjr_posterior_cm(Lsys: torch.Tensor, Lp: torch.Tensor, K: int,
                      Lw: int = 128, D: int = 32) -> torch.Tensor:
    """Column-major windowed BCJR: Lsys, Lp float32 [K+3, B] -> [K, B].

    CUDA tensors launch the kernel; CPU tensors run the plain twin. With
    Lw >= K+3 the trellis is one window: the unwindowed BCJR. A window of
    more than `LW_MAX` steps does not fit the kernel's shared memory and
    raises.
    """
    if Lsys.device.type == "cpu":
        return bcjr_windowed_cm_plain(Lsys, Lp, K, Lw, D)
    _check_inputs("bcjr_posterior_cm", Lsys, Lp, K)
    if Lw <= 0 or D < 0:
        raise ValueError(f"bcjr_posterior_cm: bad Lw={Lw}, D={D}")
    if Lw > LW_MAX:
        raise ValueError(f"bcjr_posterior_cm: a window of Lw={Lw} steps does "
                         f"not fit the kernel's shared memory (at most "
                         f"{LW_MAX})")
    from ... import kernels

    lib = kernels.load()
    post = torch.empty((K, Lsys.shape[1]), dtype=torch.float32,
                       device=Lsys.device)
    err = lib.bcjr_posterior_cm(Lsys.data_ptr(), Lp.data_ptr(),
                                post.data_ptr(), K, Lsys.shape[1], Lw, D,
                                kernels.stream_ptr(Lsys.device))
    kernels.check(err, "bcjr_posterior_cm")
    global launches, launches_one_window
    launches += 1
    launches_one_window += Lw >= K + 3
    return post


def check_bf16_window(Lw: int, D: int) -> None:
    """Raise unless the bf16 kernel takes windows of Lw steps with D
    acquisition steps: Lw + 2D and D + Lw in whole 4-step groups, Lw at
    most `LW_MAX_BF16` (its alpha checkpoints fill a block's shared memory
    beyond that)."""
    if Lw <= 0 or D < 0 or (Lw + 2 * D) % 4 or (D + Lw) % 4:
        raise ValueError(f"bcjr_posterior_cm_bf16: bad Lw={Lw}, D={D} (Lw + 2D "
                         "and D + Lw must be multiples of 4)")
    if Lw > LW_MAX_BF16:
        raise ValueError(f"bcjr_posterior_cm_bf16: a window of Lw={Lw} steps "
                         f"does not fit the kernel's shared memory (at most "
                         f"{LW_MAX_BF16})")


def bcjr_posterior_cm_bf16(Lsys: torch.Tensor, Lp: torch.Tensor, K: int,
                           Lw: int = 128, D: int = 32) -> torch.Tensor:
    """Column-major windowed BCJR with bf16 state metrics: Lsys, Lp float32
    [K+3, B] -> float32 [K, B].

    CUDA tensors launch the bf16 kernel (a window `check_bf16_window`
    refuses raises); CPU tensors run the plain twin.
    """
    if Lsys.device.type == "cpu":
        return bcjr_windowed_cm_bf16_plain(Lsys, Lp, K, Lw, D)
    _check_inputs("bcjr_posterior_cm_bf16", Lsys, Lp, K)
    check_bf16_window(Lw, D)
    from ... import kernels

    lib = kernels.load()
    post = torch.empty((K, Lsys.shape[1]), dtype=torch.float32,
                       device=Lsys.device)
    err = lib.bcjr_posterior_cm_bf16(Lsys.data_ptr(), Lp.data_ptr(),
                                     post.data_ptr(), K, Lsys.shape[1], Lw, D,
                                     kernels.stream_ptr(Lsys.device))
    kernels.check(err, "bcjr_posterior_cm_bf16")
    global launches_bf16
    launches_bf16 += 1
    return post
