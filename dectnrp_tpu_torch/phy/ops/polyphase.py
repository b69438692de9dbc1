"""Polyphase fractional-resampler FIR: CUDA kernel wrapper and plain twins.

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
ratio the resampler takes (`RATIOS`). `polyphase_fir_tiled` repeats the
kernel's decomposition (`kernel_plan`: blocks over the rows x frames space,
tiles of TF frames staged frame-padded, thread tiles of F frames x LG phases,
phase groups over their nonzero tap range `tap_ranges`) and its sums (one
fused multiply-add per tap, in ascending tap order from +0) in plain torch;
the tests hold it to the plain twin and the kernel to it.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

launches = 0          # kernel launches made by polyphase_fir

#: the (L, M) of dectnrp_tpu/phy/resampler.py::get_resampler_fraction's set
#: (TX direction) and their inverses (RX direction); 1/1 needs no FIR
RATIOS = frozenset({(10, 9), (40, 27), (20, 9), (80, 27), (2, 1),
                    (9, 10), (27, 40), (9, 20), (27, 80), (1, 2)})

_NT = 256             # threads a block (csrc/polyphase.cu)
_WARPS = _NT // 32
_NG_MAX = 8           # phase groups a design may have
_SMEM_MAX = 232448    # shared memory a block may take on an H100
_LG_F = {1: 8, 2: 8, 9: 1, 10: 1}   # phases a thread tile holds -> its frames


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


@dataclass(frozen=True)
class KernelPlan:
    """The kernel's tiling of one design: a thread holds F frames (32 lanes
    apart) x LG phases of one of NG = L / LG phase groups; a tile is TF
    frames, staged as NBF frame rows of SP (odd) samples in one half of a
    double buffer, which then holds the tile's outputs; `smem` bytes a
    block."""
    LG: int
    NG: int
    F: int
    SP: int
    TF: int
    NBF: int
    smem: int


@lru_cache(maxsize=None)
def kernel_plan(L: int, M: int, W: int) -> KernelPlan:
    """The kernel's tiling of an L/M design with W taps a phase; raises
    ValueError, with the reason, on a design it does not serve (the C entry
    refuses the same)."""
    if L < 1 or M < 1 or W < M:
        raise ValueError(f"polyphase kernel: L = {L}, M = {M}, W = {W} (needs "
                         "L, M >= 1 and W >= M)")
    LG = L if L <= 10 else 10 if L % 10 == 0 else 9 if L % 9 == 0 else 0
    if LG not in _LG_F:
        raise ValueError(f"polyphase kernel: L = {L} does not split into "
                         "groups of 1, 2, 9 or 10 phases")
    NG = L // LG
    if NG > _NG_MAX:
        raise ValueError(f"polyphase kernel: L = {L} makes {NG} phase groups "
                         f"(at most {_NG_MAX})")
    F = _LG_F[LG]
    LGP = LG if LG <= 2 else -(-LG // 4) * 4      # a tap index's taps, padded
    TF = max(1, _WARPS // NG) * 32 * F
    NBF = TF + (W - 1) // M
    SP = M | 1
    # a half holds the span or the tile's outputs (rows of L + 1 at most),
    # and starts on 16 bytes
    half = -(-max(NBF * SP, TF * (L + 1)) // 2) * 2
    smem = -(-NG * W * LGP * 4 // 16) * 16 + 2 * half * 8
    if smem > _SMEM_MAX:
        raise ValueError(f"polyphase kernel: W = {W} taps at {L}/{M} need "
                         f"{smem} bytes of shared memory a block (at most "
                         f"{_SMEM_MAX})")
    return KernelPlan(LG, NG, F, SP, TF, NBF, smem)


def tap_ranges(taps, LG: int) -> tuple[tuple[int, int], ...]:
    """[lo, hi) of each group of LG phases: the tap indices from the first
    to the last at which any phase of the group is nonzero ((0, 0) for a
    group of zeros). The kernel walks only these."""
    G = taps.detach().cpu().numpy() if torch.is_tensor(taps) else np.asarray(taps)
    L, W = G.shape
    out = []
    for nz in (G != 0).reshape(L // LG, LG, W).any(1):
        idx = np.flatnonzero(nz)
        out.append((int(idx[0]), int(idx[-1]) + 1) if idx.size else (0, 0))
    return tuple(out)


# tap_ranges of each taps tensor the CUDA route has seen, with the tensor's
# version: worked out once (one copy to the host), not in every call
_RANGES = WeakIdKeyDictionary()


def _ranges_of(taps: torch.Tensor, LG: int) -> tuple[tuple[int, int], ...]:
    key = (taps._version, LG)
    hit = _RANGES.get(taps)
    if hit is None or hit[0] != key:
        hit = (key, tap_ranges(taps, LG))
        _RANGES[taps] = hit
    return hit[1]


@lru_cache(maxsize=None)
def resident_blocks(device_index: int, L: int, M: int, W: int) -> int:
    """Blocks of the kernel for an L/M design of W taps the whole card holds
    at once."""
    from ... import kernels

    n = kernels.load().polyphase_blocks_per_sm(L, M, W)
    if n < 1:
        raise RuntimeError(f"polyphase kernel: occupancy query failed ({n})")
    return n * torch.cuda.get_device_properties(device_index).multi_processor_count


def block_count(rows: int, n_out: int, L: int, pl: KernelPlan,
                resident: int) -> int:
    """Blocks of a launch: one wave (`resident`), each walking an equal
    share of the rows x frames space, but none with less than one thread
    tile's 32 F frames."""
    n_frames = -(-n_out // L)
    return max(1, min(resident, -(-rows * n_frames // (32 * pl.F))))


def polyphase_fir_tiled(x: torch.Tensor, taps: torch.Tensor, L: int, M: int,
                        m0: int, n_out: int, blocks: int = 396) -> torch.Tensor:
    """The kernel's computation in plain torch: x complex64 [..., n_in] ->
    [..., n_out], launched as `blocks` blocks (at most; 396 is an H100's one
    wave at 3 blocks an SM) that walk their share of the rows x frames space
    tile by tile. Each tile's span is staged frame-padded (input sample i at
    (i // M) SP + i % M), and every read of it is checked against the input
    index it should hold; each output is a chain of fused multiply-adds over
    its group's tap range in ascending order from +0, each emulated in
    float64 (the product is exact there; the sum, rounded to float64 and then
    to float32, is the float32 fma's but for a rare double rounding). Values
    do not depend on `blocks`."""
    n_in, W = x.shape[-1], taps.shape[1]
    pl = kernel_plan(L, M, W)
    LG, F, SP, TF, NBF = pl.LG, pl.F, pl.SP, pl.TF, pl.NBF
    ranges = tap_ranges(taps, LG)
    dev = x.device
    xr = x.reshape(-1, n_in)
    rows = xr.shape[0]
    NF = -(-n_out // L)
    FT = rows * NF
    grid = block_count(rows, n_out, L, pl, blocks)

    # the tiles each block walks, in the kernel's order
    tiles = []
    for b in range(grid):
        cur, end = FT * b // grid, FT * (b + 1) // grid
        while cur < end:
            row, g0 = divmod(cur, NF)
            nf = min(TF, end - cur, NF - g0)
            tiles.append((row, g0, nf))
            cur += nf
    tl = torch.tensor(tiles, dtype=torch.int64, device=dev).reshape(-1, 3)
    row_t, g0_t, nf_t = tl[:, 0:1], tl[:, 1:2], tl[:, 2:3]

    # stage every tile's span: slot (i // M) SP + i % M holds input i, tagged
    # with its stream index (indices outside [0, n_in) read zeros); slots
    # never written keep a tag no index has
    i = torch.arange(TF * M + W - M, device=dev)
    s = g0_t * M + m0 + i                                      # [T, span]
    staged = i < nf_t * M + W - M
    ok = staged & (s >= 0) & (s < n_in)
    slot = (i // M) * SP + i % M
    xv = torch.view_as_real(xr).to(torch.float32)
    val = torch.where(ok[..., None], xv[row_t, s.clamp(0, n_in - 1)],
                      torch.zeros((), device=dev))
    never = torch.iinfo(torch.int64).min
    tag = torch.full((len(tiles), NBF * SP), never, dtype=torch.int64, device=dev)
    buf = torch.zeros((len(tiles), NBF * SP, 2), dtype=torch.float32, device=dev)
    tag[:, slot] = torch.where(staged, s, never)
    buf[:, slot] = torch.where(staged[..., None], val, torch.zeros((), device=dev))

    # thread tiles: frame c 32 F + f 32 + lane of each live chunk c
    fr = (torch.arange(TF // (32 * F), device=dev)[:, None, None] * 32 * F
          + torch.arange(F, device=dev)[None, :, None] * 32
          + torch.arange(32, device=dev)[None, None, :]).reshape(-1)
    live = fr[None, :] < nf_t                                  # [T, TF]
    y = torch.full((rows * n_out, 2), float("nan"), dtype=torch.float32,
                   device=dev)
    G = taps.to(device=dev, dtype=torch.float64)
    for grp, (lo, hi) in enumerate(ranges):
        acc = torch.zeros((len(tiles), TF, LG, 2), dtype=torch.float32,
                          device=dev)
        for j in range(lo, hi):
            sl = fr * SP + (j // M) * SP + j % M
            want = g0_t * M + m0 + fr * M + j
            if not torch.equal(tag[:, sl][live], want.expand_as(live)[live]):
                raise AssertionError(f"staged span slot of tap {j} does not "
                                     "hold the input it should")
            h = G[grp * LG:(grp + 1) * LG, j]
            v = buf[:, sl].double()                            # [T, TF, 2]
            acc = (acc.double() + h[None, None, :, None] * v[:, :, None, :]
                   ).to(torch.float32)
        o = (g0_t + fr)[..., None] * L + grp * LG + torch.arange(LG, device=dev)
        keep = live[..., None] & (o < n_out)
        flat = (row_t[..., None] * n_out + o)[keep]
        y[flat] = acc[keep]
    if torch.isnan(y).any():
        raise AssertionError("polyphase_fir_tiled: an output was never written")
    return torch.view_as_complex(y).reshape(*x.shape[:-1], n_out)


def polyphase_fir(x: torch.Tensor, taps: torch.Tensor, L: int, M: int,
                  m0: int, n_out: int) -> torch.Tensor:
    """L/M polyphase FIR of x complex64 [..., n_in] -> [..., n_out].

    taps: float32 [L, W] on x's device. CUDA tensors launch the kernel (a
    design beyond its limits raises ValueError, `kernel_plan`); CPU tensors
    run the plain twin.
    """
    _check(x, taps, L, M, n_out)
    if x.device.type == "cpu":
        return polyphase_fir_plain(x, taps, L, M, m0, n_out)
    if x.device.type != "cuda":
        raise ValueError(f"polyphase_fir: unsupported device {x.device}")
    import ctypes

    from ... import kernels

    W = taps.shape[1]
    pl = kernel_plan(L, M, W)
    rg = (ctypes.c_int * (2 * pl.NG))(*(v for r in _ranges_of(taps, pl.LG)
                                        for v in r))
    lib = kernels.load()
    n_in = x.shape[-1]
    rows = x.numel() // n_in
    dev = x.device.index if x.device.index is not None \
        else torch.cuda.current_device()
    grid = block_count(rows, n_out, L, pl, resident_blocks(dev, L, M, W))
    y = torch.empty((*x.shape[:-1], n_out), dtype=torch.complex64, device=x.device)
    err = lib.polyphase_fir(torch.view_as_real(x).data_ptr(), taps.data_ptr(), rg,
                            torch.view_as_real(y).data_ptr(), rows, n_in, n_out,
                            L, M, W, m0, grid, kernels.stream_ptr(x.device))
    kernels.check(err, "polyphase_fir")
    global launches
    launches += 1
    return y
