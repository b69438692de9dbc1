"""MIMO estimator: beamforming-codebook feedback from channel estimates
(port of dectnrp_tpu/phy/mimo.py).

Reference lib/src/phy/rx/rx_synced/mimo/ (estimator_mimo.cpp:80-250,
mimo_report.hpp, mimo_csi.{hpp,cpp}): the wideband channel is condensed to
4 cells (averaged subcarrier regions), then an exhaustive search over the
ETSI beamforming codebook W[N_TS -> N_TX] picks the index maximizing the
minimum per-cell received power (the min-RX-power metric of the
closed-loop single-stream modes 3/7); the reciprocal variant transposes the
channel for our own TX beamforming.

The functions take tensors on any device and compute there; `search`
leaves its results on the device, so a caller (the runtime's PDC stage)
reads them in the same host transfer as its other outputs. Numpy arrays
are taken as CPU tensors. `estimate_aoa` (a Bartlett spectrum over the
antenna array's steering vectors; the reference's estimator_aoa_t is a
stub) works on numpy, as the JAX module's does.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..common.trace import h2d
from ..sections.part3.beamforming import CODEBOOK_SIZES, get_all_W


@dataclass
class MimoReport:
    """Per-packet feedback (reference mimo_report.hpp)."""
    codebook_index: int = 0
    power_min_cell: float = 0.0        # metric of the winner
    N_TS: int = 1
    N_TX: int = 1


@dataclass
class MimoCsi:
    """Tracked per-contact CSI (reference mimo_csi.{hpp,cpp})."""
    codebook_index: int = 0
    last_update: int = -1
    history: list = field(default_factory=list)

    def update(self, report: MimoReport, now: int) -> None:
        self.codebook_index = report.codebook_index
        self.last_update = now
        self.history.append((now, report.codebook_index))
        if len(self.history) > 16:
            self.history = self.history[-8:]


def _tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def condense_wideband(h, n_cells: int = 4) -> torch.Tensor:
    """[..., n_subc] -> [..., n_cells]: average over contiguous regions
    (reference 'wideband 4-cell channel condensation')."""
    h = _tensor(h)
    n = h.shape[-1] // n_cells * n_cells
    return h[..., :n].reshape(*h.shape[:-1], n_cells, -1).mean(-1)


def search(h_cells: torch.Tensor, N_TS: int = 1, reciprocal: bool = False):
    """h_cells complex [B, R, N_TX, 4] -> (best index int64 [B], metric
    float32 [B]) on h_cells' device, or None where the codebook has no
    (N_TS, N_TX) entry.

    For every candidate W: received power per cell ||H_c W||_F^2, metric =
    min over the 4 cells, winner = argmax over the codebook (the first
    index on ties, as jnp.argmax)."""
    cells = _tensor(h_cells).to(torch.complex64)
    if reciprocal:
        cells = cells.transpose(1, 2)
    T = cells.shape[2]
    if (N_TS, T) not in CODEBOOK_SIZES:
        return None
    W_host = np.asarray(get_all_W(N_TS, T)).astype(np.complex64)
    h2d(W_host.nbytes)
    Wall = torch.as_tensor(W_host, device=cells.device)      # [n_cb, N_TX, N_TS]
    z = torch.einsum("brtc,nts->bncrs", cells, Wall)
    p = (z.abs() ** 2).sum((3, 4))                            # [B, n_cb, cell]
    metric = p.min(-1).values                                 # [B, n_cb]
    return metric.argmax(-1), metric.max(-1).values


def reports_from_cells(cells, N_TS: int = 1,
                       reciprocal: bool = False) -> list[MimoReport]:
    """Codebook search on already-condensed cells [B, N_RX, N_TX, 4]
    (e.g. the `h_cells` output of phy.rx.build_rx)."""
    cells = _tensor(cells)
    B, R, T = cells.shape[:3]
    if reciprocal:
        R, T = T, R
    found = search(cells, N_TS, reciprocal)
    if found is None:
        return [MimoReport(0, 0.0, N_TS, T) for _ in range(B)]
    idx, metric = (x.cpu().numpy() for x in found)
    return [MimoReport(int(idx[i]), float(metric[i]), N_TS, T)
            for i in range(B)]


def estimate_mimo(h, N_TS: int = 1, reciprocal: bool = False) -> list[MimoReport]:
    """Codebook feedback from channel estimates h [B, N_RX, N_TX, n_subc].

    N_TS: stream count of the FUTURE beamformed transmission (1 for the
    closed-loop single-stream modes the reference searches). reciprocal=True
    transposes RX<->TX for our own transmit beamforming.
    """
    return reports_from_cells(condense_wideband(h), N_TS, reciprocal)


def estimate_aoa(h_ant: np.ndarray, array, freq_hz: float,
                 n_grid: int = 360) -> tuple[float, np.ndarray]:
    """Azimuth AoA from per-RX-antenna channel estimates: a Bartlett
    (conventional beamformer) spectrum over an azimuth grid using the
    array's steering vectors (radio/antenna_array.py).

    h_ant: [R] or [R, n_cells] complex per-antenna channel. Returns
    (azimuth_rad, spectrum [n_grid]).
    """
    h = np.asarray(h_ant)
    if h.ndim == 1:
        h = h[:, None]                                     # [R, 1]
    Rxx = h @ h.conj().T                                   # [R, R]
    grid = np.linspace(-np.pi, np.pi, n_grid, endpoint=False)
    A = array.steering(grid, freq_hz)                      # [n_grid, R]
    spec = np.real(np.einsum("gr,rs,gs->g", A.conj(), Rxx, A))
    return float(grid[int(np.argmax(spec))]), spec
