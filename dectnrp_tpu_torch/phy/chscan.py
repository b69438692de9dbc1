"""Channel occupancy scanner (port of dectnrp_tpu/phy/chscan.py; reference
lib/src/phy/rx/chscan/).

chscanner_t measures per-antenna RMS over a time window of the RX ring,
split into N partial scans with ring-wrap handling
(chscanner.cpp:38-141). Here the window is fetched from the host ring and
the RMS reduction runs over [n_partial, len, ant] on `device`.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class Chscan:
    """Scan request/result (reference chscan_t)."""
    t_start: int
    t_end: int
    n_partial: int = 1
    rms_ant: np.ndarray | None = None      # [n_ant] linear RMS
    rms_partial: np.ndarray | None = None  # [n_partial, n_ant]

    @property
    def done(self) -> bool:
        return self.rms_ant is not None

    def rms_dB(self) -> np.ndarray:
        return 20.0 * np.log10(np.maximum(self.rms_ant, 1e-12))


def rms(iq: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """iq complex64 [n_partial, part_len, n_ant] -> (RMS per partial scan
    and antenna [n_partial, n_ant], RMS per antenna [n_ant])."""
    p = (iq.abs() ** 2).mean(1)                           # [n_partial, n_ant]
    return torch.sqrt(p), torch.sqrt(p.mean(0))


class Chscanner:
    """Runs Chscans against a hardware's RX ring (host-side pacing,
    reduction on `device`: by default the hardware's own `device`, as a
    simulated radio carries it, else the card)."""

    def __init__(self, hw, device: torch.device | str | None = None):
        self.hw = hw
        self.device = torch.device(device or getattr(hw, "device", "cuda"))

    def scan(self, chscan: Chscan) -> Chscan | None:
        """Executes the scan if all samples are available, else None."""
        if chscan.t_end > self.hw.rx_time_passed:
            return None
        total = chscan.t_end - chscan.t_start
        part = total // chscan.n_partial
        if part == 0:
            return None
        win = self.hw.get_rx_stream(chscan.t_start, part * chscan.n_partial)
        # hw ring is [A, n]; the reduction wants [n_partial, part, A]
        iq = np.ascontiguousarray(win.T).reshape(chscan.n_partial, part, -1)
        part_rms, ant_rms = rms(torch.from_numpy(iq).to(self.device))
        out = torch.cat([part_rms.reshape(-1), ant_rms]).cpu().numpy()
        chscan.rms_partial = out[:part_rms.numel()].reshape(part_rms.shape)
        chscan.rms_ant = out[part_rms.numel():]
        return chscan
