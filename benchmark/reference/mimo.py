"""The reference for the runtime's codebook search: each kept call of the
port's `phy.mimo.search` re-run as a plain search in float32 over the
frozen beamforming tables of `phyref/`, on the same channel cells; the
numbers by which the outputs differ.

The search (TS 103 636-3 6.3.4, the reference's estimator_mimo): for every
codebook matrix W [N_TX, N_TS], the received power of each of the 4 cells
is ||H_c W||_F^2; a matrix's metric is its weakest cell's power, and the
winner is the first matrix of the largest metric.
"""
from __future__ import annotations

import numpy as np
import torch

from ..phyref.sections.part3.beamforming import CODEBOOK_SIZES, get_all_W
from .scenario import round_bf16

#: two indices whose reference metrics lie within TIE (relative) of each
#: other are a tie: float32 sums in another order move a metric by a few
#: 1e-7, and the cells of an identity channel put all 28 matrices of the
#: 4-TX codebook within about 1e-3 of each other
TIE = 1e-5


class MimoReference:
    def __init__(self, device, precision: str = "float32"):
        self.device, self.precision = device, precision

    @torch.no_grad()
    def metrics(self, cells: torch.Tensor, N_TS: int = 1,
                reciprocal: bool = False) -> torch.Tensor | None:
        """Every codebook matrix's metric [B, n_cb] (float32), or None where
        the codebook has no (N_TS, N_TX) entry."""
        h = cells.to(self.device, torch.complex64)
        if reciprocal:
            h = h.transpose(1, 2)
        T = h.shape[2]
        if (N_TS, T) not in CODEBOOK_SIZES:
            return None
        W = torch.as_tensor(get_all_W(N_TS, T).astype(np.complex64),
                            device=self.device)               # [n_cb, T, S]
        if self.precision == "bfloat16":
            h, W = round_bf16(h), round_bf16(W)
        out = []
        for n in range(W.shape[0]):
            z = torch.matmul(h.permute(0, 3, 1, 2), W[n])      # [B, cell, R, S]
            p = (z.real * z.real + z.imag * z.imag).sum((2, 3))
            if self.precision == "bfloat16":
                p = round_bf16(p)
            out.append(p.min(-1).values)                      # [B]
        return torch.stack(out, -1)

    def search(self, cells, N_TS: int = 1, reciprocal: bool = False):
        """(index int64 [B], metric float32 [B]) as the program's search
        returns them, or None."""
        m = self.metrics(cells, N_TS, reciprocal)
        if m is None:
            return None
        return m.argmax(-1), m.max(-1).values

    def compare(self, kept: list, against: "MimoReference | None" = None
                ) -> dict:
        """The differences over the kept calls [(args, kwargs, output)]
        between the program's outputs (or, with `against`, that
        reference's) and this reference's:
        - cb_index_differ: calls whose index is not the reference's and
          whose metric, as the reference reads it, lies more than TIE below
          the reference's best;
        - cb_index_ties: calls whose index differs within TIE (not a fault);
        - cb_metric_gap: the widest |metric - the reference's| over the
          reference's, and where the program found no codebook and the
          reference did (or the reverse), inf."""
        out = {"cb_index_differ": 0, "cb_index_ties": 0, "cb_metric_gap": 0.0}
        for args, kw, prog in kept:
            m = self.metrics(*args, **kw)
            if against is not None:
                prog = against.search(*args, **kw)
            if m is None or prog is None:
                if (m is None) != (prog is None):
                    out["cb_metric_gap"] = float("inf")
                continue
            idx, metric = (x.to(self.device) for x in prog)
            best, best_i = m.max(-1).values, m.argmax(-1)
            at = m.gather(-1, idx.to(torch.int64)[:, None])[:, 0]
            off = idx != best_i
            tie = off & (best - at <= TIE * best.abs())
            out["cb_index_differ"] += int((off & ~tie).sum())
            out["cb_index_ties"] += int(tie.sum())
            gap = ((metric.double() - best.double()).abs()
                   / best.double().abs().clamp_min(1e-30)).max()
            out["cb_metric_gap"] = max(out["cb_metric_gap"], float(gap))
        return out
