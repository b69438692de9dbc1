"""The reference for the resampler calls of a scenario on radios off the
DECT rate: each kept call of the port's `ResamplerStream` (the runtime's
front end, radio rate -> DECT rate) and `Resampler` (a TX burst, DECT rate
-> radio rate) re-run by the frozen plain module of
`phyref/phy/resampler.py` built with the same plan and length, on the same
input; and a chain of one node's consecutive front-end steps re-run as one
stream, from the first step's history, on the samples of the node's RX
ring that the steps should have read.

The per-call check follows the program call by call, so it cannot see a
runtime that hands a step the wrong history or skips a step: the chain
can, since its reference carries its own history over the ring's samples.

Numbers (each the widest over the calls, relative to the reference's
largest magnitude in the call): `rs_rx_gap` (the output and the history
handed on), `rs_tx_gap`, `rs_rx_chain_gap`. `precision="bfloat16"` is the
control: inputs, taps and outputs rounded to bf16.
"""
from __future__ import annotations

import torch

from ..phyref.phy.resampler import (ResamplerPlan, build_resampler,
                                    build_resampler_stream)
from .scenario import round_bf16, round_module


def rel_gap(p: torch.Tensor, r: torch.Tensor) -> float:
    """max |p - r| / max |r| (0 where both are all zeros)."""
    d = float((p.to(r.device, r.dtype) - r).abs().max())
    return d / max(float(r.abs().max()), 1e-30)


class ResamplerReference:
    def __init__(self, device, precision: str = "float32"):
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.device, self.precision = torch.device(device), precision
        self._mods: dict = {}

    def _module(self, key, build):
        if key not in self._mods:
            m = build()
            if self.precision == "bfloat16":
                round_module(m)
            self._mods[key] = m
        return self._mods[key]

    def _in(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.device)
        return round_bf16(x) if self.precision == "bfloat16" else x

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        return round_bf16(y) if self.precision == "bfloat16" else y

    @staticmethod
    def _plan(plan) -> ResamplerPlan:
        return ResamplerPlan(plan.L, plan.M, plan.os)

    @torch.no_grad()
    def stream(self, plan, chunk_in: int, x, hist):
        """(y, hist') of one stream step of `chunk_in` samples."""
        p = self._plan(plan)
        m = self._module(("rx", p, chunk_in), lambda: build_resampler_stream(
            p, chunk_in, device=self.device))
        y, h = m(self._in(x), self._in(hist))
        return self._out(y), self._out(h)

    @torch.no_grad()
    def burst(self, plan, n_in: int, x):
        p = self._plan(plan)
        m = self._module(("tx", p, n_in), lambda: build_resampler(
            p, n_in, device=self.device))
        return self._out(m(self._in(x)))

    def compare(self, rx: list, tx: list, chain: dict | None,
                against: "ResamplerReference | None" = None) -> dict:
        """The widest gaps over the kept calls: rx [(module, (x, hist),
        (y, hist'))], tx [(module, (x,), y)], and the chain {"plan",
        "chunk_in", "hist", "x" (the ring's samples), "y" [outputs]}, of the
        program's outputs (or, with `against`, that reference's) from this
        reference's."""
        out = {"rs_rx_gap": 0.0, "rs_tx_gap": 0.0, "rs_rx_chain_gap": 0.0}
        for module, (x, hist), (y, h) in rx:
            yr, hr = self.stream(module.plan, module.chunk_in, x, hist)
            if against is not None:
                y, h = against.stream(module.plan, module.chunk_in, x, hist)
            out["rs_rx_gap"] = max(out["rs_rx_gap"], rel_gap(y, yr),
                                   rel_gap(h, hr))
        for module, (x,), y in tx:
            yr = self.burst(module.plan, module.n_in, x)
            if against is not None:
                y = against.burst(module.plan, module.n_in, x)
            out["rs_tx_gap"] = max(out["rs_tx_gap"], rel_gap(y, yr))
        if chain is not None and chain.get("x") is not None:
            n = chain["chunk_in"] * len(chain["y"])
            x = torch.as_tensor(chain["x"][:, :n])
            yr, _ = self.stream(chain["plan"], n, x, chain["hist"])
            y = torch.cat([v.to(self.device) for v in chain["y"]], -1)
            if against is not None:
                y, _ = against.stream(chain["plan"], n, x, chain["hist"])
            out["rs_rx_chain_gap"] = rel_gap(y, yr)
        return out
