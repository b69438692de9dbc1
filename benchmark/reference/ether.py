"""The reference for the virtual ether: a tick's RX blocks worked out again
from the TX blocks the program handed its ether, by a plain superposition
over the scenario's own radio file, plus the tick's noise draws.

    rx_i = sum_j g_ji tx_j + sqrt(noise_var) n_i

g_ji is the free-space amplitude gain between the positions radio.json
gives (20 log10 d + 20 log10 f - 147.55 dB, floored at 0 dB, as upstream's
pathloss), each antenna of node j onto the same antenna of node i; a node
hears itself only through a TX-to-RX leakage that radio.json states. The
noise n is the program's own draw for the tick, which has to be unit-variance
complex noise of the blocks' shape: a tick whose draw is missing, of another
shape or of a mean power off 1 by more than a quarter (some 20 standard
errors at the 3 x 2048 samples of a tick of the p2p scenario) counts as a
bad draw. Only an AWGN ether of static positions is covered; any other
radio file is refused.

Computed in complex128. `precision="bfloat16"` is the control: the TX
blocks, the gains and the noise rounded to bf16, the sum in float32, the
result rounded to bf16.
"""
from __future__ import annotations

import math

import torch

from .scenario import round_bf16

#: the hw keys this reference knows; any other is refused
HW_KEYS = {"n_ant", "position", "tx_leakage_db"}


def fspl_db(d_m: float, f_hz: float) -> float:
    if d_m <= 0.0 or f_hz <= 0.0:
        return 0.0
    return max(20.0 * math.log10(d_m) + 20.0 * math.log10(f_hz) - 147.55, 0.0)


class EtherReference:
    def __init__(self, radio: dict, device, precision: str = "float32"):
        if radio.get("channel_inter", "awgn") != "awgn" or any(
                set(h) - HW_KEYS or h.get("type", "simulator") != "simulator"
                for h in radio["hws"]):
            raise ValueError("the ether reference covers an AWGN ether of "
                             "static simulated radios only")
        if precision not in ("float32", "bfloat16"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision, self.device = precision, torch.device(device)
        self.noise_var = float(radio.get("noise_var", 0.0))
        hws, f = radio["hws"], float(radio.get("freq_hz", 1.9e9))
        n = len(hws)
        g = torch.zeros(n, n, dtype=torch.float64)       # g[j, i]: j -> i
        for i in range(n):
            for j in range(n):
                if i == j:
                    leak = float(hws[i].get("tx_leakage_db", math.inf))
                    g[j, i] = 0.0 if math.isinf(leak) else 10.0 ** (-leak / 20)
                else:
                    d = math.dist(hws[i].get("position", [0.0] * 3),
                                  hws[j].get("position", [0.0] * 3))
                    g[j, i] = 10.0 ** (-fspl_db(d, f) / 20)
        self.gain = g.to(self.device)

    def _bad_draw(self, tx, draws) -> bool:
        if self.noise_var <= 0.0:
            return False
        n = (draws or {}).get("noise")
        return n is None or tuple(n.shape) != tuple(tx.shape) or \
            abs(float(n.abs().pow(2).mean()) - 1.0) > 0.25

    @torch.no_grad()
    def rx(self, tx: torch.Tensor, noise) -> torch.Tensor:
        """The RX blocks [N, A, S] of one tick."""
        tx = tx.to(self.device)
        if self.precision == "bfloat16":
            g = round_bf16(self.gain.float()).to(torch.complex64)
            out = torch.einsum("ji,jas->ias", g, round_bf16(tx.to(torch.complex64)))
            if noise is not None and self.noise_var > 0.0:
                s = round_bf16(torch.tensor(self.noise_var ** 0.5)).item()
                out = out + s * round_bf16(noise.to(self.device, torch.complex64))
            return round_bf16(out)
        out = torch.einsum("ji,jas->ias", self.gain.to(torch.complex128),
                           tx.to(torch.complex128))
        if noise is not None and self.noise_var > 0.0:
            out = out + self.noise_var ** 0.5 * noise.to(self.device,
                                                         torch.complex128)
        return out

    def compare(self, kept: list, against: "EtherReference | None" = None) -> dict:
        """Over the kept ticks [(tx, rx, draws)]: `vspace_gap`, the widest
        |rx - reference| of a tick over the largest |reference| of that
        tick, for the program's rx (or, with `against`, that reference's);
        `vspace_bad_draws`, the ticks whose noise draw is not as stated."""
        gap, bad = 0.0, 0
        for tx, rx, draws in kept:
            if self._bad_draw(tx, draws):
                bad += 1
                continue
            noise = (draws or {}).get("noise")
            ref = self.rx(tx, noise)
            got = against.rx(tx, noise) if against is not None else rx
            d = (got.to(self.device, torch.complex128) - ref).abs().max()
            gap = max(gap, float(d / ref.abs().max().clamp_min(1e-300)))
        return {"vspace_gap": gap, "vspace_bad_draws": bad}
