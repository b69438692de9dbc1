"""The reference for a scenario's PHY calls: each kept call of the port's
`Sync`, `RxStream` (PCC stage, PDC stage) or `Tx` re-run by the frozen
plain module of `phyref/` built with the same arguments, on the same
input; the numbers by which the outputs differ.

Only what the runtime reads of each call is compared: of a sync call the
detections, their fine times and CFOs; of a PCC stage the PLCFs and their
CRC flags (its PDC output is ignored by the runtime) and the SNR; of a PDC
stage the TB, its CRC flag, the SNR, fractional STO and residual CFO; of a
TX call the IQ.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from ..phyref.phy.fec import turbo
from ..phyref.phy.sync import SyncParams, build_rx_stream, build_sync
from ..phyref.phy.tx import build_tx
from ..phyref.sections.part3.packet_sizes import PacketSizesDef
from ..phyref.sections.part3.stf import n_stf_patterns


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16 and back (complex: each part)."""
    if x.is_complex():
        return torch.view_as_complex(
            torch.view_as_real(x).to(torch.bfloat16).to(
                torch.float64 if x.dtype == torch.complex128 else torch.float32
            ).contiguous())
    if x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    return x


def round_module(m: torch.nn.Module) -> None:
    """Every table (buffer) of m rounded to bf16 and back."""
    for name, buf in list(m.named_buffers()):
        owner, _, attr = name.rpartition(".")
        setattr(m.get_submodule(owner), attr, round_bf16(buf))


@contextmanager
def bcjr_precision(p: str):
    """The frozen turbo decoder's BCJR in precision `p` inside the block."""
    old = turbo.PRECISION["value"]
    turbo.PRECISION["value"] = p
    try:
        yield
    finally:
        turbo.PRECISION["value"] = old


def _gap(a, b, where) -> float:
    """The widest |a - b| where `where` holds (0 where it holds nowhere)."""
    g = (a.double() - b.double()).abs()
    return float(torch.where(where, g, torch.zeros_like(g)).max()) \
        if bool(where.any()) else 0.0


def _psdef(p) -> PacketSizesDef:
    return PacketSizesDef(p.u, p.b, p.PacketLengthType, p.PacketLength,
                          p.tm_mode_index, p.mcs_index, p.Z)


class CallReference:
    def __init__(self, device, precision: str = "float32"):
        self.device, self.precision = device, precision
        self._mods: dict = {}

    def _module(self, key, build):
        if key not in self._mods:
            m = build()
            if self.precision == "bfloat16":
                round_module(m)
            self._mods[key] = m
        return self._mods[key]

    def _in(self, x):
        if self.precision == "bfloat16" and torch.is_tensor(x):
            return round_bf16(x)
        return x

    @torch.no_grad()
    def run(self, kind: str, module, args):
        """The reference's output for one call of the port's `module`."""
        if kind == "sync":
            b = module.P // 16
            u = next(u for u in (1, 2, 4, 8) if n_stf_patterns(u) == module.n_pat)
            p = module.params
            key = ("sync", u, b, module.T, module.max_peaks,
                   tuple(module.neff.tolist()), p)
            ref = self._module(key, lambda: build_sync(
                u, b, module.T, tuple(module.neff.tolist()),
                SyncParams(**vars(p)), module.max_peaks, device=self.device))
        elif kind == "tx":
            key = ("tx", module.ps.psdef, module.network_id, module.plcf_type)
            ref = self._module(key, lambda: build_tx(
                _psdef(module.ps.psdef), module.network_id, module.plcf_type,
                device=self.device))
        else:
            rx = module.rx
            key = ("rx", rx.ps.psdef, rx.network_id, rx.plcf_type, module.T)
            ref = self._module(key, lambda: build_rx_stream(
                _psdef(rx.ps.psdef), rx.network_id, rx.plcf_type, module.T,
                self.device))
        with bcjr_precision(self.precision):
            return ref(*(self._in(a) for a in args))

    def compare_all(self, kept: dict, against: "CallReference | None" = None) -> dict:
        """The widest differences over the kept calls {kind: [(module,
        args, output)]} between the program's outputs (or, with
        `against`, that reference's) and this reference's."""
        out = {"sync_detected_differ": 0, "sync_t_fine_differ": 0,
               "sync_t_fine_off_by_one": 0, "sync_t_coarse_differ": 0,
               "sync_t_coarse_shift": 0, "sync_cfo_gap": 0.0,
               "sync_cfo_gap_any_coarse": 0.0,
               "pcc_plcf_differ": 0, "pcc_snr_db_gap": 0.0,
               "pdc_tb_differ": 0, "pdc_snr_db_gap": 0.0,
               "pdc_sto_frac_gap": 0.0, "pdc_cfo_res_gap": 0.0,
               "tx_iq_gap": 0.0}

        def note(k, v):
            out[k] = max(out[k], v) if isinstance(out[k], float) \
                or k == "sync_t_coarse_shift" else out[k] + v

        for kind, calls in kept.items():
            for module, args, prog in calls:
                ref = self.run(kind, module, args)
                if against is not None:
                    prog = against.run(kind, module, args)
                for k, v in _numbers(kind, prog, ref).items():
                    note(k, v)
        return out


def _numbers(kind: str, p, r) -> dict:
    dev = r.device if torch.is_tensor(r) else r["snr_db" if kind != "sync"
                                                else "detected"].device
    if kind == "tx":
        p = p.to(dev)
        return {"tx_iq_gap": float((p - r).abs().max() / r.abs().max())}
    p = {k: v.to(dev) for k, v in p.items()}
    if kind == "sync":
        # The coarse peak is an argmax over the smoothed metric's plateau:
        # the kernel and its plain twin sum in another order, so it may
        # land samples apart, the CFO read there with it, and the fine
        # search's window with it (its FFT then rounds otherwise, which can
        # tip a two-sample tie of the fine peak). So the fine time may
        # differ by one sample, and the CFO is compared at equal peaks.
        both = p["detected"] & r["detected"]
        shift = (p["t_fine"].to(torch.int64) - r["t_fine"]).abs()
        same = both & (shift == 0)
        coarse = same & (p["t_coarse"] == r["t_coarse"])
        c_shift = (p["t_coarse"].to(torch.int64) - r["t_coarse"]).abs()
        return {"sync_detected_differ": int((p["detected"] != r["detected"]).sum()),
                "sync_t_fine_differ": int((both & (shift > 1)).sum()),
                "sync_t_fine_off_by_one": int((both & (shift == 1)).sum()),
                "sync_t_coarse_differ": int((same & ~coarse).sum()),
                "sync_t_coarse_shift": int(torch.where(both, c_shift, 0).max())
                if bool(both.any()) else 0,
                "sync_cfo_gap": _gap(p["cfo"], r["cfo"], coarse),
                "sync_cfo_gap_any_coarse": _gap(p["cfo"], r["cfo"], same)}
    one = torch.ones_like(r["snr_db"], dtype=torch.bool)
    if kind == "pcc":
        differ = torch.zeros_like(one)
        for t in (1, 2):
            ok = f"plcf{t}_ok"
            differ |= (p[ok] != r[ok]) | (r[ok] & (
                (p[f"plcf{t}"] != r[f"plcf{t}"]).any(-1)
                | (p[f"plcf{t}_cl"] != r[f"plcf{t}_cl"])
                | (p[f"plcf{t}_bf"] != r[f"plcf{t}_bf"])))
        return {"pcc_plcf_differ": int(differ.sum()),
                "pcc_snr_db_gap": _gap(p["snr_db"], r["snr_db"], one)}
    differ = (p["tb_ok"] != r["tb_ok"]) | (r["tb_ok"] & (p["tb"] != r["tb"]).any(-1))
    return {"pdc_tb_differ": int(differ.sum()),
            "pdc_snr_db_gap": _gap(p["snr_db"], r["snr_db"], one),
            "pdc_sto_frac_gap": _gap(p["sto_frac"], r["sto_frac"], one),
            "pdc_cfo_res_gap": _gap(p["cfo_res"], r["cfo_res"], one)}
