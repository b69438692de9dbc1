"""Upper layer of the port: the tpoint firmware interface and the firmware
registry (port of dectnrp_tpu/upper/__init__.py), the node runtime
(`runtime.py`), the firmwares (`misc.py`, `p2p.py`, copies) and the
loopback experiments (`loopback.py`).

The registry mirrors reference upper_t::add_tpoint (lib/src/upper/
upper.cpp:80-118): firmware name -> factory(config dict, device) -> Tpoint.
Only `loopback_snr` computes outside the runtime; it runs its experiment on
the scenario's device.
"""
from __future__ import annotations

from .tpoint import Tpoint


def _basic(cfg: dict, device: str = "cuda") -> Tpoint:
    from .misc import TfwBasic
    return TfwBasic()


def _rtt(cfg: dict, device: str = "cuda") -> Tpoint:
    from .misc import TfwRtt
    return TfwRtt(cfg.get("network_id", 0x12345678),
                  cfg.get("short_rdid", 0x2222),
                  u=cfg.get("u", 1), b=cfg.get("b", 1),
                  mcs=cfg.get("mcs", 2), echo=cfg.get("echo", False))


def _txrxdelay(cfg: dict, device: str = "cuda") -> Tpoint:
    from .misc import TfwTxrxDelay
    return TfwTxrxDelay(cfg.get("network_id", 0x12345678),
                        cfg.get("short_rdid", 0x2222))


def _txrxagc(cfg: dict, device: str = "cuda") -> Tpoint:
    from .misc import TfwTxrxAgc
    return TfwTxrxAgc(cfg.get("network_id", 0x12345678),
                      cfg.get("short_rdid", 0x2222))


def _chscanner(cfg: dict, device: str = "cuda") -> Tpoint:
    from .misc import TfwChscanner
    return TfwChscanner(window=cfg.get("window", 4096),
                        n_partial=cfg.get("n_partial", 4))


def _p2p_config(cfg: dict):
    from ..sections.part4.identity import Identity
    from .p2p import P2pConfig
    pc = P2pConfig(**{k: v for k, v in cfg.items()
                      if k in P2pConfig.__dataclass_fields__
                      and k != "ft_identity"})
    if "ft_identity" in cfg:
        pc.ft_identity = Identity(*cfg["ft_identity"])
    return pc


def _p2p_ft(cfg: dict, device: str = "cuda") -> Tpoint:
    from .p2p import TfwP2pFt
    return TfwP2pFt(_p2p_config(cfg))


def _p2p_pt(cfg: dict, device: str = "cuda") -> Tpoint:
    from ..sections.part4.identity import Identity
    from .p2p import TfwP2pPt
    pc = _p2p_config(cfg)
    ident = Identity(*cfg.get("identity",
                              (pc.ft_identity.network_id, 0x00111111,
                               0x1111)))
    return TfwP2pPt(pc, ident)


def _loopback_snr(cfg: dict, device: str = "cuda") -> Tpoint:
    from .loopback import LoopbackSnrExperiment
    from .tpoint import IrregularReport

    class TfwLoopbackSnr(Tpoint):
        """Runs the batched PER/SNR experiment at startup and stores the
        per-MCS JSON records (reference tfw_loopback_snr.cpp) -- the
        reference's packet-serial A..E state machine collapses into
        batched points, so the whole sweep completes in work_start."""
        NAME = "loopback_snr"

        def __init__(self):
            super().__init__()
            kw = {k: v for k, v in cfg.items()
                  if k in LoopbackSnrExperiment.__dataclass_fields__
                  and k != "device"}
            if "mcs_list" in kw:
                kw["mcs_list"] = tuple(kw["mcs_list"])
            if "snr_db" in kw:
                kw["snr_db"] = tuple(kw["snr_db"])
            self.experiment = LoopbackSnrExperiment(**kw, device=str(device))
            self.results: dict | None = None

        def work_start(self, start_time: int) -> IrregularReport:
            out_dir = cfg.get("out_dir")
            if out_dir:
                self.experiment.save_json(out_dir)
            self.results = self.experiment.run()
            return IrregularReport()

    return TfwLoopbackSnr()


FIRMWARES = {
    "basic": _basic,
    "rtt": _rtt,
    "txrxdelay": _txrxdelay,
    "txrxagc": _txrxagc,
    "chscanner": _chscanner,
    "p2p_ft": _p2p_ft,
    "p2p_pt": _p2p_pt,
    "loopback_snr": _loopback_snr,
}

__all__ = ["FIRMWARES", "Tpoint"]
