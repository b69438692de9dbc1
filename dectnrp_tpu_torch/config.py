"""Scenario configuration system (port of dectnrp_tpu/config.py; reference
apps/dectnrp/dectnrp.cpp:80-110 + configurations/): one directory per
scenario holding radio.json, phy.json and upper.json; `load_scenario`
parses and range-checks them (the reference uses range-validated readers,
src/phy/phy_config.cpp:111-196), and `build_scenario` wires radio -> phy
runtime -> firmware like the reference's radio_t -> phy_t -> upper_t
construction chain, on `device`. The reference's compile-time #define
families are promoted to these runtime JSON fields.

A radio is simulated (the virtual ether, driven in lock-step by a
SimDriver) or real-IQ (hw types iq_socket and iq_file: radio/hw_iq.py over
common/native.py), which paces itself: its scenario has no driver.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from .common.trace import span
from .radio.hw_simulator import HwSimulator, SimDriver
from .simulation.topology import Position, Trajectory
from .simulation.vspace import VNodeConfig, VSpaceConfig
from .upper.runtime import NodeRuntime


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"config: {msg}")


@dataclass
class RadioConfig:
    """radio.json: the vspace + one entry per simulated hardware."""
    samp_rate: float = 1_728_000.0
    spp_len: int = 2048
    freq_hz: float = 1.9e9
    channel_inter: str = "awgn"
    channel_intra: str = "awgn"
    noise_var: float = 1e-8
    sim_seed: int = 0
    hws: list[dict] = field(default_factory=list)

    @classmethod
    def parse(cls, d: dict) -> "RadioConfig":
        c = cls(**{k: v for k, v in d.items() if k != "hws"})
        c.hws = list(d.get("hws", [{"n_ant": 1}]))
        _require(c.samp_rate > 0, "samp_rate must be positive")
        _require(c.spp_len >= 64, "spp_len too small")
        _require(len(c.hws) >= 1, "at least one hw required")
        for hw in c.hws:
            _require(hw.get("n_ant", 1) in (1, 2, 4, 8), "n_ant in {1,2,4,8}")
        return c


@dataclass
class PhyConfig:
    """phy.json: one worker-pool entry per hw (u, b, chunking, cadence)."""
    units: list[dict] = field(default_factory=list)

    @classmethod
    def parse(cls, d: dict) -> "PhyConfig":
        units = list(d.get("units", [{}]))
        for u in units:
            _require(u.get("u", 1) in (1, 2, 4, 8), "u in {1,2,4,8}")
            _require(u.get("b", 1) in (1, 2, 4, 8, 12, 16),
                     "b in {1,2,4,8,12,16}")
            _require(u.get("chunk_len", 2048) >= 256, "chunk_len >= 256")
        return cls(units)


@dataclass
class UpperConfig:
    """upper.json: one firmware entry per tpoint (firmware name + args)."""
    tpoints: list[dict] = field(default_factory=list)

    @classmethod
    def parse(cls, d: dict) -> "UpperConfig":
        tps = list(d.get("tpoints", []))
        from .upper import FIRMWARES
        for t in tps:
            _require("firmware" in t, "tpoint needs a firmware name")
            _require(t["firmware"] in FIRMWARES,
                     f"unknown firmware {t['firmware']!r} "
                     f"(known: {sorted(FIRMWARES)})")
        return cls(tps)


@dataclass
class Scenario:
    radio: RadioConfig
    phy: PhyConfig
    upper: UpperConfig
    name: str = ""


def load_scenario(path: str | Path) -> Scenario:
    p = Path(path)
    with open(p / "radio.json") as f:
        radio = RadioConfig.parse(json.load(f))
    with open(p / "phy.json") as f:
        phy = PhyConfig.parse(json.load(f))
    with open(p / "upper.json") as f:
        upper = UpperConfig.parse(json.load(f))
    n = len(radio.hws)
    _require(len(phy.units) in (1, n), "phy units: 1 (shared) or one per hw")
    _require(len(upper.tpoints) in (1, n), "tpoints: 1 or one per hw")
    return Scenario(radio, phy, upper, p.name)


@dataclass
class RunningScenario:
    driver: SimDriver | None          # None: real-IQ radios pace themselves
    hws: list
    runtimes: list[NodeRuntime]
    firmwares: list
    tick_ms: list[float] = field(default_factory=list)   # host time a tick

    def tick(self) -> None:
        t0 = time.perf_counter()
        with span("scenario.tick"):
            if self.driver is not None:
                self.driver.tick()
            for rt in self.runtimes:
                rt.process()
        self.tick_ms.append((time.perf_counter() - t0) * 1e3)

    def run_ticks(self, n: int) -> None:
        for _ in range(n):
            self.tick()

    def close(self) -> None:
        for hw in self.hws:
            if hasattr(hw, "close"):
                hw.close()


def build_scenario(sc: Scenario,
                   device: torch.device | str = "cuda") -> RunningScenario:
    """radio_t -> phy_t -> upper_t construction (dectnrp.cpp:80-110), the
    virtual ether (simulated radios) and every node's PHY on `device`."""
    from .upper import FIRMWARES

    vcfg = VSpaceConfig(samp_rate=sc.radio.samp_rate,
                        spp_len=sc.radio.spp_len,
                        freq_hz=sc.radio.freq_hz,
                        channel_inter=sc.radio.channel_inter,
                        channel_intra=sc.radio.channel_intra,
                        noise_var=sc.radio.noise_var,
                        sim_seed=sc.radio.sim_seed)
    # radio backend selection per hw (reference radio.json picks the
    # device class, "simulator" vs "usrp"; here: simulator / iq_file /
    # iq_socket — the real-IQ radios carry their own native ingress/egress
    # threads and need no lock-step driver)
    hw_types = {h.get("type", "simulator") for h in sc.radio.hws}
    if hw_types != {"simulator"}:
        _require(hw_types.isdisjoint({"simulator"}),
                 "cannot mix simulator and real-IQ radios in one scenario")
        hws = []
        for hw_cfg in sc.radio.hws:
            n_ant = hw_cfg.get("n_ant", 1)
            rate = int(sc.radio.samp_rate)
            if hw_cfg.get("type") == "iq_socket":
                from .radio.hw_iq import HwIqSocket
                hws.append(HwIqSocket(
                    rx_port=hw_cfg["rx_port"], samp_rate=rate, n_ant=n_ant,
                    tx_sink=hw_cfg.get("tx_sink"),
                    spp=hw_cfg.get("spp", 2048)))
            elif hw_cfg.get("type") == "iq_file":
                from .radio.hw_iq import HwIqStream
                hws.append(HwIqStream(
                    hw_cfg["path"], samp_rate=rate, n_ant=n_ant,
                    spp=hw_cfg.get("spp", 2048),
                    realtime=hw_cfg.get("realtime", True)))
            else:
                _require(False, f"unknown hw type {hw_cfg.get('type')!r}")
        driver = None
    else:
        hws, nodes = [], []
        for hw_cfg in sc.radio.hws:
            n_ant = hw_cfg.get("n_ant", 1)
            hws.append(HwSimulator(n_ant))
            pos = hw_cfg.get("position", [0.0, 0.0, 0.0])
            nodes.append(VNodeConfig(
                n_ant,
                Trajectory(Position(*pos)),
                tx_leakage_db=hw_cfg.get("tx_leakage_db", float("inf")),
                noise_figure_db=hw_cfg.get("noise_figure_db", 0.0)))
        driver = SimDriver(vcfg, hws, nodes, device)

    runtimes, firmwares = [], []
    for i, hw in enumerate(hws):
        pu = sc.phy.units[i if len(sc.phy.units) > 1 else 0]
        tp = sc.upper.tpoints[i if len(sc.upper.tpoints) > 1 else 0]
        fw = FIRMWARES[tp["firmware"]](tp, device)
        firmwares.append(fw)
        runtimes.append(NodeRuntime(
            hw, fw,
            network_id=tp.get("network_id", 0x12345678),
            u=pu.get("u", 1), b=pu.get("b", 1),
            chunk_len=pu.get("chunk_len", 2048),
            regular_period=pu.get("regular_period"),
            hw_samp_rate=getattr(hw, "samp_rate", None) or None,
            device=device))
    return RunningScenario(driver, hws, runtimes, firmwares)
