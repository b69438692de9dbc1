"""A scenario of simulated DECT NR+ nodes driven through the user's entry:
`config.load_scenario` -> `build_scenario` -> `RunningScenario.tick`, ticks
back to back as `apps.dectnrp_main` runs them, with the application queues
topped up before each tick (gen/datagrams.py).

Set-up builds the scenario (the virtual ether's seed is the run's), runs
ticks until every PT is associated, then `warm_periods` beacon periods of
the traffic, so every module the window uses is built. The window's tick is
timed on the host around `RunningScenario.tick`.

For the check, forward hooks on the port's `Sync`, `RxStream` and `Tx`
keep a sample of the window's calls, drawn from the seed (each call's
input and output): the reference re-runs each on the same input, which
comes from the program's own virtual ether (the TX that feeds it is
checked by itself, against the reference TX on the same bits). Wrappers of
the ether's `VSpace.tick` and `VSpace.draw` keep a sample of the window's
ticks in which some node sends (TX blocks, RX blocks, the tick's draws),
which the ether's reference works out again from the scenario's radio
file. Every kind of call and tick has to be seen `sample` times in the
window: a path that no hook or wrapper catches fails the check. Every
datagram sent must arrive once, unaltered; every beacon the FT sent must
reach every PT.

Configuration keys: scenario (directory of radio/phy/upper.json under
benchmark/configs/), max_assoc_ticks, trace_units, sample (calls or
ticks kept of each kind), control_ticks, limits {check: limit}.
"""
from __future__ import annotations

import json
import random
import time
from dataclasses import dataclass, field

import torch

from ..gen.datagrams import Datagrams
from ..phyref.sections.part3.packet_sizes import PacketSizesDef, get_packet_sizes
from ..reference.ether import EtherReference
from ..reference.scenario import CallReference

SPANS = {"dectnrp_tpu_torch.phy.sync.Sync": "sync",
         "dectnrp_tpu_torch.phy.sync.RxStream": "rx",
         "dectnrp_tpu_torch.phy.tx.Tx": "tx"}
KINDS = ("sync", "pcc", "pdc", "tx", "vspace")
#: the name of each kind's count of calls (ticks) missing from the sample
MISSING = {"sync": "sync_calls_missing", "pcc": "pcc_calls_missing",
           "pdc": "pdc_calls_missing", "tx": "tx_calls_missing",
           "vspace": "vspace_ticks_missing"}


@dataclass
class State:
    cell: object
    sc: object                  # the running scenario
    spp: int
    rate: float
    device: torch.device
    gen: Datagrams
    rng: random.Random
    sample: int
    kept: dict = field(default_factory=lambda: {k: [] for k in KINDS})
    seen: dict = field(default_factory=lambda: {k: 0 for k in KINDS})
    recording: bool = False
    hooks: list = field(default_factory=list)
    readings: dict = field(default_factory=dict)   # every number the check read
    beacons_sent: int = 0                   # by the FT in the windows
    beacons_heard: list = field(default_factory=list)   # by each PT in them
    windows: int = 0
    draws: dict | None = None               # the ether's draws of this tick


def _fw(state: State, name: str) -> list:
    return [(i, f) for i, f in enumerate(state.sc.firmwares) if f.NAME == name]


def _associated(state: State) -> bool:
    from dectnrp_tpu_torch.upper.p2p import AssocState
    return all(f.state is AssocState.ASSOCIATED for _, f in _fw(state, "p2p_pt"))


def _min_len(u: int, b: int, tm: int) -> tuple:
    """(PacketLengthType, PacketLength) of the smallest valid packet of a
    geometry at MCS 0, which the runtime's PCC stage demodulates (the rule
    of the port's `upper.runtime._min_len_psdef`)."""
    for plt, plen in ((0, 1), (0, 2), (0, 4), (1, 1), (1, 2)):
        if get_packet_sizes(PacketSizesDef(u, b, plt, plen, tm, 0, 6144)):
            return plt, plen
    raise ValueError("no valid minimum packet")


def _kind(module) -> str | None:
    name = type(module).__qualname__
    if name == "Sync":
        return "sync"
    if name == "Tx":
        return "tx"
    if name == "RxStream":
        p = module.rx.ps.psdef
        pcc = p.mcs_index == 0 and (p.PacketLengthType, p.PacketLength) \
            == _min_len(p.u, p.b, p.tm_mode_index)
        return "pcc" if pcc else "pdc"
    return None


def _keep(state: State, kind: str, rec) -> None:
    """A reservoir sample of the window's calls of `kind`; `rec` makes the
    record to keep, only when it is kept."""
    state.seen[kind] += 1
    kept = state.kept[kind]
    if len(kept) < state.sample:
        kept.append(rec())
    else:
        i = state.rng.randrange(state.seen[kind])
        if i < state.sample:
            kept[i] = rec()


def _catch(state: State):
    def hook(module, args, out):
        kind = _kind(module) if state.recording else None
        if kind is not None:
            _keep(state, kind, lambda: (module, args, out))
    state.hooks.append(torch.nn.modules.module.register_module_forward_hook(hook))

    vs = state.sc.driver.vspace
    draw, tick = vs.draw, vs.tick

    def draw_seen(*a, **kw):
        state.draws = draw(*a, **kw)
        return state.draws

    def tick_seen(tx, draws=None):
        state.draws = draws
        rx = tick(tx, draws)
        if state.recording and bool((tx != 0).any()):
            d = state.draws
            _keep(state, "vspace", lambda: (
                tx.clone(), rx.clone(),
                None if d is None else {k: v.clone() for k, v in d.items()}))
        return rx
    vs.draw, vs.tick = draw_seen, tick_seen


def _top_up(state: State) -> None:
    if not state.gen.queue:
        return
    pts = _fw(state, "p2p_pt")
    for i, f in _fw(state, "p2p_ft"):
        n = sum(1 for pi, p in pts if p.state.name == "ASSOCIATED")
        state.sc.runtimes[i].work_application(
            state.gen.top_up(i, len(f.app_tx), n))
    for i, f in pts:
        state.sc.runtimes[i].work_application(
            state.gen.top_up(i, len(f.app_tx), 1))


def setup(cell, seed: int, device) -> State:
    from dectnrp_tpu_torch.config import build_scenario, load_scenario

    cfg, tr = cell.config, cell.traffic
    sc = load_scenario(cell.root / "benchmark" / "configs" / cfg["scenario"])
    sc.radio.sim_seed = seed
    running = build_scenario(sc, device)
    state = State(cell, running, sc.radio.spp_len, sc.radio.samp_rate,
                  torch.device(device), Datagrams(tr, seed), random.Random(seed),
                  int(cfg["sample"]))
    for _ in range(int(cfg["max_assoc_ticks"])):
        running.tick()
        if _associated(state):
            break
    else:
        raise RuntimeError("set-up: not every PT associated within "
                           f"{cfg['max_assoc_ticks']} ticks")
    ft = _fw(state, "p2p_ft")[0][1]
    period = ft.cfg.beacon_period
    ticks = -(-int(tr["warm_periods"]) * period // state.spp)
    for _ in range(ticks):
        _top_up(state)
        running.tick()
    _catch(state)
    return state


def attach(state: State, spans) -> None:
    drv = state.sc.driver
    drv.tick = spans.wrap(drv.tick, "vspace")


def window(state: State, seconds: float | None = None,
           units: int | None = None) -> dict:
    """Ticks back to back (each after the top-up) for `seconds`, or
    `units` ticks."""
    ft = _fw(state, "p2p_ft")[0][1]
    pts = [f for _, f in _fw(state, "p2p_pt")]
    b0, h0 = ft.stats["beacons"], [p.stats["beacons"] for p in pts]
    state.recording = True
    unit_ms = []
    t_start = time.perf_counter()
    while True:
        _top_up(state)
        t0 = time.perf_counter()
        state.sc.tick()
        t1 = time.perf_counter()
        unit_ms.append((t1 - t0) * 1e3)
        if (units is not None and len(unit_ms) >= units) or \
                (seconds is not None and t1 - t_start >= seconds):
            break
    state.recording = False
    state.beacons_sent += ft.stats["beacons"] - b0
    heard = [p.stats["beacons"] - h for p, h in zip(pts, h0)]
    state.beacons_heard = [a + b for a, b in zip(state.beacons_heard, heard)] \
        if state.beacons_heard else heard
    state.windows += 1
    return {"unit_ms": unit_ms, "window_s": t1 - t_start}


def end_to_end(state: State, win: dict) -> dict:
    from ..core.stats import percentile
    from ..metrics.frozen import tick_rate

    return {"node_realtime_x": tick_rate(len(win["unit_ms"]), state.spp,
                                         state.rate, win["window_s"]),
            "node_tick_p95_ms": percentile(win["unit_ms"], 95)}


def shape(state: State) -> dict:
    return {}                             # no reader needs the sizes


def _delivery(state: State) -> tuple[dict, int, int]:
    """Datagrams: every one that arrives arrives once and unaltered; the
    share that never arrives (the p2p firmware has no retransmission, so a
    datagram is best effort: PERF.md §6 gives the losses seen)."""
    got: dict[bytes, int] = {}
    for f in state.sc.firmwares:
        for d in f.app_rx:
            got[d] = got.get(d, 0) + 1
    pushed = state.gen.pushed
    wrong = sum(n for d, n in got.items() if d not in pushed)
    dup = sum(n - 1 for d, n in got.items() if d in pushed and n > 1)
    lost = [d for d in pushed if d not in got]
    return {"dgram_missing_pct": 100.0 * len(lost) / max(1, len(pushed)),
            "dgram_wrong": wrong + dup, "dgram_missing": len(lost),
            "dgram_missing_from": sorted(pushed[d] for d in lost)}, \
        len(pushed), len(lost)


def check(state: State) -> tuple[list, int, int]:
    cfg, tr = state.cell.config, state.cell.traffic
    sent_in_window = len(state.gen.pushed)
    state.gen.queue = 0                   # no new datagrams: drain
    for _ in range(int(tr["drain_ticks"])):
        state.sc.tick()
    for h in state.hooks:
        h.remove()
    found, attempted, failed = _delivery(state)
    # the FT counts a beacon when it schedules it, a prepare time ahead of
    # its air time: one a window may be heard after the window closed
    missed = sum(max(0, state.beacons_sent - h - state.windows)
                 for h in state.beacons_heard)
    heard_due = state.beacons_sent * len(state.beacons_heard)
    found["beacon_missed"] = missed
    found["beacon_missed_pct"] = 100.0 * missed / max(1, heard_due)
    if not sent_in_window:                # beacons only
        attempted, failed = heard_due, missed
    state.sc.close()
    state.sc = None
    for kind, name in MISSING.items():
        found[name] = max(0, state.sample - state.seen[kind])
    found.update(CallReference(state.device).compare_all(_calls(state)))
    found.update(EtherReference(_radio(state), state.device).compare(
        state.kept["vspace"]))
    state.readings = found
    limits = cfg["limits"]
    return [(k, found[k], limits[k]) for k in limits], attempted, failed


def _calls(state: State) -> dict:
    return {k: v for k, v in state.kept.items() if k != "vspace"}


def _radio(state: State) -> dict:
    cell = state.cell
    return json.loads((cell.root / "benchmark" / "configs"
                       / cell.config["scenario"] / "radio.json").read_text())


def control(state: State) -> dict:
    """The control's readings: the references in bf16 put in the
    program's place on the kept calls and ticks, read against the float32
    (ether: complex128) references."""
    window(state, units=int(state.cell.config["control_ticks"]))
    ref = CallReference(state.device)
    low = CallReference(state.device, "bfloat16")
    out = ref.compare_all(_calls(state), against=low)
    radio = _radio(state)
    out.update(EtherReference(radio, state.device).compare(
        state.kept["vspace"],
        against=EtherReference(radio, state.device, "bfloat16")))
    return out
