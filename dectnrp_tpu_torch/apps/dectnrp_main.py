"""Scenario runner CLI (port of dectnrp_tpu/apps/dectnrp_main.py; reference
apps/dectnrp/dectnrp.cpp): loads a scenario directory (radio.json +
phy.json + upper.json), builds the full radio -> phy -> upper stack on
--device (the card by default) and runs it for a given number of ticks (or
until ctrl+c), then prints one JSON line of the program's spans and
counters over the ticks (common/trace.py: each span's calls, ms a tick and
self ms a tick) and one per node of its stats.

    python -m dectnrp_tpu_torch.apps.dectnrp_main configurations/rtt_simulator --ticks 40
    python -m dectnrp_tpu_torch.apps.dectnrp_main configurations/socket_radio --ticks 40

A tick of simulated radios advances the virtual ether by spp samples. A
real-IQ radio (iq_socket, iq_file) paces itself: a tick waits until each
radio has delivered spp more samples, at most RADIO_WAIT_S, then runs the
runtimes.

--datagrams N hands node 0's firmware N numbered 24-byte datagrams, one
before every DATAGRAM_TICKS-th tick (an option of the port; the JAX CLI has
none): with rtt_simulator each goes over the air to node 1, which echoes
it back.

--profile PATH runs the last PROFILE_TICKS ticks (every tick without
--ticks) under torch.profiler with the spans on its timeline, writes the
Chrome trace to PATH and prints a JSON line of the ten longest device-idle
gaps, each named by the innermost span the host was in at its middle:

    python -m dectnrp_tpu_torch.apps.dectnrp_main configurations/p2p_simulator \
        --ticks 700 --profile p2p_trace.json
"""
from __future__ import annotations

import argparse
import json

from ..common import trace

#: ticks between two datagrams of --datagrams (16,384 samples at spp 2048:
#: each echo is on the air before the next datagram leaves)
DATAGRAM_TICKS = 8
#: longest a tick waits for a real-IQ radio's next spp samples (a file at
#: its end; a socket radio whose TX pacer has not started yet)
RADIO_WAIT_S = 0.1
#: ticks --profile traces, the last of the run: a short window (a profiled
#: tick records thousands of host and device events) after the simulated
#: radios' rings have filled (1 << 20 samples, 512 ticks at spp 2048)
PROFILE_TICKS = 90


def datagrams(n: int) -> list[bytes]:
    """n numbered 24-byte datagrams (the rtt app's probes)."""
    return [i.to_bytes(4, "big") + bytes(20) for i in range(n)]


def _profiler(device):
    """A started torch.profiler (the host, and the card if `device` is
    one) with the program's spans on its timeline."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    trace.timeline(True)
    return prof


def _stop_profiler(prof, device, path: str) -> list:
    """Stop `prof` (after the device's queue), write its Chrome trace to
    `path`; the ten longest device-idle gaps as [span, ms]."""
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    trace.timeline(False)
    prof.stop()
    prof.export_chrome_trace(path)
    gaps = trace.idle_gaps(*trace.device_intervals(
        prof.profiler.kineto_results.events()))
    return [[name, ns / 1e6] for name, ns, _, _ in gaps]


def run(argv: list[str] | None = None):
    """The CLI's work: (the running scenario, the per-node records it
    printed). The caller closes the scenario."""
    ap = argparse.ArgumentParser(
        description="DECT NR+ scenario runner (PyTorch + CUDA port)")
    ap.add_argument("scenario", help="scenario directory with "
                    "radio.json/phy.json/upper.json")
    ap.add_argument("--ticks", type=int, default=0,
                    help="number of lock-step spp ticks (0 = until ctrl+c)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the virtual ether and the PHY "
                    "(default cuda; cpu runs every kernel's plain twin)")
    ap.add_argument("--datagrams", type=int, default=0,
                    help="numbered datagrams handed to node 0's firmware, "
                    f"one every {DATAGRAM_TICKS} ticks")
    ap.add_argument("--profile", metavar="PATH",
                    help=f"run the last {PROFILE_TICKS} ticks under "
                    "torch.profiler with the program's spans on its timeline, "
                    "write the Chrome trace to PATH and print the ten longest "
                    "device-idle gaps")
    a = ap.parse_args(argv)

    from ..config import build_scenario, load_scenario
    sc = load_scenario(a.scenario)
    scenario = build_scenario(sc, a.device)
    print(f"scenario {sc.name}: {len(scenario.hws)} node(s), "
          f"{[t['firmware'] for t in sc.upper.tpoints]}")
    queued = datagrams(a.datagrams)
    first_profiled = max(0, a.ticks - PROFILE_TICKS)
    prof = None
    c0 = trace.counters()
    n = 0
    try:
        while a.ticks <= 0 or n < a.ticks:
            if a.profile and prof is None and n >= first_profiled:
                prof = _profiler(a.device)
            if queued and n % DATAGRAM_TICKS == 0:
                scenario.runtimes[0].work_application([queued.pop(0)])
            if scenario.driver is None:
                for hw in scenario.hws:
                    hw.wait_until(hw.rx_time_passed + sc.radio.spp_len,
                                  int(RADIO_WAIT_S * 1e6))
            scenario.tick()
            n += 1
    except KeyboardInterrupt:
        pass
    if prof is not None:
        print(json.dumps({"idle_gaps": _stop_profiler(prof, a.device, a.profile)}))
    c1 = trace.counters()
    print(json.dumps({"trace": {
        "ticks": n, "spans": trace.span_table(c0, c1, n),
        "counters": {k: c1[k] - c0[k] for k in trace.COUNTERS}}}))
    records = []
    for i, rt in enumerate(scenario.runtimes):
        fw = scenario.firmwares[i]
        stats = getattr(fw, "stats", None)
        records.append({"node": i, "runtime": vars(rt.stats),
                        "firmware": stats if isinstance(stats, dict) else None})
        print(json.dumps(records[-1]))
    return scenario, records


def main(argv: list[str] | None = None) -> int:
    scenario, _ = run(argv)
    scenario.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
