"""Scenario runner CLI (port of dectnrp_tpu/apps/dectnrp_main.py; reference
apps/dectnrp/dectnrp.cpp): loads a scenario directory (radio.json +
phy.json + upper.json), builds the full radio -> phy -> upper stack on
--device (the card by default) and runs it for a given number of ticks (or
until ctrl+c), then prints per-node stats.

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
"""
from __future__ import annotations

import argparse
import json

#: ticks between two datagrams of --datagrams (16,384 samples at spp 2048:
#: each echo is on the air before the next datagram leaves)
DATAGRAM_TICKS = 8
#: longest a tick waits for a real-IQ radio's next spp samples (a file at
#: its end; a socket radio whose TX pacer has not started yet)
RADIO_WAIT_S = 0.1


def datagrams(n: int) -> list[bytes]:
    """n numbered 24-byte datagrams (the rtt app's probes)."""
    return [i.to_bytes(4, "big") + bytes(20) for i in range(n)]


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
    a = ap.parse_args(argv)

    from ..config import build_scenario, load_scenario
    sc = load_scenario(a.scenario)
    scenario = build_scenario(sc, a.device)
    print(f"scenario {sc.name}: {len(scenario.hws)} node(s), "
          f"{[t['firmware'] for t in sc.upper.tpoints]}")
    queued = datagrams(a.datagrams)
    try:
        n = 0
        while a.ticks <= 0 or n < a.ticks:
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
