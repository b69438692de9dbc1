"""The port's scenario configuration and runner (tests/test_config_cli.py
mirrored): JSON parsing with range validation through both packages, the
firmware registry, full-stack construction on the CPU and short runs of
the committed simulator configurations through
`python -m dectnrp_tpu_torch.apps.dectnrp_main`, and the socket_radio
scenario (a real-IQ radio on a UDP socket) from a copy of its
configuration on a free port; p2p_simulator on RX rings cut short enough
to wrap decides tick by tick as on the default ring.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from dectnrp_tpu import config as J
from dectnrp_tpu_torch import config as T
from dectnrp_tpu_torch.upper import FIRMWARES

torch.set_num_threads(1)
CONF = "configurations"
SIMULATORS = ("basic_simulator", "loopback_simulator", "p2p_simulator",
              "rtt_simulator")


def test_registry_names():
    from dectnrp_tpu.upper import FIRMWARES as JF
    for name in ("basic", "rtt", "txrxdelay", "txrxagc", "chscanner",
                 "p2p_ft", "p2p_pt", "loopback_snr"):
        assert name in FIRMWARES
    assert sorted(FIRMWARES) == sorted(JF)


@pytest.mark.parametrize("pkg", [J, T], ids=["jax", "torch"])
def test_parse_validation(pkg):
    with pytest.raises(ValueError, match="n_ant"):
        pkg.RadioConfig.parse({"hws": [{"n_ant": 3}]})
    with pytest.raises(ValueError, match="unknown firmware"):
        pkg.UpperConfig.parse({"tpoints": [{"firmware": "nope"}]})
    with pytest.raises(ValueError, match="firmware name"):
        pkg.UpperConfig.parse({"tpoints": [{}]})
    with pytest.raises(ValueError, match="b in"):
        pkg.PhyConfig.parse({"units": [{"b": 3}]})


def test_load_all_scenarios():
    """Both packages read each committed scenario alike."""
    for name in SIMULATORS + ("socket_radio",):
        sc, sj = T.load_scenario(f"{CONF}/{name}"), J.load_scenario(f"{CONF}/{name}")
        assert sc.name == name
        assert len(sc.radio.hws) >= 1
        for part in ("radio", "phy", "upper"):
            assert dataclasses.asdict(getattr(sc, part)) == \
                dataclasses.asdict(getattr(sj, part))


def test_basic_simulator_runs():
    sc = T.load_scenario(f"{CONF}/basic_simulator")
    run = T.build_scenario(sc, "cpu")
    run.run_ticks(8)
    assert run.runtimes[0].stats.chunks >= 1
    assert run.hws[0].rx_time_passed == 8 * sc.radio.spp_len


def test_cli_main(capsys):
    from dectnrp_tpu_torch.apps.dectnrp_main import main
    rc = main([f"{CONF}/basic_simulator", "--ticks", "4", "--device", "cpu"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    assert rec["node"] == 0 and "runtime" in rec


def test_p2p_simulator_scenario():
    """The p2p_simulator configuration end to end through the config
    system: the PT hears the FT's beacons and associates."""
    from dectnrp_tpu_torch.upper.p2p import AssocState
    sc = T.load_scenario(f"{CONF}/p2p_simulator")
    run = T.build_scenario(sc, "cpu")
    run.run_ticks(120)
    ft, pt = run.firmwares
    assert pt.stats["beacons"] >= 2
    assert pt.state is AssocState.ASSOCIATED


def _p2p_history(ticks: int):
    """p2p_simulator on the CPU: after every tick, each node's RuntimeStats
    and firmware stats and the PT's association state."""
    run = T.build_scenario(T.load_scenario(f"{CONF}/p2p_simulator"), "cpu")
    hist = []
    for _ in range(ticks):
        run.tick()
        hist.append(([vars(rt.stats).copy() for rt in run.runtimes],
                     [dict(f.stats) for f in run.firmwares],
                     run.firmwares[1].state))
    return run, hist


def test_p2p_simulator_on_a_wrapped_rx_ring(monkeypatch):
    """The radios' RX rings cut to 32 spp wrap three times in 100 ticks;
    association, beacons heard and every PCC / PDC outcome stay, tick by
    tick, those of the same seed on the default ring."""
    from functools import partial

    from dectnrp_tpu_torch.radio.hw_simulator import HwSimulator
    from dectnrp_tpu_torch.upper.p2p import AssocState

    ticks, cap = 100, 32 * 2048
    big, want = _p2p_history(ticks)
    monkeypatch.setattr(T, "HwSimulator", partial(HwSimulator, rx_ring_len=cap))
    small, got = _p2p_history(ticks)
    assert [h.rx_ring_len for h in small.hws] == [cap, cap]
    assert got == want
    stats, fw, state = got[-1]
    assert state is AssocState.ASSOCIATED
    assert fw[1]["beacons"] > got[ticks // 2][1][1]["beacons"] >= 2
    assert all(s["pcc_ok"] and s["pdc_ok"] for s in stats)
    for a, b in zip(small.hws, big.hws):     # the same samples, wrapped
        assert a.rx_time == a.rx_time_passed - cap > 2 * cap
        np.testing.assert_array_equal(a.get_rx_stream(a.rx_time, cap),
                                      b.get_rx_stream(a.rx_time, cap))


def test_socket_radio_scenario_not_ported(tmp_path):
    """The socket_radio scenario (hw type iq_socket) builds a full-duplex
    network radio stack with no lock-step driver; its TX egress loops back
    into its RX ingress on the same UDP port and the runtime consumes the
    self-paced stream (tests/test_config_cli.py::
    test_socket_radio_scenario_builds_and_runs mirrored; the name is kept
    from when the port refused it). Run from a copy of the configuration
    whose port is a free one."""
    import shutil
    import time

    from dectnrp_tpu_torch.common.native import native_available
    from dectnrp_tpu_torch.iq_check import on_free_port
    if not native_available():
        pytest.skip("native runtime unavailable (no g++)")

    def build(port):
        d = tmp_path / f"socket_radio_{port}"
        shutil.copytree(f"{CONF}/socket_radio", d)
        radio = json.loads((d / "radio.json").read_text())
        assert radio["hws"][0]["rx_port"] == 40555
        radio["hws"][0].update(rx_port=port, tx_sink=f"udp:{port}")
        (d / "radio.json").write_text(json.dumps(radio))
        return T.build_scenario(T.load_scenario(d), "cpu")

    run = on_free_port(build)
    try:
        assert run.driver is None
        assert run.hws[0].txc is not None
        deadline = time.time() + 30.0
        while time.time() < deadline and run.hws[0].rx_time_passed < 40000:
            run.tick()
            time.sleep(0.01)
        # the paced TX consumer emits zeros -> they arrive on the RX ring
        assert run.hws[0].rx_time_passed >= 40000
        assert run.runtimes[0].stats.chunks > 0
        assert run.hws[0].producer.malformed == 0
    finally:
        run.close()


def test_rtt_simulator_round_trips():
    """rtt_simulator with three datagrams handed to node 0 (the CLI's
    --datagrams): each goes over the air to node 1, which echoes it; all
    three come back and no PDC fails its CRC."""
    from dectnrp_tpu_torch.apps.dectnrp_main import datagrams, run
    scenario, recs = run([f"{CONF}/rtt_simulator", "--ticks", "40",
                          "--device", "cpu", "--datagrams", "3"])
    assert [r["firmware"] for r in recs] == [{"tx": 3, "rx": 3}] * 2, recs
    assert all(r["runtime"]["pdc_err"] == 0 for r in recs), recs
    assert scenario.firmwares[0].app_rx == datagrams(3)


def test_loopback_simulator_records():
    """loopback_simulator: the loopback_snr firmware runs its PER sweep
    (MCS 1 and 2 at 0, 10 and 20 dB, 20 packets) at startup; at 20 dB
    every packet decodes."""
    from dectnrp_tpu_torch.apps.dectnrp_main import run
    scenario, _ = run([f"{CONF}/loopback_simulator", "--ticks", "1",
                       "--device", "cpu"])
    res = scenario.firmwares[0].results
    assert sorted(res) == [1, 2]
    for mcs, rec in res.items():
        assert rec["experiment_range"]["snr_vec"] == [0.0, 10.0, 20.0]
        assert rec["result"]["PER_pdc_crc"][-1] == 0.0, (mcs, rec)
