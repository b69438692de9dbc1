"""The p2p scenario on radios at 1.92 Ms/s (`p2p_u1b1_sdr.beacon`, loop
`scenario_sdr`) through the harness on the CPU, traced and untraced; the
faults of the resampler path that its check must catch; the control, which
must fail a limit of the resampler's own checks; and what its new files
import."""
import time

import pytest
import torch

from benchmark.core import harness
from benchmark.core.spec import load_cell, loop_module

CELL = "p2p_u1b1_sdr.beacon"
NEW = ("node.pump_ms", "node.tx_resample_ms")
#: a window of the CPU holds two beacons (a period is 12.5 ticks) and the
#: chain's 8 front-end steps (5 ticks)
SECONDS = 6.0


def _run(root, trace=False, fault=None, monkeypatch=None, trace_units=3):
    cell = load_cell(CELL, root)
    cell.config.update(sample=2, trace_units=trace_units)
    if fault is not None:
        loop = loop_module(cell.config)
        setup = loop.setup

        def broken(*a, **kw):
            state = setup(*a, **kw)
            fault(state)
            return state
        monkeypatch.setattr(loop, "setup", broken)
    return harness.run_cell(cell, 2 ** 31 + 37, SECONDS, trace, "cpu",
                            time.perf_counter())


def test_sdr_cell_rehearses(root):
    r = _run(root)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert {"rs_rx_gap", "rs_tx_gap", "rs_rx_chain_gap", "rs_rx_calls_missing",
            "rs_tx_calls_missing", "tx_late", "sync_calls_missing",
            "vspace_gap", "beacon_missed_pct"} <= set(r["checks"])
    assert set(r["metrics"]) == {"node_realtime_x", "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())


def test_sdr_cell_traced(root):
    r = _run(root, trace=True)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    for name in NEW + ("node.tick_p95_ms",):
        assert isinstance(m.get(name), float) and m[name] > 0, (name, m)
    # no device on the CPU: no idle share, no device time for the roofline
    assert "node.idle_pct" not in m and "node.b3_roofline_pct" not in m
    # the DECT-rate buffers (2**20 samples) are not full yet: nothing slid
    assert m["node.dbuf_slide_mb"] == 0.0


def test_b3_roofline_reader_by_hand():
    from benchmark.core.spec import reader
    from benchmark.core.trace import Trace

    read = reader("node.b3_roofline_pct")
    shape = {"A": 1, "chunk_in": 1280, "H": 24, "L": 9, "M": 10, "W": 24,
             "n_out": 1152, "steps": 10}
    by_hand = (1304 * 8 + 1152 * 8 + 9 * 24 * 4) * 10 / 3.35e12
    tr = Trace(units=3, shape=shape, profile={"span_device_s":
                                              {"resample_rx": 2 * by_hand}})
    assert read(tr) == pytest.approx(50.0)
    assert read(Trace(units=3, shape=shape, profile={})) is None
    assert read(Trace(units=3, profile={"span_device_s": {"resample_rx": 1.0}})) \
        is None


# ------------------------------------------------------------------ faults

def _taps_perturbed(state):
    """one tap of the front end's 9/10 filter off by a percent."""
    from dectnrp_tpu_torch.upper.runtime import _module
    rt = state.sc.runtimes[0]
    step = _module("resampler_stream", (rt.plan_rx, rt._chunk_pump), rt._dev)
    state.restore = step.G.clone()
    state.restore_to = step
    step.G[4, 10] *= 1.01


def _zero_history(state):
    """every front-end step handed zeros for its history."""
    for rt in state.sc.runtimes:
        rt._rx_step = (lambda f: lambda x, hist: f(x, torch.zeros_like(hist)))(
            rt._rx_step)


def _step_skipped(state):
    """a front-end step skipped wherever two steps' samples are in: the
    runtime moves on by both and resamples only the second."""
    for rt in state.sc.runtimes:
        get = rt.hw.get_rx_stream

        def g(t0, k, rt=rt, get=get):
            if k == rt._chunk_pump and state.recording and \
                    rt._hw_consumed + 2 * k <= rt.hw.rx_time_passed:
                rt._hw_consumed += k
                t0 += k
            return get(t0, k)
        rt.hw.get_rx_stream = g


@pytest.mark.parametrize("fault,name", [(_taps_perturbed, "rs_rx_gap"),
                                        (_zero_history, "rs_rx_chain_gap"),
                                        (_step_skipped, "rs_rx_chain_gap")])
def test_sdr_faults_are_caught(root, monkeypatch, fault, name):
    kept = []

    def keep(state):
        fault(state)
        kept.append(state)
    try:
        r = _run(root, fault=keep, monkeypatch=monkeypatch)
    finally:
        for s in kept:
            if hasattr(s, "restore"):
                s.restore_to.G.copy_(s.restore)
    assert not r["correct"]
    c = r["checks"][name]
    assert c["value"] > c["limit"], (name, r["checks"])


def test_sdr_tx_resampler_bypassed_is_caught(root, monkeypatch):
    """the TX burst sent at the DECT rate, the 10/9 resampler skipped."""
    import dectnrp_tpu_torch.upper.runtime as R

    def bypass(state):
        real = R._module
        monkeypatch.setattr(R, "_module", lambda kind, *a, **kw: (
            (lambda x: x) if kind == "resampler" else real(kind, *a, **kw)))
    r = _run(root, fault=bypass, monkeypatch=monkeypatch)
    assert not r["correct"]
    assert r["checks"]["rs_tx_calls_missing"]["value"] > 0
    assert r["checks"]["beacon_missed_pct"]["value"] > 1.0


# ----------------------------------------------------------------- control

def test_sdr_control_fails_a_resampler_limit(root):
    cell = load_cell(CELL, root)
    cell.config.update(control_ticks=30, sample=2)
    loop = loop_module(cell.config)
    readings = loop.control(loop.setup(cell, 5, "cpu"))
    limits = cell.config["limits"]
    failed = [k for k in ("rs_rx_gap", "rs_tx_gap", "rs_rx_chain_gap")
              if readings[k] > limits[k]]
    assert failed, readings
    assert readings["rs_rx_chain_gap"] > limits["rs_rx_chain_gap"]


# ----------------------------------------------------------------- imports

def test_new_files_load_no_jax():
    import subprocess
    import sys
    import textwrap

    from conftest import ROOT

    code = textwrap.dedent("""
        import sys
        import benchmark.reference.resampler, benchmark.phyref.phy.resampler
        yard = sorted({m.split(".")[0] for m in sys.modules}
                      & {"dectnrp_tpu_torch", "dectnrp_tpu", "jax"})
        import benchmark.loops.scenario_sdr
        print(yard, sorted({m.split(".")[0] for m in sys.modules}
                           & {"dectnrp_tpu", "jax", "jaxlib", "flax"}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=600).stdout
    assert out.strip().splitlines()[-1] == "[] []"
