"""The p2p scenario on radios of class 2.12.4.A (`p2p_u2b12n4.beacon`, loop
`scenario_mimo`) through the harness on the CPU, traced and untraced; the
faults of the codebook search that its check must catch; the control,
which must fail a limit; the sync roofline's reader; and what the new
files import."""
import time

import pytest
import torch

from benchmark.core import harness
from benchmark.core.spec import load_cell, loop_module

CELL = "p2p_u2b12n4.beacon"
#: a window of the CPU holds several beacons (a period is 11.25 ticks),
#: each heard by both PTs: more PDCs, so codebook searches, than `sample`,
#: also on a CPU that other tests load
SECONDS = 10.0


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


def test_mimo_cell_rehearses(root):
    r = _run(root)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert {"cb_index_differ", "cb_metric_gap", "cb_calls_missing", "tx_late",
            "sync_calls_missing", "pdc_tb_differ", "vspace_gap",
            "beacon_missed_pct"} <= set(r["checks"])
    assert set(r["metrics"]) == {"node_realtime_x", "setup_s"}
    assert all(v["value"] > 0 for v in r["metrics"].values())


def test_mimo_cell_traced(root):
    r = _run(root, trace=True)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    for name in ("node.mimo_ms", "node.sync_ms", "node.rx_ms",
                 "node.tick_p95_ms"):
        assert isinstance(m.get(name), float) and m[name] > 0, (name, m)
    # no device on the CPU: no idle share, no device time for the roofline
    assert "node.idle_pct" not in m and "node.sync_roofline_pct" not in m


def test_sync_roofline_reader_by_hand():
    from benchmark.core.spec import reader
    from benchmark.core.trace import Trace

    read = reader("node.sync_roofline_pct")
    # the cell's chunk: u = 2 (9 STF patterns), b = 12, 4 antennas, K = 4
    shape = {"A": 4, "T": 31488, "K": 4, "u": 2, "b": 12, "P": 192,
             "L": 1728, "half": 192, "M": 4, "calls": 10}
    n_t, seg, D = 31488 - 1728 - 192, 1728 + 384, 385
    ops = n_t * (4 * (14 + 6 * 8) + 11) + 4 * 4 * (
        1536 * 8 + 1728 * 3 + seg * 6 + D * 1728 * 4 + D * 4 * 1728 * 8)
    nbytes = 4 * 31488 * 8 + n_t * 4 + n_t * 4 + 4 * 4 * seg * 8 \
        + 4 * 1728 * 8 + 1536 * 4 + 4 * 25
    by_hand = 10 * max(nbytes / 3.35e12, ops / 67e12)
    assert ops / 67e12 > nbytes / 3.35e12          # the fine search rules
    tr = Trace(units=3, shape=shape, profile={"span_device_s":
                                              {"sync": 4 * by_hand}})
    assert read(tr) == pytest.approx(25.0)
    assert read(Trace(units=3, shape=shape, profile={})) is None
    assert read(Trace(units=3, profile={"span_device_s": {"sync": 1.0}})) is None


# ------------------------------------------------------------------ faults

def test_wrong_codebook_index_is_caught(root, monkeypatch):
    """The runtime's search returns the weakest matrix's index (and the
    best matrix's metric)."""
    import numpy as np

    import dectnrp_tpu_torch.upper.runtime as R
    from dectnrp_tpu_torch.phy.mimo import search
    from dectnrp_tpu_torch.sections.part3.beamforming import get_all_W

    def weakest(cells, *a, **kw):
        idx, metric = search(cells, *a, **kw)
        W = torch.as_tensor(get_all_W(1, cells.shape[2]).astype(np.complex64))
        z = torch.einsum("brtc,nts->bncrs", cells.cpu(), W)
        p = (z.abs() ** 2).sum((3, 4)).min(-1).values
        return p.argmin(-1).to(idx.device), metric
    monkeypatch.setattr(R, "mimo_search", weakest)
    r = _run(root)
    assert not r["correct"]
    c = r["checks"]["cb_index_differ"]
    assert c["value"] > c["limit"], r["checks"]


def test_search_past_the_wrapper_is_caught(root, monkeypatch):
    """The runtime calls the search by another name than the module
    attribute the loop wraps."""
    import dectnrp_tpu_torch.upper.runtime as R
    from dectnrp_tpu_torch.phy.mimo import search

    def past(state):
        R.mimo_search = search
    r = _run(root, fault=past, monkeypatch=monkeypatch)
    assert not r["correct"]
    c = r["checks"]["cb_calls_missing"]
    assert c["value"] > c["limit"], r["checks"]


# ----------------------------------------------------------------- control

def test_mimo_control_fails_a_limit(root):
    cell = load_cell(CELL, root)
    cell.config.update(control_ticks=30, sample=2)
    loop = loop_module(cell.config)
    readings = loop.control(loop.setup(cell, 5, "cpu"))
    limits = cell.config["limits"]
    failed = [k for k in limits if k in readings and readings[k] > limits[k]]
    assert failed, readings
    assert readings["cb_metric_gap"] > limits["cb_metric_gap"] or \
        readings["cb_index_differ"] > limits["cb_index_differ"], readings


# ----------------------------------------------------------------- imports

def test_new_files_load_no_jax():
    import subprocess
    import sys
    import textwrap

    from conftest import ROOT

    code = textwrap.dedent("""
        import sys
        import benchmark.reference.mimo
        yard = sorted({m.split(".")[0] for m in sys.modules}
                      & {"dectnrp_tpu_torch", "dectnrp_tpu", "jax"})
        import benchmark.loops.scenario_mimo
        print(yard, sorted({m.split(".")[0] for m in sys.modules}
                           & {"dectnrp_tpu", "jax", "jaxlib", "flax"}))
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, check=True,
                         timeout=600).stdout
    assert out.strip().splitlines()[-1] == "[] []"
