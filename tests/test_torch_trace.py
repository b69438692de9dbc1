"""The port's tracer (common/trace.py): its arithmetic on synthetic spans,
the gap namer on synthetic intervals, and the spans and counters of a
short run of configurations/p2p_simulator on the CPU (calls per tick and
node, self times, reads of device values, decoder calls, module builds
after warm-up); the timeline under a CPU torch.profiler, whose ranges
nest as the spans do and which moves no decision of the runtime; the
scenario runner's trace line and --profile."""
import json
import time
from pathlib import Path

import pytest
import torch

from dectnrp_tpu_torch import config as T
from dectnrp_tpu_torch.common import trace

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
P2P = ROOT / "configurations" / "p2p_simulator"
#: each span's parent as the program opens them (None: a root)
PARENT = {"scenario.tick": None, "sim.tick": "scenario.tick",
          "sim.assemble": "sim.tick", "sim.ether": "sim.tick",
          "sim.deliver": "sim.tick", "runtime.process": "scenario.tick",
          **{s: "runtime.process" for s in trace.SPANS
             if s.split(".")[0] == "firmware" or s.startswith("runtime.")
             and s != "runtime.process"},
          "runtime.mimo": "runtime.pdc"}
WARM_MAX, WINDOW = 80, 12


def _delta(c0, c1):
    return {k: c1[k] - c0[k] for k in c0}


def _stats(run):
    return [vars(rt.stats).copy() for rt in run.runtimes], \
        [dict(f.stats) for f in run.firmwares]


# ------------------------------------------------------------ synthetic
def test_registry_from_import():
    c = trace.counters()
    for name in trace.COUNTERS:
        assert name in c
    for s in trace.SPANS:
        for f in ("calls", "ns", "self_ns"):
            assert f"span.{s}.{f}" in c
    assert set(PARENT) == set(trace.SPANS)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        trace.span("no.such.span")
    with pytest.raises(KeyError):
        trace.count("no.such.counter")


def test_span_arithmetic():
    c0 = trace.counters()
    with trace.span("sim.tick"):
        time.sleep(0.002)
        for _ in range(2):
            with trace.span("sim.assemble"):
                time.sleep(0.001)
                with trace.span("sim.ether"):
                    time.sleep(0.001)
    d = _delta(c0, trace.counters())
    assert d["span.sim.tick.calls"] == 1
    assert d["span.sim.assemble.calls"] == 2
    assert d["span.sim.ether.calls"] == 2
    assert d["span.sim.tick.self_ns"] == \
        d["span.sim.tick.ns"] - d["span.sim.assemble.ns"]
    assert d["span.sim.assemble.self_ns"] == \
        d["span.sim.assemble.ns"] - d["span.sim.ether.ns"]
    assert d["span.sim.ether.self_ns"] == d["span.sim.ether.ns"] >= 2e6
    assert d["span.sim.tick.self_ns"] >= 2e6


def test_span_closes_on_error():
    c0 = trace.counters()
    with pytest.raises(RuntimeError):
        with trace.span("runtime.process"):
            with trace.span("runtime.sync"):
                raise RuntimeError("fault")
    d = _delta(c0, trace.counters())
    assert d["span.runtime.process.calls"] == d["span.runtime.sync.calls"] == 1
    assert not trace._stack


def test_counters_and_copies():
    c0 = trace.counters()
    trace.count("fec.pdc_blocks")
    trace.count("fec.pdc_iters", 5)
    trace.h2d(100)
    trace.d2h(8)
    trace.d2h(1)
    d = _delta(c0, trace.counters())
    assert (d["fec.pdc_blocks"], d["fec.pdc_iters"]) == (1, 5)
    assert (d["xfer.h2d"], d["xfer.h2d_bytes"]) == (1, 100)
    assert (d["xfer.d2h"], d["xfer.d2h_bytes"]) == (2, 9)


def test_launch_counts_holds_the_program_counters():
    from dectnrp_tpu_torch import dcn_dryrun, kernels, scaling

    c = kernels.launch_counts()
    assert kernels.LAUNCH_KEYS == ("bcjr", "bcjr_one_window", "bcjr_bf16", "sync",
                                   "polyphase", "sync_report")
    assert tuple(c)[:len(kernels.LAUNCH_KEYS)] == kernels.LAUNCH_KEYS
    assert set(trace.counters()) <= set(c)
    # the tools' reports keep their shape: the launch keys only
    _, launches = scaling._launches(lambda: None)
    assert tuple(launches) == kernels.LAUNCH_KEYS
    assert tuple(dcn_dryrun._since(c)) == kernels.LAUNCH_KEYS


def test_idle_gaps_named_by_innermost_range():
    dev = [(0, 10), (20, 30), (25, 28), (50, 60), (100, 110), (300, 301)]
    ranges = [(0, 200, "scenario.tick"), (60, 120, "runtime.process"),
              (70, 90, "runtime.sync"), (35, 45, "sim.tick")]
    gaps = trace.idle_gaps(dev, ranges)
    # longest first: (110, 300) outside every range but scenario.tick's
    # end, (60, 100) in runtime.sync, (30, 50) in sim.tick, (10, 20)
    assert gaps == [("host", 190, 110, 300), ("runtime.sync", 40, 60, 100),
                    ("sim.tick", 20, 30, 50), ("scenario.tick", 10, 10, 20)]
    assert trace.idle_gaps(dev, ranges, n=2) == gaps[:2]
    assert trace.idle_gaps([], ranges) == []
    assert trace.idle_gaps([(0, 5), (3, 9)], ranges) == []   # overlapping


class _Event:
    def __init__(self, name, t0, dur, cuda):
        self._n, self._t, self._d, self._c = name, t0, dur, cuda

    def name(self):
        return self._n

    def start_ns(self):
        return self._t

    def duration_ns(self):
        return self._d

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._c \
            else torch.autograd.DeviceType.CPU


def test_device_intervals_leave_out_annotations():
    ev = [_Event("bcjr_kernel", 10, 5, True),
          _Event("dectnrp.runtime.pcc", 0, 40, True),     # an annotation
          _Event("dectnrp.runtime.pcc", 0, 40, False),
          _Event("aten::add", 2, 1, False),
          _Event("Memcpy DtoH", 30, 2, True)]
    dev, ranges = trace.device_intervals(ev)
    assert dev == [(10, 15), (30, 32)]
    assert ranges == [(0, 40, "runtime.pcc")]


# ------------------------------------------------- a run of the scenario
@pytest.fixture(scope="module")
def p2p_windows():
    """configurations/p2p_simulator on the CPU: ticks until the PT is
    associated, every PCC-stage module the detector's N_eff can ask for
    built, then two windows of WINDOW ticks; the counters and stats
    around each."""
    from dectnrp_tpu_torch.sections.part3.packet_sizes import get_packet_sizes
    from dectnrp_tpu_torch.upper import runtime as R
    from dectnrp_tpu_torch.upper.p2p import AssocState

    run = T.build_scenario(T.load_scenario(P2P), "cpu")
    for _ in range(WARM_MAX):
        run.tick()
        if run.firmwares[1].state is AssocState.ASSOCIATED:
            break
    assert run.firmwares[1].state is AssocState.ASSOCIATED
    for rt in run.runtimes:                 # false detections' geometries
        for tm in rt.tm_by_n_eff.values():
            ps = R._min_len_psdef(rt.u, rt.b, tm)
            R._module("rx_stream", (ps, rt.network_id, 1,
                                    get_packet_sizes(ps).N_samples_packet),
                      rt._dev)
    run.tick()
    out = []
    for _ in range(2):
        c, s = trace.counters(), _stats(run)
        misses = R._module.cache_info().misses
        run.run_ticks(WINDOW)
        out.append({"d": _delta(c, trace.counters()),
                    "stats": [{k: b[k] - a[k] for k in a}
                              for a, b in zip(s[0], _stats(run)[0])],
                    "misses": R._module.cache_info().misses - misses})
    return run, out


def test_calls_per_tick_and_node(p2p_windows):
    run, (w, _) = p2p_windows
    d = w["d"]
    assert d["span.scenario.tick.calls"] == WINDOW
    assert d["span.sim.tick.calls"] == WINDOW
    for s in ("sim.assemble", "sim.ether", "sim.deliver"):
        assert d[f"span.{s}.calls"] == WINDOW
    assert d["span.runtime.process.calls"] == WINDOW * len(run.runtimes)
    assert d["span.runtime.sync.calls"] == sum(s["chunks"] for s in w["stats"])


def test_self_times_and_children(p2p_windows):
    _, wins = p2p_windows
    for w in wins:
        d = w["d"]
        for s in trace.SPANS:
            assert 0 <= d[f"span.{s}.self_ns"] <= d[f"span.{s}.ns"], s
        for s in trace.SPANS:
            kids = [c for c, p in PARENT.items() if p == s]
            assert sum(d[f"span.{c}.ns"] for c in kids) <= d[f"span.{s}.ns"], s
        # every span of the window lies in a tick: the self times add up
        # to the ticks' time, to the nanosecond
        assert sum(d[f"span.{s}.self_ns"] for s in trace.SPANS) == \
            d["span.scenario.tick.ns"]


def test_reads_of_device_values(p2p_windows):
    _, wins = p2p_windows
    for w in wins:
        d, st = w["d"], w["stats"]
        chunks = sum(s["chunks"] for s in st)
        # a sync report a chunk and the ether's RX block a tick, at least
        assert d["xfer.d2h"] >= chunks + WINDOW
        assert d["xfer.d2h_bytes"] > 0
        # a chunk to the card, and the ether's TX block a tick
        assert d["xfer.h2d"] >= chunks + WINDOW


def test_decoder_calls_and_iterations(p2p_windows):
    _, wins = p2p_windows
    for w in wins:
        d, st = w["d"], w["stats"]
        assert d["fec.pdc_blocks"] >= sum(s["pdc_ok"] + s["pdc_err"] for s in st)
        # the PDC's early stop runs 2 to 8 iterations a call
        assert 2 * d["fec.pdc_blocks"] <= d["fec.pdc_iters"] \
            <= 8 * d["fec.pdc_blocks"]
    assert sum(w["d"]["fec.pdc_blocks"] for w in wins) > 0


def test_no_module_built_after_warm_up(p2p_windows):
    _, (w1, w2) = p2p_windows
    assert w2["d"]["runtime.module_builds"] == 0
    for w in (w1, w2):
        assert w["d"]["runtime.module_builds"] == w["misses"]


# ------------------------------------------------------------- timeline
def _profiled_run(timeline: bool, ticks: int, profiled: int):
    """A fresh p2p_simulator run of `ticks` ticks with the timeline on or
    off, its last `profiled` ticks under a CPU torch.profiler: (the
    program's ranges in the profile as (start, end, span), the spans'
    counters over the profiled ticks, the stats)."""
    from torch.profiler import ProfilerActivity, profile

    run = T.build_scenario(T.load_scenario(P2P), "cpu")
    trace.timeline(timeline)
    try:
        run.run_ticks(ticks - profiled)
        c0 = trace.counters()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run.run_ticks(profiled)
        d = _delta(c0, trace.counters())
    finally:
        trace.timeline(False)
    _, ranges = trace.device_intervals(prof.profiler.kineto_results.events())
    return ranges, d, _stats(run)


@pytest.fixture(scope="module")
def timeline_runs():
    # the PT hears its first beacon about tick 12: the profiled ticks hold
    # the PCC and PDC stages and their firmware calls
    return {on: _profiled_run(on, 16, 6) for on in (True, False)}


def test_timeline_ranges_nest_as_spans(timeline_runs):
    ranges, d, _ = timeline_runs[True]
    names = [r[2] for r in ranges]
    for s in trace.SPANS:
        assert names.count(s) == d[f"span.{s}.calls"], s
    assert {"runtime.pcc", "runtime.pdc", "firmware.pdc"} <= set(names)
    for r in ranges:
        holders = [q for q in ranges if q is not r and q[0] <= r[0]
                   and r[1] <= q[1]]
        inner = min(holders, key=lambda q: q[1] - q[0], default=None)
        assert (inner[2] if inner else None) == PARENT[r[2]], r


def test_timeline_off_leaves_no_ranges(timeline_runs):
    ranges, d, _ = timeline_runs[False]
    assert ranges == []
    assert d["span.scenario.tick.calls"] == 6       # the aggregates run on


def test_timeline_moves_no_decision(timeline_runs):
    on, off = timeline_runs[True][2], timeline_runs[False][2]
    assert on == off
    assert sum(s["pdc_ok"] for s in on[0]) > 0


# ------------------------------------------------------ scenario runner
def test_cli_prints_trace_line(capsys, tmp_path):
    from dectnrp_tpu_torch.apps.dectnrp_main import main

    out = tmp_path / "profile.json"
    rc = main([str(ROOT / "configurations" / "basic_simulator"), "--ticks", "4",
               "--device", "cpu", "--profile", str(out)])
    assert rc == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()
             if x.startswith("{")]
    gaps, tr = lines[0], lines[1]["trace"]
    assert gaps == {"idle_gaps": []}                 # no device on the CPU
    assert tr["ticks"] == 4
    assert tr["spans"]["scenario.tick"]["calls"] == 4
    assert tr["spans"]["sim.tick"]["self_ms_per_tick"] >= 0
    assert set(tr["counters"]) == set(trace.COUNTERS)
    assert lines[-1]["node"] == 0
    events = json.loads(out.read_text())["traceEvents"]
    ticks = [e for e in events if e.get("name") == "dectnrp.scenario.tick"]
    assert len(ticks) == 4            # fewer ticks than PROFILE_TICKS: all
