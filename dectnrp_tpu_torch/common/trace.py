"""The program's tracer: host spans and counters at the sites of the work,
and an optional profiler timeline of the spans.

- **Spans.** `span(name, key=None)` is a context over one piece of work
  whose name is in `SPANS`. Spans nest on one stack (the runtime is one
  thread), so each knows its parent. On exit a span adds its call, its
  time (`time.perf_counter_ns`) and its self time (its time less its
  child spans' time) under `span.<name>.calls`, `.ns` and `.self_ns`.
- **Counters.** `count(name, n=1)` adds to a counter of `COUNTERS`;
  `h2d(nbytes)` / `d2h(nbytes)` count one copy to / from the device and
  its bytes. A read of a device value waits for the device, so `xfer.d2h`
  counts the program's waits on it.
- **The timeline.** Off by default. While `timeline(True)` holds, each span
  also opens `torch.profiler.record_function("dectnrp.<name>", key)`, so
  the spans land in a profiler's trace on its clock beside the device's
  activity; `key` (the detection's `t_global` on the spans of one packet)
  ties the spans of one packet together. kineto also puts each such range
  on the device timeline as an annotation: `device_intervals` leaves them
  out, and `idle_gaps` names the device's idle gaps by the innermost span
  the host was in.

Every name is registered at zero from import on, and `counters()` returns
a snapshot of all of them; `kernels.launch_counts()` returns it beside the
kernels' launch counters. The aggregates are always on: a span costs two
clock reads and a few dict adds on the host.
"""
from __future__ import annotations

import bisect
from time import perf_counter_ns

SPANS = (
    "scenario.tick",
    "sim.tick", "sim.assemble", "sim.ether", "sim.deliver",
    "runtime.process", "runtime.pump", "runtime.sync", "runtime.pcc",
    "runtime.pdc", "runtime.mimo", "runtime.tx", "runtime.tx_resample",
    "firmware.start", "firmware.regular", "firmware.irregular",
    "firmware.pcc", "firmware.pcc_error", "firmware.pdc",
    "firmware.pdc_error", "firmware.application",
)
COUNTERS = (
    "xfer.h2d", "xfer.h2d_bytes", "xfer.d2h", "xfer.d2h_bytes",
    "fec.pdc_blocks", "fec.pdc_iters", "runtime.module_builds",
    "sim.rx_ring_bytes",
    "runtime.pump_steps", "runtime.pump_skipped_steps",
    "runtime.dbuf_slide_bytes", "runtime.dbuf_ring_bytes",
)
#: the prefix of the program's ranges in a profiler trace
PREFIX = "dectnrp."

_KEYS = {s: (f"span.{s}.calls", f"span.{s}.ns", f"span.{s}.self_ns")
         for s in SPANS}
_values: dict[str, int] = dict.fromkeys(
    [*COUNTERS, *(k for ks in _KEYS.values() for k in ks)], 0)
_stack: list["_Span"] = []
_timeline = False


class _Span:
    __slots__ = ("keys", "name", "key", "t0", "child_ns", "rf")

    def __init__(self, name: str, key):
        self.keys = _KEYS[name]          # KeyError: not in the table
        self.name, self.key, self.child_ns, self.rf = name, key, 0, None

    def __enter__(self):
        if _timeline:
            import torch
            self.rf = torch.profiler.record_function(
                PREFIX + self.name, None if self.key is None else str(self.key))
            self.rf.__enter__()
        _stack.append(self)
        self.t0 = perf_counter_ns()
        return self

    def __exit__(self, *exc):
        dt = perf_counter_ns() - self.t0
        _stack.pop()
        calls, ns, self_ns = self.keys
        _values[calls] += 1
        _values[ns] += dt
        _values[self_ns] += dt - self.child_ns
        if _stack:
            _stack[-1].child_ns += dt
        if self.rf is not None:
            self.rf.__exit__(*exc)
        return False


def span(name: str, key=None) -> _Span:
    """A span of `name` (one of SPANS) around a `with` block; `key` names
    the packet on the timeline."""
    return _Span(name, key)


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (one of COUNTERS)."""
    _values[name] += n


def h2d(nbytes: int) -> None:
    """One copy of nbytes from the host to the device."""
    _values["xfer.h2d"] += 1
    _values["xfer.h2d_bytes"] += nbytes


def d2h(nbytes: int) -> None:
    """One read of nbytes of a device value by the host (a wait)."""
    _values["xfer.d2h"] += 1
    _values["xfer.d2h_bytes"] += nbytes


def counters() -> dict[str, int]:
    """A snapshot of every counter and span aggregate."""
    return dict(_values)


def timeline(on: bool) -> None:
    """Open a profiler range with every span while on (spans open at the
    switch keep their state)."""
    global _timeline
    _timeline = bool(on)


def span_table(c0: dict, c1: dict, ticks: int) -> dict:
    """Each span's calls, ms a tick and self ms a tick between the
    snapshots c0 and c1 of `ticks` ticks."""
    per = 1e-6 / max(1, ticks)
    return {s: {"calls": c1[c] - c0[c], "ms_per_tick": (c1[n] - c0[n]) * per,
                "self_ms_per_tick": (c1[sn] - c0[sn]) * per}
            for s, (c, n, sn) in _KEYS.items()}


def device_intervals(events) -> tuple[list, list]:
    """From a profiler's kineto events: the device operations as (start,
    end) ns, and the program's host ranges as (start, end, span name).
    The program's ranges that kineto mirrors on the device timeline are
    annotations, not operations."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, ranges = [], []
    for e in events:
        name = e.name()
        t0 = e.start_ns()
        if e.device_type() == cuda:
            if not name.startswith(PREFIX):
                dev.append((t0, t0 + e.duration_ns()))
        elif name.startswith(PREFIX):
            ranges.append((t0, t0 + e.duration_ns(), name[len(PREFIX):]))
    return dev, ranges


def idle_gaps(dev: list, ranges: list, n: int = 10) -> list:
    """The n longest gaps between device operations (start, end) ns, each
    as (name, length ns, start, end): the innermost (shortest) of `ranges`
    (start, end, name) that holds the gap's middle, else "host"."""
    gaps, end = [], None
    for s0, s1 in sorted(dev):
        if end is not None and s0 > end:
            gaps.append((s0 - end, end, s0))
        end = s1 if end is None else max(end, s1)
    gaps.sort(reverse=True)
    rs = sorted(ranges)
    starts = [r[0] for r in rs]
    out = []
    for length, a, b in gaps[:n]:
        mid = (a + b) // 2
        inside = [r for r in rs[:bisect.bisect_right(starts, mid)]
                  if mid < r[1]]
        pick = min(inside, key=lambda r: r[1] - r[0], default=None)
        out.append((pick[2] if pick else "host", length, a, b))
    return out
