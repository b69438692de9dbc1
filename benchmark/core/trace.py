"""What a traced run reads: host spans around calls into the port's layers,
the port's kernel launch counters, and a torch.profiler trace.

Spans come from the benchmark's own hooks, not from the program: global
`torch.nn` forward pre- and post-hooks on the port's module classes (named
by module path and class), and wrappers of public methods (the scenario's
`driver.tick`). In a traced run every span is closed by
`torch.cuda.synchronize`, so it holds the device work of its calls; each
span is also a `record_function` range, so the profiler attributes the
kernels launched inside it.
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from ..metrics.frozen import busy_union


@dataclass
class Trace:
    """What the per-layer readers read."""
    units: int                                  # steps or ticks traced
    unit_ms: list = field(default_factory=list)      # host ms of each
    spans_ms: dict = field(default_factory=dict)     # span -> total ms
    counts: dict = field(default_factory=dict)       # counter -> delta
    profile: dict = field(default_factory=dict)      # see profile_window
    shape: dict = field(default_factory=dict)        # the cell's sizes


class Spans:
    """Host spans by name around the calls of the given module classes
    ({"package.module.Class": span name}) and wrapped callables."""

    def __init__(self, classes: dict[str, str], sync: bool):
        self.classes, self.sync = classes, sync
        self.total_ms: dict[str, float] = defaultdict(float)
        self._open: list = []
        self._handles = []

    def _name(self, module) -> str | None:
        t = type(module)
        return self.classes.get(f"{t.__module__}.{t.__qualname__}")

    def _enter(self, name):
        if self.sync:
            torch.cuda.synchronize()
        rf = torch.profiler.record_function(f"bench.{name}")
        rf.__enter__()
        self._open.append((name, rf, time.perf_counter()))

    def _exit(self):
        name, rf, t0 = self._open.pop()
        if self.sync:
            torch.cuda.synchronize()
        self.total_ms[name] += (time.perf_counter() - t0) * 1e3
        rf.__exit__(None, None, None)

    def attach(self) -> "Spans":
        def pre(module, args):
            name = self._name(module)
            if name is not None:
                self._enter(name)

        def post(module, args, out):
            if self._name(module) is not None:
                self._exit()

        reg = torch.nn.modules.module
        self._handles = [reg.register_module_forward_pre_hook(pre),
                         reg.register_module_forward_hook(post)]
        return self

    def wrap(self, fn, name: str):
        """fn with a span `name` around each call."""
        def wrapped(*a, **kw):
            self._enter(name)
            try:
                return fn(*a, **kw)
            finally:
                self._exit()
        return wrapped

    def detach(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


@contextmanager
def profiled(out: dict):
    """torch.profiler (host and device activity) over the block; on exit
    `out` holds the traced window's reduction (`reduce_profile`)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    out.update(reduce_profile(prof, window_s))


def _is_device(e) -> bool:
    """A device operation (kineto also puts each record_function range on
    the device timeline as an annotation; those are not operations)."""
    return e.device_type() == torch.autograd.DeviceType.CUDA \
        and not e.name().startswith("bench.")


def reduce_profile(prof, window_s: float) -> dict:
    """busy_s (the union of device activity), window_s, the device seconds
    of the operations launched inside each bench.* span (a device
    operation's launch is the host runtime call of the same correlation
    id; without one, the operation counts where it ran inside a span's host
    interval), the ten device operations that took most time, and the ten
    longest device-idle gaps named by the innermost bench.* span (else the
    host operation) that the host was in at the gap's middle."""
    ev = prof.profiler.kineto_results.events()
    dev = [e for e in ev if _is_device(e)]
    host = [e for e in ev if e.device_type() != torch.autograd.DeviceType.CUDA]
    busy_ns = busy_union((e.start_ns(), e.start_ns() + e.duration_ns())
                         for e in dev)
    by_name: dict[str, float] = defaultdict(float)
    for e in dev:
        by_name[e.name()] += e.duration_ns() / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    span_dev: dict[str, float] = defaultdict(float)
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()[6:])
                    for e in host if e.name().startswith("bench."))
    starts = [r[0] for r in ranges]
    launched = {e.correlation_id(): e.start_ns() for e in host
                if e.name().startswith("cu") and e.correlation_id()}
    for e in dev:
        t0 = launched.get(e.correlation_id(), e.start_ns())
        t1 = t0 if e.correlation_id() in launched else t0 + e.duration_ns()
        i = bisect.bisect_right(starts, t0) - 1    # spans do not overlap
        if i >= 0 and t1 <= ranges[i][1]:
            span_dev[ranges[i][2]] += e.duration_ns() / 1e9
    return {"busy_s": busy_ns / 1e9, "window_s": window_s,
            "n_device_events": len(dev), "span_device_s": dict(span_dev),
            "device_ops": [[n, s] for n, s in ops],
            "idle_gaps": _idle_gaps(dev, host)}


def _idle_gaps(dev, host, n: int = 10) -> list:
    iv = sorted((e.start_ns(), e.start_ns() + e.duration_ns()) for e in dev)
    gaps, end = [], None
    for s0, s1 in iv:
        if end is not None and s0 > end:
            gaps.append((s0 - end, end, s0))
        end = s1 if end is None else max(end, s1)
    gaps.sort(reverse=True)
    named = []
    for length, a, b in gaps[:n]:
        mid = (a + b) // 2
        inside = [e for e in host
                  if e.start_ns() <= mid < e.start_ns() + e.duration_ns()]
        spans = [e for e in inside if e.name().startswith("bench.")]
        pick = min(spans or inside, key=lambda e: e.duration_ns(), default=None)
        named.append([pick.name() if pick is not None else "host",
                      length / 1e9])
    return named
