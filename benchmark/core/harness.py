"""One run of one cell: set-up, the measured window, the traced window,
the check against the reference, and the result line.

Untraced (`--trace 0`), the result's metrics are the cell's end-to-end
metrics, taken over the whole window. Traced (`--trace 1`), the window runs
with the host spans on (each closed by a device synchronisation) and the
launch counters read around it, then a short window of `trace_units`
steps or ticks runs under torch.profiler with the spans open but not
synchronised (so the device's idle share is the loop's own); the
per-layer readers of metrics/ read both. In both, once the window has closed and the memory
peak is read, the program's state goes and the reference decides
`correct`.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

from .spec import load_cell, loop_module, reader
from .trace import Spans, Trace, profiled

BANNED = {"jax", "jaxlib", "flax", "dectnrp_tpu"}


def banned_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def _launch_counts() -> dict:
    from dectnrp_tpu_torch.kernels import launch_counts
    return launch_counts()


def _power_limit() -> str | None:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20).stdout.splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return None


def _device(chips: int, device) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(),
            "count": chips, "memory_peak_bytes": torch.cuda.max_memory_allocated(),
            "power_limit": _power_limit()}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """The result of one run (the dict the last stdout line prints)."""
    loop = loop_module(cell.config)
    state = loop.setup(cell, seed, device)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    result = {"metrics": {}}
    if not trace:
        win = loop.window(state, seconds=seconds)
        values = loop.end_to_end(state, win)
        values["setup_s"] = setup_s
        for m in cell.end_to_end:
            result["metrics"][m["name"]] = {"value": values[m["name"]],
                                            "unit": m["unit"]}
        dev = _device(cell.chips, device)
    else:
        spans = Spans(loop.SPANS, sync=on_card).attach()
        loop.attach(state, spans)
        c0 = _launch_counts()
        win = loop.window(state, seconds=seconds)
        c1 = _launch_counts()
        tr = Trace(units=len(win["unit_ms"]), unit_ms=win["unit_ms"],
                   spans_ms=dict(spans.total_ms),
                   counts={k: c1[k] - c0[k] for k in c0},
                   shape=loop.shape(state))
        spans.sync = False            # the profiled window runs as untraced
        with profiled(tr.profile):
            loop.window(state, units=int(cell.config["trace_units"]))
        tr.profile["units"] = int(cell.config["trace_units"])
        spans.detach()
        for m in cell.per_layer:
            v = reader(m["name"], cell.root)(tr)
            if v is not None:
                result["metrics"][m["name"]] = {"value": v, "unit": m["unit"]}
        dev = _device(cell.chips, device)
        dev["busy_s"] = tr.profile["busy_s"]
        dev["window_s"] = tr.profile["window_s"]
        result["breakdown"] = {"device_ops": tr.profile["device_ops"],
                               "idle_gaps": tr.profile["idle_gaps"]}
    t_check = time.perf_counter()
    checks, attempted, failed = loop.check(state)
    result.update(correct=all(v <= lim for _, v, lim in checks),
                  attempted=attempted, failed=failed, device=dev,
                  setup_s=setup_s, check_s=time.perf_counter() - t_check,
                  readings=state.readings)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result


def main(argv: list[str] | None = None, t_start: float | None = None) -> int:
    import argparse

    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="one run of a benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    cell = load_cell(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {a.workload} needs {cell.chips} CUDA device(s), "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(cell, a.seed, a.seconds, bool(a.trace), "cuda", t_start)
    found = banned_modules()
    if found:
        print(f"benchmark: the run loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
