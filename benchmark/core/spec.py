"""A cell of BENCHMARK.json and the files it names, found by name.

configs/<config>.json  the configuration: its `loop` (a module of loops/)
                       and its sizes and limits
traffic/<traffic>.json the traffic mix: its `generator` and parameters
metrics/<metric>.py    a per-layer metric's reader: read(trace) -> number
                       or None
"""
from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]      # the checkout


@dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list[dict]        # the metrics this cell reports untraced
    per_layer: list[dict]         # ... and traced
    root: Path = ROOT             # the checkout that holds them


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json and the files it names."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r} (known: {sorted(cells)})")
    w = cells[name]
    cfg = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg["file"]).read_text())
    traffic = json.loads((root / "benchmark" / "traffic" / f"{w['traffic']}.json"
                          ).read_text())
    if traffic["loop"] != config["loop"]:
        raise SystemExit(f"traffic {w['traffic']!r} is for loop "
                         f"{traffic['loop']!r}, the config's is {config['loop']!r}")
    return Cell(name, w["config"], w["traffic"], int(w["chips"]), config,
                traffic, [m for m in spec["end_to_end"] if _applies(m, name)],
                [m for m in spec["per_layer"] if _applies(m, name)], root)


def loop_module(config: dict):
    """The loop that drives the port for this configuration."""
    return importlib.import_module(f"benchmark.loops.{config['loop']}")


def reader(metric: str, root: Path = ROOT):
    """benchmark/metrics/<metric>.py's read(trace)."""
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
