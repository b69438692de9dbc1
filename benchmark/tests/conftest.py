"""CPU tests of the benchmark: run from the checkout's root with
`python -m pytest benchmark/tests -q`. The cells' rehearsals run the port's
plain twins on the CPU, a second or two of a window; nothing here needs a
card."""
import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def make_root(tmp: Path) -> Path:
    """A checkout-shaped directory: BENCHMARK.json, with a cell of the data
    mix added, and benchmark/ whose configs, traffic and metrics are
    directories of links to the real files (so a test can add files to
    them), the rest links to the real directories."""
    bench = ROOT / "benchmark"
    (tmp / "benchmark").mkdir()
    for sub in bench.iterdir():
        if sub.name in ("configs", "traffic", "metrics"):
            (tmp / "benchmark" / sub.name).mkdir()
            for f in sub.iterdir():
                os.symlink(f, tmp / "benchmark" / sub.name / f.name)
        else:
            os.symlink(sub, tmp / "benchmark" / sub.name)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    # the data mix has no cell (PERF.md §7): the tests still drive it
    if not any(w["name"] == "p2p_u1b1.data" for w in spec["workloads"]):
        spec["workloads"].append({"name": "p2p_u1b1.data", "config": "p2p_u1b1",
                                  "traffic": "data", "chips": 1, "why": "tests"})
        for m in spec["end_to_end"] + spec["per_layer"]:
            if "p2p_u1b1.beacon" in m.get("workloads", []):
                m["workloads"].append("p2p_u1b1.data")
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp


@pytest.fixture
def root(tmp_path):
    return make_root(tmp_path)


@pytest.fixture(autouse=True)
def few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    yield
    torch.set_num_threads(n)
