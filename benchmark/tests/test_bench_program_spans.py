"""The per-layer metrics read from the program's own spans and counters
(common/trace.py of the port, handed to the readers by `launch_counts`):
a traced run of the beacon cell on the CPU reports each as a number, and
they agree with the hook-based spans that hold them."""
import time

from benchmark.core import harness
from benchmark.core.spec import load_cell

NEW = ("node.ether_host_ms", "node.firmware_ms", "node.runtime_self_ms",
       "node.d2h_per_tick", "node.pdc_turbo_iters")


def test_program_span_metrics(root):
    cell = load_cell("p2p_u1b1.beacon", root)
    cell.config.update(sample=2, trace_units=3)
    # long enough for a beacon's PCC and PDC stages in the window
    r = harness.run_cell(cell, 2 ** 31 + 23, 6.0, True, "cpu",
                         time.perf_counter())
    m = {k: v["value"] for k, v in r["metrics"].items()}
    for name in NEW:
        assert isinstance(m.get(name), float), (name, m)
        assert m[name] > 0, (name, m)
    assert m["node.firmware_ms"] + m["node.runtime_self_ms"] \
        <= m["node.host_ms"] * 1.05
    assert m["node.ether_host_ms"] <= m["node.vspace_ms"]
    assert 2.0 <= m["node.pdc_turbo_iters"] <= 8.0
