"""Every cell through the harness on the CPU (the scenario at its own size
for a few seconds, each kind of call and tick sampled twice), a dummy
configuration, traffic mix and metric added as new files only, the faults
each cell can have, which the check must catch, and the control, which
must fail a limit."""
import json
import time

import pytest

from benchmark.core import harness
from benchmark.core.spec import load_cell, loop_module

P2P = ("p2p_u1b1.data", "p2p_u1b1.beacon")


def _few(cell):
    """Two calls of each kind, as a window of a few seconds holds."""
    cell.config["sample"] = 2


def _run(root, name, trace=False, seconds=2.5, fault=None, monkeypatch=None,
         cell_edit=_few):
    cell = load_cell(name, root)
    cell_edit(cell)
    if fault is not None:
        loop = loop_module(cell.config)
        setup = loop.setup

        def broken(*a, **kw):
            state = setup(*a, **kw)
            fault(state)
            return state
        monkeypatch.setattr(loop, "setup", broken)
    return harness.run_cell(cell, 2 ** 31 + 11, seconds, trace, "cpu",
                            time.perf_counter())


def _shape_ok(r, cell, trace):
    assert set(r) >= {"correct", "attempted", "failed", "metrics", "device"}
    assert list(r)[-1] == "checks"
    names = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    got = set(r["metrics"])
    if trace:        # no device on the CPU: no idle share to read
        assert got == names - {n for n in names if n.endswith("idle_pct")}
    else:
        assert got == names
    assert all(v["value"] > 0 for v in r["metrics"].values())


@pytest.mark.parametrize("name", P2P)
def test_scenario_cells_rehearse(root, name):
    # a data tick decodes more on the CPU: its window needs longer to send
    r = _run(root, name, seconds=5.0 if name.endswith("data") else 2.5)
    _shape_ok(r, load_cell(name, root), False)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    assert {"sync_calls_missing", "pdc_calls_missing", "vspace_ticks_missing",
            "vspace_gap", "vspace_bad_draws"} <= set(r["checks"])


def test_scenario_traced(root):
    def edit(c):
        _few(c)
        c.config.update(trace_units=3)
    r = _run(root, "p2p_u1b1.beacon", trace=True, cell_edit=edit)
    _shape_ok(r, load_cell("p2p_u1b1.beacon", root), True)


def test_new_cell_from_new_files_only(root):
    """A configuration, a traffic mix and a per-layer metric, each a new
    file, and a cell naming them in BENCHMARK.json: no other edit."""
    b = root / "benchmark"
    cfg = json.loads((b / "configs" / "p2p_u1b1.json").read_text())
    (b / "configs" / "dummy_cfg.json").write_text(json.dumps(dict(cfg, sample=2)))
    tr = json.loads((b / "traffic" / "data.json").read_text())
    (b / "traffic" / "dummy_mix.json").write_text(json.dumps(dict(tr, queue=1)))
    (b / "metrics" / "dummy.ticks.py").write_text(
        "def read(trace):\n    return float(trace.units)\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "dummy_cfg", "source": "https://example.org",
                            "file": "benchmark/configs/dummy_cfg.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy_cfg.dummy_mix", "config": "dummy_cfg",
                              "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "p2p_u1b1.beacon" in m.get("workloads", []):
            m["workloads"].append("dummy_cfg.dummy_mix")
    spec["per_layer"].append({"name": "dummy.ticks", "unit": "ticks",
                              "better": "higher", "source": "program_counter",
                              "layer": "upper.runtime and the firmware",
                              "moves": "node_realtime_x",
                              "workloads": ["dummy_cfg.dummy_mix"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    r = _run(root, "dummy_cfg.dummy_mix", trace=True,
             cell_edit=lambda c: c.config.update(trace_units=3))
    assert r["correct"] and r["metrics"]["dummy.ticks"]["value"] >= 1


# ------------------------------------------------------------------ faults

def _frozen_ether(state):
    """a tick that returns its state unchanged: the ether stands still."""
    state.sc.driver.tick = lambda *a, **kw: None


def _flip_pdc(state):
    """a decoded TB bit altered where the PDC stage produces it."""
    import torch

    def hook(module, args, out):
        if type(module).__qualname__ == "RxStream" and \
                module.rx.ps.psdef.mcs_index != 0:
            out["tb"][:, 200] ^= 1
    state.hooks.append(torch.nn.modules.module.register_module_forward_hook(hook))


def _sync_unseen(state):
    """every sync call made past Module.__call__ (as a replayed graph
    would be), so no hook sees one."""
    for rt in state.sc.runtimes:
        rt._sync = rt._sync.forward


def _no_noise(state):
    """the ether skips its AWGN draw and adds no noise."""
    state.sc.driver.vspace.cfg.noise_var = 0.0


def _no_path_gain(state):
    """the ether leaves out the path loss: every gain is 1."""
    vs = state.sc.driver.vspace
    vs._gain[:] = 1.0
    vs._update_gains = lambda: None


@pytest.mark.parametrize("fault", [_frozen_ether, _flip_pdc, _sync_unseen,
                                   _no_noise, _no_path_gain])
def test_scenario_faults_are_caught(root, monkeypatch, fault):
    r = _run(root, "p2p_u1b1.beacon", fault=fault, monkeypatch=monkeypatch)
    assert not r["correct"]


@pytest.mark.parametrize("fault,name", [(_no_noise, "vspace_bad_draws"),
                                        (_no_path_gain, "vspace_gap")])
def test_each_ether_fault_fails_its_own_number(root, monkeypatch, fault, name):
    """Skipping the noise is a bad draw; skipping the path loss a gap."""
    r = _run(root, "p2p_u1b1.beacon", fault=fault, monkeypatch=monkeypatch)
    c = r["checks"][name]
    assert c["value"] > c["limit"], (name, r["checks"])


# ----------------------------------------------------------------- control

def test_scenario_control_fails_a_limit(root):
    cell = load_cell("p2p_u1b1.data", root)
    cell.config["control_ticks"] = 30
    loop = loop_module(cell.config)
    readings = loop.control(loop.setup(cell, 5, "cpu"))
    limits = cell.config["limits"]
    assert any(readings[k] > lim for k, lim in limits.items() if k in readings)
    assert readings["vspace_gap"] > limits["vspace_gap"]
