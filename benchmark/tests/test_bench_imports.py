"""What the benchmark imports: nothing whose top-level name is `jax`,
`jaxlib`, `flax` or the JAX package `dectnrp_tpu` (whole names: the port
`dectnrp_tpu_torch` is another name), checked in the sources and in a
process after a run; and the reference, the generators and the frozen PHY
import nothing of the port."""
import ast
import subprocess
import sys
import textwrap

from conftest import ROOT

BANNED = {"jax", "jaxlib", "flax", "dectnrp_tpu"}
YARDSTICK = ("reference", "gen", "phyref", "metrics")


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_sources_import_no_jax():
    files = list((ROOT / "benchmark").rglob("*.py"))
    assert len(files) > 30
    for f in files:
        found = set(_imports(f)) & BANNED
        assert not found, f"{f} imports {found}"
        if f.relative_to(ROOT / "benchmark").parts[0] in YARDSTICK:
            assert "dectnrp_tpu_torch" not in set(_imports(f)), f


def _run(code: str) -> str:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=ROOT, capture_output=True, text=True,
                          check=True, timeout=600).stdout


def test_yardstick_loads_nothing_of_the_port():
    out = _run("""
        import sys
        import benchmark.reference.scenario, benchmark.reference.ether
        import benchmark.gen.datagrams
        import benchmark.metrics.frozen
        print(sorted({m.split(".")[0] for m in sys.modules}
                     & {"dectnrp_tpu_torch", "dectnrp_tpu", "jax"}))
    """)
    assert out.strip().splitlines()[-1] == "[]"


def test_a_run_loads_no_jax():
    out = _run("""
        import json, sys, time, tempfile, pathlib, torch
        sys.path.insert(0, "benchmark/tests")
        torch.set_num_threads(4)
        from conftest import make_root
        from benchmark.core.spec import load_cell
        from benchmark.core.harness import run_cell, banned_modules
        root = make_root(pathlib.Path(tempfile.mkdtemp()))
        cell = load_cell("p2p_u1b1.beacon", root)
        r = run_cell(cell, 3, 0.1, False, "cpu", time.perf_counter())
        assert "dectnrp_tpu_torch" in sys.modules
        print(banned_modules())
    """)
    assert out.strip().splitlines()[-1] == "[]"
