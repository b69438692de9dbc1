"""The benchmark of the PyTorch + CUDA port `dectnrp_tpu_torch`.

`run.py` runs one cell of `BENCHMARK.json`. Everything a cell needs is
found by name: its configuration in `configs/<config>.json` (which names
the loop in `loops/` that drives the port), its traffic in
`traffic/<traffic>.json` (parameters that one generator in `gen/` reads),
and each per-layer metric's reader in `metrics/<metric>.py`. The
references in `reference/` use `phyref/`, a frozen plain copy of the
port's PHY, so a change to the program does not change them.
"""
