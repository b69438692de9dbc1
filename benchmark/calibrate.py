"""Readings that set a cell's limits: the program's checks over many seeds,
and the control's, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        --seconds 3 [--control-seeds 1 2 3] [--out chiprun_out/x.jsonl]

For each seed: the cell's set-up, a short window at the cell's own load,
and the check (as a run makes them), printed as one JSON line of every
number compared. For each control seed: the set-up, then the loop's
control (the reference put in the program's place in the next lower
precision) read by the same comparison. The limits in the cell's
configuration are set between the two (PERF.md gives the readings).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from benchmark.core.spec import load_cell, loop_module  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    cell = load_cell(a.workload)
    cell.config["limits"] = {k: float("inf") for k in cell.config["limits"]}
    loop = loop_module(cell.config)
    lines = []
    for kind, seeds in (("program", a.seeds), ("control", a.control_seeds)):
        for seed in seeds:
            t0 = time.perf_counter()
            state = loop.setup(cell, seed, "cuda")
            if kind == "program":
                loop.window(state, seconds=a.seconds)
                _, att, failed = loop.check(state)
                rec = dict(state.readings, attempted=att, failed=failed)
            else:
                rec = loop.control(state)
            rec.update(kind=kind, seed=seed, s=time.perf_counter() - t0)
            print(json.dumps(rec), flush=True)
            lines.append(rec)
            del state
            torch.cuda.empty_cache()
    if a.out:
        with open(a.out, "a") as f:
            for r in lines:
                f.write(json.dumps(dict(r, workload=a.workload)) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
