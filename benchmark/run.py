"""Run one cell of BENCHMARK.json on the card(s) of this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as its last line, one JSON object: correct, attempted, failed,
metrics, device (and with --trace 1 a breakdown), then the numbers the
check compared, each beside its limit. Exits non-zero, with no result,
without enough CUDA devices or when JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
# one process with few threads: the host work is launches and small
# arrays, and idle OpenMP workers spinning on the host's cores add jitter
os.environ.setdefault("OMP_NUM_THREADS", "1")

from benchmark.core.harness import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main(t_start=T_START))
