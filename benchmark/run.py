"""Run one benchmark cell once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything about the cell (its configuration, traffic and metrics) is read
from ``BENCHMARK.json`` at the root of the checkout and the files it names.
"""

import os
import sys
import time

T_START = time.perf_counter()

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# build and kernel caches at fixed paths inside the checkout: only a cell's
# first run in a checkout builds; later runs load what it built
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")

if __name__ == "__main__":
    from benchmark.harness.main import keep_out_jax, main

    keep_out_jax()
    sys.exit(main(sys.argv[1:], ROOT, T_START))
