"""The control of each cell on the card, at the cell's own size.

The control is the reference in the program's place with its matmul and
convolution operands in fp8 (e4m3, one scale a tensor): the precision below
the configurations' bfloat16.  Each cell's comparison has to find it not
correct on every seed.  Each seed's readings are printed (``-s`` shows
them).

    python -m pytest -p no:cacheprovider benchmark/tests/test_bench_control.py

runs on a machine with a CUDA card (marker ``cuda``); elsewhere it skips.
"""

from __future__ import annotations

import io
import json
import time

import pytest

from benchmark.harness import main, spec
from benchmark.tests.conftest import ROOT

SEEDS = (2 ** 31 + 11, 2 ** 32 + 12, 2 ** 33 + 13)
# long enough for the serving control (about 1.3 s a request) to finish as
# many requests as a run compares; the training controls need no window
WINDOW_S = 12.0
CELLS = [w["name"] for w in spec.load(ROOT)["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is read at the cells' own sizes")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(card, cell):
    c = spec.resolve(ROOT, cell)
    for seed in SEEDS:
        out = io.StringIO()
        rc = main.run_cell(ROOT, c, seed, WINDOW_S, False, "cuda", time.perf_counter(),
                           program="control", out=out, err=io.StringIO())
        assert rc == 0
        line = json.loads(out.getvalue().strip().splitlines()[-1])
        print(json.dumps({"workload": cell, "seed": seed, "checks": line["checks"]}))
        assert line["correct"] is False, (cell, seed, line["checks"])
