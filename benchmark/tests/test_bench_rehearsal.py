"""Tiny rehearsals of each cell on the CPU, through the harness.

The harness's look for a card is skipped (``run_cell`` on the CPU); the
rest of a run is driven at tiny widths in float32, where the port's CPU
path computes what the reference computes:

- the program agrees with the reference;
- after the rehearsal no module whose top-level name is ``jax``, ``jaxlib``,
  ``flax`` or ``psg_tpu`` is loaded, and the reference imports nothing of
  ``psg_tpu_torch``;
- with the timed path broken underneath, ``correct`` comes out false: an
  answer altered where it is produced (serving); a step that returns its
  state unchanged, and half of the batch left out (training).
"""

from __future__ import annotations

import ast
import io
import json
import time

import pytest

from benchmark.harness import main
from benchmark.tests import faults, tiny
from benchmark.tests.conftest import ROOT

SERVE = dict(corpus_captions=40, check_requests=2, warmup_requests=1)
TRAIN = dict(sprites=40, overrides={"data": {"batch_size": 4, "num_workers": 2}})
CELLS = {"psg655.serve.recipe": SERVE, "sd15.train.b32": TRAIN,
         "psg655.train.s2-fast-b16": TRAIN}
TRAIN_CELLS = ["sd15.train.b32", "psg655.train.s2-fast-b16"]
SEED = 2 ** 33 + 17


def _runner(cell: str) -> str:
    return tiny.cell(ROOT, cell).traffic["runner"]


def rehearse(cell: str, seconds: float = 6.0, program: str = "port") -> dict:
    """One tiny run of ``cell`` on the CPU; its result line.  The window is
    long enough for a request to finish inside it on a loaded CPU."""
    out, err = io.StringIO(), io.StringIO()
    rc = main.run_cell(ROOT, tiny.cell(ROOT, cell, **CELLS[cell]), SEED, seconds, False,
                       "cpu", time.perf_counter(), program=program, out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert all(f"check {k}:" in err.getvalue() for k in line["checks"])
    return line


@pytest.fixture(scope="module")
def runs():
    return {cell: rehearse(cell) for cell in CELLS}


@pytest.mark.parametrize("cell", list(CELLS))
def test_program_matches_reference(runs, cell):
    line = runs[cell]
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    for name, c in line["checks"].items():
        # float32 on both sides: far inside every limit
        assert c["value"] <= 0.1 * c["limit"], (name, c)
    assert "setup_s" in line["metrics"]


@pytest.mark.parametrize("cell", list(CELLS))
def test_no_jax_after_rehearsal(runs, cell):
    assert runs[cell]["correct"] is True
    assert main.forbidden_modules() == []


def test_reference_imports_nothing_of_the_port():
    for path in sorted((ROOT / "benchmark" / "reference").glob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for n in names:
                assert n.split(".")[0] not in ("psg_tpu_torch", "psg_tpu", "jax", "jaxlib",
                                               "flax"), (path.name, n)


def test_served_answer_altered():
    with faults.altered_answer():
        line = rehearse("psg655.serve.recipe")
    assert line["correct"] is False
    assert line["checks"]["image_mae"]["value"] > line["checks"]["image_mae"]["limit"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_step_returns_state_unchanged(cell):
    with faults.unchanged_state(_runner(cell)):
        line = rehearse(cell)
    assert line["correct"] is False
    assert line["checks"]["change_leaf_gap"]["value"] >= 0.99


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_half_batch_left_out(cell):
    with faults.half_batch(_runner(cell)):
        line = rehearse(cell)
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_loader_batch_altered():
    """The classic loader's images, augmented from another seed, are found."""
    with faults.altered_batch():
        line = rehearse("sd15.train.b32")
    assert line["correct"] is False
    gap = line["checks"]["loader_image_gap"]
    assert gap["value"] > 10 * gap["limit"]


def test_traced_rehearsal(capsys):
    """A ``--trace 1`` run on the CPU: the measured window, then the traced
    one; the per-layer metrics read from host clocks are reported, those
    read from the device's trace are left out."""
    out, err = io.StringIO(), io.StringIO()
    cell = "psg655.serve.recipe"
    rc = main.run_cell(ROOT, tiny.cell(ROOT, cell, **CELLS[cell]), SEED, 6.0, True,
                       "cpu", time.perf_counter(), out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True
    assert set(line["metrics"]) == {"sampler_ms_per_eval.serve", "mfu.serve",
                                    "request_p50_s.serve", "sprites_per_s.serve"}
    said = capsys.readouterr().err
    assert "traced window:" in said and "host: main thread CPU" in said


def test_control_fails_at_tiny_size():
    """The control (the reference with fp8 operands in the program's place)
    fails the comparison here too; on the card it is read at the cells' own
    sizes (``test_bench_control.py``)."""
    for cell in CELLS:
        line = rehearse(cell, program="control")
        assert line["correct"] is False
        assert all(c["value"] < float("inf") for c in line["checks"].values())
