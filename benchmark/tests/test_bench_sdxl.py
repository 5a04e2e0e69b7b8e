"""A tiny rehearsal of ``sdxl.train.full-b32`` on the CPU, through the harness.

The cell's files at a cut of their own (``tiny.py`` cuts ``sd_unet`` to
SD-1.5's four levels): the tiny model and data of ``tiny.py`` and a tiny
SDXL-shaped UNet (3 levels, no attention at level 0, depths 1/2/3, head
width 8, linear projections, ``text_time``), the reference computing its
gradients two rows at a time.  In float32 on both sides:

- the program agrees with the reference, and no JAX is loaded after it;
- a step that returns its state unchanged, and half of the batch left out,
  come out not correct;
- a program that builds another UNet (the SD-1.5 spec) stops in the
  runner's first lines, before anything is built;
- a traced run reports the per-layer metrics read from host clocks and
  leaves out those read from the device's trace.
"""

from __future__ import annotations

import copy
import io
import json
import time

import pytest

from benchmark.harness import main, spec
from benchmark.tests import faults, tiny
from benchmark.tests.conftest import ROOT

CELL = "sdxl.train.full-b32"
SEED = 2 ** 33 + 23
TRAIN = dict(sprites=40, overrides={"data": {"batch_size": 4, "num_workers": 2}},
             reference_micro_batch=2)
TINY_UNET = {"block_out_channels": [16, 24, 32], "attention_head_dim": [2, 3, 4],
             "transformer_layers_per_block": [1, 2, 3], "norm_num_groups": 8,
             "cross_attention_dim": 32, "addition_time_embed_dim": 8,
             "projection_class_embeddings_input_dim": 16 + 6 * 8}


def tiny_cell():
    c = spec.resolve(ROOT, CELL)
    c.config = copy.deepcopy(c.config)
    raw = c.config["config"]
    raw["model"].update(tiny.TINY_MODEL, cross_attention_dim=32)
    raw["data"].update(tiny.TINY_DATA)
    raw["sd_unet"].update(TINY_UNET)
    c.traffic = dict(copy.deepcopy(c.traffic), **TRAIN)
    return c


def rehearse(trace: bool = False, program: str = "port") -> dict:
    out, err = io.StringIO(), io.StringIO()
    rc = main.run_cell(ROOT, tiny_cell(), SEED, 6.0, trace, "cpu", time.perf_counter(),
                       program=program, out=out, err=err)
    assert rc == 0, err.getvalue()[-2000:]
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    return line


def test_program_matches_reference():
    line = rehearse()
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["checks"]) == {"grad_leaf_gap", "change_leaf_gap", "loader_rows",
                                   "loader_image_gap"}
    for name, c in line["checks"].items():
        # float32 on both sides: far inside every limit
        assert c["value"] <= 0.1 * c["limit"], (name, c)
    assert {"setup_s", "train_samples_per_s"} <= set(line["metrics"])
    assert main.forbidden_modules() == []


def test_step_returns_state_unchanged():
    with faults.unchanged_state("train_sd"):
        line = rehearse()
    assert line["correct"] is False
    assert line["checks"]["change_leaf_gap"]["value"] >= 0.99


def test_half_batch_left_out():
    with faults.half_batch("train_sd"):
        line = rehearse()
    assert line["correct"] is False
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


def test_another_unet_stops_before_building(monkeypatch):
    """The SD-1.5 spec in the program's place (as a program without the SDXL
    layout builds it): the runner raises before the corpus or any weight."""
    from psg_tpu_torch.models.sd_unet import SDUNetSpec
    from psg_tpu_torch.train import stage2_sd

    monkeypatch.setattr(stage2_sd, "sd_spec_from_config", lambda cfg: SDUNetSpec.sd15()._replace(
        cross_attention_dim=cfg.model.cross_attention_dim))
    t0 = time.perf_counter()
    with pytest.raises(ValueError, match="is not the configuration's"):
        main.run_cell(ROOT, tiny_cell(), SEED, 6.0, False, "cpu", time.perf_counter(),
                      out=io.StringIO(), err=io.StringIO())
    assert time.perf_counter() - t0 < 5.0


def test_traced_rehearsal():
    from psg_tpu_torch.utils.profiling import HOST_READS, reset_counts

    reset_counts(HOST_READS)      # the reader counts from process start, as one run does
    line = rehearse(trace=True)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"mfu.train", "host_reads_per_step.train"}
    assert 0.0 < line["metrics"]["mfu.train"]["value"]
    # the optimizer's one read of its statistics a step
    assert line["metrics"]["host_reads_per_step.train"]["value"] == 1.0


def test_control_fails_at_tiny_size():
    line = rehearse(program="control")
    assert line["correct"] is False
    assert all(c["value"] < float("inf") for c in line["checks"].values())
