"""The benchmark's files and its yardstick, on the CPU.

- every cell of ``BENCHMARK.json`` resolves to its configuration, traffic and
  metric files, and every name and unit keeps to the allowed characters;
- the kernel counters agree with ``FlopCounterMode`` and with hand counts;
- the model FLOP counter agrees with a hand count;
- the trace reduction's interval arithmetic on a made-up trace.
"""

from __future__ import annotations

import json
import re

import pytest
import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counters import attention, gn_silu, model
from benchmark.harness import peaks, spec, trace
from benchmark.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    c = spec.resolve(ROOT, cell)
    assert (ROOT / "benchmark" / "runners" / f"{c.traffic['runner']}.py").exists()
    assert c.end_to_end and c.per_layer
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2
    for m in c.end_to_end + c.per_layer:
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").exists(), m["name"]


@pytest.mark.parametrize("metric", METRICS, ids=[m["name"] for m in METRICS])
def test_metric_entry(metric):
    assert spec.NAME.match(metric["name"])
    assert spec.UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        e2e = {m["name"] for m in BENCH["end_to_end"]}
        assert metric["moves"] in e2e
        assert metric["layer"] and "\n" not in metric["layer"]
    for w in metric.get("workloads", ()):
        assert w in CELLS


@pytest.mark.parametrize("conf", BENCH["configs"], ids=[c["name"] for c in BENCH["configs"]])
def test_config_file(conf):
    assert spec.NAME.match(conf["name"])
    assert conf["file"].startswith("benchmark/configs/")
    raw = json.loads((ROOT / conf["file"]).read_text())
    assert raw["name"] == conf["name"] and raw["reduced"] == conf["reduced"]
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


def test_workload_names():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs) == len(set(CELLS))
    for w in BENCH["workloads"]:
        assert spec.NAME.match(w["name"]) and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200


ATTN_SHAPES = [(2, 4, 27 * 27, 27 * 27, 40), (2, 4, 49, 128, 160), (1, 2, 16, 7, 8)]


@pytest.mark.parametrize("shape", ATTN_SHAPES)
def test_attention_ops_match_flop_counter(shape):
    b, h, lq, lk, d = shape
    q = torch.randn(b, h, lq, d, requires_grad=True)
    k = torch.randn(b, h, lk, d, requires_grad=True)
    v = torch.randn(b, h, lk, d, requires_grad=True)
    with FlopCounterMode(display=False) as fwd:
        s = torch.matmul(q, k.transpose(-1, -2))
        o = torch.matmul(torch.softmax(s, -1), v)
    ops, nbytes = attention.forward(b, h, lq, lk, d, "bfloat16", bias=False)
    assert ops == fwd.get_total_flops() == 4 * b * h * lq * lk * d
    assert nbytes == 2 * (2 * b * h * lq * d + 2 * b * h * lk * d)
    with FlopCounterMode(display=False) as bwd:
        torch.autograd.grad(o.sum(), [q, k, v])
    ops_b, nbytes_b = attention.backward(b, h, lq, lk, d, "float32", bias=True)
    assert ops_b == bwd.get_total_flops() == 8 * b * h * lq * lk * d
    assert nbytes_b == (4 * (3 * b * h * lq * d + 2 * b * h * lk * d) + 4 * b * h * lq
                        + 4 * b * lk + 4 * (b * h * lq * d + 2 * b * h * lk * d))


def test_gn_silu_bytes():
    assert gn_silu.forward(1000, 10, "bfloat16") == (10000.0, 2 * 2 * 1000 + 80)
    assert gn_silu.backward(1000, 10, "float32") == (20000.0, 4 * 3 * 1000 + 160)
    # bound by bytes at every width
    ops, nbytes = gn_silu.forward(32 * 27 * 27 * 960, 960, "bfloat16")
    assert nbytes / peaks.HBM_BYTES_PER_S > ops / peaks.FLOPS["bfloat16"]


def test_model_flops_hand_count():
    x = torch.empty(4, 16, device="meta")
    w = torch.empty(16, 32, device="meta", requires_grad=True)
    img = torch.empty(2, 3, 10, 10, device="meta")
    cw = torch.empty(8, 3, 3, 3, device="meta")

    def fwd():
        torch.matmul(x, w)
        F.conv2d(img, cw, padding=1)

    assert model.flops(fwd) == 2 * 4 * 16 * 32 + 2 * 2 * 8 * 10 * 10 * 3 * 9

    def step():
        torch.autograd.grad(torch.matmul(x, w).sum(), [w])

    # forward plus the weight gradient; no input gradient (x takes none)
    assert model.flops(step) == 2 * (2 * 4 * 16 * 32)


def test_least_seconds():
    assert peaks.least_seconds(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert peaks.least_seconds(0, 3.35e12, "float32") == pytest.approx(1.0)


def _ev(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def test_trace_reduction():
    events = [
        _ev("user_annotation", trace.WINDOW, 0, 1000),
        _ev("user_annotation", "bench.unet", 100, 300),
        _ev("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=1),
        _ev("cuda_runtime", "cudaLaunchKernel", 500, 5, corr=2),
        _ev("user_annotation", "bench.gn.bwd", 700, 100, tid=3),
        _ev("cuda_runtime", "cudaLaunchKernel", 390, 5, tid=3, corr=4),   # another thread
        _ev("kernel", "k4", 360, 10, tid=7, corr=4),
        _ev("kernel", "k1", 200, 100, tid=7, corr=1),
        _ev("kernel", "k2", 250, 100, tid=7, corr=2),
        _ev("kernel", "k3", 900, 200, tid=7),
        _ev("cpu_op", "aten::mm", 600, 50),
    ]
    r = trace.Reduced(events)
    assert r.window_s == pytest.approx(1e-3)
    # busy: [200, 350], [360, 370] and [900, 1000] (clipped to the window)
    assert r.busy_s == pytest.approx(260e-6)
    # k1 (launched at 110) and k4 (launched at 390 by another thread) fall
    # in the range; k2 (launched at 500) does not
    assert r.device_s_in("bench.unet") == pytest.approx(110e-6)
    assert r.device_s_in("bench.gn.bwd") == 0.0
    assert r.top_device_ops(2)[0] == ["k1", pytest.approx(100e-6)]
    gaps = dict(r.idle_gaps())
    assert gaps["bench.unet"] == pytest.approx(210e-6)   # [0, 200) and [350, 360)
    assert sum(gaps.values()) == pytest.approx(740e-6)
    assert gaps["host:aten::mm"] == pytest.approx(530e-6)   # [370, 900), mid 635


def test_names_in_core_are_generic():
    """The core names no cell, configuration or metric."""
    names = set(CELLS) | {c["name"] for c in BENCH["configs"]} | {m["name"] for m in METRICS}
    for path in [ROOT / "benchmark" / "run.py", *(ROOT / "benchmark" / "harness").glob("*.py")]:
        text = path.read_text()
        for n in names:
            assert not re.search(rf"(?<![\w.]){re.escape(n)}(?![\w])", text), (path, n)
