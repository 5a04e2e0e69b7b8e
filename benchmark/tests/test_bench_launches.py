"""The launch-call count and the program's counter readers, on made-up
traces and runs on the CPU; and the program's own ``psg.*`` ranges in a
trace leave every ``bench.*`` reading as it was."""

from __future__ import annotations

import types

import pytest

from benchmark.harness import main, trace
from benchmark.harness.launches import calls_in
from benchmark.runners.training import CHECKED_STEPS
from benchmark.tests.conftest import ROOT


def _ev(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "pid": 1}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


BENCH_EVENTS = [
    _ev("user_annotation", trace.WINDOW, 0, 1000),
    _ev("user_annotation", "bench.sampler", 95, 310),
    _ev("user_annotation", "bench.unet", 100, 300),
    _ev("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=1),
    _ev("cuda_runtime", "cudaGraphLaunch", 150, 5, corr=2),        # three kernels
    _ev("cuda_runtime", "cudaStreamSynchronize", 160, 5, corr=3),  # no device work
    _ev("cuda_runtime", "cudaMemcpyAsync", 170, 5, corr=5),
    _ev("cuda_driver", "cuLaunchKernel", 390, 5, tid=3, corr=4),    # another thread
    _ev("cuda_runtime", "cudaLaunchKernel", 500, 5, corr=6),        # outside the range
    _ev("user_annotation", "bench.gn.bwd", 700, 100, tid=3),
    _ev("kernel", "k1", 200, 50, tid=7, corr=1),
    *[_ev("kernel", f"g{i}", 250 + 10 * i, 10, tid=7, corr=2) for i in range(3)],
    _ev("gpu_memcpy", "Memcpy HtoD", 290, 5, tid=7, corr=5),
    _ev("kernel", "k4", 400, 10, tid=7, corr=4),
    _ev("kernel", "k6", 600, 20, tid=7, corr=6),
    _ev("cpu_op", "aten::mm", 620, 50),
]
PSG_EVENTS = [
    _ev("user_annotation", "psg.unet.eval", 102, 290),
    _ev("user_annotation", "psg.unet.enc0", 105, 100),
    _ev("user_annotation", "psg.train.backward", 450, 300, tid=3),
]


def test_calls_in_counts_each_call_that_reached_the_device_once():
    r = trace.Reduced(BENCH_EVENTS)
    # the kernel launch, the graph launch (once for its three kernels), the
    # copy and the other thread's launch; not the synchronize, nor the launch
    # after the range closed
    assert calls_in(r, "bench.unet") == 4
    assert calls_in(r, trace.WINDOW) == 5
    assert calls_in(r, "bench.gn.bwd") == 0
    assert calls_in(r, "bench.absent") == 0


def test_program_ranges_leave_bench_readings_as_they_were():
    plain, both = trace.Reduced(BENCH_EVENTS), trace.Reduced(BENCH_EVENTS + PSG_EVENTS)
    for name in ("bench.unet", "bench.gn.bwd", trace.WINDOW):
        assert both.device_s_in(name) == plain.device_s_in(name)
        assert calls_in(both, name) == calls_in(plain, name)
    assert both.idle_gaps() == plain.idle_gaps()
    assert both.top_device_ops() == plain.top_device_ops()
    assert (both.busy_s, both.window_s) == (plain.busy_s, plain.window_s)


def _reader(name):
    return main.reader(ROOT, name)


def _ctx(run, reduced=None):
    return main.Context(run, 1.0, reduced)


def test_launch_readers():
    r = trace.Reduced(BENCH_EVENTS)
    # four calls in the sampler's range over 1 request of 2 passes of 1 step
    serve = types.SimpleNamespace(traced_requests=1, recipe={"restarts": 1, "steps": 1})
    assert _reader("launch_calls_per_eval.serve")(_ctx(serve, r)) == 2.0
    assert _reader("launch_calls_per_eval.serve")(_ctx(serve)) is None
    assert _reader("launch_calls_per_eval.serve")(
        _ctx(types.SimpleNamespace(traced_requests=0), r)) is None
    train = types.SimpleNamespace(traced_steps=5)
    assert _reader("launch_calls_per_step.train")(_ctx(train, r)) == 1.0
    assert _reader("launch_calls_per_step.train")(
        _ctx(types.SimpleNamespace(traced_steps=0), r)) is None


def test_host_reads_reader(monkeypatch):
    from psg_tpu_torch.utils import profiling

    read = _reader("host_reads_per_step.train")
    monkeypatch.setattr(profiling, "_counts", {profiling.HOST_READS: 2 * (CHECKED_STEPS + 9)})
    run = types.SimpleNamespace(program="port", steps=7, traced_steps=2)
    assert read(_ctx(run)) == pytest.approx(2.0)
    assert read(_ctx(types.SimpleNamespace(program="control"))) is None
    monkeypatch.setattr(profiling, "_counts", {})
    assert read(_ctx(run)) is None
