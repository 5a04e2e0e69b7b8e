"""Tracing, timing and debugging helpers (port of
``psg_tpu/utils/profiling.py``), and the port's own spans and counters.

- ``span(name)``: a named region of the program.  With no profiler
  running it is one shared no-op object; under a running ``torch.profiler``
  it is a ``record_function`` range, on the profiler's clock beside the
  kernels it launched.  ``span_table`` reads the spans of an exported
  trace: their count, host and device time, launch calls and the device's
  idle time inside them (``scripts/torch_profile_serve.py`` and
  ``scripts/torch_profile_train.py`` print it);
- ``count(name, n)``: always-on integer counters (``counts``,
  ``reset_counts``): ``host_reads``, one at the optimizer's device-to-host
  read of the step's finite flag and norms; ``launch.<library>``, the
  kernel launches each ``ops`` library makes from the host (a launch
  captured into a CUDA graph once, its replays never; the UNet's graphs
  leave these kernels out, ``utils/graphs.py``, so each of its evaluations
  counts them, forward and backward); and the UNet's graphs
  (``models/unet.py``):
  ``unet_graph.capture`` and ``unet_graph.replay``, and
  ``unet_graph.eager`` for an evaluation handed a graph cache that ran its
  eager body; the same three of the training graphs, whose evaluation
  replays its forward and its backward, ``unet_train_graph.capture``,
  ``.replay`` and ``.eager``;
- ``trace``: a ``torch.profiler`` capture of everything inside the block,
  written as a Chrome trace (view in Perfetto);
- ``StepTimer``: per-step times; on the card from CUDA events recorded on
  the stream around the step (device time, read once at ``summary``), on
  the CPU from the host clock;
- ``debug_nans``: autograd's anomaly detection, so the first backward that
  makes a NaN raises with the forward's traceback;
- ``device_memory_stats``: the caching allocator's counters
  (``torch.cuda.memory_stats``).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import tempfile
import time
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

_profiler_on = torch._C._autograd._profiler_enabled
_record_function = torch.profiler.record_function

# -- counters ----------------------------------------------------------------

HOST_READS = "host_reads"
UNET_GRAPH_CAPTURE = "unet_graph.capture"
UNET_GRAPH_REPLAY = "unet_graph.replay"
UNET_GRAPH_EAGER = "unet_graph.eager"
UNET_TRAIN_GRAPH_CAPTURE = "unet_train_graph.capture"
UNET_TRAIN_GRAPH_REPLAY = "unet_train_graph.replay"
UNET_TRAIN_GRAPH_EAGER = "unet_train_graph.eager"
_counts: Dict[str, int] = {}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    _counts[name] = _counts.get(name, 0) + n


def counts() -> Dict[str, int]:
    """A copy of every counter."""
    return dict(_counts)


def reset_counts(prefix: str = "") -> None:
    """Zero the counters whose names start with ``prefix`` (all by default)."""
    for name in _counts:
        if name.startswith(prefix):
            _counts[name] = 0


# -- spans ---------------------------------------------------------------------

_OFF = contextlib.nullcontext()
_PREFIX = "psg."   # the port's spans


def span(name: str):
    """A context manager around a named region of the program: one shared
    no-op object unless a profiler is running, then a ``record_function``
    range.  Pass a name made once, not per call."""
    if not _profiler_on():
        return _OFF
    return _record_function(name)


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def span_table(events) -> Dict[str, dict]:
    """The ``psg.*`` spans of a Chrome trace (``events``: its
    ``traceEvents``), each with its ``count`` and, a span on
    average: ``host_ms``, its duration; ``device_ms``, the device time of
    the kernels, copies and sets launched by any thread while a span of that
    name was open (autograd's thread launches the backward); ``calls``, the
    host CUDA API calls (runtime or ``cu*``) that reached the device in that
    time, a CUDA graph's launch once; ``idle_ms``, the device's idle time, between
    the first span's start and the last one's end, whose middle fell in this
    span and in none nested in it."""
    ranges, launches, device = [], [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, ts = ev.get("cat", ""), float(ev["ts"])
        end = ts + float(ev.get("dur", 0.0))
        corr = (ev.get("args") or {}).get("correlation")
        if cat == "user_annotation" and ev["name"].startswith(_PREFIX):
            ranges.append((ts, end, ev["name"]))
        elif cat in _LAUNCH_CATS and corr is not None:
            launches.append((ts, corr))
        elif cat in _DEVICE_CATS:
            device.append((ts, end, corr))
    if not ranges:
        return {}
    work: Dict[object, float] = {}
    for s, e, corr in device:
        if corr is not None:
            work[corr] = work.get(corr, 0.0) + (e - s)
    by_name: Dict[str, list] = {}
    for s, e, name in ranges:
        by_name.setdefault(name, []).append((s, e))
    table = {}
    for name, spans in by_name.items():
        merged = _merge(spans)
        starts = [s for s, _ in merged]
        seen = set()
        for ts, corr in launches:
            i = bisect.bisect_right(starts, ts) - 1
            if corr in work and i >= 0 and ts <= merged[i][1]:
                seen.add(corr)
        n = len(spans)
        table[name] = {"count": n, "host_ms": sum(e - s for s, e in spans) / n / 1e3,
                       "device_ms": sum(work[c] for c in seen) / n / 1e3,
                       "calls": len(seen) / n, "idle_ms": 0.0}
    # idle gaps, each put down to the innermost span open at its middle
    # (spans nest: they are opened and closed on one thread)
    t0, t1 = min(s for s, _, _ in ranges), max(e for _, e, _ in ranges)
    gaps, prev = [], t0
    for s, e in _merge([(s, e) for s, e, _ in device if e > t0 and s < t1]):
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    if t1 > prev:
        gaps.append((prev, t1))
    ranges.sort(key=lambda r: (r[0], -r[1]))
    stack, i = [], 0
    for s, e in gaps:
        mid = 0.5 * (s + e)
        while i < len(ranges) and ranges[i][0] <= mid:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        if stack:
            table[stack[-1][2]]["idle_ms"] += (e - s) / 1e3
    for row in table.values():
        row["idle_ms"] /= row["count"]
    return table


def profile_spans(prof, path=None) -> Dict[str, dict]:
    """``span_table`` of a finished ``torch.profiler`` session, read from its
    Chrome trace (written to ``path`` and kept there when given)."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(path) if path else Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(out))
        return span_table(json.loads(out.read_text())["traceEvents"])


@contextlib.contextmanager
def trace(log_dir="profile"):
    """Capture a torch.profiler trace (CPU, and CUDA where there is a card)
    of the block into ``log_dir/trace.json``; yields the profiler."""
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / "trace.json"))


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Autograd anomaly detection inside the block, restored after it."""
    old = torch.is_anomaly_enabled()
    torch.autograd.set_detect_anomaly(enable)
    try:
        yield
    finally:
        torch.autograd.set_detect_anomaly(old)


class StepTimer:
    """Step times: CUDA events on the current stream on the card (the
    default; raises without one), the host clock for ``device="cpu"``."""

    def __init__(self, device=None):
        from psg_tpu_torch.serve.generator import resolve_device

        self.cuda = resolve_device(device).type == "cuda"
        self.samples: List[float] = []
        self._events: list = []

    @contextlib.contextmanager
    def measure(self):
        if self.cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            yield
            end.record()
            self._events.append((start, end))
        else:
            t0 = time.perf_counter()
            yield
            self.samples.append(time.perf_counter() - t0)

    def _collect(self) -> None:
        if self._events:
            self._events[-1][1].synchronize()
            self.samples.extend(s.elapsed_time(e) / 1e3 for s, e in self._events)
            self._events = []

    def summary(self) -> dict:
        self._collect()
        if not self.samples:
            return {}
        a = np.asarray(self.samples)
        return {"mean_s": float(a.mean()), "p50_s": float(np.percentile(a, 50)),
                "p90_s": float(np.percentile(a, 90)), "steps_per_s": float(1.0 / a.mean()),
                "n": len(a)}


def device_memory_stats(device=None) -> dict:
    """Bytes allocated now, the peak since the last reset, and the card's
    memory, from the caching allocator (``device``: a CUDA device, the
    current one by default)."""
    stats = torch.cuda.memory_stats(device)
    return {"bytes_in_use": stats.get("allocated_bytes.all.current"),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak"),
            "bytes_limit": torch.cuda.get_device_properties(
                torch.device("cuda", torch.cuda.current_device())
                if device is None else device).total_memory}
