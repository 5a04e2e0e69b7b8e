"""Tracing, timing and debugging helpers (port of
``psg_tpu/utils/profiling.py``).

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

import contextlib
import time
from pathlib import Path
from typing import List

import numpy as np
import torch


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
