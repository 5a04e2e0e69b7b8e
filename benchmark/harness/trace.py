"""A profiler over the measured window, reduced to what metric readers need.

``Tracer`` runs ``torch.profiler`` (CPU and CUDA activities) over the window
and reduces its Chrome trace to kernel intervals, the host's launch calls
and the benchmark's own ``bench.*`` ranges.  Device time inside a range is
the summed duration of the kernels launched (by a CUDA runtime or driver API call)
while the range was open.
"""

from __future__ import annotations

import bisect
import collections
import heapq
import json
import os
import tempfile

import torch

WINDOW = "bench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Tracer:
    def __init__(self):
        self.reduced = None
        self._prof = None
        self._range = None

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._range = torch.profiler.record_function(WINDOW)
        self._range.__enter__()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            fd, path = tempfile.mkstemp(suffix=".json")
            os.close(fd)
            try:
                self._prof.export_chrome_trace(path)
                with open(path) as f:
                    self.reduced = Reduced(json.load(f)["traceEvents"])
            finally:
                os.unlink(path)
        self._prof = None
        return False


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


class Reduced:
    """The traced window's kernels, launches and ``bench.*`` ranges (times
    in microseconds on the trace's clock)."""

    def __init__(self, events):
        self.device_ops = []      # (name, start, end)
        kernels_by_corr = {}
        launches = []             # (tid, ts, correlation)
        self.ranges = collections.defaultdict(list)   # name -> [(tid, start, end)]
        cpu_ops = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
            args = ev.get("args") or {}
            if cat in _DEVICE_CATS:
                self.device_ops.append((ev["name"], ts, ts + dur))
                corr = args.get("correlation")
                if corr is not None:
                    kernels_by_corr.setdefault(corr, []).append(dur)
            elif cat in _LAUNCH_CATS:
                corr = args.get("correlation")
                if corr is not None:
                    launches.append((ev["tid"], ts, corr))
            elif cat == "user_annotation" and ev["name"].startswith("bench."):
                self.ranges[ev["name"]].append((ev["tid"], ts, ts + dur))
            elif cat == "cpu_op":
                cpu_ops.append((ts, ts + dur, ev["name"], ev["tid"]))
        if not self.ranges.get(WINDOW):
            raise RuntimeError("the trace holds no window range")
        _, self.t0, self.t1 = self.ranges[WINDOW][0]
        self.device_ops = [(n, max(s, self.t0), min(e, self.t1))
                           for n, s, e in self.device_ops if e > self.t0 and s < self.t1]
        self._kernels = kernels_by_corr
        self._launches = launches
        self._cpu_ops = sorted(cpu_ops)
        self.busy = _merge([(s, e) for _, s, e in self.device_ops])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def device_s_in(self, name: str) -> float:
        """Seconds of device work launched, by any thread, while a range
        named ``name`` was open.  Any thread: a backward's kernels are
        launched by autograd's device thread while the range's own thread
        waits in ``autograd.grad``; the process has no other thread that
        launches work."""
        merged = _merge([(s, e) for _, s, e in self.ranges.get(name, ())])
        if not merged:
            return 0.0
        starts = [s for s, _ in merged]
        total = 0.0
        for _, ts, corr in self._launches:
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= merged[i][1]:
                total += sum(self._kernels.get(corr, ()))
        return total * 1e-6

    def top_device_ops(self, n: int = 10):
        by = collections.Counter()
        for name, s, e in self.device_ops:
            by[name] += (e - s) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]

    def idle_gaps(self, n: int = 10):
        """Idle device time by what the host was doing at each gap's middle:
        the innermost ``bench.*`` range open then, else the outermost CPU op
        open then, else plain Python."""
        gaps, prev = [], self.t0
        for s, e in self.busy:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        named = sorted((s, e, name) for name, rs in self.ranges.items() if name != WINDOW
                       for _, s, e in rs)
        ops = [(s, e, name) for s, e, name, _ in self._cpu_ops]
        by = collections.Counter()
        for (s, e), (label_r, label_o) in zip(gaps, zip(_sweep(named, gaps, max),
                                                        _sweep(ops, gaps, min))):
            label = label_r or (f"host:{label_o}" if label_o else "host:python")
            by[label] += (e - s) * 1e-6
        return [[k, v] for k, v in by.most_common(n)]


def _sweep(spans, gaps, pick):
    """For each gap (in time order), the name of the span open at its middle
    whose start ``pick`` (max: the innermost, min: the outermost) chooses."""
    out, active, i = [], {}, 0
    ends = []   # heap of (end, index)
    for s, e in gaps:
        mid = 0.5 * (s + e)
        while i < len(spans) and spans[i][0] <= mid:
            active[i] = spans[i]
            heapq.heappush(ends, (spans[i][1], i))
            i += 1
        while ends and ends[0][0] < mid:
            active.pop(heapq.heappop(ends)[1], None)
        if active:
            k = pick(active, key=lambda j: active[j][0])
            out.append(active[k][2])
        else:
            out.append(None)
    return out
