"""Host calls that reached the device, counted in a reduced trace.

A CUDA API call (runtime or `cu*`) reaches the device when its correlation id
appears on at least one kernel, copy or set.  Counted by distinct
correlation id, a launch is one call however many kernels it made (a CUDA
graph's replay is one call), and a call that made no device work (a
synchronize, an event record) is none.
"""

from __future__ import annotations

import bisect

from benchmark.harness.trace import _merge


def calls_in(reduced, name: str) -> int:
    """Host calls, on any thread, made while a range named ``name`` was
    open, that reached the device (read from the reduction's launch and
    device-operation tables)."""
    merged = _merge([(s, e) for _, s, e in reduced.ranges.get(name, ())])
    starts = [s for s, _ in merged]
    seen = set()
    for _, ts, corr in reduced._launches:
        if corr in reduced._kernels:
            i = bisect.bisect_right(starts, ts) - 1
            if i >= 0 and ts <= merged[i][1]:
                seen.add(corr)
    return len(seen)
