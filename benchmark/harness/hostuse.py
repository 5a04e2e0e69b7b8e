"""What the host did during a window, printed to standard error.

The cells are host-bound, so a run's rate follows the host's speed.  These
lines let a reader tell a slow host from more work: the CPU seconds of the
main thread and of the process against the window (the same CPU seconds
for fewer steps is a slower host), the time of each unit of work, and the
work done in each slice of the window.
"""

from __future__ import annotations

import time


class HostUse:
    """Readings of the host from ``start()`` to ``stop()``."""

    def start(self) -> None:
        self.t0 = time.perf_counter()
        self.thread0 = time.thread_time()
        self.proc0 = time.process_time()
        self.marks = []

    def mark(self) -> None:
        """One unit of work (a step or a request) has ended."""
        self.marks.append(time.perf_counter())

    def stop(self) -> None:
        self.wall = time.perf_counter() - self.t0
        self.thread = time.thread_time() - self.thread0
        self.proc = time.process_time() - self.proc0

    def slices(self, width: float = 5.0) -> list:
        """Units of work ended in each ``width``-second slice of the window."""
        n = max(1, int(self.wall // width + (self.wall % width > 1e-9)))
        out = [0] * n
        for t in self.marks:
            out[min(n - 1, int((t - self.t0) // width))] += 1
        return out

    def report(self, unit: str, file) -> None:
        gaps = sorted(b - a for a, b in zip([self.t0] + self.marks, self.marks))
        q = (lambda p: 1e3 * gaps[min(len(gaps) - 1, int(p * len(gaps)))]) if gaps else (
            lambda p: float("nan"))
        print(f"host: main thread CPU {self.thread:.2f} s, process CPU {self.proc:.2f} s "
              f"of {self.wall:.2f} s", file=file)
        print(f"host: ms a {unit} p10 {q(0.1):.1f} p50 {q(0.5):.1f} p90 {q(0.9):.1f} "
              f"max {q(1.0):.1f}; {unit}s a 5-s slice {self.slices()}", file=file)
