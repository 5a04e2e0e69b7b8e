"""Seconds of each part of a run's set-up, printed to standard error."""

from __future__ import annotations

import sys
import time

import torch


class Parts:
    def __init__(self):
        self.t = time.perf_counter()
        self.seconds = {}

    def mark(self, name: str) -> None:
        """The seconds since the last mark (or the start) belong to ``name``."""
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        self.t = now

    def report(self, device) -> None:
        if device.type == "cuda":
            torch.cuda.synchronize()
        print("set-up parts (s): " + ", ".join(f"{k} {v:.2f}" for k, v in
                                               self.seconds.items()), file=sys.stderr)
