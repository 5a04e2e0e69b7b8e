"""Metrics and logging (port of ``psg_tpu/core/metrics.py``).

A JSONL scalar log, ``metrics.jsonl`` (always on), TensorBoard beside it
when ``torch.utils.tensorboard`` imports, per-stage file and console
logging, and the batches/hour throughput line.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Dict


def setup_logging(log_dir, stage: str, *, writer: bool = True) -> logging.Logger:
    """Per-stage file + console logging; on a rank that is not the mesh's
    writer, a logger that drops everything below a warning and writes no
    file."""
    if not writer:
        logger = logging.getLogger(f"psg_tpu_torch.{stage}.quiet")
        logger.setLevel(logging.WARNING)
        return logger
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    logger = logging.getLogger(f"psg_tpu_torch.{stage}")
    logger.setLevel(logging.INFO)
    if not logger.handlers:
        fh = logging.FileHandler(log_dir / f"{stage}.log")
        fh.setFormatter(logging.Formatter("%(asctime)s %(levelname)s %(message)s"))
        logger.addHandler(fh)
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter("%(asctime)s %(message)s"))
        logger.addHandler(sh)
    return logger


class MetricsWriter:
    def __init__(self, log_dir, use_tensorboard: bool = True, *, enabled: bool = True):
        """``enabled=False`` (a rank that is not the mesh's writer): records
        nothing."""
        self.enabled = enabled
        self._f = self._tb = None
        if not enabled:
            return
        self.dir = Path(log_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._f = open(self.dir / "metrics.jsonl", "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=str(self.dir / "tb"))
            except ImportError:  # tensorboard is not installed
                self._tb = None

    def scalar(self, tag: str, value, step: int) -> None:
        if not self.enabled:
            return
        rec = {"tag": tag, "value": float(value), "step": int(step),
               "time": time.time()}
        self._f.write(json.dumps(rec) + "\n")
        if self._tb is not None:
            self._tb.add_scalar(tag, float(value), int(step))

    def scalars(self, values: Dict[str, float], step: int, prefix: str = "") -> None:
        for k, v in values.items():
            self.scalar(prefix + k, v, step)

    def flush(self) -> None:
        if not self.enabled:
            return
        self._f.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self) -> None:
        if not self.enabled:
            return
        self.flush()
        self._f.close()
        if self._tb is not None:
            self._tb.close()


class Throughput:
    """batches/hour estimator."""

    def __init__(self):
        self.start = time.time()
        self.count = 0

    def step(self, n: int = 1) -> None:
        self.count += n

    def batches_per_hour(self) -> float:
        dt = max(time.time() - self.start, 1e-9)
        return self.count / dt * 3600.0
