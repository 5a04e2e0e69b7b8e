"""Device memory planning (port of ``psg_tpu/utils/memory.py``).

The JAX package compiles a step ahead of time and reads XLA's memory
analysis.  PyTorch has no such analysis, so here the step runs once on the
card and the caching allocator's peak-allocated counter gives its
footprint; the largest-batch search tries batches the same way and treats
an out-of-memory error, inside the search only, as "does not fit".
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from psg_tpu_torch.utils.profiling import device_memory_stats


def _nbytes(obj) -> int:
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, dict):
        return sum(_nbytes(v) for v in obj.values())
    if isinstance(obj, (list, tuple)):
        return sum(_nbytes(v) for v in obj)
    return 0


def step_memory_analysis(step_fn: Callable, *example_args) -> dict:
    """Run ``step_fn(*example_args)`` once on the card and report its
    memory: the peak allocated during the step, the part of it above what
    was allocated before (temporaries and outputs), and the arguments' and
    outputs' bytes.  The arguments must already be on the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("step_memory_analysis needs a CUDA device")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = step_fn(*example_args)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    return {"peak_bytes": int(peak), "temp_size_bytes": int(peak - before),
            "argument_size_bytes": _nbytes(example_args), "output_size_bytes": _nbytes(out)}


def find_max_batch_size(make_args: Callable[[int], tuple], step_fn: Callable,
                        start: int = 1, limit: int = 4096,
                        hbm_bytes: Optional[int] = None, safety: float = 0.9) -> int:
    """The largest batch whose step peaks within ``safety`` of the card's
    memory (or of ``hbm_bytes``): doubling from ``start``, then a binary
    search; 0 if ``start`` does not fit.  ``make_args(batch)`` returns the
    step's arguments on the card."""
    if hbm_bytes is None:
        hbm_bytes = device_memory_stats()["bytes_limit"]
    budget = hbm_bytes * safety

    def fits(b: int) -> bool:
        try:
            peak = step_memory_analysis(step_fn, *make_args(b))["peak_bytes"]
        except torch.OutOfMemoryError:
            torch.cuda.empty_cache()
            return False
        return 0 < peak <= budget

    if not fits(start):
        return 0
    hi = start
    while hi < limit and fits(hi * 2):
        hi *= 2
    lo, hi = hi, min(hi * 2, limit)
    while lo + 1 < hi:
        mid = (lo + hi) // 2
        if fits(mid):
            lo = mid
        else:
            hi = mid
    return lo
