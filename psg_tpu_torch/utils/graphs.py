"""CUDA graphs captured in pieces, with the hand-written kernels' calls
launched from the host between the pieces.

``PiecewiseGraph.capture(fn, stream)`` captures what ``fn()`` launches on
``stream`` as a chain of CUDA graphs on one memory pool, and leaves out the
call of every function marked ``eager_between``.  While a capture is open
on the thread, such a call ends the piece being captured, runs once for the
place and layout of its output (on inputs the pieces have not computed
yet), and opens the next piece.  ``replay`` replays the pieces in order and,
between them, makes each left-out call again with the tensors it was
captured with, through the name it has on its module at that moment, and
copies the result into the tensor that the next piece reads.

The ops layer marks the entry points of its hand-written kernels
(``ops.sdpa``, ``ops.group_norm_silu``).  So in a replayed evaluation they
still launch from the host, with their argument checks: the counters
``launch.<library>`` count every launch, and whatever wraps an entry point,
a profiler range or a measurement placed from outside, sees every call with
its shapes and the device time of its kernels.  Everything else the
function launches (convolutions, matmuls, norms, casts, adds) replays from
the graphs.
"""

from __future__ import annotations

import functools
import gc
import itertools
import sys
import threading

import torch

_open = threading.local()   # .graph: the PiecewiseGraph capturing on this thread


def eager_between(fn):
    """Mark ``fn``, a function of its module's top level, as launched from
    the host between a ``PiecewiseGraph``'s pieces; outside a capture the
    mark only passes the call on."""
    module, name = sys.modules[fn.__module__], fn.__name__

    @functools.wraps(fn)
    def call(*args, **kwargs):
        graph = getattr(_open, "graph", None)
        if graph is None:
            return fn(*args, **kwargs)
        return graph._leave_out(module, name, fn, args, kwargs)

    return call


class PiecewiseGraph:
    """One function's launches as CUDA graphs between host calls (see the
    module note).  Captured once; the pieces share ``pool`` with whatever
    else is captured on it, so replays of graphs on one pool must not
    overlap."""

    def __init__(self, pool):
        self.pool = pool
        self._pieces = []    # torch.cuda.CUDAGraph, in order
        self._between = []   # (module, name, args, kwargs, out) after each piece but the last
        self._capturing = False

    def __len__(self) -> int:
        return len(self._pieces)

    def capture(self, fn, stream):
        """Capture ``fn()`` on ``stream`` and return its output, which each
        ``replay`` fills.  Run ``fn`` once eagerly on ``stream`` first, so
        that cuDNN and cuBLAS choose their kernels and workspaces outside
        the capture."""
        torch.cuda.synchronize()   # as torch.cuda.graph does before a capture
        gc.collect()
        torch.cuda.empty_cache()
        with torch.cuda.stream(stream):
            self._begin()
            _open.graph = self
            try:
                out = fn()
            finally:
                _open.graph = None
                self._end()
        # the left-out calls ran on ``stream`` into tensors that replays refill
        torch.cuda.current_stream().wait_stream(stream)
        return out

    def replay(self) -> None:
        for piece, call in itertools.zip_longest(self._pieces, self._between):
            piece.replay()
            if call is not None:
                module, name, args, kwargs, out = call
                out.copy_(getattr(module, name)(*args, **kwargs))

    def _begin(self) -> None:
        piece = torch.cuda.CUDAGraph()
        piece.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self._pieces.append(piece)
        self._capturing = True

    def _end(self) -> None:
        if self._capturing:
            self._capturing = False
            self._pieces[-1].capture_end()

    def _leave_out(self, module, name, fn, args, kwargs):
        self._end()
        _open.graph = None
        try:
            out = fn(*args, **kwargs)
        finally:
            _open.graph = self
        self._between.append((module, name, args, kwargs, out))
        self._begin()
        return out
