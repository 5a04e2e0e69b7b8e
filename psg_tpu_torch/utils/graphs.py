"""CUDA graphs captured in pieces, with the hand-written kernels' calls
launched from the host between the pieces.

``PiecewiseGraph.capture(fn, stream)`` captures what ``fn()`` launches on
``stream`` as a chain of CUDA graphs on one memory pool, and leaves out the
call of every function marked ``eager_between``.  While a capture is open
on the thread, such a call ends the piece being captured, runs once for the
place and layout of its output (on inputs the pieces have not computed
yet), and opens the next piece.  ``replay`` replays the pieces in order and,
between them, makes each left-out call again with the tensors it was
captured with, through the name it has on its module (or its module's
class) at that moment, and copies the result into the tensors that the
next piece reads.

The ops layer marks the entry points of its hand-written kernels
(``ops.sdpa``, ``ops.group_norm_silu``) and the backwards of their autograd
Functions (``FlashSDPA.backward``, ``GroupNormSiLU.backward``).  So in a
replayed evaluation, or a replayed training backward, they still launch
from the host, with their argument checks: the counters ``launch.<library>``
count every launch, and whatever wraps one of these names, a profiler range
or a measurement placed from outside, sees every call with its shapes and
the device time of its kernels.  Everything else the function launches
(convolutions, matmuls, norms, casts, adds) replays from the graphs.

A backward is captured from inside the autograd engine: the capture must
open and close its pieces on the thread that runs the marked backwards,
which is the engine's thread for the device (``models.unet``'s training
graphs capture theirs from the backward of an autograd Function).
"""

from __future__ import annotations

import functools
import gc
import itertools
import sys
import threading
from typing import Any, NamedTuple

import torch

_open = threading.local()   # .graph: the PiecewiseGraph capturing on this thread


def eager_between(fn):
    """Mark ``fn``, a function of its module's top level or a static method
    of one of its classes, as launched from the host between a
    ``PiecewiseGraph``'s pieces; outside a capture the mark only passes the
    call on."""
    module, path = sys.modules[fn.__module__], tuple(fn.__qualname__.split("."))

    @functools.wraps(fn)
    def call(*args, **kwargs):
        graph = getattr(_open, "graph", None)
        if graph is None:
            return fn(*args, **kwargs)
        return graph._leave_out(module, path, fn, args, kwargs)

    return call


class LeftOut(NamedTuple):
    """A call left out of the graph: made through ``path`` on ``module``,
    with ``args`` and ``kwargs``; ``out`` is what it returned at capture."""
    module: Any
    path: tuple
    args: tuple
    kwargs: dict
    out: Any


def _refill(out, new) -> None:
    """Copy ``new`` into ``out``, a tensor or a tuple of tensors and Nones.
    The copy goes through ``.data`` and so bumps no version counter: an
    autograd graph recorded at capture may have saved ``out``, and the
    replay refreshes it as the pieces refresh their own outputs, unseen by
    autograd."""
    if isinstance(out, torch.Tensor):
        out.data.copy_(new)
    elif out is not None:
        for o, n in zip(out, new):
            _refill(o, n)


class PiecewiseGraph:
    """One function's launches as CUDA graphs between host calls (see the
    module note).  Captured once; the pieces share ``pool`` with whatever
    else is captured on it, so replays of graphs on one pool must not
    overlap."""

    def __init__(self, pool):
        self.pool = pool
        self._pieces = []    # torch.cuda.CUDAGraph, in order
        self.calls = []      # LeftOut, one after each piece but the last
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

    def replay(self, call=None) -> None:
        """Replay the pieces and make the left-out calls between them.
        ``call(i, fn, args, kwargs)``, where given, makes the ``i``-th call
        of ``fn`` (its current name) in place of ``fn(*args, **kwargs)``."""
        for i, (piece, left) in enumerate(itertools.zip_longest(self._pieces, self.calls)):
            piece.replay()
            if left is not None:
                fn = functools.reduce(getattr, left.path, left.module)
                _refill(left.out, fn(*left.args, **left.kwargs) if call is None
                        else call(i, fn, left.args, left.kwargs))

    def _begin(self) -> None:
        piece = torch.cuda.CUDAGraph()
        piece.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        self._pieces.append(piece)
        self._capturing = True

    def _end(self) -> None:
        if self._capturing:
            self._capturing = False
            self._pieces[-1].capture_end()

    def _leave_out(self, module, path, fn, args, kwargs):
        self._end()
        _open.graph = None
        try:
            out = fn(*args, **kwargs)
        finally:
            _open.graph = self
        self.calls.append(LeftOut(module, path, args, kwargs, out))
        self._begin()
        return out
