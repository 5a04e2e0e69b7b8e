"""Ranges and counts around calls into the program, placed from outside it.

``Spans.wrap(owner, attr, name)`` replaces ``owner.attr`` with a function
that opens the profiler range ``bench.<name>`` around each call, counts the
call and keeps what ``record`` derives from its arguments (the shapes a
counter needs).  ``restore`` puts every original back.  Spans are placed only
in traced runs.
"""

from __future__ import annotations

import collections
import functools
import time

import torch


class Spans:
    def __init__(self):
        self.calls = collections.defaultdict(list)   # name -> [record(...)]
        self.host_s = collections.defaultdict(float)  # name -> host seconds
        self._undo = []

    def wrap(self, owner, attr, name, record=None, *, static=False, sync=False):
        """``owner`` is a module, class, object or dict (``attr`` its key).
        ``record(*args, **kwargs)`` -> what to keep of a call; ``static``:
        ``attr`` is a staticmethod of a class; ``sync``: the call's host time
        ends in a device synchronize and is added to ``host_s[name]``."""
        is_map = isinstance(owner, dict)
        orig = owner[attr] if is_map else getattr(owner, attr)
        label = f"bench.{name}"

        @functools.wraps(orig)
        def wrapped(*args, **kwargs):
            self.calls[name].append(record(*args, **kwargs) if record else None)
            with torch.profiler.record_function(label):
                if not sync:
                    return orig(*args, **kwargs)
                t0 = time.perf_counter()
                out = orig(*args, **kwargs)
                if torch.cuda.is_initialized():
                    torch.cuda.synchronize()
                self.host_s[name] += time.perf_counter() - t0
                return out

        if is_map:
            self._undo.append((owner, attr, orig))
            owner[attr] = wrapped
            return self
        self._undo.append((owner, attr, owner.__dict__.get(attr, orig)
                           if isinstance(owner, type) else orig))
        setattr(owner, attr, staticmethod(wrapped) if static else wrapped)
        return self

    def restore(self) -> None:
        for owner, attr, orig in reversed(self._undo):
            if isinstance(owner, dict):
                owner[attr] = orig
            else:
                setattr(owner, attr, orig)
        self._undo.clear()
