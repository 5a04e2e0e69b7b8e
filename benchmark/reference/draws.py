# Frozen copy of psg_tpu_torch/core/draws.py for the benchmark's plain reference;
# calls into the port's kernels, where it has any, go to plainops.py.
"""Random draws a mesh can cut into rows.

The JAX package's mesh runs are single-controller: every random draw of a
step has the global batch's shape, and each device keeps its rows.  The
port runs one process per device, so each rank draws the whole global shape
from the same generator and keeps its own rows (``RowDraws``); a run on any
mesh then draws exactly what the single-process run draws.

Every draw of a batch-shaped tensor in the port goes through ``randn``,
``rand`` and ``randint`` here.  Their ``generator`` is a ``torch.Generator``
(drawn from as ``torch.randn(shape, generator=...)`` does) or a
``RowDraws``, whose draws have the rows of the requested shape's first
dimension cut out of a draw at the global shape.
"""

from __future__ import annotations

from typing import Optional

import torch


class RowDraws:
    """Rows ``rows`` of draws made at a global batch of ``global_rows`` rows
    from ``generator``.  ``real_rows`` (at most ``global_rows``): the rows
    actually drawn, the rest repeating the last drawn row (the padding a
    batch gets to a multiple of the mesh's 'data' axis), so that the drawn
    rows equal those of an unpadded single-process draw."""

    def __init__(self, generator: torch.Generator, rows: slice, global_rows: int,
                 real_rows: Optional[int] = None):
        self.generator = generator
        self.rows = rows
        self.global_rows = int(global_rows)
        self.real_rows = self.global_rows if real_rows is None else int(real_rows)
        if not 0 < self.real_rows <= self.global_rows:
            raise ValueError(f"real_rows {self.real_rows} not in (0, {self.global_rows}]")

    @property
    def device(self) -> torch.device:
        return self.generator.device

    def _draw(self, fn, shape):
        shape = tuple(shape)
        local = len(range(*self.rows.indices(self.global_rows)))
        if not shape or shape[0] != local:
            raise ValueError(f"a draw of shape {shape} is not this rank's {local} rows")
        full = fn((self.real_rows,) + shape[1:])
        if self.real_rows < self.global_rows:
            pad = full[-1:].expand((self.global_rows - self.real_rows,) + shape[1:])
            full = torch.cat([full, pad], dim=0)
        return full[self.rows]


def is_source(x) -> bool:
    """A ``torch.Generator`` or a ``RowDraws``."""
    return isinstance(x, (torch.Generator, RowDraws))


def randn(generator, shape, *, device=None, dtype=None) -> torch.Tensor:
    device = device if device is not None else generator.device
    if isinstance(generator, RowDraws):
        return generator._draw(lambda s: torch.randn(
            s, generator=generator.generator, device=device, dtype=dtype), shape)
    return torch.randn(shape, generator=generator, device=device, dtype=dtype)


def rand(generator, shape, *, device=None) -> torch.Tensor:
    device = device if device is not None else generator.device
    if isinstance(generator, RowDraws):
        return generator._draw(lambda s: torch.rand(
            s, generator=generator.generator, device=device), shape)
    return torch.rand(shape, generator=generator, device=device)


def randint(generator, low: int, high: int, shape, *, device=None) -> torch.Tensor:
    device = device if device is not None else generator.device
    if isinstance(generator, RowDraws):
        return generator._draw(lambda s: torch.randint(
            low, high, s, generator=generator.generator, device=device), shape)
    return torch.randint(low, high, shape, generator=generator, device=device)
