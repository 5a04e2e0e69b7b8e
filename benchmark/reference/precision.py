"""The precision the reference's matmul and convolution operands carry.

By default an operand passes unchanged (float32).  ``lowered(fn)`` routes
every operand of ``layers.linear`` and ``layers.conv2d`` through ``fn`` for
the duration of a block: the control run computes them in fp8 (``fp8``),
the step below bfloat16, to show that the comparison fails it.
"""

from __future__ import annotations

import contextlib

import torch

_ROUND = []


def operand(t: torch.Tensor) -> torch.Tensor:
    return _ROUND[-1](t) if _ROUND else t


@contextlib.contextmanager
def lowered(fn):
    _ROUND.append(fn)
    try:
        yield
    finally:
        _ROUND.pop()


@contextlib.contextmanager
def float32():
    """Float32 matmuls and convolutions with TF32 off, for the reference."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8(t: torch.Tensor) -> torch.Tensor:
    """Round to float8 e4m3 with one per-tensor scale (absmax to 448, as fp8
    matmuls scale their operands), back in the operand's dtype."""
    if not t.is_floating_point():
        return t
    amax = t.detach().abs().amax().float().clamp_min(1e-12)
    scale = 448.0 / amax
    q = ((t.detach().float() * scale).to(torch.float8_e4m3fn).float() / scale).to(t.dtype)
    # the rounded value forward; the gradient passes straight through
    return t + (q - t.detach())
