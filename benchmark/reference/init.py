# Frozen copy of psg_tpu_torch/nn/init.py for the benchmark's plain reference;
# calls into the port's kernels, where it has any, go to plainops.py.
"""Weight initializers with the distributions ``psg_tpu/nn/init.py`` uses.

Conv kernels are OIHW and linear kernels ``[in, out]`` here.  Draws come from
a ``torch.Generator``; they follow the same distributions as the JAX package
but not the same numbers (parity tests carry JAX parameters across with
``models.bridge`` instead).
"""

from __future__ import annotations

import math

import torch


def _fans(shape):
    if len(shape) == 4:  # OIHW
        o, i, kh, kw = shape
        return i * kh * kw, o * kh * kw
    if len(shape) == 2:  # [in, out]
        return shape[0], shape[1]
    raise ValueError(f"unsupported shape {shape}")


def _uniform(gen, shape, bound):
    u = torch.rand(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (2.0 * u - 1.0) * bound


def kaiming_normal(gen, shape, mode: str = "fan_out"):
    """He normal with relu gain (torch kaiming_normal_)."""
    fan_in, fan_out = _fans(shape)
    std = math.sqrt(2.0) / math.sqrt(fan_out if mode == "fan_out" else fan_in)
    return std * torch.randn(shape, generator=gen, device=gen.device)


def kaiming_uniform_torch(gen, shape):
    """torch's default layer init: kaiming_uniform_(a=sqrt(5)), bound 1/sqrt(fan_in)."""
    fan_in, _ = _fans(shape)
    return _uniform(gen, shape, 1.0 / math.sqrt(fan_in))


def torch_default_bias(gen, shape, fan_in: int):
    return _uniform(gen, shape, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0)


def xavier_uniform(gen, shape, gain: float = 1.0):
    fan_in, fan_out = _fans(shape)
    return _uniform(gen, shape, gain * math.sqrt(6.0 / (fan_in + fan_out)))
