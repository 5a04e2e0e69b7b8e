# Frozen copy of psg_tpu_torch/nn/embeddings.py for the benchmark's plain reference;
# calls into the port's kernels, where it has any, go to plainops.py.
"""Fixed sinusoidal timestep embedding (port of ``psg_tpu/nn/embeddings.py``).

``coeff = exp(-ln(10000) * arange(half) / (half - 1))`` — the divisor is
``half - 1``, as in the reference's TimestepEmbedding — then concat(sin, cos).
"""

from __future__ import annotations

import math

import torch


def sinusoidal_time_embedding(timesteps, dim: int):
    """timesteps: [B] (int or float) -> [B, dim] fp32."""
    half = dim // 2
    coeff = torch.exp(
        torch.arange(half, dtype=torch.float32, device=timesteps.device)
        * (-math.log(10000.0) / (half - 1)))
    args = timesteps.float()[:, None] * coeff[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
