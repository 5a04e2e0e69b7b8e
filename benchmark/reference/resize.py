# Frozen copy of psg_tpu_torch/nn/resize.py for the benchmark's plain reference;
# calls into the port's kernels, where it has any, go to plainops.py.
"""Bilinear resize with half-pixel (``align_corners=False``) centres.

Port of ``psg_tpu/nn/resize.py``.  ``F.interpolate(mode="bilinear",
align_corners=False)`` matches ``jax.image.resize(method="linear")`` on the
upsamples the model uses (4->7->14->27, 27->54->108->215); downsampling
would differ (jax antialiases) and does not occur on the path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def bilinear_resize(x, size):
    """x: [B, H, W, C] -> [B, size[0], size[1], C].  bf16 resizes in bf16,
    every other dtype in fp32, as in the JAX package."""
    orig_dtype = x.dtype
    xc = x if orig_dtype == torch.bfloat16 else x.float()
    y = F.interpolate(xc.permute(0, 3, 1, 2), size=tuple(size), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1).to(orig_dtype)
