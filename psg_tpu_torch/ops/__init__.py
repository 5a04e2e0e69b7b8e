"""Kernel layer.

Each hot op has a hand-written Hopper kernel (``csrc/``) and, in the same
module, a plain PyTorch version of the same function:

- ``fused_norm``       GroupNorm + SiLU        (``csrc/group_norm_silu.cu``)
- ``flash_attention``  short-KV attention      (``csrc/flash_attention.cu``)
- ``spatial_xattn``    VAE spatial attention   (``csrc/spatial_xattn.cu``)

A wrapper takes the plain version for a tensor on the CPU, and for a CUDA
tensor launches its kernel or raises; nothing falls back.  Each kernel
library counts its launches (``launch_counts``).
"""

from __future__ import annotations

import torch

from psg_tpu_torch.ops import flash_attention, fused_norm, spatial_xattn

KERNELS = (fused_norm.KERNEL, flash_attention.KERNEL, spatial_xattn.KERNEL)


def launch_counts():
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def group_norm_silu(params, x, num_groups: int, *, eps: float = 1e-5):
    """silu(group_norm(x)) over channels-last x."""
    return fused_norm.fused_group_norm_silu(params, x.contiguous(), num_groups,
                                            eps=eps)


def sdpa(q, k, v, *, bias=None, scale=None):
    """Scaled dot-product attention.

    q: [B, H, Lq, D], k/v: [B, H, Lk, D], bias: None or [B, 1, 1, Lk].
    Mixed dtypes compute in the widest one (as the reference's einsum
    promotion does) and return q's dtype."""
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    out = flash_attention.flash_sdpa(
        q.to(dt).contiguous(), k.to(dt).contiguous(), v.to(dt).contiguous(),
        bias=bias, scale=scale)
    return out.to(q.dtype)
