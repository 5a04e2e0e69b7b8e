"""Kernel layer.

Each hot op has a hand-written Hopper kernel (``csrc/``) and, in the same
module, a plain PyTorch version of the same function:

- ``fused_norm``       GroupNorm + SiLU        (``csrc/group_norm_silu.cu``)
- ``flash_attention``  attention forward       (``csrc/flash_attention.cu``)
                       and backward            (``csrc/flash_attention_bwd.cu``)
- ``spatial_xattn``    VAE spatial attention   (``csrc/spatial_xattn.cu``)

A wrapper takes the plain version for a tensor on the CPU, and for a CUDA
tensor launches its kernel or raises; nothing falls back.  Each kernel
library counts its launches (``launch_counts``; the counters
``launch.<library>`` of ``utils.profiling``).

Training differentiates every kernel through a ``torch.autograd.Function``
(``fused_norm.GroupNormSiLU``, ``flash_attention.FlashSDPA``,
``spatial_xattn.SpatialXattn``): the kernel runs forward.  ``FlashSDPA``'s
backward launches its own kernel (``flash_attention.BWD_KERNEL``, counted as
``flash_attention_bwd``: one launch for each attention call whose q, k or v
needs a gradient); the other two recompute the plain version (for the
spatial block, its fp32 body) and take its gradient, as the TPU package's
``custom_vjp`` does for its spatial kernel, and launch nothing backward.

``sdpa`` dispatches on the bias's shape as the TPU package's ``ops.sdpa``
does (``psg_tpu/ops/__init__.py``): ``None`` or a per-key ``[B, 1, 1, Lk]``
bias goes to the flash kernel, any other bias that broadcasts to
``[B, H, Lq, Lk]`` (CLIP's causal + padding mask) to ``sdpa_plain``, the
reference's ``sdpa_xla``, on either device.  The kernel refuses such a bias,
as the TPU kernel does, so the dispatch hides no kernel.

``sdpa`` and ``group_norm_silu`` are marked ``utils.graphs.eager_between``:
a CUDA graph captured in pieces (the serving UNet's, ``models.unet``)
leaves their calls out and makes them from the host at each replay.
"""

from __future__ import annotations

import torch

from psg_tpu_torch.ops import flash_attention, fused_norm, spatial_xattn
from psg_tpu_torch.utils import profiling
from psg_tpu_torch.utils.graphs import eager_between

KERNELS = (fused_norm.KERNEL, flash_attention.KERNEL, spatial_xattn.KERNEL,
           flash_attention.BWD_KERNEL)


def launch_counts():
    return {k.name: k.launches for k in KERNELS}


def reset_launch_counts() -> None:
    profiling.reset_counts("launch.")


@eager_between
def group_norm_silu(params, x, num_groups: int, *, eps: float = 1e-5):
    """silu(group_norm(x)) over channels-last x."""
    return fused_norm.fused_group_norm_silu(params, x.contiguous(), num_groups,
                                            eps=eps)


@eager_between
def sdpa(q, k, v, *, bias=None, scale=None):
    """Scaled dot-product attention.

    q: [B, H, Lq, D], k/v: [B, H, Lk, D], bias: None, [B, 1, 1, Lk] (the
    flash kernel) or any additive bias that broadcasts to [B, H, Lq, Lk]
    (``sdpa_plain``).
    Head views are passed as they are: the kernel takes strides, and only an
    operand whose last dimension is strided (``compat_reshape``'s K/V) is
    copied.  On the card the output is a [B, H, Lq, D] view of [B, Lq, H, D]
    memory, so ``out.transpose(1, 2).reshape(B, Lq, H * D)`` is a view.
    Mixed dtypes compute in the widest one (as the reference's einsum
    promotion does) and return q's dtype."""
    if not flash_attention.is_key_bias(bias, q.shape[0], k.shape[2]):
        return flash_attention.sdpa_plain(q, k, v, bias=bias, scale=scale)
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    out = flash_attention.flash_sdpa(_rows_contiguous(q.to(dt)),
                                     _rows_contiguous(k.to(dt)),
                                     _rows_contiguous(v.to(dt)), bias=bias, scale=scale)
    return out.to(q.dtype)


def _rows_contiguous(t):
    return t if t.stride(-1) == 1 else t.contiguous()
