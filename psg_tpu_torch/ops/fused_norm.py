"""GroupNorm + SiLU on channels-last tensors: Hopper kernel and plain version.

Port of ``psg_tpu/ops/fused_norm.py::fused_group_norm_silu`` (the TPU
kernel's ``pallas_call`` at line 83).  The kernel is
``csrc/group_norm_silu.cu``: a split reduction (per row-chunk partial
statistics, a fixed-order combine per (sample, group), then a normalize
pass) with two-pass/Chan statistics in fp32; its source note says why.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from psg_tpu_torch.nn.layers import group_norm
from psg_tpu_torch.ops import cuda_build as cb

KERNEL = cb.KernelLibrary(
    "group_norm_silu", "group_norm_silu.cu",
    {"psg_group_norm_silu": (ctypes.c_int, [ctypes.c_void_p] * 6
                             + [ctypes.c_int] * 5
                             + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p])})

MAX_GROUPS = 32
# elements of one sample a block reduces in pass 1 (fp32: 32 KB)
CHUNK_ELEMENTS = 8192


def group_norm_silu_plain(params, x, num_groups: int, *, eps: float = 1e-5,
                          silu: bool = True):
    """The kernel's function in plain PyTorch: two-pass fp32 statistics
    (``nn.layers.group_norm``), output in the input dtype, then SiLU."""
    y = group_norm(params, x, num_groups, eps=eps)
    return F.silu(y) if silu else y


def _launch(params, x, num_groups: int, eps: float, silu: bool):
    b, c = x.shape[0], x.shape[-1]
    cb.check_cuda_tensor("group_norm_silu", x, cb.DTYPE_CODES)
    if num_groups < 1 or num_groups > MAX_GROUPS or c % num_groups:
        raise ValueError(f"group_norm_silu: {num_groups} groups over {c} channels "
                         f"(takes 1..{MAX_GROUPS} groups dividing C)")
    scale = params["scale"].float().contiguous()
    bias = params["bias"].float().contiguous()
    cb.check_cuda_tensor("group_norm_silu scale", scale)
    cb.check_cuda_tensor("group_norm_silu bias", bias)
    if scale.numel() != c or bias.numel() != c:
        raise ValueError("group_norm_silu: scale/bias must have C elements")
    s = x.numel() // (b * c)
    rows = max(1, CHUNK_ELEMENTS // c)
    nchunks = -(-s // rows)
    # per-chunk partial (mean, M2), then per-group (mean, rstd)
    part = torch.empty((b, nchunks, num_groups, 2), dtype=torch.float32,
                       device=x.device)
    stats = torch.empty((b, num_groups, 2), dtype=torch.float32, device=x.device)
    y = torch.empty_like(x)
    rc = KERNEL.lib().psg_group_norm_silu(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        part.data_ptr(), stats.data_ptr(), b, s, c, num_groups, rows, float(eps),
        int(silu),
        cb.DTYPE_CODES[x.dtype], cb.stream_ptr())
    KERNEL.check(rc)
    return y


def fused_group_norm_silu(params, x, num_groups: int, *, eps: float = 1e-5,
                          silu: bool = True):
    """x: [B, ..., C] -> silu(group_norm(x)) (or group_norm(x), ``silu=False``).

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
    raises."""
    if x.device.type == "cpu":
        return group_norm_silu_plain(params, x, num_groups, eps=eps, silu=silu)
    return _launch(params, x, num_groups, eps, silu)
