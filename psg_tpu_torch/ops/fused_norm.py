"""GroupNorm + SiLU on channels-last tensors: Hopper kernel and plain version.

Port of ``psg_tpu/ops/fused_norm.py::fused_group_norm_silu`` (the TPU
kernel's ``pallas_call`` at line 83).  The kernel is
``csrc/group_norm_silu.cu``: one launch per call where a sample fits a
thread-block cluster (every UNet site in bf16), with the statistics
exchanged through distributed shared memory; two launches and one workspace
otherwise.  Statistics are two-pass in fp32 and summed in a fixed order;
its source note gives the boundary between the paths.

Gradients: the TPU kernel has no VJP, and neither has this kernel.  Where a
gradient is asked for, ``GroupNormSiLU`` (a ``torch.autograd.Function``)
launches the kernel forward and, in the backward, recomputes the plain
version from the saved inputs and takes its autograd gradient for x, scale
and bias.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from psg_tpu_torch.nn.layers import group_norm
from psg_tpu_torch.ops import cuda_build as cb

KERNEL = cb.KernelLibrary(
    "group_norm_silu", "group_norm_silu.cu",
    {"psg_group_norm_silu": (ctypes.c_int, [ctypes.c_void_p] * 5
                             + [ctypes.c_int] * 4
                             + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                                ctypes.c_void_p]),
     "psg_group_norm_silu_workspace_bytes": (ctypes.c_longlong, [ctypes.c_int] * 5)})

MAX_GROUPS = 32


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
    lib = KERNEL.lib()
    code = cb.DTYPE_CODES[x.dtype]
    ws = lib.psg_group_norm_silu_workspace_bytes(b, s, c, num_groups, code)
    if ws < 0:
        raise ValueError(f"group_norm_silu: the kernel does not take C={c} "
                         f"({x.dtype})")
    # the split path's per-chunk (mean, M2); none on the one-launch path
    part = torch.empty(ws // 4, dtype=torch.float32, device=x.device) if ws else None
    y = torch.empty_like(x)
    rc = lib.psg_group_norm_silu(
        x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
        part.data_ptr() if part is not None else None, b, s, c, num_groups,
        float(eps), int(silu), code, cb.stream_ptr())
    KERNEL.check(rc)
    return y


class GroupNormSiLU(torch.autograd.Function):
    """``forward_impl(params, x, num_groups, eps, silu)`` computes the output
    (the kernel's launch on the card); the backward differentiates the plain
    version, recomputed from the saved inputs."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, silu, forward_impl):
        ctx.save_for_backward(x, scale, bias)
        ctx.args = (num_groups, eps, silu)
        return forward_impl({"scale": scale, "bias": bias}, x, num_groups, eps, silu)

    @staticmethod
    def backward(ctx, grad_out):
        x, scale, bias = ctx.saved_tensors
        num_groups, eps, silu = ctx.args
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(need)
                      for t, need in zip((x, scale, bias), ctx.needs_input_grad)]
            y = group_norm_silu_plain({"scale": inputs[1], "bias": inputs[2]}, inputs[0],
                                      num_groups, eps=eps, silu=silu)
            wanted = [t for t in inputs if t.requires_grad]
            grads = iter(torch.autograd.grad(y, wanted, grad_out))
        return (*(next(grads) if t.requires_grad else None for t in inputs),
                None, None, None, None)


def group_norm_silu_autograd(params, x, num_groups: int, *, eps: float = 1e-5,
                             silu: bool = True, forward_impl=_launch):
    """``GroupNormSiLU`` on ``params``' scale and bias (``forward_impl``
    defaults to the kernel; the CPU tests pass the plain version)."""
    return GroupNormSiLU.apply(x, params["scale"], params["bias"], num_groups, eps,
                               silu, forward_impl)


def fused_group_norm_silu(params, x, num_groups: int, *, eps: float = 1e-5,
                          silu: bool = True):
    """x: [B, ..., C] -> silu(group_norm(x)) (or group_norm(x), ``silu=False``).

    A CPU tensor takes the plain version; a CUDA tensor takes the kernel or
    raises, through ``GroupNormSiLU`` when a gradient is asked for."""
    if x.device.type == "cpu":
        return group_norm_silu_plain(params, x, num_groups, eps=eps, silu=silu)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, params["scale"], params["bias"])):
        return group_norm_silu_autograd(params, x, num_groups, eps=eps, silu=silu)
    return _launch(params, x, num_groups, eps, silu)
