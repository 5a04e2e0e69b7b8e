"""Functional layer primitives on NHWC activations (port of ``psg_tpu/nn/layers.py``).

Every layer is a pair: ``*_init(gen, ...) -> params`` (a dict of fp32
tensors) and a plain function over tensors.  Conv kernels are stored OIHW,
linear kernels ``[in, out]``.  Convolutions take the NHWC activation through
``x.permute(0, 3, 1, 2)`` (an NCHW view with channels-last strides) and
explicit symmetric integer padding, which has torch's floor output sizes
(the VAE's k4/s2/p2 conv takes 53 to 27).

``dtype`` follows the JAX package: matmul and conv operands are cast to it;
a linear layer returns fp32 (the JAX dot accumulates into fp32 and keeps
it), a convolution returns ``dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from psg_tpu_torch.nn import init as wi

# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------


def linear_init(gen, in_dim: int, out_dim: int, *, init: str = "torch",
                gain: float = 1.0):
    shape = (in_dim, out_dim)
    if init == "torch":
        w = wi.kaiming_uniform_torch(gen, shape)
        b = wi.torch_default_bias(gen, (out_dim,), in_dim)
    elif init == "xavier":
        w = wi.xavier_uniform(gen, shape, gain=gain)
        b = torch.zeros(out_dim, device=gen.device)
    else:
        raise ValueError(init)
    return {"w": w, "b": b}


def linear(params, x, *, dtype=None):
    w = params["w"]
    if dtype is not None:
        y = torch.matmul(x.to(dtype), w.to(dtype)).float()
    else:
        y = torch.matmul(x, w)
    return y + params["b"].to(y.dtype)


# ---------------------------------------------------------------------------
# Conv2d (NHWC x OIHW -> NHWC)
# ---------------------------------------------------------------------------


def conv2d_init(gen, cin: int, cout: int, kernel: int, *, init: str = "torch",
                gain: float = 1.0):
    shape = (cout, cin, kernel, kernel)
    if init == "torch":
        w = wi.kaiming_uniform_torch(gen, shape)
        b = wi.torch_default_bias(gen, (cout,), cin * kernel * kernel)
    elif init == "kaiming_normal":
        w = wi.kaiming_normal(gen, shape, mode="fan_out")
        b = torch.zeros(cout, device=gen.device)
    elif init == "xavier":
        w = wi.xavier_uniform(gen, shape, gain=gain)
        b = torch.zeros(cout, device=gen.device)
    else:
        raise ValueError(init)
    return {"w": w, "b": b}


def conv2d(params, x, *, stride: int = 1, padding: int = 0, dtype=None):
    """x: [B, H, W, Cin]; params['w']: [Cout, Cin, kh, kw] -> [B, H', W', Cout]."""
    w = params["w"]
    if dtype is not None:
        x, w = x.to(dtype), w.to(dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w, params["b"].to(w.dtype),
                 stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# GroupNorm (channels-last) with the reference's group-count rule
# ---------------------------------------------------------------------------


def channel_constant(values, like: torch.Tensor) -> torch.Tensor:
    """Per-channel constants [C] in ``like``'s dtype on its device, filled
    there: a training step uploads nothing from the host."""
    return torch.stack([torch.full((), float(v), dtype=like.dtype, device=like.device)
                        for v in values])


def largest_group_count(channels: int, max_groups: int = 32) -> int:
    """Largest divisor of ``channels`` that is <= max_groups."""
    g = min(max_groups, channels)
    while channels % g != 0 and g > 1:
        g -= 1
    return max(1, g)


def group_norm_init(channels: int, device=None):
    return {"scale": torch.ones(channels, device=device),
            "bias": torch.zeros(channels, device=device)}


def group_norm(params, x, num_groups: int, *, eps: float = 1e-5):
    """GroupNorm over [B, ..., C]: two-pass statistics per (sample, group) in
    fp32 whatever the input dtype; output in the input dtype."""
    orig_dtype = x.dtype
    xf = x.float()
    b, c = xf.shape[0], xf.shape[-1]
    xg = xf.reshape(b, -1, num_groups, c // num_groups)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    xn = ((xg - mean) * torch.rsqrt(var + eps)).reshape(xf.shape)
    return (xn * params["scale"] + params["bias"]).to(orig_dtype)


# ---------------------------------------------------------------------------
# LayerNorm
# ---------------------------------------------------------------------------


def layer_norm_init(dim: int, device=None):
    return {"scale": torch.ones(dim, device=device),
            "bias": torch.zeros(dim, device=device)}


def layer_norm(params, x, *, eps: float = 1e-5):
    y = F.layer_norm(x.float(), (x.shape[-1],), params["scale"], params["bias"],
                     eps)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Serving-time weight storage
# ---------------------------------------------------------------------------


def prepare_weights(params, dtype=None):
    """Serving layout for a parameter tree (dict leaves named ``"w"``):
    matmul and conv kernels cast to ``dtype`` (biases and norm parameters
    stay fp32), conv kernels stored channels-last so cuDNN's NHWC kernels
    take them without a per-call copy.  Outputs are unchanged: every apply
    function casts ``w`` to the compute dtype anyway."""
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            if k == "w" and isinstance(v, torch.Tensor) and v.ndim >= 2:
                if dtype is not None:
                    v = v.to(dtype)
                if v.ndim == 4:
                    v = v.contiguous(memory_format=torch.channels_last)
                out[k] = v
            else:
                out[k] = prepare_weights(v, dtype)
        return out
    if isinstance(params, list):
        return [prepare_weights(v, dtype) for v in params]
    return params
