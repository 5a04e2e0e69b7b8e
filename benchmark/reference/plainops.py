"""Plain PyTorch in place of the port's kernels, for the benchmark's reference.

Frozen copies of the plain versions beside ``psg_tpu_torch/ops``: GroupNorm +
SiLU, scaled dot-product attention with fp32 scores and softmax, and the VAE's
spatial cross-attention body.  Every function runs the same arithmetic on any
device and keeps autograd's own gradient; nothing here launches a kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .layers import group_norm

# the widths the port's spatial kernel is built for; the copied attention
# module routes them here and every other width through conv + sdpa, as the
# port does, so both sides compute the same function
CHANNELS = (8, 16, 32, 64)


def group_norm_silu(params, x, num_groups: int, *, eps: float = 1e-5):
    return F.silu(group_norm(params, x, num_groups, eps=eps))


def sdpa(q, k, v, *, bias=None, scale=None):
    """softmax(q k^T * scale + bias) v in fp32, output in q's dtype."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1)
    dt = torch.promote_types(torch.promote_types(q.dtype, k.dtype), v.dtype)
    return torch.matmul(p.to(dt).float(), v.float()).to(q.dtype)


def split_heads(t, num_heads: int, compat_reshape: bool):
    """[B, S, C] -> [B, heads, S, C/heads] (the reference's raw reshape with
    ``compat_reshape``)."""
    b, s, c = t.shape
    hd = c // num_heads
    if compat_reshape:
        return t.reshape(b, num_heads, hd, s).transpose(2, 3)
    return t.reshape(b, s, num_heads, hd).transpose(1, 2)


def fused_spatial_xattn(xn, residual, k, v, wq, bq, wp, bp, *, num_heads: int,
                        text_bias=None, scale=None, compat_reshape: bool = False):
    """proj(softmax(q K^T * scale + bias) V) + residual over xn [B, L, C],
    k/v [B, S, C]; fp32 throughout, output in xn's dtype."""
    b, l, c = xn.shape
    if scale is None:
        scale = 1.0 / ((c // num_heads) ** 0.5)
    kh = split_heads(k.float(), num_heads, compat_reshape)
    vh = split_heads(v.float(), num_heads, compat_reshape)
    q = torch.matmul(xn.float(), wq.float()) + bq.float()
    qh = (q * scale).reshape(b, l, num_heads, c // num_heads).transpose(1, 2)
    s = torch.matmul(qh, kh.transpose(-1, -2))
    if text_bias is not None:
        s = s + text_bias.reshape(b, 1, 1, -1).float()
    p = torch.softmax(s, dim=-1)
    o = torch.matmul(p, vh).transpose(1, 2).reshape(b, l, c)
    out = torch.matmul(o, wp.float()) + bp.float() + residual.float()
    return out.to(xn.dtype)
