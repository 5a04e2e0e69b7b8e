"""Attention modules (port of ``psg_tpu/nn/attention.py``).

1. ``mha`` — ``torch.nn.MultiheadAttention(batch_first=True)`` semantics
   with the fused in-projection ``[C, 3C]`` split into thirds, used by the
   UNet's self- and cross-attention.
2. ``spatial_cross_attention`` — the VAE decoder's pixel-query / text-key
   block: GroupNorm -> 1x1-conv Q -> linear K/V -> attention -> 1x1-conv
   proj -> residual.

``compat_reshape`` reproduces the reference's raw [B,S,C] -> [B,H,hd,S]
reshape of K/V (a fixed permutation that reference-trained checkpoints
learned through); the default is the conventional head split.

Dispatch on the card: every attention core goes through the short-KV flash
kernel (``ops.sdpa``), except the spatial sites whose C the fused spatial
kernel is built for (``ops.spatial_xattn.CHANNELS``, all <= 64), which take
that kernel — it keeps Wq, Wp and all heads' K/V in shared memory, and that
bounds C, not a speed measurement.
"""

from __future__ import annotations

from typing import Optional

import torch

from psg_tpu_torch import ops
from psg_tpu_torch.core import draws
from psg_tpu_torch.nn import init as wi
from psg_tpu_torch.nn.layers import (
    conv2d,
    conv2d_init,
    group_norm,
    group_norm_init,
    largest_group_count,
    linear,
    linear_init,
)
from psg_tpu_torch.ops.spatial_xattn import (
    CHANNELS,
    fused_spatial_xattn,
    split_heads,
)


def mha_init(gen, dim: int, *, gain: Optional[float] = None):
    return {
        "in_proj": {"w": wi.xavier_uniform(gen, (dim, 3 * dim), gain=gain or 1.0),
                    "b": torch.zeros(3 * dim, device=gen.device)},
        "out_proj": linear_init(gen, dim, dim, init="torch"),
    }


def dropout(x, rate: float, keep):
    """Inverted dropout as the JAX package writes it: ``where(keep, x /
    (1 - rate), 0)`` in x's dtype.  ``keep`` is a boolean mask of x's shape,
    or a ``torch.Generator`` on x's device to draw it from; ``None`` or rate
    0 leaves x as it is."""
    if keep is None or rate <= 0.0:
        return x
    if draws.is_source(keep):
        keep = draws.rand(keep, x.shape, device=x.device) < 1.0 - rate
    return torch.where(keep.to(x.device), x / (1.0 - rate), 0.0).to(x.dtype)


def mha(params, q_in, kv_in, num_heads: int, *, bias=None, dtype=None,
        dropout_rate: float = 0.0, dropout_keep=None):
    """Multi-head attention, batch-first.  q_in: [B, Lq, C]; kv_in: [B, Lk, C]
    -> [B, Lq, C].  ``bias``: None or an additive [B, 1, 1, Lk] key bias.
    ``dropout_keep`` (see ``dropout``) drops attention outputs, [B, H, Lq, hd],
    before the heads merge."""
    b, lq, c = q_in.shape
    lk = kv_in.shape[1]
    hd = c // num_heads
    w = params["in_proj"]["w"]
    bb = params["in_proj"]["b"]
    if dtype is not None:
        q_in, kv_in, w = q_in.to(dtype), kv_in.to(dtype), w.to(dtype)
    wq, wk, wv = w[:, :c], w[:, c:2 * c], w[:, 2 * c:]
    bq, bk, bv = bb[:c], bb[c:2 * c], bb[2 * c:]

    q = torch.matmul(q_in, wq).float() + bq
    k = torch.matmul(kv_in, wk).float() + bk
    v = torch.matmul(kv_in, wv).float() + bv
    if dtype is not None:
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)

    q = q.reshape(b, lq, num_heads, hd).transpose(1, 2)
    k = k.reshape(b, lk, num_heads, hd).transpose(1, 2)
    v = v.reshape(b, lk, num_heads, hd).transpose(1, 2)
    out = dropout(ops.sdpa(q, k, v, bias=bias), dropout_rate, dropout_keep)
    out = out.transpose(1, 2).reshape(b, lq, c)
    return linear(params["out_proj"], out, dtype=dtype)


def spatial_cross_attention_init(gen, channels: int, text_dim: int):
    return {
        "norm": group_norm_init(channels, gen.device),
        "q": conv2d_init(gen, channels, channels, 1, init="torch"),
        "k": linear_init(gen, text_dim, channels, init="torch"),
        "v": linear_init(gen, text_dim, channels, init="torch"),
        "proj": conv2d_init(gen, channels, channels, 1, init="torch"),
    }


def spatial_cross_attention(params, x, text_emb, num_heads: int = 8, *,
                            text_bias=None, dtype=None,
                            compat_reshape: bool = False):
    """Pixel-query text-key cross-attention with residual.

    x: [B, H, W, C]; text_emb: [B, S, text_dim] -> [B, H, W, C].
    ``text_bias``: additive [B, 1, 1, S] mask bias for padded text tokens.
    """
    b, h, w, c = x.shape
    hd = c // num_heads
    residual = x
    xn = group_norm(params["norm"], x, largest_group_count(c), eps=1e-5)
    k = linear(params["k"], text_emb, dtype=dtype)  # [B,S,C] fp32
    v = linear(params["v"], text_emb, dtype=dtype)

    if c in CHANNELS:
        # 1x1-conv kernels [Cout, Cin, 1, 1] -> [in, out]
        wq = params["q"]["w"].reshape(c, c).t()
        wp = params["proj"]["w"].reshape(c, c).t()
        if dtype is not None:   # the compute dtype, as psg_tpu/nn/attention.py:168-170
            xn = xn.to(dtype)
            wq, wp = wq.to(dtype), wp.to(dtype)
        out = fused_spatial_xattn(
            xn.reshape(b, h * w, c).contiguous(),
            residual.reshape(b, h * w, c).contiguous(),
            k, v, wq, params["q"]["b"], wp, params["proj"]["b"],
            num_heads=num_heads, text_bias=text_bias,
            compat_reshape=compat_reshape)
        return out.reshape(b, h, w, c)

    q = conv2d(params["q"], xn, stride=1, padding=0, dtype=dtype)
    q = q.reshape(b, h * w, num_heads, hd).transpose(1, 2)  # [B,H,L,D]
    k = split_heads(k, num_heads, compat_reshape)
    v = split_heads(v, num_heads, compat_reshape)
    out = ops.sdpa(q, k, v, bias=text_bias)
    out = out.transpose(1, 2).reshape(b, h, w, c)
    out = conv2d(params["proj"], out, stride=1, padding=0, dtype=dtype)
    return out + residual
