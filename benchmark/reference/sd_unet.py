# Frozen copy of psg_tpu_torch/models/sd_unet.py for the benchmark's plain reference;
# calls into the port's kernels, where it has any, go to plainops.py.
"""Stable-Diffusion-1.5-family UNet (port of ``psg_tpu/models/sd_unet.py``).

The alternative stage-2 backbone: diffusers' ``UNet2DConditionModel``
topology in functional form, adapted to the 8-channel 27x27 latent.

- conv_in -> 3x CrossAttnDownBlock + DownBlock -> mid (ResNet, Transformer,
  ResNet) -> UpBlock + 3x CrossAttnUpBlock -> GN+SiLU -> conv_out;
  ResnetBlock2D with the time embedding added after conv1; Transformer2D
  blocks with self-attention, cross-attention on the text states and a
  GEGLU feed-forward;
- the odd 27/14/7/4 ladder: each upsampler targets the next skip's size,
  with nearest-neighbour picks at half-pixel centres as
  ``jax.image.resize(method="nearest")`` makes them (``F.interpolate``'s
  ``"nearest-exact"``; plain ``"nearest"`` picks other rows, 4->7 and 14->27);
- ``adapt_in_channels`` / ``adapt_out_channels``: conv_in / conv_out's
  channel axis sliced, or tiled and averaged, to the latent's channels;
- ``sd_wrapper_*``: the text projection and LayerNorm (eps 1e-6) when the
  text width differs from ``cross_attention_dim``;
- ``sd_training_mask``: the three training modes as boolean trees.

The tree is the JAX package's (``bridge`` carries it across): the ``None``
``attentions`` of the levels without attention stay ``None``.  Conv kernels
are OIHW, linear kernels ``[in, out]``.  Every resnet's two norms and
``conv_norm_out`` go through ``ops.group_norm_silu`` (45 calls an evaluation
at SD-1.5's 22 resnets), every attention core through ``ops.sdpa`` (32
calls at 16 transformers); the transformer's own GroupNorm (eps 1e-6) is
plain, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import plainops as ops
from . import tree
from .layers import (
    conv2d,
    conv2d_init,
    group_norm,
    group_norm_init,
    layer_norm,
    layer_norm_init,
    linear,
    linear_init,
)


class SDUNetSpec(NamedTuple):
    in_channels: int = 4
    out_channels: int = 4
    channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_heads: int = 8
    cross_attention_dim: int = 768
    norm_groups: int = 32

    @classmethod
    def sd15(cls) -> "SDUNetSpec":
        return cls()

    @classmethod
    def tiny_test(cls, text_dim: int = 32) -> "SDUNetSpec":
        return cls(channels=(16, 24, 32, 32), num_heads=2,
                   cross_attention_dim=text_dim, norm_groups=8)


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------


def _resnet_init(gen, cin, cout, temb_dim):
    p = {
        "norm1": group_norm_init(cin, gen.device),
        "conv1": conv2d_init(gen, cin, cout, 3, init="torch"),
        "time_emb_proj": linear_init(gen, temb_dim, cout, init="torch"),
        "norm2": group_norm_init(cout, gen.device),
        "conv2": conv2d_init(gen, cout, cout, 3, init="torch"),
    }
    if cin != cout:
        p["conv_shortcut"] = conv2d_init(gen, cin, cout, 1, init="torch")
    return p


def _resnet_apply(p, x, temb, groups, dtype=None):
    residual = x
    h = ops.group_norm_silu(p["norm1"], x, groups, eps=1e-5)
    h = conv2d(p["conv1"], h, stride=1, padding=1, dtype=dtype)
    t = linear(p["time_emb_proj"], F.silu(temb), dtype=dtype)
    h = h + t[:, None, None, :]
    h = ops.group_norm_silu(p["norm2"], h, groups, eps=1e-5)
    h = conv2d(p["conv2"], h, stride=1, padding=1, dtype=dtype)
    if "conv_shortcut" in p:
        residual = conv2d(p["conv_shortcut"], residual, stride=1, padding=0, dtype=dtype)
    return h + residual


def _attention_init(gen, dim, kv_dim):
    return {
        "to_q": {"w": linear_init(gen, dim, dim, init="xavier")["w"]},
        "to_k": {"w": linear_init(gen, kv_dim, dim, init="xavier")["w"]},
        "to_v": {"w": linear_init(gen, kv_dim, dim, init="xavier")["w"]},
        "to_out": linear_init(gen, dim, dim, init="torch"),
    }


def _attention_apply(p, x, kv, heads, bias=None, dtype=None):
    b, length, c = x.shape
    s = kv.shape[1]
    hd = c // heads
    if dtype is not None:
        x = x.to(dtype)
    kv = kv.to(x.dtype)
    # q/k/v: one product with fp32 accumulation, rounded once to x's dtype
    q = torch.matmul(x, p["to_q"]["w"].to(x.dtype))
    k = torch.matmul(kv, p["to_k"]["w"].to(x.dtype))
    v = torch.matmul(kv, p["to_v"]["w"].to(x.dtype))
    q = q.reshape(b, length, heads, hd).transpose(1, 2)
    k = k.reshape(b, s, heads, hd).transpose(1, 2)
    v = v.reshape(b, s, heads, hd).transpose(1, 2)
    out = ops.sdpa(q, k, v, bias=bias)
    out = out.transpose(1, 2).reshape(b, length, c)
    return linear(p["to_out"], out, dtype=dtype)


def _transformer_init(gen, dim, kv_dim):
    d = gen.device
    return {
        "norm": group_norm_init(dim, d),
        "proj_in": conv2d_init(gen, dim, dim, 1, init="torch"),
        "norm1": layer_norm_init(dim, d),
        "attn1": _attention_init(gen, dim, dim),
        "norm2": layer_norm_init(dim, d),
        "attn2": _attention_init(gen, dim, kv_dim),
        "norm3": layer_norm_init(dim, d),
        "ff_proj": linear_init(gen, dim, dim * 8, init="torch"),   # GEGLU
        "ff_out": linear_init(gen, dim * 4, dim, init="torch"),
        "proj_out": conv2d_init(gen, dim, dim, 1, init="torch"),
    }


def _transformer_apply(p, x, text, spec: SDUNetSpec, text_bias=None, dtype=None):
    b, h, w, c = x.shape
    residual = x
    xn = group_norm(p["norm"], x, spec.norm_groups, eps=1e-6)
    xn = conv2d(p["proj_in"], xn, stride=1, padding=0, dtype=dtype)
    seq = xn.reshape(b, h * w, c)

    n1 = layer_norm(p["norm1"], seq)
    seq = seq + _attention_apply(p["attn1"], n1, n1, spec.num_heads, dtype=dtype)
    seq = seq + _attention_apply(p["attn2"], layer_norm(p["norm2"], seq), text,
                                 spec.num_heads, bias=text_bias, dtype=dtype)
    # GEGLU (diffusers' order: the first half is the value, the second the gate)
    ff = linear(p["ff_proj"], layer_norm(p["norm3"], seq), dtype=dtype)
    val, gate = ff.chunk(2, dim=-1)
    seq = seq + linear(p["ff_out"], val * F.gelu(gate), dtype=dtype)

    out = seq.reshape(b, h, w, c)
    out = conv2d(p["proj_out"], out, stride=1, padding=0, dtype=dtype)
    return out + residual


def nearest_resize(x, size: int):
    """[B, H, W, C] -> [B, size, size, C], nearest neighbour at half-pixel
    centres (source row ``floor((i + 0.5) * H / size)``), as
    ``jax.image.resize(method="nearest")``."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(size, size), mode="nearest-exact")
    return y.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# full UNet
# ---------------------------------------------------------------------------


def sd_unet_init(gen, spec: SDUNetSpec = SDUNetSpec.sd15()):
    ch = spec.channels
    nlvl = len(ch)
    temb = ch[0] * 4
    p = {
        "conv_in": conv2d_init(gen, spec.in_channels, ch[0], 3, init="torch"),
        "time_embedding": {
            "linear_1": linear_init(gen, ch[0], temb, init="torch"),
            "linear_2": linear_init(gen, temb, temb, init="torch"),
        },
        "down_blocks": [],
        "up_blocks": [],
    }
    # down: CrossAttn x3 + a plain DownBlock; a downsampler on all but the last
    cin = ch[0]
    for lvl in range(nlvl):
        has_attn = lvl < nlvl - 1
        blk = {"resnets": [], "attentions": [] if has_attn else None}
        for j in range(spec.layers_per_block):
            blk["resnets"].append(_resnet_init(gen, cin if j == 0 else ch[lvl], ch[lvl],
                                               temb))
            if has_attn:
                blk["attentions"].append(
                    _transformer_init(gen, ch[lvl], spec.cross_attention_dim))
        if lvl < nlvl - 1:
            blk["downsampler"] = conv2d_init(gen, ch[lvl], ch[lvl], 3, init="torch")
        p["down_blocks"].append(blk)
        cin = ch[lvl]

    p["mid_block"] = {
        "resnets": [_resnet_init(gen, ch[-1], ch[-1], temb),
                    _resnet_init(gen, ch[-1], ch[-1], temb)],
        "attentions": [_transformer_init(gen, ch[-1], spec.cross_attention_dim)],
    }

    # up: a plain UpBlock + CrossAttn x3 (channels reversed)
    rev = list(reversed(ch))
    prev = ch[-1]
    for lvl in range(nlvl):
        cout = rev[lvl]
        has_attn = lvl > 0
        blk = {"resnets": [], "attentions": [] if has_attn else None}
        for j in range(spec.layers_per_block + 1):
            # skip channels: the matching down level's activations
            skip_ch = rev[min(lvl + 1, nlvl - 1)] if j == spec.layers_per_block else cout
            res_in = (prev if j == 0 else cout) + skip_ch
            blk["resnets"].append(_resnet_init(gen, res_in, cout, temb))
            if has_attn:
                blk["attentions"].append(
                    _transformer_init(gen, cout, spec.cross_attention_dim))
        if lvl < nlvl - 1:
            blk["upsampler"] = conv2d_init(gen, cout, cout, 3, init="torch")
        p["up_blocks"].append(blk)
        prev = cout

    p["conv_norm_out"] = group_norm_init(ch[0], gen.device)
    p["conv_out"] = conv2d_init(gen, ch[0], spec.out_channels, 3, init="torch")
    return p


def sd_timestep_embedding(timesteps, dim: int):
    """diffusers' ``Timesteps(dim, flip_sin_to_cos=True, freq_shift=0)``:
    the exponent's denominator is ``half`` (not half - 1) and cos comes
    first."""
    half = dim // 2
    coeff = torch.exp(torch.arange(half, dtype=torch.float32, device=timesteps.device)
                      * (-math.log(10000.0) / half))
    args = timesteps.float()[:, None] * coeff[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def sd_unet_apply(params, sample, timesteps, text_states,
                  spec: SDUNetSpec = SDUNetSpec.sd15(), *, text_bias=None, dtype=None):
    """sample: [B, H, W, in_ch]; timesteps: [B]; text_states: [B, S,
    cross_attention_dim]; ``text_bias``: None or the [B, 1, 1, S] key bias."""
    ch = spec.channels
    g = spec.norm_groups

    t = sd_timestep_embedding(timesteps, ch[0])
    te = params["time_embedding"]
    temb = linear(te["linear_2"], F.silu(linear(te["linear_1"], t, dtype=dtype)),
                  dtype=dtype)

    x = conv2d(params["conv_in"], sample, stride=1, padding=1, dtype=dtype)
    skips = [x]
    for blk in params["down_blocks"]:
        for j, rp in enumerate(blk["resnets"]):
            x = _resnet_apply(rp, x, temb, g, dtype=dtype)
            if blk["attentions"] is not None:
                x = _transformer_apply(blk["attentions"][j], x, text_states, spec,
                                       text_bias=text_bias, dtype=dtype)
            skips.append(x)
        if "downsampler" in blk:
            x = conv2d(blk["downsampler"], x, stride=2, padding=1, dtype=dtype)
            skips.append(x)

    mp = params["mid_block"]
    x = _resnet_apply(mp["resnets"][0], x, temb, g, dtype=dtype)
    x = _transformer_apply(mp["attentions"][0], x, text_states, spec,
                           text_bias=text_bias, dtype=dtype)
    x = _resnet_apply(mp["resnets"][1], x, temb, g, dtype=dtype)

    for blk in params["up_blocks"]:
        for j, rp in enumerate(blk["resnets"]):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = _resnet_apply(rp, x, temb, g, dtype=dtype)
            if blk["attentions"] is not None:
                x = _transformer_apply(blk["attentions"][j], x, text_states, spec,
                                       text_bias=text_bias, dtype=dtype)
        if "upsampler" in blk:
            # nearest upsample to the NEXT skip's size (27/14/7/4 ladder)
            x = nearest_resize(x, skips[-1].shape[1])
            x = conv2d(blk["upsampler"], x, stride=1, padding=1, dtype=dtype)

    x = ops.group_norm_silu(params["conv_norm_out"], x, g, eps=1e-5)
    return conv2d(params["conv_out"], x, stride=1, padding=1, dtype=dtype)


# ---------------------------------------------------------------------------
# channel adaptation (conv kernels OIHW: input channels axis 1, output axis 0)
# ---------------------------------------------------------------------------


def _adapt(w, target: int, axis: int):
    orig = w.shape[axis]
    if target < orig:
        return w.narrow(axis, 0, target)
    reps, rem = divmod(target, orig)
    parts = [w] * reps + ([w.narrow(axis, 0, rem)] if rem else [])
    return torch.cat(parts, dim=axis) / reps


def adapt_in_channels(params, target: int):
    """Slice, or tile and average, conv_in's input channels."""
    w = params["conv_in"]["w"]
    if target == w.shape[1]:
        return params
    out = dict(params)
    out["conv_in"] = {"w": _adapt(w, target, 1), "b": params["conv_in"]["b"]}
    return out


def adapt_out_channels(params, target: int):
    """Slice, or tile and average, conv_out's output channels and bias."""
    w, b = params["conv_out"]["w"], params["conv_out"]["b"]
    if target == w.shape[0]:
        return params
    out = dict(params)
    out["conv_out"] = {"w": _adapt(w, target, 0), "b": _adapt(b, target, 0)}
    return out


# ---------------------------------------------------------------------------
# the wrapper: text projection and the training modes
# ---------------------------------------------------------------------------


def sd_wrapper_init(gen, spec: SDUNetSpec, text_dim: int, *, latent_dim: int = 8,
                    base_params=None):
    """The wrapper's params: the SD UNet (``base_params``, e.g. converted
    SD-1.5 weights, else drawn from ``gen``) adapted to ``latent_dim``
    channels, and the text projection and LayerNorm when ``text_dim`` is
    not ``spec.cross_attention_dim``."""
    unet = base_params if base_params is not None else sd_unet_init(gen, spec)
    unet = adapt_out_channels(adapt_in_channels(unet, latent_dim), latent_dim)
    p = {"unet": unet}
    if text_dim != spec.cross_attention_dim:
        p["text_projection"] = linear_init(gen, text_dim, spec.cross_attention_dim,
                                           init="xavier", gain=0.02)
        p["text_layer_norm"] = layer_norm_init(spec.cross_attention_dim, gen.device)
    return p


def sd_wrapper_apply(params, sample, timesteps, text_emb, spec: SDUNetSpec, *,
                     text_bias=None, dtype=None):
    if "text_projection" in params:
        text_emb = linear(params["text_projection"], text_emb, dtype=dtype)
        text_emb = layer_norm(params["text_layer_norm"], text_emb, eps=1e-6)
    return sd_unet_apply(params["unet"], sample, timesteps, text_emb, spec,
                         text_bias=text_bias, dtype=dtype)


TRAINING_MODES = ("full", "cross_attention_only", "decoder_only")


def sd_training_mask(params, mode: str = "full"):
    """Boolean tree of the trainable leaves for the reference's three modes:
    ``full``; ``cross_attention_only`` (every attn2 and norm2, conv_in,
    conv_out); ``decoder_only`` (mid, up, conv_out, and attn2/norm2 of the
    down blocks).  The text projection and LayerNorm always train."""
    if mode not in TRAINING_MODES:
        raise ValueError(f"unknown training mode {mode!r}")

    def fill(t, value):
        return tree.map(lambda _: value, t)

    unet = params["unet"]
    if mode == "full":
        mask_unet = fill(unet, True)
    else:
        def unfreeze_cross_attn(block_mask, block_params):
            for j, ap in enumerate(block_params.get("attentions") or []):
                block_mask["attentions"][j]["attn2"] = fill(ap["attn2"], True)
                block_mask["attentions"][j]["norm2"] = fill(ap["norm2"], True)

        mask_unet = fill(unet, False)
        if mode == "cross_attention_only":
            for bm, bp in zip(mask_unet["down_blocks"], unet["down_blocks"]):
                unfreeze_cross_attn(bm, bp)
            for bm, bp in zip(mask_unet["up_blocks"], unet["up_blocks"]):
                unfreeze_cross_attn(bm, bp)
            unfreeze_cross_attn(mask_unet["mid_block"], unet["mid_block"])
            mask_unet["conv_in"] = fill(unet["conv_in"], True)
            mask_unet["conv_out"] = fill(unet["conv_out"], True)
        else:
            mask_unet["mid_block"] = fill(unet["mid_block"], True)
            mask_unet["up_blocks"] = fill(unet["up_blocks"], True)
            mask_unet["conv_out"] = fill(unet["conv_out"], True)
            for bm, bp in zip(mask_unet["down_blocks"], unet["down_blocks"]):
                unfreeze_cross_attn(bm, bp)

    out = {"unet": mask_unet}
    if "text_projection" in params:
        out["text_projection"] = fill(params["text_projection"], True)
        out["text_layer_norm"] = fill(params["text_layer_norm"], True)
    return out
