"""Stable-Diffusion-family UNet (port of ``psg_tpu/models/sd_unet.py``,
widened to SDXL's layout).

The alternative stage-2 backbone: diffusers' ``UNet2DConditionModel``
topology in functional form, adapted to the 8-channel 27x27 latent.

- conv_in -> down levels -> mid (ResNet, Transformer, ResNet) -> up levels
  -> GN+SiLU -> conv_out; ResnetBlock2D with the time embedding added
  after conv1; Transformer2D blocks with self-attention, cross-attention on
  the text states and a GEGLU feed-forward;
- ``SDUNetSpec`` gives the layout by level: whether a level has attention
  (SD-1.5: every level but the last; SDXL: every level but the first), its
  transformer depth (SDXL: 1/2/10, reversed on the way up, the mid block at
  the last level's) and its heads; 1x1-conv or linear ``proj_in`` /
  ``proj_out`` (``linear_projection``); and SDXL's ``text_time`` added
  embedding (``addition_time_embed_dim``): six time ids embedded
  sinusoidally, concatenated with a pooled text vector, through a 2-layer
  MLP into the time embedding.  ``SDUNetSpec.from_diffusers`` reads a
  diffusers ``unet/config.json``; ``sd15()`` and ``sdxl()`` are the two
  published layouts;
- the odd ladder: each upsampler targets the next skip's size (27/14/7/4),
  with nearest-neighbour picks at half-pixel centres as
  ``jax.image.resize(method="nearest")`` makes them (``F.interpolate``'s
  ``"nearest-exact"``; plain ``"nearest"`` picks other rows, 4->7 and 14->27);
- ``adapt_in_channels`` / ``adapt_out_channels``: conv_in / conv_out's
  channel axis sliced, or tiled and averaged, to the latent's channels;
- ``sd_wrapper_*``: the text projection and LayerNorm (eps 1e-6) when the
  text width differs from ``cross_attention_dim``; with ``text_time``, the
  pooled projection (the text states' masked mean through a linear layer);
- ``sd_training_mask``: the three training modes as boolean trees.

The tree is the JAX package's (``bridge`` carries it across): the ``None``
``attentions`` of the levels without attention stay ``None``.  A
transformer whose depth is 1 with conv projections (all of SD-1.5's) keeps
one flat dict, ``{norm, proj_in, norm1, attn1, norm2, attn2, norm3,
ff_proj, ff_out, proj_out}``; any other (all of SDXL's) is ``{norm,
proj_in, transformer_blocks: [{norm1 ... ff_out}], proj_out}``.  The added
embedding is ``unet.add_embedding.{linear_1, linear_2}``, the pooled
projection ``pooled_projection``.  Conv kernels are OIHW, linear kernels
``[in, out]``.  Every resnet's two norms and ``conv_norm_out`` go through
``ops.group_norm_silu`` (45 calls an evaluation at SD-1.5's 22 resnets, 35
at SDXL's 17), every attention core through ``ops.sdpa`` (two a
transformer block: 32 at SD-1.5's 16, 140 at SDXL's 70); the transformer's
own GroupNorm (eps 1e-6) is plain, as in the JAX package.  Spans
(``utils/profiling.span``, no-ops off the profiler): ``psg.sdunet.eval``
around an evaluation, ``psg.sdunet.down{i}``, ``psg.sdunet.mid`` and
``psg.sdunet.up{i}`` around its levels.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from psg_tpu_torch import ops
from psg_tpu_torch.core import tree
from psg_tpu_torch.models.unet import pooled_text
from psg_tpu_torch.nn.layers import (
    conv2d,
    conv2d_init,
    group_norm,
    group_norm_init,
    layer_norm,
    layer_norm_init,
    linear,
    linear_init,
)
from psg_tpu_torch.utils.profiling import span

TIME_IDS = 6   # text_time: original size, crop corner, target size (h, w each)
_DOWN, _UP = "CrossAttnDownBlock2D", "CrossAttnUpBlock2D"
_PLAIN = {"DownBlock2D": "UpBlock2D", _DOWN: _UP}


@dataclasses.dataclass(frozen=True)
class SDUNetSpec:
    """The UNet's shape.  The first seven fields are SD-1.5's spec; the rest
    give the layout by level, ``None`` for SD-1.5's (attention on every
    level but the last, one transformer block).  A spec iterates as those
    seven fields followed by the layout fields that differ from SD-1.5's
    layout at its number of levels, so that an SD-1.5 spec compares, as a
    tuple, equal to the seven-field tuple that older readers build."""

    in_channels: int = 4
    out_channels: int = 4
    channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    num_heads: Union[int, Tuple[int, ...]] = 8      # every level, or by level
    cross_attention_dim: int = 768
    norm_groups: int = 32
    attention: Optional[Tuple[bool, ...]] = None    # by down level
    transformer_depth: Optional[Tuple[int, ...]] = None   # by down level
    linear_projection: bool = False
    addition_time_embed_dim: int = 0                # text_time's; 0: none
    text_embeds_dim: int = 0                        # text_time's pooled width

    _LAYOUT = ("attention", "transformer_depth", "linear_projection",
               "addition_time_embed_dim", "text_embeds_dim")

    def __post_init__(self):
        n = len(self.channels)
        if self.attention == tuple(lvl < n - 1 for lvl in range(n)):
            object.__setattr__(self, "attention", None)
        if self.transformer_depth == (1,) * n:
            object.__setattr__(self, "transformer_depth", None)

    def __iter__(self):
        yield from (self.in_channels, self.out_channels, self.channels,
                    self.layers_per_block, self.num_heads, self.cross_attention_dim,
                    self.norm_groups)
        for name in self._LAYOUT:
            value = getattr(self, name)
            if value != SDUNetSpec.__dataclass_fields__[name].default:
                yield value

    def _replace(self, **changes) -> "SDUNetSpec":
        return dataclasses.replace(self, **changes)

    # -- by level ---------------------------------------------------------------

    def has_attention(self, lvl: int) -> bool:
        """Whether down level ``lvl`` (and its mirror on the way up) has
        transformers."""
        if self.attention is None:
            return lvl < len(self.channels) - 1
        return self.attention[lvl]

    def depth(self, lvl: int) -> int:
        """Transformer blocks in each transformer of down level ``lvl`` (the
        mid block: the last level's)."""
        return 1 if self.transformer_depth is None else self.transformer_depth[lvl]

    def heads(self, lvl: int) -> int:
        return self.num_heads if isinstance(self.num_heads, int) else self.num_heads[lvl]

    @property
    def text_time(self) -> bool:
        return self.addition_time_embed_dim > 0

    # -- published layouts ------------------------------------------------------

    @classmethod
    def sd15(cls) -> "SDUNetSpec":
        return cls()

    @classmethod
    def sdxl(cls) -> "SDUNetSpec":
        """The SDXL base 1.0 UNet (stabilityai/stable-diffusion-xl-base-1.0,
        ``unet/config.json``): 2,567,463,684 parameters at 4 channels."""
        return cls(channels=(320, 640, 1280), num_heads=(5, 10, 20),
                   cross_attention_dim=2048, attention=(False, True, True),
                   transformer_depth=(1, 2, 10), linear_projection=True,
                   addition_time_embed_dim=256, text_embeds_dim=1280)

    @classmethod
    def tiny_test(cls, text_dim: int = 32) -> "SDUNetSpec":
        return cls(channels=(16, 24, 32, 32), num_heads=2,
                   cross_attention_dim=text_dim, norm_groups=8)

    @classmethod
    def from_diffusers(cls, cfg: dict) -> "SDUNetSpec":
        """The spec of a diffusers ``UNet2DConditionModel`` config dict.  Its
        up blocks must mirror its down blocks; ``attention_head_dim`` holds
        head counts where ``num_attention_heads`` is unset, as diffusers
        reads it."""
        down = list(cfg["down_block_types"])
        up = list(cfg["up_block_types"])
        if any(k not in _PLAIN for k in down) or up != [_PLAIN[k] for k in reversed(down)]:
            raise ValueError(f"unsupported block types: down {down}, up {up}")
        n = len(down)

        def by_level(v):
            return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n

        heads = cfg.get("num_attention_heads") or cfg["attention_head_dim"]
        heads = heads if isinstance(heads, int) else tuple(heads)
        kind = cfg.get("addition_embed_type")
        if kind not in (None, "text_time"):
            raise ValueError(f"unsupported addition_embed_type {kind!r}")
        time_dim = int(cfg["addition_time_embed_dim"]) if kind else 0
        return cls(in_channels=cfg["in_channels"], out_channels=cfg["out_channels"],
                   channels=tuple(cfg["block_out_channels"]),
                   layers_per_block=cfg["layers_per_block"], num_heads=heads,
                   cross_attention_dim=cfg["cross_attention_dim"],
                   norm_groups=cfg["norm_num_groups"],
                   attention=tuple(k == _DOWN for k in down),
                   transformer_depth=by_level(cfg.get("transformer_layers_per_block", 1)),
                   linear_projection=bool(cfg.get("use_linear_projection", False)),
                   addition_time_embed_dim=time_dim,
                   text_embeds_dim=(int(cfg["projection_class_embeddings_input_dim"])
                                    - TIME_IDS * time_dim) if kind else 0)


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


def _block_init(gen, dim, kv_dim):
    """One transformer block: self-attention, cross-attention, GEGLU."""
    d = gen.device
    return {
        "norm1": layer_norm_init(dim, d),
        "attn1": _attention_init(gen, dim, dim),
        "norm2": layer_norm_init(dim, d),
        "attn2": _attention_init(gen, dim, kv_dim),
        "norm3": layer_norm_init(dim, d),
        "ff_proj": linear_init(gen, dim, dim * 8, init="torch"),   # GEGLU
        "ff_out": linear_init(gen, dim * 4, dim, init="torch"),
    }


def _block_apply(p, seq, text, heads, text_bias=None, dtype=None):
    n1 = layer_norm(p["norm1"], seq)
    seq = seq + _attention_apply(p["attn1"], n1, n1, heads, dtype=dtype)
    seq = seq + _attention_apply(p["attn2"], layer_norm(p["norm2"], seq), text,
                                 heads, bias=text_bias, dtype=dtype)
    # GEGLU (diffusers' order: the first half is the value, the second the gate)
    ff = linear(p["ff_proj"], layer_norm(p["norm3"], seq), dtype=dtype)
    val, gate = ff.chunk(2, dim=-1)
    return seq + linear(p["ff_out"], val * F.gelu(gate), dtype=dtype)


def _transformer_init(gen, dim, kv_dim, depth: int = 1, linear_projection: bool = False):
    d = gen.device

    def proj():
        if linear_projection:
            return linear_init(gen, dim, dim, init="torch")
        return conv2d_init(gen, dim, dim, 1, init="torch")

    if depth == 1 and not linear_projection:     # SD-1.5's flat dict
        p = {"norm": group_norm_init(dim, d), "proj_in": proj()}
        p.update(_block_init(gen, dim, kv_dim))
        p["proj_out"] = proj()
        return p
    p = {"norm": group_norm_init(dim, d), "proj_in": proj()}
    p["transformer_blocks"] = [_block_init(gen, dim, kv_dim) for _ in range(depth)]
    p["proj_out"] = proj()
    return p


def _transformer_apply(p, x, text, spec: SDUNetSpec, heads: int, text_bias=None,
                       dtype=None):
    b, h, w, c = x.shape
    residual = x
    xn = group_norm(p["norm"], x, spec.norm_groups, eps=1e-6)
    if spec.linear_projection:
        seq = linear(p["proj_in"], xn.reshape(b, h * w, c), dtype=dtype)
    else:
        seq = conv2d(p["proj_in"], xn, stride=1, padding=0, dtype=dtype).reshape(b, h * w, c)
    for bp in p.get("transformer_blocks") or (p,):
        seq = _block_apply(bp, seq, text, heads, text_bias=text_bias, dtype=dtype)
    if spec.linear_projection:
        out = linear(p["proj_out"], seq, dtype=dtype).reshape(b, h, w, c)
    else:
        out = conv2d(p["proj_out"], seq.reshape(b, h, w, c), stride=1, padding=0,
                     dtype=dtype)
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
    }
    if spec.text_time:
        width = spec.text_embeds_dim + TIME_IDS * spec.addition_time_embed_dim
        p["add_embedding"] = {"linear_1": linear_init(gen, width, temb, init="torch"),
                              "linear_2": linear_init(gen, temb, temb, init="torch")}
    p["down_blocks"], p["up_blocks"] = [], []

    def transformer(lvl, dim):
        return _transformer_init(gen, dim, spec.cross_attention_dim, spec.depth(lvl),
                                 spec.linear_projection)

    # down: a downsampler on all but the last level
    cin = ch[0]
    for lvl in range(nlvl):
        has_attn = spec.has_attention(lvl)
        blk = {"resnets": [], "attentions": [] if has_attn else None}
        for j in range(spec.layers_per_block):
            blk["resnets"].append(_resnet_init(gen, cin if j == 0 else ch[lvl], ch[lvl],
                                               temb))
            if has_attn:
                blk["attentions"].append(transformer(lvl, ch[lvl]))
        if lvl < nlvl - 1:
            blk["downsampler"] = conv2d_init(gen, ch[lvl], ch[lvl], 3, init="torch")
        p["down_blocks"].append(blk)
        cin = ch[lvl]

    p["mid_block"] = {
        "resnets": [_resnet_init(gen, ch[-1], ch[-1], temb),
                    _resnet_init(gen, ch[-1], ch[-1], temb)],
        "attentions": [transformer(nlvl - 1, ch[-1])],
    }

    # up: the down levels mirrored (channels, attention, depth and heads)
    rev = list(reversed(ch))
    prev = ch[-1]
    for lvl in range(nlvl):
        cout = rev[lvl]
        down_lvl = nlvl - 1 - lvl
        has_attn = spec.has_attention(down_lvl)
        blk = {"resnets": [], "attentions": [] if has_attn else None}
        for j in range(spec.layers_per_block + 1):
            # skip channels: the matching down level's activations
            skip_ch = rev[min(lvl + 1, nlvl - 1)] if j == spec.layers_per_block else cout
            res_in = (prev if j == 0 else cout) + skip_ch
            blk["resnets"].append(_resnet_init(gen, res_in, cout, temb))
            if has_attn:
                blk["attentions"].append(transformer(down_lvl, cout))
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


_SPAN_EVAL = "psg.sdunet.eval"
_SPAN_MID = "psg.sdunet.mid"


@functools.lru_cache(maxsize=None)
def _level_spans(nlvl: int):
    """The span names of the down and up levels, by level."""
    return (tuple(f"psg.sdunet.down{i}" for i in range(nlvl)),
            tuple(f"psg.sdunet.up{i}" for i in range(nlvl)))


def sd_unet_apply(params, sample, timesteps, text_states,
                  spec: SDUNetSpec = SDUNetSpec.sd15(), *, text_bias=None,
                  text_embeds=None, time_ids=None, dtype=None):
    """sample: [B, H, W, in_ch]; timesteps: [B]; text_states: [B, S,
    cross_attention_dim]; ``text_bias``: None or the [B, 1, 1, S] key bias.
    With ``text_time``: ``text_embeds`` [B, text_embeds_dim] and
    ``time_ids`` [B, 6]."""
    with span(_SPAN_EVAL):
        return _sd_unet_body(params, sample, timesteps, text_states, spec,
                             text_bias=text_bias, text_embeds=text_embeds,
                             time_ids=time_ids, dtype=dtype)


def _sd_unet_body(params, sample, timesteps, text_states, spec: SDUNetSpec, *,
                  text_bias=None, text_embeds=None, time_ids=None, dtype=None):
    ch = spec.channels
    nlvl = len(ch)
    g = spec.norm_groups
    down_spans, up_spans = _level_spans(nlvl)

    t = sd_timestep_embedding(timesteps, ch[0])
    te = params["time_embedding"]
    temb = linear(te["linear_2"], F.silu(linear(te["linear_1"], t, dtype=dtype)),
                  dtype=dtype)
    if spec.text_time:
        if text_embeds is None or time_ids is None:
            raise ValueError("a text_time UNet takes text_embeds and time_ids")
        b = time_ids.shape[0]
        tid = sd_timestep_embedding(time_ids.reshape(-1), spec.addition_time_embed_dim)
        added = torch.cat([text_embeds.float(), tid.reshape(b, -1)], dim=-1)
        ae = params["add_embedding"]
        temb = temb + linear(ae["linear_2"], F.silu(linear(ae["linear_1"], added,
                                                           dtype=dtype)), dtype=dtype)

    def transformer(tp, x, lvl):
        return _transformer_apply(tp, x, text_states, spec, spec.heads(lvl),
                                  text_bias=text_bias, dtype=dtype)

    x = conv2d(params["conv_in"], sample, stride=1, padding=1, dtype=dtype)
    skips = [x]
    for lvl, blk in enumerate(params["down_blocks"]):
        with span(down_spans[lvl]):
            for j, rp in enumerate(blk["resnets"]):
                x = _resnet_apply(rp, x, temb, g, dtype=dtype)
                if blk["attentions"] is not None:
                    x = transformer(blk["attentions"][j], x, lvl)
                skips.append(x)
            if "downsampler" in blk:
                x = conv2d(blk["downsampler"], x, stride=2, padding=1, dtype=dtype)
                skips.append(x)

    with span(_SPAN_MID):
        mp = params["mid_block"]
        x = _resnet_apply(mp["resnets"][0], x, temb, g, dtype=dtype)
        x = transformer(mp["attentions"][0], x, nlvl - 1)
        x = _resnet_apply(mp["resnets"][1], x, temb, g, dtype=dtype)

    for lvl, blk in enumerate(params["up_blocks"]):
        with span(up_spans[lvl]):
            for j, rp in enumerate(blk["resnets"]):
                x = torch.cat([x, skips.pop()], dim=-1)
                x = _resnet_apply(rp, x, temb, g, dtype=dtype)
                if blk["attentions"] is not None:
                    x = transformer(blk["attentions"][j], x, nlvl - 1 - lvl)
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
    channels, the text projection and LayerNorm when ``text_dim`` is not
    ``spec.cross_attention_dim``, and with ``text_time`` the pooled
    projection ``text_dim`` -> ``spec.text_embeds_dim``."""
    unet = base_params if base_params is not None else sd_unet_init(gen, spec)
    unet = adapt_out_channels(adapt_in_channels(unet, latent_dim), latent_dim)
    p = {"unet": unet}
    if text_dim != spec.cross_attention_dim:
        p["text_projection"] = linear_init(gen, text_dim, spec.cross_attention_dim,
                                           init="xavier", gain=0.02)
        p["text_layer_norm"] = layer_norm_init(spec.cross_attention_dim, gen.device)
    if spec.text_time:
        p["pooled_projection"] = linear_init(gen, text_dim, spec.text_embeds_dim,
                                             init="torch")
    return p


def sd_wrapper_apply(params, sample, timesteps, text_emb, spec: SDUNetSpec, *,
                     text_bias=None, text_mask=None, time_ids=None, dtype=None):
    """``text_emb``: [B, S, text_dim].  With ``text_time``: ``text_mask``
    [B, S] (None: every position) for the pooled text and ``time_ids``
    [B, 6]."""
    text_embeds = None
    if "pooled_projection" in params:
        text_embeds = linear(params["pooled_projection"], pooled_text(text_emb, text_mask),
                             dtype=dtype)
    if "text_projection" in params:
        text_emb = linear(params["text_projection"], text_emb, dtype=dtype)
        text_emb = layer_norm(params["text_layer_norm"], text_emb, eps=1e-6)
    return sd_unet_apply(params["unet"], sample, timesteps, text_emb, spec,
                         text_bias=text_bias, text_embeds=text_embeds, time_ids=time_ids,
                         dtype=dtype)


TRAINING_MODES = ("full", "cross_attention_only", "decoder_only")


def sd_training_mask(params, mode: str = "full"):
    """Boolean tree of the trainable leaves for the reference's three modes:
    ``full``; ``cross_attention_only`` (every attn2 and norm2, conv_in,
    conv_out); ``decoder_only`` (mid, up, conv_out, and attn2/norm2 of the
    down blocks).  The text projection and LayerNorm, and the pooled
    projection, always train."""
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
                blocks = ap.get("transformer_blocks")
                pairs = (zip(block_mask["attentions"][j]["transformer_blocks"], blocks)
                         if blocks is not None else [(block_mask["attentions"][j], ap)])
                for bm, bp in pairs:
                    bm["attn2"] = fill(bp["attn2"], True)
                    bm["norm2"] = fill(bp["norm2"], True)

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
    for key in ("text_projection", "text_layer_norm", "pooled_projection"):
        if key in params:
            out[key] = fill(params[key], True)
    return out
