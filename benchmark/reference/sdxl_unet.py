"""The SDXL base UNet in plain PyTorch, for the benchmark's reference.

Written from diffusers' ``UNet2DConditionModel`` equations for the published
configuration (``stabilityai/stable-diffusion-xl-base-1.0``,
``unet/config.json``; arXiv:2307.01952), read from the configuration's
``sd_unet`` section: ``block_out_channels`` (320, 640, 1280);
``DownBlock2D`` then ``CrossAttnDownBlock2D`` x2, mirrored on the way up;
``transformer_layers_per_block`` (1, 2, 10), reversed on the way up, the mid
block at the last level's 10; ``attention_head_dim`` (5, 10, 20) holding
head counts (head width 64); ``use_linear_projection``; cross-attention
width 2048; a GEGLU feed-forward; ``addition_embed_type`` ``text_time``:

- ``temb = time_embedding(Timesteps(320)(t))``;
- ``temb += add_embedding(cat(text_embeds, Timesteps(256)(time_ids).reshape(B, 1536)))``,
  ``Timesteps(d)`` being ``flip_sin_to_cos=True, freq_shift=0``;
- ResnetBlock2D: ``conv2(silu(gn2(conv1(silu(gn1(x))) + lin(silu(temb))))) +
  shortcut(x)``, GroupNorm eps 1e-5;
- Transformer2DModel: ``x + proj_out(blocks(proj_in(gn(x))))`` over the
  flattened positions, GroupNorm eps 1e-6, linear ``proj_in``/``proj_out``;
  a block ``s += attn1(ln1(s)); s += attn2(ln2(s), text); s +=
  ff(ln3(s))``, LayerNorm eps 1e-5, ``to_q/k/v`` without bias,
  ``ff = W2 (a * gelu(g))`` with ``[a, g] = W1 x``;
- a downsampler (3x3 conv, stride 2) after every level but the last, an
  upsampler (nearest, 3x3 conv) after every up level but the last.

Everything is float32; the caller runs it with TF32 off
(``precision.float32``).  Each operand of a matrix product or convolution
passes ``precision.operand`` (the control lowers them).

Departures from the published model, as the port runs it:

- 8 latent channels in and out (the repo's VAE latent) where SDXL has 4:
  conv_in's input and conv_out's output channels tiled and averaged
  (``sd_unet.adapt_in_channels``/``adapt_out_channels``);
- a 27x27 latent (215x215 sprites) where SDXL has 128x128: each upsampler
  targets the next skip's size (27/14/7), nearest at half-pixel centres;
- the text states are BERT-base's (768 wide, ``text_len`` tokens) through a
  linear projection to 2048 and a LayerNorm (eps 1e-6), in place of the
  concatenated CLIP ViT-L and OpenCLIP ViT-bigG penultimate states;
- ``text_embeds`` is the masked mean of the BERT states through a linear
  768 -> 1280 (``pooled_projection``), in place of OpenCLIP-bigG's pooled
  and projected output;
- ``time_ids`` are the constant (S, S, 0, 0, S, S) of a sprite of size S.

The tree is the port's (``psg_tpu_torch/models/sd_unet.py``), path for path,
so the harness hands both the same leaves: every transformer is ``{norm,
proj_in, transformer_blocks: [...], proj_out}``, linear kernels ``[in,
out]``, conv kernels OIHW.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from . import plainops
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
from .precision import operand
from .sd_unet import (
    adapt_in_channels,
    adapt_out_channels,
    nearest_resize,
    sd_timestep_embedding,
)

TIME_IDS = 6


class XLSpec(NamedTuple):
    in_channels: int
    out_channels: int
    channels: Tuple[int, ...]
    layers_per_block: int
    heads_by_level: Tuple[int, ...]
    cross_attention_dim: int
    norm_groups: int
    attention: Tuple[bool, ...]
    transformer_depth: Tuple[int, ...]
    addition_time_embed_dim: int
    text_embeds_dim: int
    linear_projection: bool = True

    def has_attention(self, lvl: int) -> bool:
        return self.attention[lvl]

    def depth(self, lvl: int) -> int:
        return self.transformer_depth[lvl]

    def heads(self, lvl: int) -> int:
        return self.heads_by_level[lvl]


def xl_spec(u: dict) -> XLSpec:
    """The spec of a diffusers UNet config with SDXL's layout: linear
    projections, the ``text_time`` embedding, up blocks mirroring the down
    blocks."""
    if not u.get("use_linear_projection") or u.get("addition_embed_type") != "text_time":
        raise ValueError("the SDXL reference takes linear projections and text_time")
    down = list(u["down_block_types"])
    n = len(down)
    mirror = {"DownBlock2D": "UpBlock2D", "CrossAttnDownBlock2D": "CrossAttnUpBlock2D"}
    if list(u["up_block_types"]) != [mirror[k] for k in reversed(down)]:
        raise ValueError("the SDXL reference takes up blocks that mirror the down blocks")

    def by_level(v):
        return tuple(v) if isinstance(v, (list, tuple)) else (v,) * n

    time_dim = int(u["addition_time_embed_dim"])
    return XLSpec(
        in_channels=u["in_channels"], out_channels=u["out_channels"],
        channels=tuple(u["block_out_channels"]), layers_per_block=u["layers_per_block"],
        heads_by_level=by_level(u.get("num_attention_heads") or u["attention_head_dim"]),
        cross_attention_dim=u["cross_attention_dim"], norm_groups=u["norm_num_groups"],
        attention=tuple(k == "CrossAttnDownBlock2D" for k in down),
        transformer_depth=by_level(u.get("transformer_layers_per_block", 1)),
        addition_time_embed_dim=time_dim,
        text_embeds_dim=int(u["projection_class_embeddings_input_dim"]) - TIME_IDS * time_dim)


# ---------------------------------------------------------------------------
# parameters (the port's tree)
# ---------------------------------------------------------------------------


def _resnet_init(gen, cin, cout, temb):
    p = {"norm1": group_norm_init(cin, gen.device),
         "conv1": conv2d_init(gen, cin, cout, 3),
         "time_emb_proj": linear_init(gen, temb, cout),
         "norm2": group_norm_init(cout, gen.device),
         "conv2": conv2d_init(gen, cout, cout, 3)}
    if cin != cout:
        p["conv_shortcut"] = conv2d_init(gen, cin, cout, 1)
    return p


def _attn_init(gen, dim, kv_dim):
    return {"to_q": {"w": linear_init(gen, dim, dim, init="xavier")["w"]},
            "to_k": {"w": linear_init(gen, kv_dim, dim, init="xavier")["w"]},
            "to_v": {"w": linear_init(gen, kv_dim, dim, init="xavier")["w"]},
            "to_out": linear_init(gen, dim, dim)}


def _transformer_init(gen, dim, kv_dim, depth):
    d = gen.device
    return {"norm": group_norm_init(dim, d),
            "proj_in": linear_init(gen, dim, dim),
            "transformer_blocks": [
                {"norm1": layer_norm_init(dim, d), "attn1": _attn_init(gen, dim, dim),
                 "norm2": layer_norm_init(dim, d), "attn2": _attn_init(gen, dim, kv_dim),
                 "norm3": layer_norm_init(dim, d),
                 "ff_proj": linear_init(gen, dim, 8 * dim),
                 "ff_out": linear_init(gen, 4 * dim, dim)} for _ in range(depth)],
            "proj_out": linear_init(gen, dim, dim)}


def xl_unet_init(gen, spec: XLSpec):
    ch, n = spec.channels, len(spec.channels)
    temb = 4 * ch[0]
    add_in = spec.text_embeds_dim + TIME_IDS * spec.addition_time_embed_dim
    p = {"conv_in": conv2d_init(gen, spec.in_channels, ch[0], 3),
         "time_embedding": {"linear_1": linear_init(gen, ch[0], temb),
                            "linear_2": linear_init(gen, temb, temb)},
         "add_embedding": {"linear_1": linear_init(gen, add_in, temb),
                           "linear_2": linear_init(gen, temb, temb)},
         "down_blocks": [], "up_blocks": []}
    cin = ch[0]
    for lvl in range(n):
        attn = spec.has_attention(lvl)
        blk = {"resnets": [], "attentions": [] if attn else None}
        for j in range(spec.layers_per_block):
            blk["resnets"].append(_resnet_init(gen, cin if j == 0 else ch[lvl], ch[lvl], temb))
            if attn:
                blk["attentions"].append(_transformer_init(
                    gen, ch[lvl], spec.cross_attention_dim, spec.depth(lvl)))
        if lvl < n - 1:
            blk["downsampler"] = conv2d_init(gen, ch[lvl], ch[lvl], 3)
        p["down_blocks"].append(blk)
        cin = ch[lvl]
    p["mid_block"] = {"resnets": [_resnet_init(gen, ch[-1], ch[-1], temb),
                                  _resnet_init(gen, ch[-1], ch[-1], temb)],
                      "attentions": [_transformer_init(gen, ch[-1], spec.cross_attention_dim,
                                                       spec.depth(n - 1))]}
    rev = list(reversed(ch))
    prev = ch[-1]
    for i in range(n):
        cout, mirror = rev[i], n - 1 - i
        attn = spec.has_attention(mirror)
        blk = {"resnets": [], "attentions": [] if attn else None}
        for j in range(spec.layers_per_block + 1):
            skip = rev[min(i + 1, n - 1)] if j == spec.layers_per_block else cout
            blk["resnets"].append(_resnet_init(gen, (prev if j == 0 else cout) + skip, cout,
                                               temb))
            if attn:
                blk["attentions"].append(_transformer_init(
                    gen, cout, spec.cross_attention_dim, spec.depth(mirror)))
        if i < n - 1:
            blk["upsampler"] = conv2d_init(gen, cout, cout, 3)
        p["up_blocks"].append(blk)
        prev = cout
    p["conv_norm_out"] = group_norm_init(ch[0], gen.device)
    p["conv_out"] = conv2d_init(gen, ch[0], spec.out_channels, 3)
    return p


def xl_wrapper_init(gen, spec: XLSpec, text_dim: int, *, latent_dim: int):
    """{unet (adapted to ``latent_dim`` channels), text_projection,
    text_layer_norm, pooled_projection}."""
    unet = adapt_out_channels(adapt_in_channels(xl_unet_init(gen, spec), latent_dim),
                              latent_dim)
    return {"unet": unet,
            "text_projection": linear_init(gen, text_dim, spec.cross_attention_dim,
                                           init="xavier", gain=0.02),
            "text_layer_norm": layer_norm_init(spec.cross_attention_dim, gen.device),
            "pooled_projection": linear_init(gen, text_dim, spec.text_embeds_dim)}


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------


def _resnet(p, x, temb, groups):
    h = plainops.group_norm_silu(p["norm1"], x, groups, eps=1e-5)
    h = conv2d(p["conv1"], h, stride=1, padding=1)
    h = h + linear(p["time_emb_proj"], F.silu(temb))[:, None, None, :]
    h = plainops.group_norm_silu(p["norm2"], h, groups, eps=1e-5)
    h = conv2d(p["conv2"], h, stride=1, padding=1)
    if "conv_shortcut" in p:
        x = conv2d(p["conv_shortcut"], x, stride=1, padding=0)
    return x + h


def _attention(p, x, kv, heads, bias=None):
    b, lq, c = x.shape
    lk, hd = kv.shape[1], c // heads

    def split(t, n):
        return t.reshape(b, n, heads, hd).transpose(1, 2)

    q = split(torch.matmul(operand(x), operand(p["to_q"]["w"])), lq)
    k = split(torch.matmul(operand(kv), operand(p["to_k"]["w"])), lk)
    v = split(torch.matmul(operand(kv), operand(p["to_v"]["w"])), lk)
    o = plainops.sdpa(q, k, v, bias=bias).transpose(1, 2).reshape(b, lq, c)
    return linear(p["to_out"], o)


def transformer_2d(p, x, text, heads, groups, text_bias=None):
    """Transformer2DModel with linear projections over [B, H, W, C]."""
    b, h, w, c = x.shape
    s = linear(p["proj_in"], group_norm(p["norm"], x, groups, eps=1e-6).reshape(b, h * w, c))
    for bp in p["transformer_blocks"]:
        n1 = layer_norm(bp["norm1"], s, eps=1e-5)
        s = s + _attention(bp["attn1"], n1, n1, heads)
        s = s + _attention(bp["attn2"], layer_norm(bp["norm2"], s, eps=1e-5), text, heads,
                           bias=text_bias)
        a, g = linear(bp["ff_proj"], layer_norm(bp["norm3"], s, eps=1e-5)).chunk(2, dim=-1)
        s = s + linear(bp["ff_out"], a * F.gelu(g))
    return x + linear(p["proj_out"], s).reshape(b, h, w, c)


def xl_unet_apply(params, sample, timesteps, text, spec: XLSpec, *, text_embeds, time_ids,
                  text_bias=None):
    """sample [B, H, W, C_in], timesteps [B], text [B, S, 2048], text_embeds
    [B, 1280], time_ids [B, 6] -> [B, H, W, C_out]."""
    ch, n, g = spec.channels, len(spec.channels), spec.norm_groups
    te, ae = params["time_embedding"], params["add_embedding"]
    temb = linear(te["linear_2"], F.silu(linear(te["linear_1"],
                                                sd_timestep_embedding(timesteps, ch[0]))))
    b = time_ids.shape[0]
    tid = sd_timestep_embedding(time_ids.reshape(-1), spec.addition_time_embed_dim)
    added = torch.cat([text_embeds, tid.reshape(b, -1)], dim=-1)
    temb = temb + linear(ae["linear_2"], F.silu(linear(ae["linear_1"], added)))

    x = conv2d(params["conv_in"], sample, stride=1, padding=1)
    skips = [x]
    for lvl, blk in enumerate(params["down_blocks"]):
        for j, rp in enumerate(blk["resnets"]):
            x = _resnet(rp, x, temb, g)
            if blk["attentions"] is not None:
                x = transformer_2d(blk["attentions"][j], x, text, spec.heads(lvl), g, text_bias)
            skips.append(x)
        if "downsampler" in blk:
            x = conv2d(blk["downsampler"], x, stride=2, padding=1)
            skips.append(x)
    mp = params["mid_block"]
    x = _resnet(mp["resnets"][0], x, temb, g)
    x = transformer_2d(mp["attentions"][0], x, text, spec.heads(n - 1), g, text_bias)
    x = _resnet(mp["resnets"][1], x, temb, g)
    for i, blk in enumerate(params["up_blocks"]):
        for j, rp in enumerate(blk["resnets"]):
            x = _resnet(rp, torch.cat([x, skips.pop()], dim=-1), temb, g)
            if blk["attentions"] is not None:
                x = transformer_2d(blk["attentions"][j], x, text, spec.heads(n - 1 - i), g,
                                   text_bias)
        if "upsampler" in blk:
            x = conv2d(blk["upsampler"], nearest_resize(x, skips[-1].shape[1]), stride=1,
                       padding=1)
    x = plainops.group_norm_silu(params["conv_norm_out"], x, g, eps=1e-5)
    return conv2d(params["conv_out"], x, stride=1, padding=1)


def masked_mean(states, mask):
    """[B, S, D] averaged over the positions ``mask`` [B, S] keeps."""
    m = mask.to(states.dtype)[:, :, None]
    return (states * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


def xl_wrapper_apply(params, sample, timesteps, text_emb, spec: XLSpec, *, text_mask,
                     time_ids, text_bias=None):
    """The wrapper: the pooled text from the BERT states, the projected and
    normalized text states, then the UNet."""
    text_embeds = linear(params["pooled_projection"], masked_mean(text_emb, text_mask))
    text = layer_norm(params["text_layer_norm"],
                      linear(params["text_projection"], text_emb), eps=1e-6)
    return xl_unet_apply(params["unet"], sample, timesteps, text, spec,
                         text_embeds=text_embeds, time_ids=time_ids, text_bias=text_bias)
