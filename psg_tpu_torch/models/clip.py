"""CLIP (ViT-B/32) for the stage-3 alignment loss (port of
``psg_tpu/models/clip.py``).

A frozen CLIP scores how well a reconstruction matches its caption: the
loss is the negative mean cosine similarity of the image and text
embeddings.  The vision tower is a ViT: the image in [0, 1] resized to 224
(bilinear), CLIP's normalisation, 32x32 patches flattened and projected by
one matmul (bf16 products summed in fp32, as the reference's
``preferred_element_type``), a class token, learned positions, pre-LN
blocks with quick-GELU, then the class token's LayerNorm and projection.
The text tower truncates to ``text_len`` (77), embeds tokens and positions,
runs the same blocks under a causal + padding bias, and pools the last
valid token.

Attention goes through ``ops.sdpa``: the vision tower has no bias, so on the
card it takes the flash kernel; the text tower's ``[B, 1, S, S]`` bias goes
to ``sdpa_plain``, as the reference's ``ops.sdpa`` sends it to
``sdpa_xla``.  Plain functions over a parameter tree in the JAX package's
layout (``models/bridge.py`` carries parameters across unchanged).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from psg_tpu_torch import ops
from psg_tpu_torch.nn.layers import (
    channel_constant,
    layer_norm,
    layer_norm_init,
    linear,
    linear_init,
)
from psg_tpu_torch.nn.resize import bilinear_resize

CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


class ClipConfig(NamedTuple):
    image_size: int = 224
    patch_size: int = 32
    vision_width: int = 768
    vision_layers: int = 12
    vision_heads: int = 12
    text_vocab: int = 49408
    text_width: int = 512
    text_layers: int = 12
    text_heads: int = 8
    text_len: int = 77
    embed_dim: int = 512

    @classmethod
    def b32(cls) -> "ClipConfig":
        return cls()

    @classmethod
    def tiny_test(cls, vocab: int = 128) -> "ClipConfig":
        return cls(image_size=64, patch_size=16, vision_width=32, vision_layers=2,
                   vision_heads=2, text_vocab=vocab, text_width=32, text_layers=2,
                   text_heads=2, text_len=16, embed_dim=32)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def _block_init(gen, width: int):
    return {"ln1": layer_norm_init(width, gen.device),
            "q": linear_init(gen, width, width, init="torch"),
            "k": linear_init(gen, width, width, init="torch"),
            "v": linear_init(gen, width, width, init="torch"),
            "out": linear_init(gen, width, width, init="torch"),
            "ln2": layer_norm_init(width, gen.device),
            "mlp1": linear_init(gen, width, width * 4, init="torch"),
            "mlp2": linear_init(gen, width * 4, width, init="torch")}


def _block_apply(p, x, heads: int, bias=None, dtype=None):
    b, s, w = x.shape

    def split(t):
        return t.reshape(b, s, heads, w // heads).transpose(1, 2)

    xn = layer_norm(p["ln1"], x)
    q, k, v = (split(linear(p[n], xn, dtype=dtype)) for n in ("q", "k", "v"))
    a = ops.sdpa(q, k, v, bias=bias).transpose(1, 2).reshape(b, s, w)
    x = x + linear(p["out"], a, dtype=dtype)
    xn = layer_norm(p["ln2"], x)
    return x + linear(p["mlp2"], quick_gelu(linear(p["mlp1"], xn, dtype=dtype)),
                      dtype=dtype)


def clip_init(gen, cfg: ClipConfig = ClipConfig.b32()):
    """Random CLIP parameters (the reference's distributions; the draws are
    torch's)."""
    dev = gen.device
    n_patches = (cfg.image_size // cfg.patch_size) ** 2
    vw, tw = cfg.vision_width, cfg.text_width

    def normal(shape, scale):
        return scale * torch.randn(shape, generator=gen, device=dev)

    return {
        "vision": {
            "patch": {"w": normal((cfg.patch_size * cfg.patch_size * 3, vw), vw ** -0.5)},
            "cls": normal((vw,), vw ** -0.5),
            "pos": normal((n_patches + 1, vw), vw ** -0.5),
            "ln_pre": layer_norm_init(vw, dev),
            "blocks": [_block_init(gen, vw) for _ in range(cfg.vision_layers)],
            "ln_post": layer_norm_init(vw, dev),
            "proj": normal((vw, cfg.embed_dim), vw ** -0.5),
        },
        "text": {
            "token": normal((cfg.text_vocab, tw), 0.02),
            "pos": normal((cfg.text_len, tw), 0.01),
            "blocks": [_block_init(gen, tw) for _ in range(cfg.text_layers)],
            "ln_final": layer_norm_init(tw, dev),
            "proj": normal((tw, cfg.embed_dim), tw ** -0.5),
        },
    }


def clip_encode_image(params, images01, cfg: ClipConfig, *, dtype=None):
    """images01: [B, H, W, 3] in [0, 1] -> [B, embed_dim] (unnormalized)."""
    v = params["vision"]
    x = bilinear_resize(images01, (cfg.image_size, cfg.image_size))
    x = (x - channel_constant(CLIP_IMAGE_MEAN, x)) / channel_constant(CLIP_IMAGE_STD, x)
    b, p = x.shape[0], cfg.patch_size
    n = cfg.image_size // p
    # [B, n, p, n, p, 3] -> [B, n*n, p*p*3]
    x = x.reshape(b, n, p, n, p, 3).permute(0, 1, 3, 2, 4, 5).reshape(b, n * n, p * p * 3)
    # the products of x.dtype operands, summed in fp32, rounded to x.dtype
    x = torch.matmul(x.float(), v["patch"]["w"].to(x.dtype).float()).to(x.dtype)
    cls = v["cls"].to(x.dtype).expand(b, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=1) + v["pos"].to(x.dtype)
    x = layer_norm(v["ln_pre"], x)
    for blk in v["blocks"]:
        x = _block_apply(blk, x, cfg.vision_heads, dtype=dtype)
    x = layer_norm(v["ln_post"], x[:, 0])
    return x @ v["proj"].to(x.dtype)


def clip_encode_text(params, ids, mask, cfg: ClipConfig, *, dtype=None):
    """ids/mask: [B, S] -> [B, embed_dim], pooling the last valid token (the
    EOT pooling under any tokenizer).  Inputs longer than ``cfg.text_len``
    are truncated first, as the reference's processor truncates to 77."""
    t = params["text"]
    if ids.shape[1] > cfg.text_len:
        ids, mask = ids[:, : cfg.text_len], mask[:, : cfg.text_len]
    b, s = ids.shape
    x = t["token"][ids] + t["pos"][:s]
    causal = torch.tril(torch.ones((s, s), device=ids.device))
    bias = (torch.where(causal[None, None] > 0, 0.0, -1e9)
            + torch.where(mask[:, None, None, :] > 0, 0.0, -1e9)).float()
    for blk in t["blocks"]:
        x = _block_apply(blk, x, cfg.text_heads, bias=bias, dtype=dtype)
    x = layer_norm(t["ln_final"], x)
    last = (mask.sum(dim=1) - 1).clamp_min(0)
    pooled = x[torch.arange(b, device=x.device), last]
    return pooled @ t["proj"].to(x.dtype)


def clip_alignment_loss(params, images, text_ids, text_mask, cfg: ClipConfig, *,
                        dtype=None, sample_weights=None):
    """Negative mean cosine similarity of the image and text embeddings;
    ``images`` in [-1, 1].  ``sample_weights`` [B] weights each sample (the
    eval batch's padded tail gets 0)."""
    img01 = (images + 1.0) / 2.0
    ie = clip_encode_image(params, img01, cfg, dtype=dtype)
    te = clip_encode_text(params, text_ids, text_mask, cfg, dtype=dtype)
    ie = ie / (torch.linalg.vector_norm(ie, dim=-1, keepdim=True) + 1e-8)
    te = te / (torch.linalg.vector_norm(te, dim=-1, keepdim=True) + 1e-8)
    cos = (ie * te).sum(dim=-1)
    if sample_weights is None:
        return -cos.mean()
    w = sample_weights.to(cos.dtype)
    return -(cos * w).sum() / w.sum().clamp_min(1.0)
