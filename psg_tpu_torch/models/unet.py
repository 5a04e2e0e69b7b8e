"""Text+time-conditioned epsilon-prediction UNet on 27x27x8 latents (port of
``psg_tpu/models/unet.py``).

- init_conv 8->320; encoder levels [320x2 @27, 640x2 @14, 1280x2 @7,
  1280x2 @4] with stride-2 3x3 downsample convs; middle block @4; decoder
  mirrors with bilinear upsample to exact sizes + conv.
- attention on every level except 27x27.
- decoder levels re-concatenate the SAME skip tensor before BOTH of their
  blocks, so decoder blocks take 2x channels in.
- conditioning enters twice: a pooled text vector is FiLM-added in every
  ResBlock with the time embedding, and the text sequence feeds the self +
  cross attention blocks, whose outputs are damped by the ``UNetSpec``
  scales.

Layout is NHWC end to end; GroupNorm+SiLU and attention go through ``ops``.

Training applies ``UNetSpec.attn_dropout`` in every attention block, as the
JAX package does: after the self- and the cross-attention core and on the
FFN output.  ``unet_apply(dropout=...)`` takes a ``torch.Generator`` to draw
the keep masks from, or the masks themselves: one entry per UNet block in
the order the blocks run (``unet_block_count``), each a triple (self, cross,
FFN) of boolean masks or ``None`` for a block without attention.  The JAX
package draws block ``i``'s triple from ``split(split(dropout_key, (2L + 1)B
+ 1)[i], 3)`` (L levels, B blocks a level; the last 2B keys go unused); the
tests pass those masks in.

Spans (``utils.profiling``): ``psg.unet.eval`` around an evaluation, and
inside it one a level, ``psg.unet.enc<i>``, ``psg.unet.mid`` and
``psg.unet.dec<i>``; a level's down or up convolution is part of it.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from psg_tpu_torch import ops
from psg_tpu_torch.core import draws
from psg_tpu_torch.nn.attention import dropout as apply_dropout
from psg_tpu_torch.nn.attention import mha, mha_init
from psg_tpu_torch.nn.embeddings import sinusoidal_time_embedding
from psg_tpu_torch.nn.layers import (
    conv2d,
    conv2d_init,
    group_norm,
    group_norm_init,
    largest_group_count,
    linear,
    linear_init,
)
from psg_tpu_torch.nn.resize import bilinear_resize
from psg_tpu_torch.utils.profiling import span


class UNetSpec(NamedTuple):
    latent_dim: int = 8
    text_dim: int = 768
    time_emb_dim: int = 128
    num_heads: int = 4
    channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    blocks_per_level: int = 2
    attention_levels: Tuple[bool, ...] = (False, True, True, True)
    spatial: Tuple[int, ...] = (27, 14, 7, 4)
    self_attn_scale: float = 0.7
    cross_attn_scale: float = 0.8
    ffn_scale: float = 0.6
    attn_dropout: float = 0.05


def unet_spatial_for(latent_size: int, levels: int = 4):
    """Per-level sizes under stride-2 k3 p1 downsamples: 27 -> 14 -> 7 -> 4."""
    sizes = [latent_size]
    for _ in range(levels - 1):
        sizes.append((sizes[-1] + 1) // 2)
    return tuple(sizes)


def unet_spec_from_config(cfg, latent_size: int) -> UNetSpec:
    m = cfg.model
    return UNetSpec(
        latent_dim=m.latent_dim,
        text_dim=m.text_embedding_dim,
        time_emb_dim=m.time_emb_dim,
        num_heads=m.num_attention_heads,
        channels=tuple(m.unet_channels),
        spatial=unet_spatial_for(latent_size, len(m.unet_channels)),
        self_attn_scale=m.self_attn_scale,
        cross_attn_scale=m.cross_attn_scale,
        ffn_scale=m.ffn_scale,
        attn_dropout=m.attn_dropout,
    )


# ---------------------------------------------------------------------------
# ResBlock with time/text FiLM-adds
# ---------------------------------------------------------------------------


def resblock_init(gen, cin: int, cout: int, time_dim: int, text_dim: int):
    p = {
        "norm1": group_norm_init(cin, gen.device),
        "conv1": conv2d_init(gen, cin, cout, 3, init="kaiming_normal"),
        "time_proj": linear_init(gen, time_dim, cout, init="xavier", gain=0.02),
        "text_proj": linear_init(gen, text_dim, cout, init="xavier", gain=0.02),
        "norm2": group_norm_init(cout, gen.device),
        "conv2": conv2d_init(gen, cout, cout, 3, init="kaiming_normal"),
    }
    if cin != cout:
        p["skip"] = conv2d_init(gen, cin, cout, 1, init="kaiming_normal")
    return p


def resblock_apply(params, x, time_emb, text_pooled, *, cin: int, cout: int,
                   dtype=None):
    residual = x
    h = ops.group_norm_silu(params["norm1"], x, largest_group_count(cin), eps=1e-5)
    h = conv2d(params["conv1"], h, stride=1, padding=1, dtype=dtype)
    h = h + linear(params["time_proj"], time_emb, dtype=dtype)[:, None, None, :]
    h = h + linear(params["text_proj"], text_pooled, dtype=dtype)[:, None, None, :]
    h = ops.group_norm_silu(params["norm2"], h, largest_group_count(cout), eps=1e-5)
    h = conv2d(params["conv2"], h, stride=1, padding=1, dtype=dtype)
    if "skip" in params:
        residual = conv2d(params["skip"], residual, stride=1, padding=0, dtype=dtype)
    return h + residual


# ---------------------------------------------------------------------------
# Self+cross attention transformer block
# ---------------------------------------------------------------------------


def attnblock_init(gen, channels: int, text_dim: int):
    return {
        "norm1": group_norm_init(channels, gen.device),
        "norm2": group_norm_init(channels, gen.device),
        "self_attn": mha_init(gen, channels),
        "cross_attn": mha_init(gen, channels),
        "text_proj": linear_init(gen, text_dim, channels, init="xavier", gain=0.02),
        "ffn1": linear_init(gen, channels, channels * 2, init="xavier", gain=0.02),
        "ffn2": linear_init(gen, channels * 2, channels, init="xavier", gain=0.02),
    }


def attnblock_apply(params, x, text_seq, spec: UNetSpec, *, channels: int,
                    text_bias=None, dtype=None, dropout=None):
    """x: [B,H,W,C]; text_seq: [B,S,text_dim].  ``dropout``: None, a
    ``torch.Generator``, or a (self, cross, FFN) triple of keep masks."""
    b, h, w, c = x.shape
    g = largest_group_count(channels)
    seq = x.reshape(b, h * w, c)
    rate = spec.attn_dropout if dropout is not None else 0.0
    keeps = (dropout,) * 3 if draws.is_source(dropout) or dropout is None \
        else dropout

    xn = group_norm(params["norm1"], seq, g, eps=1e-6)
    attn = mha(params["self_attn"], xn, xn, spec.num_heads, dtype=dtype,
               dropout_rate=rate, dropout_keep=keeps[0])
    seq = seq + spec.self_attn_scale * attn

    xn = group_norm(params["norm2"], seq, g, eps=1e-6)
    text_proj = linear(params["text_proj"], text_seq, dtype=dtype)
    attn = mha(params["cross_attn"], xn, text_proj, spec.num_heads,
               bias=text_bias, dtype=dtype, dropout_rate=rate, dropout_keep=keeps[1])
    seq = seq + spec.cross_attn_scale * attn

    ff = linear(params["ffn1"], seq, dtype=dtype)
    ff = F.gelu(ff)
    ff = apply_dropout(linear(params["ffn2"], ff, dtype=dtype), rate, keeps[2])
    seq = seq + spec.ffn_scale * ff
    return seq.reshape(b, h, w, c)


# ---------------------------------------------------------------------------
# UNet block = ResBlock (+ attention)
# ---------------------------------------------------------------------------


def unetblock_init(gen, cin: int, cout: int, spec: UNetSpec, has_attention: bool):
    p = {"res": resblock_init(gen, cin, cout, spec.time_emb_dim, spec.text_dim)}
    if has_attention:
        p["attn"] = attnblock_init(gen, cout, spec.text_dim)
    return p


def unetblock_apply(params, x, time_emb, text_pooled, text_seq, spec: UNetSpec,
                    *, cin: int, cout: int, text_bias=None, dtype=None, dropout=None):
    x = resblock_apply(params["res"], x, time_emb, text_pooled,
                       cin=cin, cout=cout, dtype=dtype)
    if "attn" in params:
        x = attnblock_apply(params["attn"], x, text_seq, spec, channels=cout,
                            text_bias=text_bias, dtype=dtype, dropout=dropout)
    return x


# ---------------------------------------------------------------------------
# Full UNet
# ---------------------------------------------------------------------------


def unet_init(gen, spec: UNetSpec = UNetSpec()):
    nlvl = len(spec.channels)
    ch = spec.channels
    d = spec.time_emb_dim
    p = {
        "time_mlp": {
            "l1": linear_init(gen, d, d * 4, init="xavier", gain=0.02),
            "l2": linear_init(gen, d * 4, d * 4, init="xavier", gain=0.02),
            "l3": linear_init(gen, d * 4, d, init="xavier", gain=0.02),
        },
        "init_conv": conv2d_init(gen, spec.latent_dim, ch[0], 3, init="kaiming_normal"),
    }
    for lvl in range(nlvl):
        has_attn = spec.attention_levels[lvl]
        if lvl > 0:
            p[f"down{lvl}"] = conv2d_init(gen, ch[lvl - 1], ch[lvl], 3,
                                          init="kaiming_normal")
        p[f"enc{lvl}"] = [unetblock_init(gen, ch[lvl], ch[lvl], spec, has_attn)
                          for _ in range(spec.blocks_per_level)]
    p["middle"] = unetblock_init(gen, ch[-1], ch[-1], spec, True)
    for lvl in reversed(range(nlvl)):
        has_attn = spec.attention_levels[lvl]
        p[f"dec{lvl}"] = [unetblock_init(gen, 2 * ch[lvl], ch[lvl], spec, has_attn)
                          for _ in range(spec.blocks_per_level)]
        if lvl > 0:
            p[f"up{lvl}"] = conv2d_init(gen, ch[lvl], ch[lvl - 1], 3,
                                        init="kaiming_normal")
    p["final_norm"] = group_norm_init(ch[0], gen.device)
    # near-zero final conv
    p["final_conv"] = conv2d_init(gen, ch[0], spec.latent_dim, 3, init="xavier",
                                  gain=0.02)
    return p


def pooled_text(text_seq, text_mask=None):
    """Masked mean of the text sequence for FiLM conditioning (plain mean
    with ``text_mask=None``)."""
    if text_mask is None:
        return text_seq.mean(dim=1)
    m = text_mask.to(text_seq.dtype)[:, :, None]
    denom = m.sum(dim=1).clamp_min(1.0)
    return (text_seq * m).sum(dim=1) / denom


def text_bias_from_mask(text_mask):
    """[B,S] 0/1 mask -> additive fp32 [B,1,1,S] attention bias."""
    if text_mask is None:
        return None
    return torch.where(text_mask[:, None, None, :] > 0, 0.0, -1e9).float()


def unet_block_count(spec: UNetSpec) -> int:
    """UNet blocks (encoder, middle, decoder), in the order they run."""
    return 2 * len(spec.channels) * spec.blocks_per_level + 1


_SPAN_EVAL = "psg.unet.eval"
_SPAN_MID = "psg.unet.mid"


@functools.lru_cache(maxsize=None)
def _level_spans(nlvl: int):
    """The span names of the encoder and decoder levels, by level."""
    return (tuple(f"psg.unet.enc{i}" for i in range(nlvl)),
            tuple(f"psg.unet.dec{i}" for i in range(nlvl)))


def unet_apply(params, noisy_latent, timesteps, text_seq, spec: UNetSpec, *,
               text_mask=None, dtype=None, dropout=None):
    """Predict noise.  noisy_latent: [B, 27, 27, latent_dim]; timesteps: [B];
    text_seq: [B, S, text_dim] -> [B, 27, 27, latent_dim].  ``dropout``:
    None (no attention dropout), a ``torch.Generator``, or one entry per
    block (see the module note)."""
    nlvl = len(spec.channels)
    ch = spec.channels
    if dropout is None or draws.is_source(dropout):
        drops = iter([dropout] * unet_block_count(spec))
    else:
        if len(dropout) != unet_block_count(spec):
            raise ValueError(f"dropout: {len(dropout)} entries for "
                             f"{unet_block_count(spec)} UNet blocks")
        drops = iter(dropout)

    enc_spans, dec_spans = _level_spans(nlvl)
    with span(_SPAN_EVAL):
        t = sinusoidal_time_embedding(timesteps, spec.time_emb_dim)
        tm = params["time_mlp"]
        t = F.silu(linear(tm["l1"], t, dtype=dtype))
        t = F.silu(linear(tm["l2"], t, dtype=dtype))
        time_emb = linear(tm["l3"], t, dtype=dtype)

        tp = pooled_text(text_seq, text_mask)
        tb = text_bias_from_mask(text_mask)

        x = conv2d(params["init_conv"], noisy_latent, stride=1, padding=1, dtype=dtype)
        skips = []
        for lvl in range(nlvl):
            with span(enc_spans[lvl]):
                if lvl > 0:
                    x = conv2d(params[f"down{lvl}"], x, stride=2, padding=1, dtype=dtype)
                for blk in params[f"enc{lvl}"]:
                    x = unetblock_apply(blk, x, time_emb, tp, text_seq, spec,
                                        cin=ch[lvl], cout=ch[lvl], text_bias=tb,
                                        dtype=dtype, dropout=next(drops))
                skips.append(x)

        with span(_SPAN_MID):
            x = unetblock_apply(params["middle"], x, time_emb, tp, text_seq, spec,
                                cin=ch[-1], cout=ch[-1], text_bias=tb, dtype=dtype,
                                dropout=next(drops))

        for lvl in reversed(range(nlvl)):
            with span(dec_spans[lvl]):
                skip = skips.pop()
                # the same skip tensor is concatenated before BOTH decoder blocks
                for blk in params[f"dec{lvl}"]:
                    x = torch.cat([x, skip], dim=-1)
                    x = unetblock_apply(blk, x, time_emb, tp, text_seq, spec,
                                        cin=2 * ch[lvl], cout=ch[lvl], text_bias=tb,
                                        dtype=dtype, dropout=next(drops))
                if lvl > 0:
                    target = spec.spatial[lvl - 1]
                    x = bilinear_resize(x, (target, target))
                    x = conv2d(params[f"up{lvl}"], x, stride=1, padding=1, dtype=dtype)

        x = ops.group_norm_silu(params["final_norm"], x, largest_group_count(ch[0]),
                                eps=1e-5)
        return conv2d(params["final_conv"], x, stride=1, padding=1, dtype=dtype)
