"""Text-conditioned convolutional VAE, 215x215x3 <-> 27x27x8 latents (port of
``psg_tpu/models/vae.py``).

- encoder: Conv(3->32,k4,s2,p1)+ReLU+Res, Conv(32->64,k4,s2,p1)+ReLU+Res,
  Conv(64->128,k4,s2,p2)+ReLU+Res, then stride-1 ResNet blocks
  128->256->256->512->512; two 3x3 convs give mu/logvar.  215 -> 107 -> 53
  -> 27.
- decoder: 3x3 conv latent->512, then five [ResNet, spatial cross-attention
  (text), ResNet] blocks with bilinear upsampling 27 -> 54 -> 108 -> 215,
  channels 512->512->256->128->64->32, final GroupNorm(8)+SiLU+conv+tanh.

Every request runs the decoder; image+text requests, retrieval seeding and
restart passes also run the encoder and ``reparameterize``.
"""

from __future__ import annotations

import torch

from psg_tpu_torch import ops
from psg_tpu_torch.core import draws
from psg_tpu_torch.nn.attention import (
    spatial_cross_attention,
    spatial_cross_attention_init,
)
from psg_tpu_torch.nn.layers import (
    conv2d,
    conv2d_init,
    group_norm_init,
    largest_group_count,
)
from psg_tpu_torch.nn.resize import bilinear_resize

# ---------------------------------------------------------------------------
# ResNet block (no time/text conditioning; GroupNorm(32))
# ---------------------------------------------------------------------------


def resnet_block_init(gen, cin: int, cout: int):
    p = {
        "norm1": group_norm_init(cin, gen.device),
        "conv1": conv2d_init(gen, cin, cout, 3, init="torch"),
        "norm2": group_norm_init(cout, gen.device),
        "conv2": conv2d_init(gen, cout, cout, 3, init="torch"),
    }
    if cin != cout:
        p["shortcut"] = conv2d_init(gen, cin, cout, 1, init="torch")
    return p


def resnet_block(params, x, *, dtype=None):
    residual = x
    h = ops.group_norm_silu(params["norm1"], x, largest_group_count(x.shape[-1]),
                            eps=1e-5)
    h = conv2d(params["conv1"], h, stride=1, padding=1, dtype=dtype)
    h = ops.group_norm_silu(params["norm2"], h, largest_group_count(h.shape[-1]),
                            eps=1e-5)
    h = conv2d(params["conv2"], h, stride=1, padding=1, dtype=dtype)
    if "shortcut" in params:
        residual = conv2d(params["shortcut"], residual, stride=1, padding=0,
                          dtype=dtype)
    return h + residual


def latent_size_for(image_size: int) -> int:
    """Latent size after the three stride-2 encoder convs: 215 -> 27, 64 -> 9."""
    s = image_size // 2
    s = s // 2
    return s // 2 + 1


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

_ENC_DOWN = (  # (cin, cout, kernel, stride, pad)
    (3, 32, 4, 2, 1),    # 215 -> 107
    (32, 64, 4, 2, 1),   # 107 -> 53
    (64, 128, 4, 2, 2),  # 53 -> 27
)
_ENC_RES = ((128, 256), (256, 256), (256, 512), (512, 512))


def width_scale(c: int, scale: float) -> int:
    """Scale a channel width, keeping it a multiple of 8 (attention heads and
    GroupNorm divisors stay valid)."""
    if scale == 1.0:
        return c
    return max(8, int(round(c * scale / 8)) * 8)


def vae_encoder_init(gen, latent_dim: int = 8, width: float = 1.0):
    p = {}
    for i, (cin, cout, k, _s, _pad) in enumerate(_ENC_DOWN):
        cin = cin if i == 0 else width_scale(cin, width)
        p[f"down{i}"] = conv2d_init(gen, cin, width_scale(cout, width), k, init="torch")
        p[f"res{i}"] = resnet_block_init(gen, width_scale(cout, width),
                                         width_scale(cout, width))
    for i, (cin, cout) in enumerate(_ENC_RES):
        p[f"deep{i}"] = resnet_block_init(gen, width_scale(cin, width),
                                          width_scale(cout, width))
    p["mu"] = conv2d_init(gen, width_scale(512, width), latent_dim, 3, init="torch")
    p["logvar"] = conv2d_init(gen, width_scale(512, width), latent_dim, 3, init="torch")
    return p


def vae_encoder_apply(params, images, *, dtype=None):
    """images: [B, 215, 215, 3] -> (mu, logvar), each [B, 27, 27, latent]."""
    x = images
    for i, (_cin, _cout, _k, s, pad) in enumerate(_ENC_DOWN):
        x = conv2d(params[f"down{i}"], x, stride=s, padding=pad, dtype=dtype)
        x = torch.relu(x)
        x = resnet_block(params[f"res{i}"], x, dtype=dtype)
    for i in range(len(_ENC_RES)):
        x = resnet_block(params[f"deep{i}"], x, dtype=dtype)
    mu = conv2d(params["mu"], x, stride=1, padding=1, dtype=dtype)
    logvar = conv2d(params["logvar"], x, stride=1, padding=1, dtype=dtype)
    return mu, logvar


def reparameterize(generator, mu, logvar, *, noise=None):
    """latent = mu + eps * exp(0.5 * logvar), in fp32, returned in mu's dtype.

    eps is drawn in fp32 from ``generator`` (a ``torch.Generator`` on mu's
    device), unless ``noise`` (mu's shape) gives it."""
    std = torch.exp(0.5 * logvar.float())
    if noise is None:
        noise = draws.randn(generator, mu.shape, device=mu.device)
    return (mu.float() + noise.float() * std).to(mu.dtype)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

_DEC_BLOCKS = (  # (cin, cout, upsample)
    (512, 512, None),    # 27x27
    (512, 256, "x2"),    # -> 54
    (256, 128, "x2"),    # -> 108
    (128, 64, "full"),   # -> 215 (exact-size bilinear)
    (64, 32, None),      # 215
)


def vae_decoder_init(gen, latent_dim: int = 8, text_dim: int = 768,
                     width: float = 1.0):
    p = {"latent_proj": conv2d_init(gen, latent_dim, width_scale(512, width), 3,
                                    init="torch")}
    for i, (cin, cout, _up) in enumerate(_DEC_BLOCKS):
        p[f"block{i}"] = {
            "res1": resnet_block_init(gen, width_scale(cin, width),
                                      width_scale(cout, width)),
            "attn": spatial_cross_attention_init(gen, width_scale(cout, width),
                                                 text_dim),
            "res2": resnet_block_init(gen, width_scale(cout, width),
                                      width_scale(cout, width)),
        }
    p["final_norm"] = group_norm_init(width_scale(32, width), gen.device)
    p["final_conv"] = conv2d_init(gen, width_scale(32, width), 3, 3, init="torch")
    return p


def vae_decoder_apply(params, latent, text_emb, *, text_bias=None,
                      image_size: int = 215, dtype=None,
                      compat_reshape: bool = False):
    """latent: [B, 27, 27, latent_dim], text_emb: [B, S, text_dim]
    -> images [B, image_size, image_size, 3] in [-1, 1]."""
    x = conv2d(params["latent_proj"], latent, stride=1, padding=1, dtype=dtype)
    for i, (_cin, _cout, up) in enumerate(_DEC_BLOCKS):
        bp = params[f"block{i}"]
        x = resnet_block(bp["res1"], x, dtype=dtype)
        x = spatial_cross_attention(bp["attn"], x, text_emb, num_heads=8,
                                    text_bias=text_bias, dtype=dtype,
                                    compat_reshape=compat_reshape)
        x = resnet_block(bp["res2"], x, dtype=dtype)
        if up == "x2":
            x = bilinear_resize(x, (x.shape[1] * 2, x.shape[2] * 2))
        elif up == "full":
            x = bilinear_resize(x, (image_size, image_size))
    x = ops.group_norm_silu(params["final_norm"], x, 8, eps=1e-5)
    x = conv2d(params["final_conv"], x, stride=1, padding=1, dtype=dtype)
    return torch.tanh(x)


def vae_init(gen, latent_dim: int = 8, text_dim: int = 768, width: float = 1.0):
    return {
        "encoder": vae_encoder_init(gen, latent_dim, width),
        "decoder": vae_decoder_init(gen, latent_dim, text_dim, width),
    }


def vae_encode(params, generator, images, *, dtype=None, noise=None):
    """Returns (latent, mu, logvar) like the reference's ``PokemonVAE.encode``."""
    mu, logvar = vae_encoder_apply(params["encoder"], images, dtype=dtype)
    return reparameterize(generator, mu, logvar, noise=noise), mu, logvar


def vae_apply(params, generator, images, text_emb, mode: str = "train", *,
              latent_dim: int = 8, latent_size: int = 27, image_size: int = None,
              text_bias=None, dtype=None, compat_reshape: bool = False, noise=None):
    """The reference's modes: 'train' / 'val' encode, reparameterize and
    decode; 'generate' decodes the mean; 'sample' decodes a prior N(0, I)
    draw (images ignored).  The reparameterize noise or the prior latent is
    drawn from ``generator`` unless ``noise`` gives it."""
    if mode == "sample" or images is None:
        b = text_emb.shape[0]
        latent = noise if noise is not None else draws.randn(
            generator, (b, latent_size, latent_size, latent_dim), device=text_emb.device)
        mu = logvar = None
    else:
        mu, logvar = vae_encoder_apply(params["encoder"], images, dtype=dtype)
        latent = mu if mode == "generate" else reparameterize(generator, mu, logvar,
                                                               noise=noise)
    if image_size is None:
        image_size = images.shape[1] if images is not None else 215
    recon = vae_decode(params, latent, text_emb, text_bias=text_bias, dtype=dtype,
                       image_size=image_size, compat_reshape=compat_reshape)
    return {"reconstructed": recon, "latent": latent, "mu": mu, "logvar": logvar}


def vae_sample(params, generator, text_emb, *, latent_dim: int = 8, latent_size: int = 27,
               image_size: int = 215, text_bias=None, dtype=None, noise=None):
    """Decode a prior draw (``noise`` gives it, else ``generator``)."""
    return vae_apply(params, generator, None, text_emb, "sample", latent_dim=latent_dim,
                     latent_size=latent_size, image_size=image_size, text_bias=text_bias,
                     dtype=dtype, noise=noise)["reconstructed"]


def vae_decode(params, latent, text_emb, *, text_bias=None, dtype=None,
               image_size: int = 215, compat_reshape: bool = False):
    return vae_decoder_apply(params["decoder"], latent, text_emb,
                             text_bias=text_bias, image_size=image_size,
                             dtype=dtype, compat_reshape=compat_reshape)
