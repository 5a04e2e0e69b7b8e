"""Weight converters: torch state dicts -> this package's parameter trees
(port of ``psg_tpu/models/convert.py``).

- HF BERT (``BertModel``) -> ``models/bert.py``
- the reference's ``TextEncoder`` (BERT + projection + LayerNorm)
- torchvision VGG16 ``features`` -> ``models/vgg.py``
- the reference's ``PokemonVAE`` and ``UNet`` state dicts
- HF CLIP (``CLIPModel``, ViT-B/32) -> ``models/clip.py``
- diffusers' ``UNet2DConditionModel`` (SD-1.5's and SDXL's naming) ->
  ``models/sd_unet.py``

This package keeps torch's conv layout (OIHW), so a conv weight is copied
as it is; a ``Linear`` weight ``[out, in]`` becomes ``[in, out]``, and
``nn.MultiheadAttention``'s fused ``in_proj_weight`` ``[3C, C]`` becomes
``[C, 3C]``.  Each converter returns what ``bridge.from_jax`` makes of the
JAX package's converter on the same state dict, leaf for leaf and dtype for
dtype, and raises ``KeyError`` on a missing key.

A state dict may hold torch tensors or numpy arrays; ``load_torch_state_dict``
reads a ``.pth`` / ``.bin`` file (tensors only, ``weights_only=True``) or a
``.safetensors`` one.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from psg_tpu_torch.models.vgg import _CONVS


def load_torch_state_dict(path) -> Dict[str, torch.Tensor]:
    """A torch checkpoint's tensors (its ``state_dict`` entry if it has
    one), on the CPU; a ``.safetensors`` file (diffusers' published UNets)
    through ``safetensors``."""
    if str(path).endswith(".safetensors"):
        from safetensors.torch import load_file

        return load_file(str(path), device="cpu")
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return {k: v.detach().cpu() for k, v in obj.items()}


def _t(sd: Mapping, key: str) -> torch.Tensor:
    v = sd[key]
    if isinstance(v, torch.Tensor):
        return v.detach().cpu()
    return torch.from_numpy(np.array(v))


def _tt(sd: Mapping, key: str) -> torch.Tensor:
    """A 2-D weight transposed to ``[in, out]``."""
    return _t(sd, key).t().contiguous()


def _conv(sd, prefix):
    return {"w": _t(sd, f"{prefix}.weight").contiguous(), "b": _t(sd, f"{prefix}.bias")}


def _linear(sd, prefix):
    return {"w": _tt(sd, f"{prefix}.weight"), "b": _t(sd, f"{prefix}.bias")}


def _norm(sd, prefix):
    return {"scale": _t(sd, f"{prefix}.weight"), "bias": _t(sd, f"{prefix}.bias")}


# ---------------------------------------------------------------------------
# BERT and the reference's text encoder
# ---------------------------------------------------------------------------


def convert_bert(sd: Mapping, num_layers: int, prefix: str = "") -> Dict:
    p = prefix
    out = {
        "embeddings": {
            "word": _t(sd, f"{p}embeddings.word_embeddings.weight"),
            "position": _t(sd, f"{p}embeddings.position_embeddings.weight"),
            "token_type": _t(sd, f"{p}embeddings.token_type_embeddings.weight"),
            "ln": _norm(sd, f"{p}embeddings.LayerNorm"),
        },
        "layers": [],
        "pooler": _linear(sd, f"{p}pooler.dense"),
    }
    for i in range(num_layers):
        lp = f"{p}encoder.layer.{i}."
        out["layers"].append({
            "attn": {
                "q": _linear(sd, lp + "attention.self.query"),
                "k": _linear(sd, lp + "attention.self.key"),
                "v": _linear(sd, lp + "attention.self.value"),
                "out": _linear(sd, lp + "attention.output.dense"),
                "ln": _norm(sd, lp + "attention.output.LayerNorm"),
            },
            "ffn": {
                "w1": _linear(sd, lp + "intermediate.dense"),
                "w2": _linear(sd, lp + "output.dense"),
                "ln": _norm(sd, lp + "output.LayerNorm"),
            },
        })
    return out


def convert_reference_text_encoder(sd: Mapping, num_layers: int, hidden: int,
                                   text_dim: int) -> Dict:
    """The reference's TextEncoder: ``bert.*``, ``projection`` (when the
    text width is not BERT's) and ``layer_norm``."""
    out = {"bert": convert_bert(sd, num_layers, prefix="bert."),
           "ln": _norm(sd, "layer_norm")}
    if hidden != text_dim:
        out["projection"] = _linear(sd, "projection")
    return out


# ---------------------------------------------------------------------------
# VGG16 features (torchvision indices 0..14)
# ---------------------------------------------------------------------------


def convert_vgg16(sd: Mapping, prefix: str = "features.") -> Dict:
    return {f"conv{idx}": _conv(sd, f"{prefix}{idx}") for idx, _cin, _cout in _CONVS}


# ---------------------------------------------------------------------------
# the reference's VAE
# ---------------------------------------------------------------------------


def _resnet(sd, prefix):
    out = {
        "norm1": _norm(sd, f"{prefix}.norm1"),
        "conv1": _conv(sd, f"{prefix}.conv1"),
        "norm2": _norm(sd, f"{prefix}.norm2"),
        "conv2": _conv(sd, f"{prefix}.conv2"),
    }
    if f"{prefix}.shortcut.weight" in sd:
        out["shortcut"] = _conv(sd, f"{prefix}.shortcut")
    return out


def _spatial_attn(sd, prefix):
    return {
        "norm": _norm(sd, f"{prefix}.norm"),
        "q": _conv(sd, f"{prefix}.q"),
        "k": _linear(sd, f"{prefix}.k"),
        "v": _linear(sd, f"{prefix}.v"),
        "proj": _conv(sd, f"{prefix}.proj"),
    }


def convert_reference_vae(sd: Mapping) -> Dict:
    """PokemonVAE state dict -> ``vae_init``'s tree.  The encoder's
    Sequential indices: convs at 0/3/6, ResNets at 2/5/8, deep ResNets at
    9-12.  The reference decoder's K/V reshape means converted weights
    serve with ``compat_reshape=True``."""
    enc = {
        "down0": _conv(sd, "encoder.encoder.0"),
        "res0": _resnet(sd, "encoder.encoder.2"),
        "down1": _conv(sd, "encoder.encoder.3"),
        "res1": _resnet(sd, "encoder.encoder.5"),
        "down2": _conv(sd, "encoder.encoder.6"),
        "res2": _resnet(sd, "encoder.encoder.8"),
        "deep0": _resnet(sd, "encoder.encoder.9"),
        "deep1": _resnet(sd, "encoder.encoder.10"),
        "deep2": _resnet(sd, "encoder.encoder.11"),
        "deep3": _resnet(sd, "encoder.encoder.12"),
        "mu": _conv(sd, "encoder.mu_proj"),
        "logvar": _conv(sd, "encoder.logvar_proj"),
    }
    dec = {"latent_proj": _conv(sd, "decoder.latent_proj")}
    for i in range(5):
        dec[f"block{i}"] = {
            "res1": _resnet(sd, f"decoder.block{i + 1}_resnet1"),
            "attn": _spatial_attn(sd, f"decoder.block{i + 1}_attn"),
            "res2": _resnet(sd, f"decoder.block{i + 1}_resnet2"),
        }
    dec["final_norm"] = _norm(sd, "decoder.final_conv.0")
    dec["final_conv"] = _conv(sd, "decoder.final_conv.2")
    return {"encoder": enc, "decoder": dec}


# ---------------------------------------------------------------------------
# the reference's UNet
# ---------------------------------------------------------------------------


def _mha(sd, prefix):
    return {"in_proj": {"w": _tt(sd, f"{prefix}.in_proj_weight"),
                        "b": _t(sd, f"{prefix}.in_proj_bias")},
            "out_proj": _linear(sd, f"{prefix}.out_proj")}


def _unet_resblock(sd, prefix):
    out = {
        "norm1": _norm(sd, f"{prefix}.norm1"),
        "conv1": _conv(sd, f"{prefix}.conv1"),
        "time_proj": _linear(sd, f"{prefix}.time_proj"),
        "text_proj": _linear(sd, f"{prefix}.text_proj"),
        "norm2": _norm(sd, f"{prefix}.norm2"),
        "conv2": _conv(sd, f"{prefix}.conv2"),
    }
    if f"{prefix}.skip_conv.weight" in sd:
        out["skip"] = _conv(sd, f"{prefix}.skip_conv")
    return out


def _unet_attnblock(sd, prefix):
    return {
        "norm1": _norm(sd, f"{prefix}.norm1"),
        "norm2": _norm(sd, f"{prefix}.norm2"),
        "self_attn": _mha(sd, f"{prefix}.self_attn"),
        "cross_attn": _mha(sd, f"{prefix}.cross_attn"),
        "text_proj": _linear(sd, f"{prefix}.text_proj"),
        "ffn1": _linear(sd, f"{prefix}.ffn.0"),
        "ffn2": _linear(sd, f"{prefix}.ffn.3"),
    }


def _unet_block(sd, prefix):
    out = {"res": _unet_resblock(sd, f"{prefix}.res_block")}
    if f"{prefix}.attn_block.norm1.weight" in sd:
        out["attn"] = _unet_attnblock(sd, f"{prefix}.attn_block")
    return out


def convert_reference_unet(sd: Mapping, levels: int = 4, blocks_per_level: int = 2) -> Dict:
    out = {
        "time_mlp": {
            "l1": _linear(sd, "time_embed.time_mlp.0"),
            "l2": _linear(sd, "time_embed.time_mlp.2"),
            "l3": _linear(sd, "time_embed.time_mlp.4"),
        },
        "init_conv": _conv(sd, "init_conv"),
    }
    for lvl in range(levels):
        if lvl > 0:
            out[f"down{lvl}"] = _conv(sd, f"downsample{lvl}")
        out[f"enc{lvl}"] = [_unet_block(sd, f"enc_block{lvl}.{i}")
                            for i in range(blocks_per_level)]
    out["middle"] = _unet_block(sd, "middle_block")
    for lvl in range(levels):
        out[f"dec{lvl}"] = [_unet_block(sd, f"dec_block{lvl}.{i}")
                            for i in range(blocks_per_level)]
        if lvl > 0:
            out[f"up{lvl}"] = _conv(sd, f"upsample{lvl}.1")
    out["final_norm"] = _norm(sd, "final_conv.0")
    out["final_conv"] = _conv(sd, "final_conv.2")
    return out


# ---------------------------------------------------------------------------
# CLIP (HF CLIPModel naming)
# ---------------------------------------------------------------------------


def convert_clip(sd: Mapping, vision_layers: int = 12, text_layers: int = 12) -> Dict:
    def block(lp):
        return {
            "ln1": _norm(sd, lp + "layer_norm1"),
            "q": _linear(sd, lp + "self_attn.q_proj"),
            "k": _linear(sd, lp + "self_attn.k_proj"),
            "v": _linear(sd, lp + "self_attn.v_proj"),
            "out": _linear(sd, lp + "self_attn.out_proj"),
            "ln2": _norm(sd, lp + "layer_norm2"),
            "mlp1": _linear(sd, lp + "mlp.fc1"),
            "mlp2": _linear(sd, lp + "mlp.fc2"),
        }

    # the patch conv [W, 3, P, P] as a matmul over patches flattened
    # (row, col, channel), clip_encode_image's order
    patch_w = _t(sd, "vision_model.embeddings.patch_embedding.weight")
    cout, cin, ph, pw = patch_w.shape
    patch_mat = patch_w.permute(2, 3, 1, 0).reshape(ph * pw * cin, cout).contiguous()

    vision = {
        "patch": {"w": patch_mat},
        "cls": _t(sd, "vision_model.embeddings.class_embedding"),
        "pos": _t(sd, "vision_model.embeddings.position_embedding.weight"),
        "ln_pre": _norm(sd, "vision_model.pre_layrnorm"),
        "blocks": [block(f"vision_model.encoder.layers.{i}.") for i in range(vision_layers)],
        "ln_post": _norm(sd, "vision_model.post_layernorm"),
        "proj": _tt(sd, "visual_projection.weight"),
    }
    text = {
        "token": _t(sd, "text_model.embeddings.token_embedding.weight"),
        "pos": _t(sd, "text_model.embeddings.position_embedding.weight"),
        "blocks": [block(f"text_model.encoder.layers.{i}.") for i in range(text_layers)],
        "ln_final": _norm(sd, "text_model.final_layer_norm"),
        "proj": _tt(sd, "text_projection.weight"),
    }
    return {"vision": vision, "text": text}


# ---------------------------------------------------------------------------
# diffusers UNet2DConditionModel (SD-1.5 naming) -> models/sd_unet.py
# ---------------------------------------------------------------------------


def convert_sd_unet(sd: Mapping, levels: int = 4, layers_per_block: int = 2, *,
                    spec=None) -> Dict:
    """A diffusers ``UNet2DConditionModel`` state dict -> ``sd_unet_init``'s
    tree.  Without ``spec``: SD-1.5's topology over ``levels`` levels (3x
    CrossAttnDown + Down, mid, Up + 3x CrossAttnUp, transformer depth 1,
    ``use_linear_projection=False``).  With an ``SDUNetSpec``: its layout,
    SDXL's among them (attention by level, ``transformer_blocks.N`` by
    depth, linear ``proj_in``/``proj_out`` stored ``[out, in]``, the
    ``text_time`` ``add_embedding``)."""
    if spec is None:
        attention = [lvl < levels - 1 for lvl in range(levels)]
        depth = [1] * levels
        linear_proj = text_time = False
    else:
        levels, layers_per_block = len(spec.channels), spec.layers_per_block
        attention = [spec.has_attention(lvl) for lvl in range(levels)]
        depth = [spec.depth(lvl) for lvl in range(levels)]
        linear_proj, text_time = spec.linear_projection, spec.text_time

    def attention_(lp):
        return {"to_q": {"w": _tt(sd, lp + "to_q.weight")},
                "to_k": {"w": _tt(sd, lp + "to_k.weight")},
                "to_v": {"w": _tt(sd, lp + "to_v.weight")},
                "to_out": _linear(sd, lp + "to_out.0")}

    def block(bp):
        return {
            "norm1": _norm(sd, bp + "norm1"),
            "attn1": attention_(bp + "attn1."),
            "norm2": _norm(sd, bp + "norm2"),
            "attn2": attention_(bp + "attn2."),
            "norm3": _norm(sd, bp + "norm3"),
            "ff_proj": _linear(sd, bp + "ff.net.0.proj"),
            "ff_out": _linear(sd, bp + "ff.net.2"),
        }

    def transformer(tp, lvl):
        proj = _linear if linear_proj else _conv
        out = {"norm": _norm(sd, tp + "norm"), "proj_in": proj(sd, tp + "proj_in")}
        if depth[lvl] == 1 and not linear_proj:      # SD-1.5's flat dict
            out.update(block(tp + "transformer_blocks.0."))
        else:
            out["transformer_blocks"] = [block(tp + f"transformer_blocks.{i}.")
                                         for i in range(depth[lvl])]
        out["proj_out"] = proj(sd, tp + "proj_out")
        return out

    def resnet(rp):
        out = {
            "norm1": _norm(sd, rp + "norm1"),
            "conv1": _conv(sd, rp + "conv1"),
            "time_emb_proj": _linear(sd, rp + "time_emb_proj"),
            "norm2": _norm(sd, rp + "norm2"),
            "conv2": _conv(sd, rp + "conv2"),
        }
        if rp + "conv_shortcut.weight" in sd:
            out["conv_shortcut"] = _conv(sd, rp + "conv_shortcut")
        return out

    p = {
        "conv_in": _conv(sd, "conv_in"),
        "time_embedding": {"linear_1": _linear(sd, "time_embedding.linear_1"),
                           "linear_2": _linear(sd, "time_embedding.linear_2")},
    }
    if text_time:
        p["add_embedding"] = {"linear_1": _linear(sd, "add_embedding.linear_1"),
                              "linear_2": _linear(sd, "add_embedding.linear_2")}
    p.update({"down_blocks": [], "up_blocks": [],
              "conv_norm_out": _norm(sd, "conv_norm_out"),
              "conv_out": _conv(sd, "conv_out")})
    for lvl in range(levels):
        dp = f"down_blocks.{lvl}."
        blk = {"resnets": [resnet(dp + f"resnets.{j}.") for j in range(layers_per_block)],
               "attentions": ([transformer(dp + f"attentions.{j}.", lvl)
                               for j in range(layers_per_block)]
                              if attention[lvl] else None)}
        if f"{dp}downsamplers.0.conv.weight" in sd:
            blk["downsampler"] = _conv(sd, dp + "downsamplers.0.conv")
        p["down_blocks"].append(blk)

    p["mid_block"] = {"resnets": [resnet("mid_block.resnets.0."),
                                  resnet("mid_block.resnets.1.")],
                      "attentions": [transformer("mid_block.attentions.0.", levels - 1)]}
    for lvl in range(levels):
        up, mirror = f"up_blocks.{lvl}.", levels - 1 - lvl
        blk = {"resnets": [resnet(up + f"resnets.{j}.") for j in range(layers_per_block + 1)],
               "attentions": ([transformer(up + f"attentions.{j}.", mirror)
                               for j in range(layers_per_block + 1)]
                              if attention[mirror] else None)}
        if f"{up}upsamplers.0.conv.weight" in sd:
            blk["upsampler"] = _conv(sd, up + "upsamplers.0.conv")
        p["up_blocks"].append(blk)
    return p
