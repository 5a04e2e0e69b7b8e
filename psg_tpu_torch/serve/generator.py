"""Serving generator: text -> sprite (port of ``psg_tpu/serve/generator.py``).

The chain is the reference's ``PokemonGenerator._generate_impl``: WordPiece
tokenize, encode the text (BERT -> projection -> LayerNorm), run DDIM or
DPM-Solver++(2M) over the UNet, decode the 27x27x8 latent with the VAE.
With guidance on, both classifier-free-guidance branches go through ONE
batch-2N UNet call per step (fused CFG) and are combined in fp32, with the
optional guidance rescale and guidance interval.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without an explicit ``"cpu"``, construction raises.
Retrieval seeding, restarts, img2img and the ``"mean"`` negative (which
needs the caption dataset) are not part of this port yet.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from psg_tpu_torch.core.checkpoint import load_serving_params
from psg_tpu_torch.core.config import Config, configure_torch
from psg_tpu_torch.diffusion.sampling import ddim_sample, dpmpp_2m_sample
from psg_tpu_torch.diffusion.schedule import make_schedule
from psg_tpu_torch.models import bridge
from psg_tpu_torch.models.bert import bert_config_for
from psg_tpu_torch.models.text_encoder import text_encoder_apply, text_encoder_init
from psg_tpu_torch.models.unet import (
    text_bias_from_mask,
    unet_apply,
    unet_init,
    unet_spec_from_config,
)
from psg_tpu_torch.models.vae import latent_size_for, vae_decode, vae_init
from psg_tpu_torch.nn.layers import prepare_weights
from psg_tpu_torch.text.tokenizer import WordPieceTokenizer
from psg_tpu_torch.utils.images import tensor_to_pil

_SAMPLERS = {"ddim": ddim_sample, "dpmpp": dpmpp_2m_sample}


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; there is no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to "
                               "run on the CPU")
        device = "cuda"
    return torch.device(device)


def find_tokenizer(cfg: Config) -> WordPieceTokenizer:
    for cand in (Path(cfg.experiment_dir) / "vocab.txt", Path("config/vocab.txt")):
        if cand.exists():
            return WordPieceTokenizer.from_vocab_file(cand)
    raise FileNotFoundError(
        f"no vocab.txt in {cfg.experiment_dir} or config/: pass a tokenizer")


def init_params(cfg: Config, bert_cfg, spec, seed: int, device) -> dict:
    """Random serving parameters {vae, text, unet} drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    m = cfg.model
    return {
        "vae": vae_init(gen, m.latent_dim, m.text_embedding_dim, m.vae_width_scale),
        "text": text_encoder_init(gen, bert_cfg, m.text_embedding_dim),
        "unet": unet_init(gen, spec),
    }


class PokemonGenerator:
    def __init__(self, cfg: Config, vae_checkpoint=None, diffusion_checkpoint=None,
                 tokenizer=None, schedule_kind: str = "linear",
                 sampler: str = "ddim", guidance_scale: float = 0.0,
                 negative: str = "zero", prediction_type: str = "eps", *,
                 device=None, params=None):
        """``params``: a parameter tree in this package's layout (e.g. from
        ``models.bridge.from_jax``) used instead of checkpoints; without
        either, parameters are drawn from ``cfg.seed``."""
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            configure_torch(cfg)
        self.cfg = cfg
        if prediction_type not in ("eps", "v"):
            raise ValueError(f"unknown prediction_type {prediction_type!r}")
        if sampler not in _SAMPLERS:
            raise ValueError(f"sampler {sampler!r} not available "
                             f"(have {sorted(_SAMPLERS)})")
        if negative == "mean":
            raise NotImplementedError("negative='mean' needs the caption dataset")
        self.prediction_type = prediction_type
        self.compute_dtype = (torch.bfloat16 if cfg.model.compute_dtype == "bfloat16"
                              else None)
        self.latent_size = latent_size_for(cfg.data.image_size)
        self.spec = unet_spec_from_config(cfg, self.latent_size)
        m = cfg.model
        # serving uses a linear beta schedule, as the reference's gradio app
        self.schedule = make_schedule(m.num_timesteps, m.beta_start, m.beta_end,
                                      schedule_kind)
        self.sampler_name = sampler
        self.guidance_scale = float(guidance_scale)
        self.guidance_rescale = float(cfg.extra.get("guidance_rescale", 0.0))
        T = m.num_timesteps
        self.guidance_t_lo = float(cfg.extra.get("guidance_interval_lo", 0.0)) * T
        self.guidance_t_hi = float(cfg.extra.get("guidance_interval_hi", 1.0)) * T

        self.tokenizer = tokenizer if tokenizer is not None else find_tokenizer(cfg)
        self.bert_cfg = bert_config_for(m.bert_model, self.tokenizer.vocab_size)

        template = init_params(cfg, self.bert_cfg, self.spec, cfg.seed, self.device)
        if params is not None:
            self.params, self.loaded = bridge.fit(template, params), "params"
        else:
            self.params, self.loaded = load_serving_params(
                vae_checkpoint, diffusion_checkpoint, template)
        # matmul/conv kernels stored in the compute dtype (outputs unchanged)
        self.params = prepare_weights(self.params, self.compute_dtype)

        # CFG negative branch: "zero" is the cond-dropout zero embedding; any
        # other string is a negative prompt, encoded once here
        self.negative = negative
        self._neg_emb = self._neg_mask = None
        if negative != "zero":
            ids, mask = self._encode_ids([negative])
            with torch.no_grad():
                self._neg_emb = text_encoder_apply(self.params["text"], ids, mask,
                                                   self.bert_cfg,
                                                   dtype=self.compute_dtype)
            self._neg_mask = mask

    # -- the chain -----------------------------------------------------------

    def _encode_ids(self, texts: Sequence[str]):
        ids, mask = self.tokenizer.encode_batch(list(texts), self.cfg.data.text_len)
        return (torch.from_numpy(ids).long().to(self.device),
                torch.from_numpy(mask).long().to(self.device))

    @torch.no_grad()
    def _generate_impl(self, params, generator, text_ids, text_mask,
                       initial_latent=None, *, steps: int, num: int, sampler: str):
        """ids/mask [N, S] on the device -> images [N, H, W, 3] in [-1, 1]."""
        text_emb = text_encoder_apply(params["text"], text_ids, text_mask,
                                      self.bert_cfg, dtype=self.compute_dtype)

        def denoise(x, t):
            out = unet_apply(params["unet"], x.to(text_emb.dtype), t, text_emb,
                             self.spec, text_mask=text_mask, dtype=self.compute_dtype)
            if self.prediction_type == "v":
                out = self.schedule.eps_from_v(out, x, t)
            return out

        guided = denoise
        if self.guidance_scale > 0.0:
            if self._neg_emb is not None:
                neg_emb = self._neg_emb.to(text_emb.dtype).expand_as(text_emb)
                neg_mask = self._neg_mask.expand_as(text_mask)
            else:  # cond-dropout zero embedding
                neg_emb = torch.zeros_like(text_emb)
                neg_mask = text_mask
            # fused CFG: both branches in one batch-2N UNet call, so the
            # weights are read once per step; the guided eps is combined here
            # in fp32 and the sampler runs with guidance 0
            emb_cat = torch.cat([text_emb, neg_emb], dim=0)
            mask_cat = torch.cat([text_mask, neg_mask], dim=0)
            g = self.guidance_scale
            resc = self.guidance_rescale
            t_lo, t_hi = self.guidance_t_lo, self.guidance_t_hi

            def guided(x, t):
                xx = torch.cat([x, x], dim=0)
                tt = torch.cat([t, t], dim=0)
                eps = unet_apply(params["unet"], xx.to(text_emb.dtype), tt, emb_cat,
                                 self.spec, text_mask=mask_cat,
                                 dtype=self.compute_dtype)
                if self.prediction_type == "v":
                    eps = self.schedule.eps_from_v(eps, xx, tt)
                e_c, e_u = eps.float().chunk(2, dim=0)
                # guidance interval, decided on the device (no host sync)
                g_eff = torch.where((t[0] >= t_lo) & (t[0] <= t_hi), g, 0.0)
                e_g = (1.0 + g_eff) * e_c - g_eff * e_u
                if resc > 0.0:
                    std_c = e_c.std(dim=(1, 2, 3), keepdim=True, correction=0)
                    std_g = e_g.std(dim=(1, 2, 3), keepdim=True, correction=0)
                    e_r = e_g * (std_c / std_g.clamp_min(1e-8))
                    e_g = resc * e_r + (1.0 - resc) * e_g
                return e_g

        shape = (num, self.latent_size, self.latent_size, self.cfg.model.latent_dim)
        latents = _SAMPLERS[sampler](
            guided, self.schedule, generator, shape=shape,
            initial_latent=initial_latent, num_inference_steps=steps,
            clip_x0=self.cfg.model.latent_clamp)
        return vae_decode(params["vae"], latents.to(text_emb.dtype), text_emb,
                          text_bias=text_bias_from_mask(text_mask),
                          image_size=self.cfg.data.image_size,
                          dtype=self.compute_dtype)

    # -- public API ------------------------------------------------------------

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def generate_from_text(self, description: str, num_inference_steps: int = 50,
                           seed: Optional[int] = None) -> Image.Image:
        ids, mask = self._encode_ids([description])
        imgs = self._generate_impl(self.params, self._generator(seed), ids, mask,
                                   steps=num_inference_steps, num=1,
                                   sampler=self.sampler_name)
        return tensor_to_pil(imgs[0].float().cpu().numpy())

    def generate_batch(self, descriptions: Sequence[str],
                       num_inference_steps: int = 50, seed: Optional[int] = None,
                       sampler: Optional[str] = None) -> np.ndarray:
        """N descriptions -> [N, H, W, 3] float32 in [-1, 1], drawn from the
        prior."""
        ids, mask = self._encode_ids(descriptions)
        imgs = self._generate_impl(self.params, self._generator(seed), ids, mask,
                                   steps=num_inference_steps, num=len(descriptions),
                                   sampler=sampler or self.sampler_name)
        return imgs.float().cpu().numpy()
