"""The plain reference of one text -> sprite request.

It follows the serving chain step by step in float32: WordPiece ids, the
BERT text encoder, DPM-Solver++(2M) over the UNet with both guidance branches
in one batch and the guided eps combined in fp32, the VAE decoder, then each
restart pass (VAE encoder, reparameterize, lerp toward fresh noise, the chain
again, decode).  The request's draws are made from its seed with a
``torch.Generator`` on the device in the order the chain makes them; the
lerp noise is drawn in the configuration's compute dtype, as the served chain
draws it, and then widened.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from . import draws
from .bert import bert_config_for
from .sampling import dpmpp_2m_sample
from .schedule import make_schedule
from .text_encoder import text_encoder_apply, text_encoder_init
from .tokenizer import WordPieceTokenizer
from .unet import text_bias_from_mask, unet_apply, unet_init, unet_spec_from_config
from .vae import latent_size_for, reparameterize, vae_decode, vae_encoder_apply, vae_init

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def as_config(raw: dict):
    """The configuration dict as attribute sections (``cfg.model.latent_dim``)."""
    return SimpleNamespace(**{k: SimpleNamespace(**v) if isinstance(v, dict) else v
                              for k, v in raw.items()})


def serving_template(raw: dict, vocab_size: int, gen) -> dict:
    """The serving parameter tree {vae, text, unet}, drawn from ``gen``."""
    cfg = as_config(raw)
    m = cfg.model
    spec = unet_spec_from_config(cfg, latent_size_for(cfg.data.image_size))
    return {"vae": vae_init(gen, m.latent_dim, m.text_embedding_dim, m.vae_width_scale),
            "text": text_encoder_init(gen, bert_config_for(m.bert_model, vocab_size),
                                      m.text_embedding_dim),
            "unet": unet_init(gen, spec)}


def to_uint8(img) -> np.ndarray:
    """[-1, 1] float [H, W, 3] -> uint8, NaN as mid-grey."""
    arr = np.asarray(img, np.float32)
    arr = np.clip((np.nan_to_num(arr) + 1.0) / 2.0, 0.0, 1.0)
    return (arr * 255.0 + 0.5).astype(np.uint8)


def read_captions(csv_path, limit: int):
    """The first ``limit`` captions of a semicolon CSV, as full descriptions."""
    out = []
    for line in open(csv_path, encoding="utf-8").read().splitlines():
        if not line.strip():
            continue
        name, _, desc = line.partition(";")
        desc = desc.strip()
        if desc.startswith('"') and desc.endswith('"'):
            desc = desc[1:-1]
        parts = [f"Pokemon named {name.strip()}"] + ([desc] if desc else [])
        out.append(". ".join(parts) + ".")
        if len(out) == limit:
            break
    return out


class Generator:
    """One request at a time, as the served chain makes it, in float32."""

    def __init__(self, raw_config: dict, params: dict, vocab_path, recipe: dict, device):
        self.cfg = as_config(raw_config)
        m = self.cfg.model
        self.device = torch.device(device)
        self.params = params
        self.tok = WordPieceTokenizer.from_vocab_file(vocab_path)
        self.bert_cfg = bert_config_for(m.bert_model, self.tok.vocab_size)
        self.latent_size = latent_size_for(self.cfg.data.image_size)
        self.spec = unet_spec_from_config(self.cfg, self.latent_size)
        self.schedule = make_schedule(m.num_timesteps, m.beta_start, m.beta_end,
                                      recipe.get("schedule", "linear"))
        self.draw_dtype = DTYPES[m.compute_dtype]
        self.recipe = recipe
        extra = getattr(self.cfg, "extra", None) or {}
        extra = vars(extra) if isinstance(extra, SimpleNamespace) else extra
        self.rescale = float(extra.get("guidance_rescale", 0.0))
        T = m.num_timesteps
        self.t_lo = float(extra.get("guidance_interval_lo", 0.0)) * T
        self.t_hi = float(extra.get("guidance_interval_hi", 1.0)) * T
        self.neg = None
        if recipe["negative"] == "mean":
            caps = read_captions(self.cfg.data.csv_path, recipe.get("negative_captions", 128))
            ids, mask = self._ids(caps)
            emb = self._embed(ids, mask)
            self.neg = (emb.mean(dim=0, keepdim=True),
                        torch.ones((1, mask.shape[1]), dtype=mask.dtype, device=self.device))
        elif recipe["negative"] != "zero":
            self.neg = self._embed(*self._ids([recipe["negative"]])), None

    def _ids(self, texts):
        ids, mask = self.tok.encode_batch(list(texts), self.cfg.data.text_len)
        return (torch.from_numpy(ids).long().to(self.device),
                torch.from_numpy(mask).long().to(self.device))

    @torch.no_grad()
    def _embed(self, ids, mask):
        return text_encoder_apply(self.params["text"], ids, mask, self.bert_cfg).float()

    def _guided(self, emb, mask):
        g = float(self.recipe["guidance"])
        if self.neg is None or self.neg[1] is None:
            neg_emb = torch.zeros_like(emb) if self.neg is None else self.neg[0]
            neg_mask = mask
        else:
            neg_emb, neg_mask = self.neg[0].expand_as(emb), self.neg[1].expand_as(mask)
        emb2, mask2 = torch.cat([emb, neg_emb]), torch.cat([mask, neg_mask])

        def denoise(x, t):
            eps = unet_apply(self.params["unet"], torch.cat([x, x]), torch.cat([t, t]),
                             emb2, self.spec, text_mask=mask2).float()
            e_c, e_u = eps.chunk(2, dim=0)
            ti = float(t[0])
            g_eff = g if self.t_lo <= ti <= self.t_hi else 0.0
            e_g = (1.0 + g_eff) * e_c - g_eff * e_u
            if self.rescale > 0.0:
                std_c = e_c.std(dim=(1, 2, 3), keepdim=True, correction=0)
                std_g = e_g.std(dim=(1, 2, 3), keepdim=True, correction=0)
                e_g = self.rescale * e_g * (std_c / std_g.clamp_min(1e-8)) \
                    + (1.0 - self.rescale) * e_g
            return e_g

        return denoise

    def _chain(self, gen, emb, mask, initial):
        m = self.cfg.model
        shape = (1, self.latent_size, self.latent_size, m.latent_dim)
        lat = dpmpp_2m_sample(self._guided(emb, mask), self.schedule, gen, shape=shape,
                              initial_latent=initial,
                              num_inference_steps=int(self.recipe["steps"]),
                              clip_x0=m.latent_clamp)
        return vae_decode(self.params["vae"], lat.float(), emb,
                          text_bias=text_bias_from_mask(mask),
                          image_size=self.cfg.data.image_size).float()

    @torch.no_grad()
    def generate(self, prompt: str, seed: int) -> np.ndarray:
        """One request -> uint8 [H, W, 3]."""
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        ids, mask = self._ids([prompt])
        emb = self._embed(ids, mask)
        img = self._chain(gen, emb, mask, None)
        strength = float(self.recipe["restart_strength"])
        for _ in range(int(self.recipe["restarts"])):
            mu, logvar = vae_encoder_apply(self.params["vae"]["encoder"], img)
            lat = reparameterize(gen, mu.float(), logvar.float())
            noise = draws.randn(gen, lat.shape, device=lat.device,
                                dtype=self.draw_dtype).float()
            lat = lat * (1.0 - strength) + noise * strength
            img = self._chain(gen, emb, mask, lat)
        return to_uint8(img[0].cpu().numpy())
