"""Serving generator: text -> sprite and image+text -> sprite (port of
``psg_tpu/serve/generator.py``).

The chain is the reference's ``PokemonGenerator._generate_impl``: WordPiece
tokenize, encode the text (BERT -> projection -> LayerNorm), run one of six
samplers over the UNet, decode the 27x27x8 latent with the VAE.  With
guidance on, DDIM and DPM-Solver++ put both classifier-free-guidance
branches through ONE batch-2N UNet call per step (fused CFG) and combine
them in fp32, with the optional guidance rescale and guidance interval; the
four DDPM-family samplers run unguided, as in the reference.

Around the chain:
- image+text -> sprite: encode the image with the VAE encoder,
  ``reparameterize``, lerp ``latent*(1-s) + noise*s``, then the chain;
- restart passes: re-encode the draft, lerp hard toward fresh noise and
  resample (the same image-seeded chain);
- retrieval seeding: the chain starts from the latent of the dataset sprite
  whose caption is nearest the prompt (hybrid of the text tower's pooled
  embedding and a caption TF-IDF cosine);
- CFG negatives: the cond-dropout zero embedding, the mean embedding of the
  dataset's first 128 captions, or a negative prompt.

Randomness comes from a ``torch.Generator`` on the model's device, seeded
per request.  The internal functions (``_encode_impl``, ``_img2img``,
``_restart_passes``, ``_serve``, ``_generate_impl``) also take the draws
themselves, which is how the tests inject the reference's ``jax.random``
draws.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a GPU and without an explicit ``"cpu"``,
construction raises.

On a mesh (``mesh=``, ``parallel/``) the UNet's wide kernels are cut by
``unet_tp_rules`` over 'model' (at ``extra.tp_min_channels``, 640 by
default; VAE and text encoder whole on every rank) and gathered whole for
each request.  ``generate_batch`` pads the batch to a multiple of 'data',
each rank runs its rows with the request's draws made at the global shape
(``core/draws.py``), and an all-gather returns the whole batch on every
rank; the images equal the single-process ones.  The other public methods
run every row on every rank.

Spans (``utils.profiling``): ``psg.serve.request`` around ``_serve``, which
every entry point goes through; inside it, a pass at a time,
``psg.serve.text``, ``psg.serve.sampler`` and ``psg.serve.vae_decode``, and
``psg.serve.vae_encode`` before each image-seeded pass.
"""

from __future__ import annotations

import os
import re
from collections import Counter
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch
from PIL import Image

from psg_tpu_torch.core import draws as draws_
from psg_tpu_torch.core.checkpoint import load_serving_params
from psg_tpu_torch.core.config import Config, configure_torch
from psg_tpu_torch.diffusion.sampling import (
    ddim_sample,
    ddpm_sample,
    ddpm_sample_fast,
    ddpm_sample_renoise,
    ddpm_sample_x0,
    dpmpp_2m_sample,
    fast_stride,
)
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
from psg_tpu_torch.models.vae import (
    latent_size_for,
    reparameterize,
    vae_decode,
    vae_encoder_apply,
    vae_init,
)
from psg_tpu_torch.nn.layers import prepare_weights
from psg_tpu_torch.text.tokenizer import WordPieceTokenizer
from psg_tpu_torch.utils.images import pil_to_array, tensor_to_pil
from psg_tpu_torch.utils.profiling import span

_SAMPLERS = {
    "ddim": ddim_sample,              # quality default: correct striding + CFG
    "dpmpp": dpmpp_2m_sample,         # 2nd order: DDIM@50 quality in ~10 evals
    "renoise": ddpm_sample_renoise,   # the reference's gradio variant
    "ddpm": ddpm_sample,              # canonical posterior variance
    "fast": ddpm_sample_fast,
    "x0": ddpm_sample_x0,
}
_GUIDED = ("ddim", "dpmpp")
_SPAN_REQUEST = "psg.serve.request"
_SPAN_TEXT = "psg.serve.text"
_SPAN_SAMPLER = "psg.serve.sampler"
_SPAN_VAE_DECODE = "psg.serve.vae_decode"
_SPAN_VAE_ENCODE = "psg.serve.vae_encode"
RETRIEVAL_MODES = ("hybrid", "embed", "lexical")


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; there is no silent CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' to "
                               "run on the CPU")
        device = "cuda"
    return torch.device(device)


def find_tokenizer(cfg: Config) -> WordPieceTokenizer:
    """The reference generator's vocabulary resolution: ``vocab.txt`` in the
    experiment dir, then ``config/vocab.txt``; then the pretrained-BERT
    vocabulary when both ``$PSG_TPU_BERT`` and ``$PSG_TPU_BERT_VOCAB`` exist
    (saved to the experiment dir, so later runs resolve it the same way);
    else a vocabulary built from the caption CSV."""
    exp = Path(cfg.experiment_dir)
    for cand in (exp / "vocab.txt", Path("config/vocab.txt")):
        if cand.exists():
            return WordPieceTokenizer.from_vocab_file(cand)
    bert_ckpt = Path(os.environ.get("PSG_TPU_BERT", "weights/bert_base.ckpt"))
    bert_vocab = Path(os.environ.get("PSG_TPU_BERT_VOCAB", "weights/bert_vocab.txt"))
    if bert_vocab.exists() and bert_ckpt.exists():
        tok = WordPieceTokenizer.from_vocab_file(bert_vocab)
        exp.mkdir(parents=True, exist_ok=True)
        tok.save_vocab(exp / "vocab.txt")
        return tok
    from psg_tpu_torch.data.dataset import full_description, read_description_csv

    rows = read_description_csv(cfg.data.csv_path)
    return WordPieceTokenizer.from_corpus(
        [full_description(r["english_name"], r["description"]) for r in rows])


def init_params(cfg: Config, bert_cfg, spec, seed: int, device) -> dict:
    """Random serving parameters {vae, text, unet} drawn on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    m = cfg.model
    return {
        "vae": vae_init(gen, m.latent_dim, m.text_embedding_dim, m.vae_width_scale),
        "text": text_encoder_init(gen, bert_cfg, m.text_embedding_dim),
        "unet": unet_init(gen, spec),
    }


def lerp_to_noise(latent, noise, strength: float):
    """``latent*(1-s) + noise*s`` in the latent's dtype, the two weights
    rounded to it first as the reference's weakly typed scalars are."""
    keep = torch.tensor(1.0 - strength, dtype=latent.dtype)
    mix = torch.tensor(strength, dtype=latent.dtype)
    return latent * keep + noise.to(latent.dtype) * mix


class _TfidfIndex:
    """Log-TF-IDF cosine retrieval over the caption corpus (a copy of the
    reference's): the lexical half of hybrid caption retrieval, robust to
    reworded prompts.  Queries are one matvec over a dense fp32 [N, V]."""

    _TOKEN = re.compile(r"[a-z]+")

    def __init__(self, corpus: Sequence[str]):
        docs = [Counter(self._TOKEN.findall(d.lower())) for d in corpus]
        df = Counter()
        for d in docs:
            df.update(d.keys())
        self.vocab = {w: i for i, w in enumerate(sorted(df))}
        n = len(docs)
        self.idf = np.zeros(len(self.vocab), np.float32)
        for w, i in self.vocab.items():
            self.idf[i] = np.log(n / (1.0 + df[w]))
        mat = np.zeros((n, len(self.vocab)), np.float32)
        for r, d in enumerate(docs):
            for w, c in d.items():
                mat[r, self.vocab[w]] = (1.0 + np.log(c)) * self.idf[self.vocab[w]]
        mat /= np.maximum(np.linalg.norm(mat, axis=1, keepdims=True), 1e-8)
        self.mat = mat

    def _vec(self, text: str) -> np.ndarray:
        q = np.zeros(self.mat.shape[1], np.float32)
        for w, c in Counter(self._TOKEN.findall(text.lower())).items():
            i = self.vocab.get(w)
            if i is not None:
                q[i] = (1.0 + np.log(c)) * self.idf[i]
        return q / max(float(np.linalg.norm(q)), 1e-8)

    def sims(self, text: str) -> np.ndarray:
        """Cosine similarity of ``text`` against every corpus caption."""
        return self.mat @ self._vec(text)


class PokemonGenerator:
    def __init__(self, cfg: Config, vae_checkpoint=None, diffusion_checkpoint=None,
                 tokenizer=None, schedule_kind: str = "linear",
                 sampler: str = "ddim", guidance_scale: float = 0.0,
                 negative: str = "zero", retrieval_mode: str = "hybrid",
                 prediction_type: str = "eps", *, device=None, params=None, mesh=None):
        """``params``: a parameter tree in this package's layout (e.g. from
        ``models.bridge.from_jax``) used instead of checkpoints; without
        either, parameters are drawn from ``cfg.seed``.  ``mesh``: a
        ('data', 'model') ``DeviceMesh`` this rank serves on."""
        self.device = resolve_device(device)
        self.mesh_run = None
        if self.device.type == "cuda":
            configure_torch(cfg)
        self.cfg = cfg
        if prediction_type not in ("eps", "v"):
            raise ValueError(f"unknown prediction_type {prediction_type!r}")
        if sampler not in _SAMPLERS:
            raise ValueError(f"sampler {sampler!r} not available "
                             f"(have {sorted(_SAMPLERS)})")
        if retrieval_mode not in RETRIEVAL_MODES:
            raise ValueError(f"unknown retrieval_mode {retrieval_mode!r}")
        self.prediction_type = prediction_type
        self.retrieval_mode = retrieval_mode
        self.vae_checkpoint = str(vae_checkpoint) if vae_checkpoint else None
        self.diffusion_checkpoint = (str(diffusion_checkpoint)
                                     if diffusion_checkpoint else None)
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
        if mesh is not None:
            from psg_tpu_torch.train.common import MeshRun

            self.mesh_run = MeshRun(mesh, self.params["unet"], tp_min_channels=int(
                (cfg.extra or {}).get("tp_min_channels", 640)))
            self.params["unet"] = self.mesh_run.layout.shard(self.params["unet"])

        # CFG negative branch: "zero" is the cond-dropout zero embedding,
        # "mean" the mean dataset-caption embedding (an in-distribution
        # negative that needs no special training), any other string a
        # negative prompt; embedded once here
        self.negative = negative
        self._neg_emb = self._neg_mask = None
        if negative != "zero":
            self._neg_emb, self._neg_mask = self._negative_embedding(negative)
        self._retr = None

    def set_guidance(self, scale=None, rescale=None, interval_lo=None,
                     interval_hi=None) -> None:
        """Change the CFG knobs of a live generator (``interval_lo/hi`` are
        fractions of T, like the config keys).  The chain reads them at
        every request, so nothing is rebuilt."""
        if scale is not None:
            self.guidance_scale = float(scale)
        if rescale is not None:
            self.guidance_rescale = float(rescale)
        T = self.cfg.model.num_timesteps
        if interval_lo is not None:
            self.guidance_t_lo = float(interval_lo) * T
        if interval_hi is not None:
            self.guidance_t_hi = float(interval_hi) * T

    # -- text ------------------------------------------------------------------

    def _encode_ids(self, texts: Sequence[str]):
        ids, mask = self.tokenizer.encode_batch(list(texts), self.cfg.data.text_len)
        return (torch.from_numpy(ids).long().to(self.device),
                torch.from_numpy(mask).long().to(self.device))

    @torch.no_grad()
    def _embed(self, ids, mask):
        return text_encoder_apply(self.params["text"], ids, mask, self.bert_cfg,
                                  dtype=self.compute_dtype)

    def _negative_embedding(self, negative: str, max_captions: int = 128):
        """-> ([1,S,D] embedding, [1,S] mask) for the CFG negative branch."""
        if negative == "mean":
            from psg_tpu_torch.data.dataset import full_description, read_description_csv

            rows = read_description_csv(self.cfg.data.csv_path)[:max_captions]
            caps = [full_description(r["english_name"], r["description"]) for r in rows]
        else:
            caps = [negative]
        ids, mask = self._encode_ids(caps)
        emb = self._embed(ids, mask)
        if negative == "mean":
            # the mean of the per-caption sequence embeddings, attending to
            # every position
            return (emb.float().mean(dim=0, keepdim=True).to(emb.dtype),
                    torch.ones((1, mask.shape[1]), dtype=mask.dtype, device=mask.device))
        return emb, mask

    # -- the chain -----------------------------------------------------------

    @torch.no_grad()
    def _encode_impl(self, params, generator, images, noise=None):
        """images [N, H, W, 3] in [-1, 1] -> reparameterized latents [N, h, w,
        latent_dim] in the encoder's output dtype; ``noise`` (fp32, the
        latent's shape) replaces the draw."""
        with span(_SPAN_VAE_ENCODE):
            mu, logvar = vae_encoder_apply(params["vae"]["encoder"], images,
                                           dtype=self.compute_dtype)
            return reparameterize(generator, mu, logvar, noise=noise)

    @torch.no_grad()
    def _generate_impl(self, params, generator, text_ids, text_mask,
                       initial_latent=None, *, steps: int, num: int, sampler: str,
                       noises=None):
        """ids/mask [N, S] on the device -> images [N, H, W, 3] in [-1, 1].
        ``noises`` ([evals, N, h, w, c]) replaces the per-step draws of the
        four DDPM-family samplers."""
        with span(_SPAN_TEXT):
            text_emb = text_encoder_apply(params["text"], text_ids, text_mask,
                                          self.bert_cfg, dtype=self.compute_dtype)

        def denoise(x, t):
            out = unet_apply(params["unet"], x.to(text_emb.dtype), t, text_emb,
                             self.spec, text_mask=text_mask, dtype=self.compute_dtype)
            if self.prediction_type == "v":
                out = self.schedule.eps_from_v(out, x, t)
            return out

        shape = (num, self.latent_size, self.latent_size, self.cfg.model.latent_dim)
        fn = _SAMPLERS[sampler]
        with span(_SPAN_SAMPLER):
            if sampler in _GUIDED:
                latents = fn(self._guided(params, denoise, text_emb, text_mask),
                             self.schedule, generator, shape=shape,
                             initial_latent=initial_latent, num_inference_steps=steps,
                             clip_x0=self.cfg.model.latent_clamp)
            elif sampler == "fast":
                latents = fn(denoise, self.schedule, generator, shape=shape,
                             initial_latent=initial_latent,
                             stride=fast_stride(self.schedule.num_timesteps, steps),
                             noises=noises)
            else:  # renoise, ddpm, x0: unguided, strided to ``steps``
                latents = fn(denoise, self.schedule, generator, shape=shape,
                             initial_latent=initial_latent, num_inference_steps=steps,
                             noises=noises)
        with span(_SPAN_VAE_DECODE):
            return vae_decode(params["vae"], latents.to(text_emb.dtype), text_emb,
                              text_bias=text_bias_from_mask(text_mask),
                              image_size=self.cfg.data.image_size,
                              dtype=self.compute_dtype)

    def _guided(self, params, denoise, text_emb, text_mask):
        """The denoise function DDIM and DPM-Solver++ run: ``denoise`` itself
        at guidance 0, else fused CFG."""
        if self.guidance_scale <= 0.0:
            return denoise
        if self._neg_emb is not None:
            neg_emb = self._neg_emb.to(text_emb.dtype).expand_as(text_emb)
            neg_mask = self._neg_mask.expand_as(text_mask)
        else:  # cond-dropout zero embedding
            neg_emb = torch.zeros_like(text_emb)
            neg_mask = text_mask
        # fused CFG: both branches in one batch-2N UNet call, so the weights
        # are read once per step; the guided eps is combined here in fp32
        # and the sampler runs with guidance 0
        emb_cat = torch.cat([text_emb, neg_emb], dim=0)
        mask_cat = torch.cat([text_mask, neg_mask], dim=0)
        g = self.guidance_scale
        resc = self.guidance_rescale
        t_lo, t_hi = self.guidance_t_lo, self.guidance_t_hi

        def guided(x, t):
            xx = torch.cat([x, x], dim=0)
            tt = torch.cat([t, t], dim=0)
            eps = unet_apply(params["unet"], xx.to(text_emb.dtype), tt, emb_cat,
                             self.spec, text_mask=mask_cat, dtype=self.compute_dtype)
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

        return guided

    def _img2img(self, images, ids, mask, generator, *, steps: int, num: int,
                 sampler: str, strength: float, draws=None, params=None):
        """Encode ``images``, lerp the latent toward noise at ``strength``
        (none at 0), run the chain from it.  ``draws``: (encoder noise, lerp
        noise) replacing the two draws."""
        params = params if params is not None else self.params
        enc_noise, lerp_noise = draws if draws is not None else (None, None)
        latent = self._encode_impl(params, generator, images, noise=enc_noise)
        if strength > 0:
            if lerp_noise is None:   # drawn in the latent's dtype (bf16 at full width)
                lerp_noise = draws_.randn(generator, latent.shape, device=latent.device,
                                         dtype=latent.dtype)
            latent = lerp_to_noise(latent, lerp_noise, strength)
        return self._generate_impl(params, generator, ids, mask, latent,
                                   steps=steps, num=num, sampler=sampler)

    def _restart_passes(self, imgs, ids, mask, generator, *, steps: int, num: int,
                        sampler: str, restarts: int, strength: float, draws=None,
                        params=None):
        """Restart sampling (cf. Xu et al. 2023): re-encode the draft, mix hard
        with fresh noise, resample; ``restarts`` times.  ``draws[i]`` replaces
        pass i's draws (see ``_img2img``)."""
        for i in range(restarts):
            imgs = self._img2img(imgs, ids, mask, generator, steps=steps, num=num,
                                 sampler=sampler, strength=strength,
                                 draws=draws[i] if draws is not None else None,
                                 params=params)
        return imgs

    def _serve(self, ids, mask, generator, *, steps: int, num: int, sampler: str,
               init_images=None, init_strength: float = 0.85, restarts: int = 0,
               restart_strength: float = 0.9, draws=None):
        """One request: the chain from the prior, or from ``init_images``
        [N, H, W, 3] (image+text, retrieval seeding), then the restart passes.
        ``draws`` (tests): {"prior": initial latent, "init": (encoder noise,
        lerp noise), "restarts": [(encoder noise, lerp noise), ...]}.  On a
        mesh the UNet is gathered whole for the request."""
        draws = draws or {}
        params = self.params
        with span(_SPAN_REQUEST):
            if self.mesh_run is not None:
                params = dict(params, unet=self.mesh_run.gather(params["unet"]))
            if init_images is not None:
                imgs = self._img2img(init_images, ids, mask, generator, steps=steps,
                                     num=num, sampler=sampler, strength=init_strength,
                                     draws=draws.get("init"), params=params)
            else:
                imgs = self._generate_impl(params, generator, ids, mask,
                                           draws.get("prior"), steps=steps, num=num,
                                           sampler=sampler)
            return self._restart_passes(imgs, ids, mask, generator, steps=steps,
                                        num=num, sampler=sampler, restarts=restarts,
                                        strength=restart_strength,
                                        draws=draws.get("restarts"), params=params)

    # -- retrieval -------------------------------------------------------------

    def _pooled(self, ids, mask) -> np.ndarray:
        """Masked-mean text embeddings [N, D] in fp32, on the host."""
        e = self._embed(ids, mask).float()
        m = mask[:, :, None].float()
        return ((e * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)).cpu().numpy()

    def _retrieval_index(self):
        """Lazy (pooled caption embeddings [N, D], dataset, TF-IDF index),
        from the serving config's dataset paths: the text tower's masked-mean
        embedding (exact-wording matches) and a caption TF-IDF cosine
        (content-word matches)."""
        if self._retr is None:
            from psg_tpu_torch.data.dataset import PokemonDataset

            ds = PokemonDataset(self.cfg.data.csv_path, self.cfg.data.image_dir,
                                image_size=self.cfg.data.image_size,
                                text_len=self.cfg.data.text_len)
            ids, mask = self._encode_ids(ds.full_descriptions)
            pooled = np.concatenate([self._pooled(ids[s:s + 64], mask[s:s + 64])
                                     for s in range(0, ids.shape[0], 64)], axis=0)
            pooled /= np.maximum(np.linalg.norm(pooled, axis=1, keepdims=True), 1e-8)
            self._retr = (pooled, ds, _TfidfIndex(ds.full_descriptions))
        return self._retr

    def _query_embedding(self, description: str) -> np.ndarray:
        """L2-normalized masked-mean text embedding of one description."""
        q = self._pooled(*self._encode_ids([description]))[0]
        return q / max(float(np.linalg.norm(q)), 1e-8)

    def retrieve_nearest(self, description: str, exclude: Optional[int] = None,
                         mode: Optional[str] = None) -> int:
        """Index of the dataset sprite whose caption is closest to
        ``description``.  ``mode``: 'hybrid' (the mean of the embedding and
        TF-IDF cosines), 'embed' (text tower only) or 'lexical' (TF-IDF
        only); ``exclude`` masks one index out (leave-one-out evaluation)."""
        mode = mode or self.retrieval_mode
        if mode not in RETRIEVAL_MODES:
            raise ValueError(f"unknown retrieval mode {mode!r}")
        pooled, _, tfidf = self._retrieval_index()
        sims = 0.0
        if mode in ("hybrid", "embed"):
            sims = sims + pooled @ self._query_embedding(description)
        if mode in ("hybrid", "lexical"):
            sims = sims + tfidf.sims(description)
        if mode == "hybrid":
            sims = sims / 2.0
        if exclude is not None:
            sims = sims.copy()
            sims[exclude] = -np.inf
        return int(np.argmax(sims))

    def _retrieval_images(self, descriptions: Sequence[str],
                          exclude: Optional[int] = None):
        """[N, H, W, 3] fp32 on the device: each prompt's nearest sprite."""
        _, ds, _ = self._retrieval_index()
        arr = np.stack([ds.image_float(self.retrieve_nearest(d, exclude=exclude))
                        for d in descriptions])
        return torch.from_numpy(arr).to(self.device)

    # -- public API ------------------------------------------------------------

    def _generator(self, seed: Optional[int]) -> torch.Generator:
        if seed is None:
            seed = int(np.random.randint(0, 2**31 - 1))
            if self.mesh_run is not None:    # every rank draws rank 0's seed
                seed = int(self.mesh_run.broadcast(torch.tensor(seed, device=self.device)))
        return torch.Generator(device=self.device).manual_seed(int(seed))

    def generate_from_text(self, description: str, num_inference_steps: int = 50,
                           seed: Optional[int] = None, restarts: int = 0,
                           restart_strength: float = 0.9) -> Image.Image:
        """Text -> sprite from the prior; ``restarts`` > 0 runs that many
        restart passes after the base chain."""
        ids, mask = self._encode_ids([description])
        imgs = self._serve(ids, mask, self._generator(seed), steps=num_inference_steps,
                           num=1, sampler=self.sampler_name, restarts=restarts,
                           restart_strength=restart_strength)
        return tensor_to_pil(imgs[0].float().cpu().numpy())

    def generate_from_text_retrieval(self, description: str,
                                     num_inference_steps: int = 50,
                                     seed: Optional[int] = None,
                                     strength: float = 0.85, restarts: int = 0,
                                     exclude: Optional[int] = None) -> Image.Image:
        """Text -> sprite seeded from the nearest dataset sprite's latent at
        ``strength`` noise (automatic img2img); restarts at that strength."""
        init = self._retrieval_images([description], exclude=exclude)
        ids, mask = self._encode_ids([description])
        imgs = self._serve(ids, mask, self._generator(seed), steps=num_inference_steps,
                           num=1, sampler=self.sampler_name, init_images=init,
                           init_strength=strength, restarts=restarts,
                           restart_strength=strength)
        return tensor_to_pil(imgs[0].float().cpu().numpy())

    def generate_from_image_and_text(self, input_image: Image.Image, description: str,
                                     num_inference_steps: int = 50,
                                     noise_strength: float = 0.7,
                                     seed: Optional[int] = None) -> Image.Image:
        """img2img via the latent lerp (the reference UI's second tab)."""
        arr = pil_to_array(input_image, self.cfg.data.image_size)[None]
        ids, mask = self._encode_ids([description])
        imgs = self._serve(ids, mask, self._generator(seed), steps=num_inference_steps,
                           num=1, sampler=self.sampler_name,
                           init_images=torch.from_numpy(arr).to(self.device),
                           init_strength=noise_strength)
        return tensor_to_pil(imgs[0].float().cpu().numpy())

    def generate_batch(self, descriptions: Sequence[str],
                       num_inference_steps: int = 50, seed: Optional[int] = None,
                       sampler: Optional[str] = None, restarts: int = 0,
                       restart_strength: float = 0.9, init: str = "prior",
                       init_strength: float = 0.85) -> np.ndarray:
        """N descriptions -> [N, H, W, 3] float32 in [-1, 1].  ``init``:
        'prior', or 'retrieval' to seed every chain from its prompt's nearest
        dataset sprite at ``init_strength``.  On a mesh each rank runs its
        rows of the batch padded to a multiple of 'data', and every rank
        returns the whole batch."""
        if init not in ("prior", "retrieval"):
            raise ValueError(f"unknown init {init!r}")
        init_images = (self._retrieval_images(descriptions) if init == "retrieval"
                       else None)
        ids, mask = self._encode_ids(descriptions)
        n, gen, mr = len(descriptions), self._generator(seed), self.mesh_run
        if mr is not None:
            inits = [] if init_images is None else [init_images]
            gen, (ids, mask, *inits) = mr.split_rows(gen, n, ids, mask, *inits)
            init_images = inits[0] if inits else None
        imgs = self._serve(ids, mask, gen, steps=num_inference_steps,
                           num=ids.shape[0], sampler=sampler or self.sampler_name,
                           init_images=init_images, init_strength=init_strength,
                           restarts=restarts, restart_strength=restart_strength)
        if mr is not None:
            imgs = mr.gather_rows(imgs, n)
        return imgs.float().cpu().numpy()
