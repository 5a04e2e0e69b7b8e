"""Stage 2: UNet diffusion training on frozen VAE latents (port of
``psg_tpu/train/stage2_diffusion.py``: the classic loader path and the
device-resident fast path).

A step: the frozen text encoder and VAE encoder (no gradient), the
reparameterized latent clamped to +-latent_clamp, ``q_sample`` at a uniform
timestep, the UNet forward with attention dropout, SmoothL1(beta 0.1) or MSE
on the noise (or, with ``extra.prediction_type`` 'v', the velocity) with
optional min-SNR weighting and cond-dropout, the backward, then the
optimizer (``train/optim.py``: skip non-finite and norm-exploded steps,
clip, AdamW) and the EMA of the parameters, ``d*e + (1-d)*p`` after the
update.  On the card GroupNorm+SiLU and flash attention run their kernels
forward and differentiate their plain versions backward (``ops``).

Randomness: the trainer's ``torch.Generator`` (seeded from ``cfg.seed``,
saved in the train state) draws the reparameterize noise, ``t``, the noise,
the cond-dropout mask and the dropout masks, in that order.  Torch cannot
replay ``jax.random``, so ``_noise_loss`` and ``_step`` also take these
draws (``draws``), which is how the tests inject the JAX trainer's.
Validation draws from a generator seeded the same way for every batch, as
the JAX trainer folds one fixed key.

With ``training.fast_path`` ``train()`` takes the device-resident path
(``train/fastpath.py``): the split on the device, each step's minibatch
drawn, gathered and augmented there, the frozen text embeddings precomputed
once (or, with ``extra.caption_augment``, a drawn caption variant encoded
in the step), then the classic step's ``_grads`` and ``_apply_update``; the
best checkpoints are light (bf16 sampling params on the ``best_every``
cadence) and one full periodic state is written at the end.  Its draws, in
order: the index uniforms, the augmentation parameters, the variant index,
then the loss's; ``train_epoch_fast`` and ``validate_fast`` take them too
(``draws``, one dict a step or a validation batch).

On a mesh (``mesh=``, ``parallel/``) the trainer runs the classic path as
the JAX trainer does on its mesh: every rank loads the global batch and
keeps its rows, draws at the global shape and keeps its rows
(``train/common.py::MeshRun``), averages gradients over 'data', and with a
'model' axis holds its shards of the UNet's wide kernels, their EMA and
moments (the rule ``unet_tp_rules`` at ``extra.tp_min_channels``, 640 by
default); the frozen VAE and text encoder are whole on every rank.  Loss,
gradients, parameters, the EMA and checkpoints then equal the
single-process run's.  The fast path is off on a mesh, as in JAX.

The step, validation, checkpoints, loops and spans are ``StageTrainer``'s
(``train/trainer.py``); the step's optimizer is followed by the EMA
(``psg.train.ema``), and the classic loop ends with a final periodic write,
as the JAX trainer's ``_train_classic`` does.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Dict, Optional

import torch

from psg_tpu_torch.core import draws as draws_
from psg_tpu_torch.core import tree
from psg_tpu_torch.core.checkpoint import load_params, wait_for_writes
from psg_tpu_torch.core.config import Config
from psg_tpu_torch.diffusion.sampling import ddim_sample, ddpm_sample_fast, dpmpp_2m_sample
from psg_tpu_torch.diffusion.schedule import make_schedule
from psg_tpu_torch.models.losses import mse_loss, smooth_l1_loss
from psg_tpu_torch.models.text_encoder import text_encoder_apply, text_encoder_init
from psg_tpu_torch.models.unet import (  # noqa: F401  (re-exported, as in psg_tpu)
    text_bias_from_mask,
    unet_apply,
    unet_init,
    unet_spatial_for,
    unet_spec_from_config,
)
from psg_tpu_torch.models.vae import reparameterize, vae_decode, vae_encoder_apply, vae_init
from psg_tpu_torch.nn.layers import prepare_weights
from psg_tpu_torch.train.fastpath import FastPath
from psg_tpu_torch.train.optim import build_optimizer, make_lr_schedule
from psg_tpu_torch.train.trainer import StageTrainer


class DiffusionTrainer(FastPath, StageTrainer):
    """Stage-2 trainer."""

    STAGE, EPOCHS, LOSS = "diffusion", "diffusion_epochs", "loss"
    LOG_LINE = "loss {loss:.4f} gnorm {grad_norm:.2f}"
    VAL_SEED_OFFSET = 2            # the validation draws' generator: cfg.seed + 2
    SAMPLE_SEED_OFFSET = 20_000    # sample grid of epoch e: cfg.seed + 20000 + e
    FINAL_SAVE = True

    def __init__(self, cfg: Config, vae_checkpoint_path, experiment_name: str = "pokemon",
                 *, device=None, mesh=None):
        """``vae_checkpoint_path``: the stage-1 checkpoint holding the frozen
        ``vae`` and ``text`` parameters; it must exist and fit.  ``None``
        draws them from ``cfg.seed`` (as serving does without a
        checkpoint).  ``mesh``: a ('data', 'model') ``DeviceMesh``
        (``parallel.make_mesh``) this rank trains on."""
        self._setup(cfg, experiment_name, device, mesh)
        m = cfg.model
        self.spec = unet_spec_from_config(cfg, self.latent_size)
        self.vae_ckpt_path = str(vae_checkpoint_path) if vae_checkpoint_path else None
        self.frozen = self._load_frozen(vae_checkpoint_path)
        self.schedule = make_schedule(m.num_timesteps, m.beta_start, m.beta_end,
                                      m.beta_schedule)

        unet_params = unet_init(self._generator(1), self.spec)
        extra = cfg.extra or {}
        uo = extra.get("unet_optimization", {})
        o = cfg.optimization
        spe = max(len(self.train_loader), 1)
        # stage-2 'cosine' is OneCycle with pct_start warmup; 'legacy_cosine'
        # the plain cosine anneal
        kind = {"cosine": "onecycle", "legacy_cosine": "cosine"}.get(
            uo.get("scheduler", o.scheduler), uo.get("scheduler", o.scheduler))
        lr_sched = make_lr_schedule(kind, uo.get("learning_rate", o.learning_rate),
                                    total_steps=cfg.training.diffusion_epochs * spe,
                                    steps_per_epoch=spe, pct_start=o.onecycle_pct_start,
                                    warmup_steps=uo.get("warmup_steps", o.warmup_steps),
                                    end_factor=o.lr_end_factor)
        # AdamW eps 1e-6 for stability
        opt_cfg = dataclasses.replace(o, eps=1e-6,
                                      weight_decay=uo.get("weight_decay", o.weight_decay))
        self.tx = build_optimizer(
            opt_cfg, {"unet": {"lr_schedule": lr_sched,
                               "max_grad_norm": uo.get("max_grad_norm", o.max_grad_norm)}},
            tree.map(lambda _: "unet", unet_params))
        self.ema_decay = float(o.ema_decay)
        self._start(unet_params)
        self.loss_kind = extra.get("diffusion_loss", "smooth_l1")
        self.pred_type = str(extra.get("prediction_type", "eps"))
        if self.pred_type not in ("eps", "v"):
            raise ValueError(f"unknown extra.prediction_type {self.pred_type!r} "
                             f"(want 'eps' or 'v')")
        self.snr_gamma = float(extra.get("snr_gamma", 0.0) or 0.0)
        self.cond_dropout = float(extra.get("cond_dropout", 0.0) or 0.0)
        self.caption_augment = int(extra.get("caption_augment", 0) or 0)
        if self.caption_augment > 0:
            # a variant per sample: drawn by the loader (data/loader.py), or by
            # the fast step on the device
            self.ds.set_caption_variants(
                self.caption_augment, int(extra.get("caption_aug_seed", cfg.seed)),
                p_name_drop=float(extra.get("caption_name_drop", 0.5)))

    # -- setup ---------------------------------------------------------------

    def _load_frozen(self, vae_checkpoint_path) -> Dict:
        """The frozen {'vae', 'text'} parameters: from a stage-1 checkpoint,
        which must exist and fit (no random fallback), or drawn from
        ``cfg.seed`` when none is named.  Matmul and conv kernels are kept
        in the compute dtype."""
        m = self.cfg.model
        gen = self._generator()
        template = {"vae": vae_init(gen, m.latent_dim, m.text_embedding_dim,
                                    m.vae_width_scale),
                    "text": text_encoder_init(gen, self.bert_cfg, m.text_embedding_dim)}
        if vae_checkpoint_path is None:
            self.log.warning("no VAE checkpoint named: frozen VAE/text drawn from seed %d",
                             self.cfg.seed)
            params = template
        else:
            wait_for_writes()     # this process may still be writing it (--stage all)
            if not Path(vae_checkpoint_path).exists():
                raise FileNotFoundError(f"VAE checkpoint not found: {vae_checkpoint_path}")
            params = load_params(vae_checkpoint_path, template)
            self.log.info("loaded frozen VAE/text from %s", vae_checkpoint_path)
        return prepare_weights(params, self.compute_dtype)

    # -- the loss ------------------------------------------------------------

    def _text(self, frozen, batch):
        if "text_emb" in batch:         # the fast path's precomputed embeddings
            return batch["text_emb"]
        with torch.no_grad():
            return text_encoder_apply(frozen["text"], batch["text_ids"], batch["text_mask"],
                                      self.bert_cfg, dtype=self.compute_dtype)

    def _noise_loss(self, unet_params, frozen, batch, generator, draws=None, dropout=None,
                    sample_weights=None, train: bool = True):
        """Diffusion loss of a batch with the frozen text encoder and VAE.
        Draws come from ``generator`` unless ``draws`` gives them:
        ``rep_noise`` (the latent's shape), ``t`` [B], ``noise`` (the
        latent's shape), ``keep`` [B, 1, 1] (cond-dropout).  ``dropout``: the
        UNet's attention dropout (``models/unet.py``), None for none."""
        text_emb = self._text(frozen, batch)
        with torch.no_grad():
            mu, logvar = vae_encoder_apply(frozen["vae"]["encoder"], batch["image"],
                                           dtype=self.compute_dtype)
            rep = self._draw(draws, "rep_noise", lambda: draws_.randn(
                generator, mu.shape, device=self.device))
            latent = reparameterize(None, mu, logvar, noise=rep)
            clamp = self.cfg.model.latent_clamp
            latent = latent.clamp(-clamp, clamp)
            b = latent.shape[0]
            t = self._draw(draws, "t", lambda: draws_.randint(
                generator, 0, self.schedule.num_timesteps, (b,), device=self.device)).long()
            noise = self._draw(draws, "noise", lambda: draws_.randn(
                generator, latent.shape, device=self.device)).float()
            noisy = self.schedule.add_noise(latent, noise, t)
        if train and self.cond_dropout > 0.0:
            keep = self._draw(draws, "keep", lambda: draws_.rand(
                generator, (b,) + (1,) * (text_emb.ndim - 1),
                device=self.device) >= self.cond_dropout)
            text_emb = text_emb * keep.to(text_emb.dtype)
        pred = unet_apply(unet_params, noisy.to(latent.dtype), t, text_emb, self.spec,
                          text_mask=batch["text_mask"], dtype=self.compute_dtype,
                          dropout=dropout)
        target = noise if self.pred_type == "eps" else self.schedule.velocity(latent, noise, t)
        if train and self.snr_gamma > 0.0:
            acp = self.schedule.alphas_cumprod.to(self.device)[t]
            snr = acp / (1.0 - acp).clamp_min(1e-8)
            if self.pred_type == "v":
                # the v objective carries an (SNR+1) factor against the x0 error
                w = snr.clamp_max(self.snr_gamma) / (snr + 1.0)
            else:
                w = snr.clamp_max(self.snr_gamma) / snr.clamp_min(1e-8)
            sample_weights = w if sample_weights is None else w * sample_weights
        if self.loss_kind == "mse":
            loss = mse_loss(pred, target, sample_weights=sample_weights)
        else:
            loss = smooth_l1_loss(pred, target, beta=0.1, sample_weights=sample_weights)
        # on a mesh with the weights the loss was taken with, min-SNR's included
        return self._mesh_scaled(sample_weights, b, loss)[0]

    def _loss(self, params, batch, generator, draws, *, weights=None, train: bool = True):
        """The loss alone; a training step with the attention dropout."""
        return self._noise_loss(params, self.frozen, batch, generator, draws=draws,
                                dropout=self._dropout(draws, generator) if train else None,
                                sample_weights=weights, train=train), None

    def _dropout(self, draws, generator):
        """The step's attention dropout: the injected masks, else
        ``generator`` (none when the rate is 0)."""
        if draws is not None and "dropout" in draws:
            return draws["dropout"]
        return generator if self.spec.attn_dropout > 0 else None

    @torch.no_grad()
    def _sample(self, unet_params, frozen, generator, text_ids, text_mask, *, num: int,
                stride: int = 50, sampler: str = "ddim", steps: int = 100,
                guidance: float = 0.0):
        text_emb = text_encoder_apply(frozen["text"], text_ids, text_mask, self.bert_cfg,
                                      dtype=self.compute_dtype)

        def make_denoise(emb):
            def denoise(x, t):
                out = unet_apply(unet_params, x.to(emb.dtype), t, emb, self.spec,
                                 text_mask=text_mask, dtype=self.compute_dtype)
                if self.pred_type == "v":
                    out = self.schedule.eps_from_v(out, x, t)
                return out
            return denoise

        shape = (num, self.latent_size, self.latent_size, self.cfg.model.latent_dim)
        clamp = self.cfg.model.latent_clamp
        if sampler == "fast":   # the reference's strided sampler
            latents = ddpm_sample_fast(make_denoise(text_emb), self.schedule, generator,
                                       shape=shape, stride=stride)
        elif sampler == "dpmpp":
            latents = dpmpp_2m_sample(make_denoise(text_emb), self.schedule, generator,
                                      shape=shape, num_inference_steps=steps,
                                      clip_x0=clamp)
        else:   # DDIM; CFG against cond-dropout's zero embedding
            uncond = make_denoise(torch.zeros_like(text_emb)) if guidance > 0.0 else None
            latents = ddim_sample(make_denoise(text_emb), self.schedule, generator,
                                  shape=shape, num_inference_steps=steps, clip_x0=clamp,
                                  guidance_scale=guidance, uncond_denoise_fn=uncond)
        return vae_decode(frozen["vae"], latents.to(text_emb.dtype), text_emb,
                          text_bias=text_bias_from_mask(text_mask),
                          image_size=self.cfg.data.image_size, dtype=self.compute_dtype)

    # -- the device-resident fast path (train/fastpath.py) -----------------------

    def _fast_text_emb_fn(self):
        return lambda ids, mask: self._text(self.frozen, {"text_ids": ids, "text_mask": mask})

    # -- loops ---------------------------------------------------------------

    def generate_samples(self, epoch: int, num: int = 8, stride: Optional[int] = None):
        extra = self.cfg.extra or {}
        if stride is None:
            stride = int(extra.get("sample_stride", 50))

        def sample(params, gen, ids, mask):
            return self._sample(params, self.frozen, gen, ids, mask, num=ids.shape[0],
                                stride=stride, sampler=str(extra.get("sample_sampler", "ddim")),
                                steps=int(extra.get("sample_steps", 100)),
                                guidance=float(extra.get("sample_guidance", 0.0)))

        return self._save_grid(epoch, self.ds.full_descriptions[:num], f"epoch_{epoch:04d}.png",
                               sample)

    def _meta(self, epoch: int, classic: bool = False) -> Dict:
        return {"epoch": epoch, "vae_checkpoint": self.vae_ckpt_path,
                "config": self.cfg.to_dict()}

    def _banner(self, epochs: int) -> str:
        return (f"stage 2: {epochs} epochs, {len(self.train_loader)} train batches/epoch "
                f"on {self.device}")
