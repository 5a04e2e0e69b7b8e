"""Stage 2 on the Stable-Diffusion-family UNet with a trainable text encoder
(port of ``psg_tpu/train/stage2_sd.py``, selected by ``--use-diffusers``).

- backbone: the SD UNet wrapper (``models/sd_unet.py``) adapted to the
  8-channel latent, shaped by the configuration's ``sd_unet`` section (a
  diffusers ``unet/config.json``: SD-1.5's, SDXL base's) where it has one,
  else SD-1.5 (``tiny-test``: the tiny SD spec); pretrained weights from
  ``$PSG_TPU_SD_UNET`` (default ``weights/sd15_unet.ckpt``): a ``.ckpt``
  holds the UNet tree in the JAX layout, a ``.pth`` / ``.bin`` /
  ``.safetensors`` a diffusers state dict in the spec's naming
  (``convert_sd_unet``).  A named file must exist and fit; with nothing
  named and no default file the UNet is drawn from ``cfg.seed``.
- the VAE (frozen) and the text encoder (trained) come from the stage-1
  checkpoint, which must exist when named; none named draws both from
  ``cfg.seed`` as stage 2 does.
- the optimizer has two groups: ``unet`` and ``text`` (lr
  ``text_encoder_lr`` or a tenth of the UNet's, clip norm half the
  UNet's); the training mode (``freeze_encoder`` / ``freeze_decoder``:
  both give ``cross_attention_only``, the encoder alone ``decoder_only``,
  neither ``full``) and the fine-tune strategy freeze the rest.  Only
  ``extra.prediction_type`` 'eps' is taken.
- the loss: the text encoder on the bare description (``desc_ids`` /
  ``desc_mask``), the reparameterized latent clamped to +-latent_clamp,
  ``t`` uniform, the cosine schedule, MSE on the noise.  As in the JAX
  step every leaf gets a gradient, frozen ones included, and the logged
  ``grad_norm`` covers them all.  A UNet with SDXL's ``text_time``
  embedding also gets the pooled text (the description's masked mean) and
  the time ids ``(S, S, 0, 0, S, S)`` for the sprite size ``S``: original
  and target size, no crop; they are made on the device once per batch
  size.
- the step, validation, checkpoints, the loop and the spans are
  ``StageTrainer``'s (``train/trainer.py``); the loss runs through this
  module's ``sd_wrapper_apply``.
- samples: ``ddpm_sample_x0`` (50 strided steps), then ``vae_decode``.

On the card GroupNorm+SiLU and flash attention run their kernels forward
and differentiate their plain versions backward (``ops``); the sample's
decode runs the spatial kernel.  There is no fast path (nor in the JAX
package): ``training.fast_path`` is not read here.

Randomness: the trainer's ``torch.Generator`` (seeded from ``cfg.seed``,
saved in the train state) draws the reparameterize noise, ``t`` and the
noise, in that order; ``_loss`` and ``_step`` also take them
(``draws``), which is how the tests inject the JAX trainer's.  Validation
draws from a generator seeded the same way for every batch.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict

import torch

from psg_tpu_torch.core import draws as draws_
from psg_tpu_torch.core.checkpoint import load_params, read_checkpoint, wait_for_writes
from psg_tpu_torch.core.config import Config
from psg_tpu_torch.diffusion.sampling import ddpm_sample_x0
from psg_tpu_torch.diffusion.schedule import make_schedule
from psg_tpu_torch.models import bridge
from psg_tpu_torch.models.convert import convert_sd_unet, load_torch_state_dict
from psg_tpu_torch.models.losses import mse_loss
from psg_tpu_torch.models.sd_unet import (
    SDUNetSpec,
    sd_training_mask,
    sd_unet_init,
    sd_wrapper_apply,
    sd_wrapper_init,
)
from psg_tpu_torch.models.text_encoder import (
    finetune_mask,
    text_encoder_apply,
    text_encoder_init,
)
from psg_tpu_torch.models.unet import text_bias_from_mask
from psg_tpu_torch.models.vae import reparameterize, vae_decode, vae_encoder_apply, vae_init
from psg_tpu_torch.nn.layers import prepare_weights
from psg_tpu_torch.train.optim import build_optimizer, labels_from_mask, make_lr_schedule
from psg_tpu_torch.train.trainer import StageTrainer

SD_UNET_DEFAULT = "weights/sd15_unet.ckpt"
_SD_SEED_OFFSET = 3            # the random-init SD UNet: cfg.seed + 3


def sd_spec_from_config(cfg: Config) -> SDUNetSpec:
    """The configuration's ``sd_unet`` section (a diffusers UNet config,
    its ``cross_attention_dim`` included) where it has one; else SD-1.5 at
    ``model.cross_attention_dim`` (``tiny-test``: the tiny SD spec)."""
    section = (cfg.extra or {}).get("sd_unet")
    if section is not None:
        return SDUNetSpec.from_diffusers(section)
    m = cfg.model
    if "tiny-test" in m.bert_model:
        return SDUNetSpec.tiny_test(text_dim=m.cross_attention_dim)
    return SDUNetSpec.sd15()._replace(cross_attention_dim=m.cross_attention_dim)


def train_mode_for(model_cfg) -> str:
    """The reference's training mode from the freeze flags."""
    if model_cfg.freeze_encoder and model_cfg.freeze_decoder:
        return "cross_attention_only"
    return "decoder_only" if model_cfg.freeze_encoder else "full"


def sd_batch(batch, device):
    """A loader batch's image and bare-description ids and mask on ``device``."""
    out = {"image": torch.as_tensor(batch["image"]).to(device)}
    for k in ("desc_ids", "desc_mask"):
        out[k] = torch.as_tensor(batch[k]).long().to(device)
    return out


class SDDiffusionTrainer(StageTrainer):
    """``--use-diffusers`` stage-2 trainer."""

    STAGE, EPOCHS, LOSS = "diffusers", "diffusion_epochs", "loss"
    LOG_LINE = "loss {loss:.4f}"
    VAL_SEED_OFFSET = 4            # the validation draws' generator: cfg.seed + 4
    SAMPLE_SEED_OFFSET = 40_000    # sample grid of epoch e: cfg.seed + 40000 + e
    _to_device = staticmethod(sd_batch)

    def __init__(self, cfg: Config, vae_checkpoint_path, experiment_name: str = "pokemon",
                 *, device=None, mesh=None):
        """``mesh``: a ('data', 'model') ``DeviceMesh`` this rank trains on
        (stage 2's mechanism, ``train/common.py::MeshRun``; with a 'model'
        axis the wide SD-UNet and BERT kernels and their moments are sharded
        by ``unet_tp_rules``; the frozen VAE whole on every rank)."""
        self._setup(cfg, experiment_name, device, mesh)
        m = cfg.model
        self.spec = sd_spec_from_config(cfg)
        self.schedule = make_schedule(m.num_timesteps, m.beta_start, m.beta_end, "cosine")
        if (cfg.extra or {}).get("prediction_type", "eps") != "eps":
            # the SD trainer keeps the reference's eps objective
            raise ValueError("extra.prediction_type != 'eps' is not supported by the "
                             "SD trainer")

        self.vae_ckpt_path = str(vae_checkpoint_path) if vae_checkpoint_path else None
        vae_params, text_params = self._load_stage1(vae_checkpoint_path)
        self.frozen_vae = prepare_weights(vae_params, self.compute_dtype)
        sd_params = sd_wrapper_init(self._generator(_SD_SEED_OFFSET), self.spec,
                                    m.text_embedding_dim, latent_dim=m.latent_dim,
                                    base_params=self._load_sd_base())
        params = {"sd": sd_params, "text": text_params}

        o = cfg.optimization
        uo = (cfg.extra or {}).get("unet_optimization", {})
        unet_lr = uo.get("learning_rate", o.learning_rate)
        text_lr = o.text_encoder_lr or unet_lr * 0.1
        spe = max(len(self.train_loader), 1)
        total = cfg.training.diffusion_epochs * spe
        kind = uo.get("scheduler", o.scheduler)
        kind = "onecycle" if kind == "cosine" else kind

        def schedule(lr):
            return make_lr_schedule(kind, lr, total_steps=total, steps_per_epoch=spe,
                                    pct_start=o.onecycle_pct_start,
                                    warmup_steps=uo.get("warmup_steps", o.warmup_steps),
                                    end_factor=o.lr_end_factor)

        self.train_mode = train_mode_for(m)
        labels = {"sd": labels_from_mask(sd_training_mask(sd_params, self.train_mode), "unet"),
                  "text": labels_from_mask(finetune_mask(text_params, self.bert_cfg,
                                                         m.bert_finetune_strategy), "text")}
        self.tx = build_optimizer(
            o, {"unet": {"lr_schedule": schedule(unet_lr), "max_grad_norm": o.max_grad_norm},
                # the text group clips at half the UNet's norm
                "text": {"lr_schedule": schedule(text_lr),
                         "max_grad_norm": o.max_grad_norm * 0.5}},
            labels)
        self._start(params)
        self._time_ids = {}      # batch size -> the [B, 6] time ids on the device

    # -- setup ---------------------------------------------------------------

    def _load_stage1(self, path):
        """(VAE, text encoder) from the stage-1 checkpoint, which must exist
        and fit; drawn from ``cfg.seed`` when none is named."""
        m = self.cfg.model
        gen = self._generator()
        vt = {"vae": vae_init(gen, m.latent_dim, m.text_embedding_dim, m.vae_width_scale),
              "text": text_encoder_init(gen, self.bert_cfg, m.text_embedding_dim)}
        if path is None:
            self.log.warning("no VAE checkpoint named: VAE/text drawn from seed %d",
                             self.cfg.seed)
        else:
            wait_for_writes()     # this process may still be writing it (--stage all)
            if not Path(path).exists():
                raise FileNotFoundError(f"VAE checkpoint not found: {path}")
            vt = load_params(path, vt)
            self.log.info("loaded VAE+text from %s", path)
        return vt["vae"], vt["text"]

    def _load_sd_base(self):
        """The pretrained SD UNet (4 channels, before the adaptation), or
        None.  ``$PSG_TPU_SD_UNET`` must name an existing file; the default
        path may be missing (random init).  ``.pth`` / ``.bin`` /
        ``.safetensors`` go through ``convert_sd_unet`` in the spec's
        naming, anything else is read as a checkpoint of the UNet tree;
        either must fit the spec's shapes."""
        named = os.environ.get("PSG_TPU_SD_UNET")
        path = Path(named or SD_UNET_DEFAULT)
        if not path.exists():
            if named:
                raise FileNotFoundError(f"PSG_TPU_SD_UNET names a missing file: {path}")
            self.log.warning("no pretrained SD UNet found: random init")
            return None
        template = sd_unet_init(torch.Generator(device=self.device).manual_seed(0), self.spec)
        if path.suffix in (".pth", ".bin", ".safetensors"):
            tree_ = convert_sd_unet(load_torch_state_dict(path), spec=self.spec)
        else:
            tree_ = bridge.from_jax(read_checkpoint(path))
        self.log.info("loading pretrained SD UNet from %s", path)
        return bridge.fit(template, tree_, str(path))

    # -- the loss ------------------------------------------------------------

    def _conditioning(self, text_mask) -> dict:
        """The UNet's added conditioning: with ``text_time``, the text mask
        (for the pooled text) and the time ids of a sprite of the
        configured size; none for SD-1.5."""
        if not self.spec.text_time:
            return {}
        b = text_mask.shape[0]
        if b not in self._time_ids:
            s = float(self.cfg.data.image_size)
            self._time_ids[b] = torch.tensor([s, s, 0.0, 0.0, s, s],
                                             device=self.device).expand(b, 6).contiguous()
        return {"text_mask": text_mask, "time_ids": self._time_ids[b]}

    def _loss(self, params, batch, generator, draws, *, weights=None, train: bool = True):
        """The MSE noise loss alone.  Draws come from ``generator`` unless
        ``draws`` gives them: ``rep_noise`` and ``noise`` (the latent's
        shape), ``t`` [B]."""
        text_emb = text_encoder_apply(params["text"], batch["desc_ids"], batch["desc_mask"],
                                      self.bert_cfg, dtype=self.compute_dtype)
        with torch.no_grad():
            mu, logvar = vae_encoder_apply(self.frozen_vae["encoder"], batch["image"],
                                           dtype=self.compute_dtype)
            rep = self._draw(draws, "rep_noise", lambda: draws_.randn(
                generator, mu.shape, device=self.device))
            clamp = self.cfg.model.latent_clamp
            latent = reparameterize(None, mu, logvar, noise=rep).clamp(-clamp, clamp)
            b = latent.shape[0]
            t = self._draw(draws, "t", lambda: draws_.randint(
                generator, 0, self.schedule.num_timesteps, (b,), device=self.device)).long()
            noise = self._draw(draws, "noise", lambda: draws_.randn(
                generator, latent.shape, device=self.device)).float()
            noisy = self.schedule.add_noise(latent, noise, t)
        pred = sd_wrapper_apply(params["sd"], noisy.to(text_emb.dtype), t, text_emb,
                                self.spec, text_bias=text_bias_from_mask(batch["desc_mask"]),
                                dtype=self.compute_dtype,
                                **self._conditioning(batch["desc_mask"]))
        return self._mesh_scaled(weights, b, mse_loss(pred, noise, sample_weights=weights))

    @torch.no_grad()
    def _sample(self, params, generator, text_ids, text_mask, *, num: int, steps: int = 50,
                initial_latent=None, noises=None):
        text_emb = text_encoder_apply(params["text"], text_ids, text_mask, self.bert_cfg,
                                      dtype=self.compute_dtype)
        bias = text_bias_from_mask(text_mask)
        cond = self._conditioning(text_mask)

        def denoise(x, t):
            return sd_wrapper_apply(params["sd"], x.to(text_emb.dtype), t, text_emb,
                                    self.spec, text_bias=bias, dtype=self.compute_dtype,
                                    **cond)

        shape = (num, self.latent_size, self.latent_size, self.cfg.model.latent_dim)
        latents = ddpm_sample_x0(denoise, self.schedule, generator, shape=shape,
                                 initial_latent=initial_latent, num_inference_steps=steps,
                                 noises=noises)
        return vae_decode(self.frozen_vae, latents.to(text_emb.dtype), text_emb,
                          text_bias=bias, image_size=self.cfg.data.image_size,
                          dtype=self.compute_dtype)

    # -- loops ---------------------------------------------------------------

    def generate_samples(self, epoch: int, num: int = 8, steps: int = 50):
        return self._save_grid(epoch, self.ds.descriptions[:num], f"epoch_{epoch:04d}.png",
                               lambda params, gen, ids, mask: self._sample(
                                   params, gen, ids, mask, num=ids.shape[0], steps=steps))

    def _meta(self, epoch: int, classic: bool = False) -> Dict:
        return {"epoch": epoch, "vae_checkpoint": self.vae_ckpt_path,
                "config": self.cfg.to_dict()}

    def _banner(self, epochs: int) -> str:
        return (f"stage 2 (--use-diffusers: the SD UNet, {self.train_mode}): {epochs} epochs, "
                f"{len(self.train_loader)} batches/epoch on {self.device}")
