"""Stage 1: joint VAE + text-encoder training (port of
``psg_tpu/train/stage1_vae.py``: the classic loader path and the
device-resident fast path).

A step: the text encoder (BERT, projection, LayerNorm), the VAE encoder,
``reparameterize``, the decoder with its text cross-attention, then L1 +
VGG16 perceptual + KL loss with the KL weight annealed over epochs, the
backward, and the optimizer (``train/optim.py``) over two groups: the VAE
at ``learning_rate`` and the text encoder at ``text_encoder_lr`` (or a
tenth of the VAE's), each clipped to its own ``max_grad_norm``; the BERT
layers the fine-tune strategy freezes get no update.  As in the JAX step,
every parameter gets a gradient, frozen ones included, and the logged
``grad_norm`` and the non-finite check cover all of them.  On the card
GroupNorm+SiLU, flash attention and the decoder's spatial cross-attention
run their kernels forward and differentiate their plain versions backward
(``ops``).

Randomness: the trainer's ``torch.Generator`` (seeded from ``cfg.seed``,
saved in the train state) draws the reparameterize noise.  Torch cannot
replay ``jax.random``, so ``_loss`` and ``_step`` also take it
(``draws={'rep_noise': ...}``), which is how the tests inject the JAX
trainer's.  Validation draws from a generator seeded the same way for
every batch, as the JAX trainer folds one fixed key.

The step, validation, checkpoints and loops are ``StageTrainer``'s
(``train/trainer.py``); a step's stage argument is the epoch's KL weight,
which the step also reports.

Weights named by ``$PSG_TPU_BERT``, ``$PSG_TPU_VGG16`` or
``extra.text_init`` must exist and fit, or the trainer raises.  With none
named and no file at the default ``weights/`` path, BERT is drawn from the
config's seed and VGG16 from a generator seeded 1234, and the log says so.

With ``training.fast_path`` ``train()`` takes the device-resident path
(``train/fastpath.py``): the split on the device, each step's minibatch
drawn, gathered and augmented there, then the classic step's ``_grads`` and
``_apply_update`` at the epoch's KL weight; light best checkpoints (bf16
params on the ``best_every`` cadence) and one full periodic state at the
end.  Its draws, in order: the index uniforms, the augmentation parameters,
then the reparameterize noise; ``train_epoch_fast`` and ``validate_fast``
take them too (``draws``, one dict a step or a validation batch).

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict

import numpy as np
import torch

from psg_tpu_torch.core import tree
from psg_tpu_torch.core.checkpoint import read_checkpoint
from psg_tpu_torch.core.config import Config
from psg_tpu_torch.data.device_augment import normalize_batch
from psg_tpu_torch.models import bridge
from psg_tpu_torch.models.losses import kl_anneal_weight, vae_loss
from psg_tpu_torch.models.text_encoder import (
    finetune_mask,
    text_encoder_apply,
    text_encoder_init,
)
from psg_tpu_torch.models.unet import text_bias_from_mask
from psg_tpu_torch.models.vae import vae_apply, vae_init, vae_sample
from psg_tpu_torch.models.vgg import vgg16_init
from psg_tpu_torch.nn.layers import prepare_weights
from psg_tpu_torch.train.common import MeshRun
from psg_tpu_torch.train.fastpath import FastPath
from psg_tpu_torch.train.optim import build_optimizer, labels_from_mask, make_lr_schedule
from psg_tpu_torch.train.stage0_mlm import load_text_init
from psg_tpu_torch.train.trainer import StageTrainer
from psg_tpu_torch.utils.images import save_image_grid

VGG_SEED = 1234            # the random perceptual tower, as the JAX package's PRNGKey(1234)


def _named_weights(env: str, default: str):
    """(path, named): the file ``$env`` names, else the default path."""
    named = os.environ.get(env)
    return Path(named or default), bool(named)


class VAETrainer(FastPath, StageTrainer):
    """Stage-1 trainer."""

    STAGE, EPOCHS, LOSS = "vae", "vae_epochs", "total_loss"
    LOG_LINE = "loss {total_loss:.4f} recon {reconstruction_loss:.4f} kl {kl_loss:.4f}"
    VAL_SEED_OFFSET = 2            # the validation draws' generator: cfg.seed + 2
    SAMPLE_SEED_OFFSET = 10_000    # prior samples of epoch e: cfg.seed + 10000 + e
    MARK_BEST = True

    def __init__(self, cfg: Config, experiment_name: str = "pokemon",
                 sample_descriptions=None, *, device=None, mesh=None):
        """``mesh``: a ('data', 'model') ``DeviceMesh`` this rank trains on
        (stage 2's mechanism, ``train/common.py::MeshRun``: the global
        batch's rows and draws, gradients averaged over 'data', with a
        'model' axis the wide VAE/BERT kernels and their moments sharded by
        ``unet_tp_rules``; VGG whole on every rank)."""
        self._setup(cfg, experiment_name, device, mesh)
        m = cfg.model
        # the same draws as stage 2's and serving's template without a checkpoint
        gen = self._generator()
        params = {"vae": vae_init(gen, m.latent_dim, m.text_embedding_dim, m.vae_width_scale),
                  "text": text_encoder_init(gen, self.bert_cfg, m.text_embedding_dim)}
        params["text"]["bert"], bert_src = self._load_bert(params["text"]["bert"])
        text_init = (cfg.extra or {}).get("text_init")
        if text_init:
            params["text"] = load_text_init(text_init, params["text"])
            bert_src = f"mlm:{text_init}"
        self.vgg_params, vgg_src = self._load_vgg()
        self.log.info("weights: bert=%s vgg16=%s", bert_src, vgg_src)

        o = cfg.optimization
        spe = max(len(self.train_loader), 1)
        total = cfg.training.vae_epochs * spe

        def schedule(lr):
            return make_lr_schedule(o.scheduler, lr, total_steps=total, steps_per_epoch=spe,
                                    warmup_steps=o.warmup_steps, end_factor=o.lr_end_factor)

        labels = {"vae": tree.map(lambda _: "vae", params["vae"]),
                  "text": labels_from_mask(finetune_mask(params["text"], self.bert_cfg,
                                                         m.bert_finetune_strategy), "text")}
        self.tx = build_optimizer(
            o, {"vae": {"lr_schedule": schedule(o.learning_rate),
                        "max_grad_norm": o.max_grad_norm},
                "text": {"lr_schedule": schedule(o.text_encoder_lr or o.learning_rate * 0.1),
                         "max_grad_norm": o.text_max_grad_norm}},
            labels)
        self._start(params)
        self.sample_descriptions = sample_descriptions

    # -- setup ---------------------------------------------------------------

    def _load_bert(self, template):
        """Converted BERT weights (the bert subtree) from ``$PSG_TPU_BERT``
        or ``weights/bert_base.ckpt``: (params, source)."""
        path, named = _named_weights("PSG_TPU_BERT", "weights/bert_base.ckpt")
        if not path.exists():
            if named:
                raise FileNotFoundError(f"PSG_TPU_BERT names a missing file: {path}")
            return template, "random-init"
        return bridge.fit(template, bridge.from_jax(read_checkpoint(path)), str(path)), \
            "pretrained"

    def _load_vgg(self):
        """VGG16 features from ``$PSG_TPU_VGG16`` or
        ``weights/vgg16_features.ckpt``, else drawn from seed ``VGG_SEED``;
        kept in the compute dtype, channels-last."""
        template = vgg16_init(torch.Generator(device=self.device).manual_seed(VGG_SEED))
        path, named = _named_weights("PSG_TPU_VGG16", "weights/vgg16_features.ckpt")
        if path.exists():
            vgg, src = bridge.fit(template, bridge.from_jax(read_checkpoint(path)),
                                  str(path)), "pretrained"
        elif named:
            raise FileNotFoundError(f"PSG_TPU_VGG16 names a missing file: {path}")
        else:
            vgg, src = template, "random-features"
        return prepare_weights(vgg, self.compute_dtype), src

    # -- the loss ------------------------------------------------------------

    def _loss(self, params, batch, generator, draws, kl_weight: float, *, weights=None,
              train: bool = True):
        """(total loss, parts).  The reparameterize noise comes from
        ``generator`` unless ``draws['rep_noise']`` gives it."""
        text_emb = text_encoder_apply(params["text"], batch["text_ids"], batch["text_mask"],
                                      self.bert_cfg, dtype=self.compute_dtype)
        noise = self._draw(draws, "rep_noise", lambda: None)
        out = vae_apply(params["vae"], generator, batch["image"], text_emb,
                        "train" if train else "val",
                        latent_dim=self.cfg.model.latent_dim, latent_size=self.latent_size,
                        text_bias=text_bias_from_mask(batch["text_mask"]),
                        dtype=self.compute_dtype, noise=noise)
        t = self.cfg.training
        loss, parts = vae_loss(self.vgg_params, out["reconstructed"], batch["image"],
                               out["mu"], out["logvar"],
                               reconstruction_weight=t.reconstruction_weight,
                               perceptual_weight=t.perceptual_weight, kl_weight=kl_weight,
                               dtype=self.compute_dtype, sample_weights=weights)
        return self._mesh_scaled(weights, batch["image"].shape[0], loss, parts)

    def _epoch_args(self, epoch: int) -> tuple:
        return (self.kl_weight(epoch),)

    def _step_extras(self, kl_weight: float) -> Dict:
        return {"kl_weight": kl_weight}

    @torch.no_grad()
    def _sample(self, params, generator, text_ids, text_mask, noise=None):
        text_emb = text_encoder_apply(params["text"], text_ids, text_mask, self.bert_cfg,
                                      dtype=self.compute_dtype)
        return vae_sample(params["vae"], generator, text_emb,
                          latent_dim=self.cfg.model.latent_dim, latent_size=self.latent_size,
                          image_size=self.cfg.data.image_size,
                          text_bias=text_bias_from_mask(text_mask), dtype=self.compute_dtype,
                          noise=noise)

    # -- loops ---------------------------------------------------------------

    def kl_weight(self, epoch: int) -> float:
        t = self.cfg.training
        return kl_anneal_weight(epoch, start=t.kl_anneal_start, end=t.kl_anneal_end,
                                w_start=t.kl_weight_start, w_end=t.kl_weight_end)

    def generate_samples(self, epoch: int, num: int = 8):
        """A grid of prior samples for the first ``num`` captions, then the
        reconstruction grid; returns both paths."""
        descs = (self.sample_descriptions or self.ds.full_descriptions)[:num]
        return (self._save_grid(epoch, descs, f"epoch_{epoch:04d}.png", self._sample),
                self.save_recon_grid(epoch, num=num))

    @torch.no_grad()
    def save_recon_grid(self, epoch: int, num: int = 8) -> Path:
        """Reconstructions of the first ``num`` validation sprites from their
        means, interleaved with the inputs."""
        idx = np.asarray(self.val_loader.indices[:num])
        imgs = normalize_batch(torch.from_numpy(self.ds.images[idx]).to(self.device))
        ids = torch.from_numpy(np.asarray(self.ds.text_ids[idx])).long().to(self.device)
        mask = torch.from_numpy(np.asarray(self.ds.text_mask[idx])).long().to(self.device)
        params = MeshRun.whole(self.mesh_run, self.state.params)
        text_emb = text_encoder_apply(params["text"], ids, mask, self.bert_cfg,
                                      dtype=self.compute_dtype)
        recon = vae_apply(params["vae"], None, imgs, text_emb, "generate",
                          latent_dim=self.cfg.model.latent_dim, latent_size=self.latent_size,
                          text_bias=text_bias_from_mask(mask),
                          dtype=self.compute_dtype)["reconstructed"]
        orig, recon = imgs.float().cpu().numpy(), recon.float().cpu().numpy()
        inter = np.stack([orig, recon], 1).reshape((-1,) + orig.shape[1:])
        path = self.stage_dir / "samples" / f"recon_{epoch:04d}.png"
        self._write(lambda: save_image_grid(inter, path))
        return path

    def _banner(self, epochs: int) -> str:
        return (f"stage 1: {epochs} epochs, {len(self.train_loader)} train batches/epoch "
                f"on {self.device}")

    def _after_restore(self) -> None:
        self.log.info("restored checkpoint at epoch %d (val %.4f)", self.start_epoch,
                      self.best_val)
