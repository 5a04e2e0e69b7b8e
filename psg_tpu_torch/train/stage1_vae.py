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
replay ``jax.random``, so ``_forward_loss`` and ``_step`` also take it
(``draws={'rep_noise': ...}``), which is how the tests inject the JAX
trainer's.  Validation draws from a generator seeded the same way for every
batch, as the JAX trainer folds one fixed key.

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
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from psg_tpu_torch.core import tree
from psg_tpu_torch.core.checkpoint import (
    load_metadata,
    load_params,
    read_checkpoint,
)
from psg_tpu_torch.core.config import Config, configure_torch
from psg_tpu_torch.core.metrics import Throughput
from psg_tpu_torch.data.dataset import PokemonDataset
from psg_tpu_torch.data.device_augment import normalize_batch
from psg_tpu_torch.data.loader import make_loaders
from psg_tpu_torch.models import bridge
from psg_tpu_torch.models.bert import bert_config_for
from psg_tpu_torch.models.losses import kl_anneal_weight, vae_loss
from psg_tpu_torch.models.text_encoder import (
    finetune_mask,
    text_encoder_apply,
    text_encoder_init,
)
from psg_tpu_torch.models.unet import text_bias_from_mask
from psg_tpu_torch.models.vae import latent_size_for, vae_apply, vae_init, vae_sample
from psg_tpu_torch.models.vgg import vgg16_init
from psg_tpu_torch.nn.layers import prepare_weights
from psg_tpu_torch.serve.generator import resolve_device
from psg_tpu_torch.train.common import MeshRun, device_batch, get_tokenizer, stage_io
from psg_tpu_torch.train.fastpath import FastPath
from psg_tpu_torch.train.optim import (
    build_optimizer,
    labels_from_mask,
    make_lr_schedule,
    skipped_steps,
)
from psg_tpu_torch.train.stage0_mlm import load_text_init
from psg_tpu_torch.train.state import TrainState
from psg_tpu_torch.utils.images import save_image_grid

VGG_SEED = 1234            # the random perceptual tower, as the JAX package's PRNGKey(1234)
_VAL_SEED_OFFSET = 2       # the validation draws' generator: cfg.seed + 2
_SAMPLE_SEED_OFFSET = 10_000   # prior samples of epoch e: cfg.seed + 10000 + e


def _named_weights(env: str, default: str):
    """(path, named): the file ``$env`` names, else the default path."""
    named = os.environ.get(env)
    return Path(named or default), bool(named)


class VAETrainer(FastPath):
    """Stage-1 trainer."""

    STAGE = "vae"
    EPOCHS = "vae_epochs"

    def __init__(self, cfg: Config, experiment_name: str = "pokemon",
                 sample_descriptions=None, *, device=None, mesh=None):
        """``mesh``: a ('data', 'model') ``DeviceMesh`` this rank trains on
        (stage 2's mechanism, ``train/common.py::MeshRun``: the global
        batch's rows and draws, gradients averaged over 'data', with a
        'model' axis the wide VAE/BERT kernels and their moments sharded by
        ``unet_tp_rules``; VGG whole on every rank)."""
        self.device = resolve_device(device)
        self.mesh, self.mesh_run = mesh, None
        if self.device.type == "cuda":
            configure_torch(cfg)
        self.cfg = cfg
        self.stage_dir = Path(cfg.experiment_dir) / f"{experiment_name}_vae"
        self.ckpt, self.log, self.metrics = stage_io(self.stage_dir, self.STAGE, mesh,
                                                     self.device)

        ds = PokemonDataset(cfg.data.csv_path, cfg.data.image_dir,
                            image_size=cfg.data.image_size,
                            background_color=cfg.data.background_color,
                            text_len=cfg.data.text_len)
        self.tokenizer = get_tokenizer(cfg, self.stage_dir, corpus=ds.full_descriptions,
                                       mesh=mesh)
        self.train_loader, self.val_loader, self.test_loader, self.ds = make_loaders(
            cfg, self.tokenizer, ds=ds)

        m = cfg.model
        self.bert_cfg = bert_config_for(m.bert_model, self.tokenizer.vocab_size)
        self.compute_dtype = torch.bfloat16 if m.compute_dtype == "bfloat16" else None
        self.latent_size = latent_size_for(cfg.data.image_size)

        # the same draws as stage 2's and serving's template without a checkpoint
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
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
        if mesh is not None:
            self.mesh_run = MeshRun(mesh, params, tp_min_channels=int(
                (cfg.extra or {}).get("tp_min_channels", 640)))
        self.state = self._fresh_state(params, step=0, rng=torch.Generator(
            device=self.device).manual_seed(cfg.seed))
        self.start_epoch = 0
        self.best_val = float("inf")
        self.sample_descriptions = sample_descriptions

    # -- setup ---------------------------------------------------------------

    def _fresh_state(self, params, *, step: int, rng: torch.Generator) -> TrainState:
        """A state from whole params (cut to this rank's shards on a mesh
        with a 'model' axis)."""
        params = tree.map(lambda t: t.detach().requires_grad_(True), params)
        state = TrainState(step, params, self.tx.init(params), rng)
        return self.mesh_run.place(state) if self.mesh_run is not None else state

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

    def _batch(self, batch):
        """A loader batch on the device: this rank's rows on a mesh."""
        if self.mesh_run is not None:
            batch = self.mesh_run.local(batch)
        return device_batch(batch, self.device)

    # -- the loss ------------------------------------------------------------

    def _forward_loss(self, params, batch, kl_weight: float, mode: str, generator,
                      draws=None, sample_weights=None):
        """(total loss, parts).  The reparameterize noise comes from
        ``generator`` unless ``draws['rep_noise']`` gives it."""
        text_emb = text_encoder_apply(params["text"], batch["text_ids"], batch["text_mask"],
                                      self.bert_cfg, dtype=self.compute_dtype)
        noise = None
        if draws is not None and "rep_noise" in draws:
            noise = torch.as_tensor(draws["rep_noise"]).to(self.device)
        out = vae_apply(params["vae"], generator, batch["image"], text_emb, mode,
                        latent_dim=self.cfg.model.latent_dim, latent_size=self.latent_size,
                        text_bias=text_bias_from_mask(batch["text_mask"]),
                        dtype=self.compute_dtype, noise=noise)
        t = self.cfg.training
        loss, parts = vae_loss(self.vgg_params, out["reconstructed"], batch["image"],
                               out["mu"], out["logvar"],
                               reconstruction_weight=t.reconstruction_weight,
                               perceptual_weight=t.perceptual_weight, kl_weight=kl_weight,
                               dtype=self.compute_dtype, sample_weights=sample_weights)
        if self.mesh_run is not None:   # averaged over 'data': the global batch's loss
            scale = self.mesh_run.loss_scale(sample_weights, batch["image"].shape[0])
            loss, parts = loss * scale, {k: v * scale for k, v in parts.items()}
        return loss, parts

    # -- steps ---------------------------------------------------------------

    def _grads(self, batch, kl_weight: float, draws=None):
        """(loss parts, gradient tree) of one training batch: every leaf
        gets a gradient, zero where the loss does not reach it (BERT's
        pooler), as ``jax.grad`` gives."""
        st = self.state
        mr = self.mesh_run
        gen, params = st.rng, st.params
        if mr is not None:
            gen, draws, params = mr.step_inputs(st, batch["image"].shape[0], draws)
        loss, parts = self._forward_loss(params, batch, kl_weight, "train", gen,
                                         draws=draws)
        paths, leaves = zip(*tree.items(params))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(p) for g, p in zip(grads, leaves)]
        parts = {k: v.detach() for k, v in parts.items()}
        if mr is not None:
            grads, parts = mr.reduce_grads(paths, grads), mr.mean_parts(parts)
        it = iter(grads)
        return parts, tree.map(lambda _: next(it), st.params)

    def _apply_update(self, parts, grads, kl_weight: float) -> Dict:
        st = self.state
        stats = self.tx.update(st.params, grads, st.opt_state, layout=st.layout)
        st.step += 1
        return {**parts, "grad_norm": stats["grad_norm"], "kl_weight": kl_weight}

    def _step(self, batch, kl_weight: float, draws=None) -> Dict:
        parts, grads = self._grads(batch, kl_weight, draws)
        return self._apply_update(parts, grads, kl_weight)

    def _val_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.cfg.seed + _VAL_SEED_OFFSET)

    @torch.no_grad()
    def _eval(self, batch, kl_weight: float, valid: int) -> Dict:
        """Loss parts over the first ``valid`` samples of ``batch``: the
        loader pads the last eval batch by wraparound, and the padding is
        weighted 0 in every term.  On a mesh ``batch`` is this rank's rows
        and ``valid`` counts the global batch's."""
        b = batch["image"].shape[0]
        gen, first, params = self._val_generator(), 0, self.state.params
        if self.mesh_run is not None:
            gen, first, params = self.mesh_run.eval_inputs(gen, b, params)
        w = (torch.arange(first, first + b, device=self.device) < valid).float()
        _, parts = self._forward_loss(params, batch, kl_weight, "val", gen, sample_weights=w)
        return self.mesh_run.mean_parts(parts) if self.mesh_run is not None else parts

    @torch.no_grad()
    def _sample(self, params, generator, text_ids, text_mask, noise=None):
        text_emb = text_encoder_apply(params["text"], text_ids, text_mask, self.bert_cfg,
                                      dtype=self.compute_dtype)
        return vae_sample(params["vae"], generator, text_emb,
                          latent_dim=self.cfg.model.latent_dim, latent_size=self.latent_size,
                          image_size=self.cfg.data.image_size,
                          text_bias=text_bias_from_mask(text_mask), dtype=self.compute_dtype,
                          noise=noise)

    # -- the device-resident fast path (train/fastpath.py) -----------------------

    def train_epoch_fast(self, epoch: int, draws=None) -> Dict[str, float]:
        klw = self.kl_weight(epoch)
        ys = self._fast_epoch(lambda batch, d: self._step(batch, klw, d), draws)
        stats = {k: float(np.mean(v)) for k, v in ys.items()}
        stats["grad_norm_max"] = float(np.max(ys["grad_norm"]))
        self.metrics.scalars(stats, self.state.step, prefix="vae_train/")
        return stats

    def validate_fast(self, epoch: int, draws=None) -> float:
        klw = self.kl_weight(epoch)
        val = self._fast_validate(lambda batch, gen, d, w: self._forward_loss(
            self.state.params, batch, klw, "val", gen, draws=d,
            sample_weights=w)[1]["total_loss"], draws)
        self.metrics.scalar("vae_val/total_loss", val, self.state.step)
        return val

    # -- loops ---------------------------------------------------------------

    def kl_weight(self, epoch: int) -> float:
        t = self.cfg.training
        return kl_anneal_weight(epoch, start=t.kl_anneal_start, end=t.kl_anneal_end,
                                w_start=t.kl_weight_start, w_end=t.kl_weight_end)

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        klw = self.kl_weight(epoch)
        sums: Dict[str, object] = {}
        count = 0
        thr = Throughput()
        for batch in self.train_loader:
            parts = self._step(self._batch(batch), klw)
            count += 1
            thr.step()
            if count % self.cfg.training.log_every == 0:
                vals = {k: float(v) for k, v in parts.items()}
                self.metrics.scalars(vals, self.state.step, prefix="vae_train/")
                self.log.info("epoch %d step %d loss %.4f recon %.4f kl %.4f | %.0f b/h",
                              epoch, self.state.step, vals["total_loss"],
                              vals["reconstruction_loss"], vals["kl_loss"],
                              thr.batches_per_hour())
            for k, v in parts.items():
                # losses stay on the device: float() here would wait for them
                sums[k] = sums.get(k, 0.0) + v
        return {k: float(v) / max(count, 1) for k, v in sums.items()}

    def validate(self, epoch: int) -> float:
        klw = self.kl_weight(epoch)
        total, n = 0.0, 0
        for batch in self.val_loader:
            valid = int(batch["valid"])
            total += float(self._eval(self._batch(batch), klw, valid)["total_loss"]) * valid
            n += valid
        val = total / max(n, 1)
        self.metrics.scalar("vae_val/total_loss", val, self.state.step)
        return val

    def generate_samples(self, epoch: int, num: int = 8):
        """A grid of prior samples for the first ``num`` captions, then the
        reconstruction grid; returns both paths."""
        descs = (self.sample_descriptions or self.ds.full_descriptions)[:num]
        ids, mask = self.tokenizer.encode_batch(descs, self.cfg.data.text_len)
        gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed + _SAMPLE_SEED_OFFSET + epoch)
        ids, mask = (torch.from_numpy(a).long().to(self.device) for a in (ids, mask))
        mr = self.mesh_run
        if mr is not None:   # this rank's rows of the grid, then all of them
            gen, (ids, mask) = mr.split_rows(gen, len(descs), ids, mask)
        imgs = self._sample(MeshRun.whole(mr, self.state.params), gen, ids, mask)
        if mr is not None:
            imgs = mr.gather_rows(imgs, len(descs))
        path = self.stage_dir / "samples" / f"epoch_{epoch:04d}.png"
        if mr is None or mr.writer:
            save_image_grid(imgs.float().cpu().numpy(), path, captions=descs)
        return path, self.save_recon_grid(epoch, num=num)

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
        if self.mesh_run is None:
            save_image_grid(inter, path)
        else:
            self.mesh_run.write(lambda: save_image_grid(inter, path))
        return path

    def skipped_batches(self) -> int:
        """Non-finite rejections plus norm rejections (every group)."""
        return skipped_steps(self.state.opt_state)

    def _meta(self, epoch: int) -> Dict:
        return {"epoch": epoch, "config": self.cfg.to_dict()}

    def save_checkpoint(self, epoch: int, val_loss: float) -> bool:
        tr = self.cfg.training
        allow_best = ((epoch + 1) % max(tr.best_every, 1) == 0 or epoch + 1 == tr.vae_epochs)
        return self.ckpt.save(self.state, self.state.step, val_loss if allow_best else None,
                              extra_meta=self._meta(epoch),
                              periodic=(epoch + 1) % tr.save_every == 0)

    def load_checkpoint(self, path: Optional[str] = None):
        """Resume the full state a port checkpoint holds; from a checkpoint
        without one (a JAX one, or a light best), the params and step with a
        fresh optimizer state."""
        if path is None:
            self.state, meta = self.ckpt.restore(self.state, best=True)
        else:
            self.ckpt.wait()     # every rank: no write of this run is in flight
            meta = load_metadata(path)
            try:
                self.state = self.state.from_checkpoint(read_checkpoint(path))
            except (KeyError, ValueError) as e:
                self.log.warning("full restore failed (%s): params-only restore", e)
                params = load_params(path, MeshRun.whole(self.mesh_run, self.state.params))
                self.state = self._fresh_state(params, step=int(meta.get("step", 0)),
                                               rng=self.state.rng)
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.best_val = float(meta.get("metric", float("inf")))
        self.log.info("restored checkpoint at epoch %d (val %.4f)", self.start_epoch,
                      self.best_val)

    def train(self) -> Path:
        if self.cfg.training.fast_path and self.mesh is None:
            return self._train_fast()
        epochs = self.cfg.training.vae_epochs
        self.log.info("stage 1: %d epochs, %d train batches/epoch on %s", epochs,
                      len(self.train_loader), self.device)
        for epoch in range(self.start_epoch, epochs):
            t0 = time.time()
            self.train_loader.set_epoch(epoch)
            stats = self.train_epoch(epoch)
            val_loss = self.validate(epoch)
            is_best = val_loss < self.best_val
            if is_best:
                self.best_val = val_loss
            self.save_checkpoint(epoch, val_loss)
            if (epoch + 1) % self.cfg.training.sample_every == 0:
                self.generate_samples(epoch)
            self.log.info("epoch %d done in %.1fs: train %.4f val %.4f%s skipped %d", epoch,
                          time.time() - t0, stats.get("total_loss", 0.0), val_loss,
                          " (best)" if is_best else "", self.skipped_batches())
        self.metrics.flush()
        self.ckpt.wait()     # the files this run reports are on disk
        return self.ckpt.best_path
