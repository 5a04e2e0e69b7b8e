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
replay ``jax.random``, so ``_noise_loss_emb`` and ``_step`` also take these
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

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from psg_tpu_torch.core import draws as draws_
from psg_tpu_torch.core import tree
from psg_tpu_torch.core.checkpoint import (
    load_metadata,
    load_params,
    read_checkpoint,
    wait_for_writes,
)
from psg_tpu_torch.core.config import Config, configure_torch
from psg_tpu_torch.core.metrics import Throughput
from psg_tpu_torch.data.dataset import PokemonDataset
from psg_tpu_torch.data.loader import make_loaders
from psg_tpu_torch.diffusion.sampling import ddim_sample, ddpm_sample_fast, dpmpp_2m_sample
from psg_tpu_torch.diffusion.schedule import make_schedule
from psg_tpu_torch.models.bert import bert_config_for
from psg_tpu_torch.models.losses import mse_loss, smooth_l1_loss
from psg_tpu_torch.models.text_encoder import text_encoder_apply, text_encoder_init
from psg_tpu_torch.models.unet import (  # noqa: F401  (re-exported, as in psg_tpu)
    text_bias_from_mask,
    unet_apply,
    unet_init,
    unet_spatial_for,
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
from psg_tpu_torch.serve.generator import resolve_device
from psg_tpu_torch.train.common import MeshRun, device_batch, get_tokenizer, stage_io
from psg_tpu_torch.train.fastpath import FastPath
from psg_tpu_torch.train.optim import (
    build_optimizer,
    ema_update,
    make_lr_schedule,
    skipped_steps,
)
from psg_tpu_torch.train.state import TrainState
from psg_tpu_torch.utils.images import save_image_grid

_VAL_SEED_OFFSET = 2    # the validation draws' generator: cfg.seed + 2
_SAMPLE_SEED_OFFSET = 20_000   # sample grid of epoch e: cfg.seed + 20000 + e


class DiffusionTrainer(FastPath):
    """Stage-2 trainer."""

    STAGE = "diffusion"
    EPOCHS = "diffusion_epochs"

    def __init__(self, cfg: Config, vae_checkpoint_path, experiment_name: str = "pokemon",
                 *, device=None, mesh=None):
        """``vae_checkpoint_path``: the stage-1 checkpoint holding the frozen
        ``vae`` and ``text`` parameters; it must exist and fit.  ``None``
        draws them from ``cfg.seed`` (as serving does without a
        checkpoint).  ``mesh``: a ('data', 'model') ``DeviceMesh``
        (``parallel.make_mesh``) this rank trains on."""
        self.device = resolve_device(device)
        self.mesh, self.mesh_run = mesh, None
        if self.device.type == "cuda":
            configure_torch(cfg)
        self.cfg = cfg
        self.stage_dir = Path(cfg.experiment_dir) / f"{experiment_name}_diffusion"
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
        self.spec = unet_spec_from_config(cfg, self.latent_size)
        self.vae_ckpt_path = str(vae_checkpoint_path) if vae_checkpoint_path else None
        self.frozen = self._load_frozen(vae_checkpoint_path)
        self.schedule = make_schedule(m.num_timesteps, m.beta_start, m.beta_end,
                                      m.beta_schedule)

        unet_params = unet_init(torch.Generator(device=self.device).manual_seed(cfg.seed + 1),
                                self.spec)
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
        if mesh is not None:
            self.mesh_run = MeshRun(mesh, unet_params,
                                    tp_min_channels=int(extra.get("tp_min_channels", 640)))
        self.state = self._fresh_state(unet_params, step=0,
                                       rng=torch.Generator(device=self.device)
                                       .manual_seed(cfg.seed))
        self.start_epoch = 0
        self.best_val = float("inf")
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

    def _fresh_state(self, unet_params, *, step: int, rng: torch.Generator) -> TrainState:
        """A state from whole UNet params (cut to this rank's shards on a
        mesh with a 'model' axis)."""
        params = tree.map(lambda t: t.detach().requires_grad_(True), unet_params)
        ema = (tree.map(lambda t: t.detach().clone(), params)
               if self.ema_decay > 0 else None)
        state = TrainState(step, params, self.tx.init(params), rng, ema)
        return self.mesh_run.place(state) if self.mesh_run is not None else state

    def _load_frozen(self, vae_checkpoint_path) -> Dict:
        """The frozen {'vae', 'text'} parameters: from a stage-1 checkpoint,
        which must exist and fit (no random fallback), or drawn from
        ``cfg.seed`` when none is named.  Matmul and conv kernels are kept
        in the compute dtype."""
        m = self.cfg.model
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
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

    def _batch(self, batch):
        """A loader batch on the device: this rank's rows on a mesh."""
        if self.mesh_run is not None:
            batch = self.mesh_run.local(batch)
        return device_batch(batch, self.device)

    # -- the loss ------------------------------------------------------------

    def _draw(self, draws, name, make):
        if draws is not None and name in draws:
            return torch.as_tensor(draws[name]).to(self.device)
        return make()

    def _noise_loss_emb(self, unet_params, frozen_vae, images, text_emb, text_mask,
                        generator, draws=None, dropout=None, sample_weights=None,
                        train: bool = True):
        """Diffusion loss from images and text embeddings.  Draws come from
        ``generator`` unless ``draws`` gives them: ``rep_noise`` (the
        latent's shape), ``t`` [B], ``noise`` (the latent's shape), ``keep``
        [B, 1, 1] (cond-dropout).  ``dropout``: the UNet's attention dropout
        (``models/unet.py``), None for none."""
        with torch.no_grad():
            mu, logvar = vae_encoder_apply(frozen_vae["encoder"], images,
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
                          text_mask=text_mask, dtype=self.compute_dtype, dropout=dropout)
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
        if self.mesh_run is not None:   # averaged over 'data': the global batch's loss
            loss = loss * self.mesh_run.loss_scale(sample_weights, b)
        return loss

    def _text(self, frozen, batch):
        if "text_emb" in batch:         # the fast path's precomputed embeddings
            return batch["text_emb"]
        with torch.no_grad():
            return text_encoder_apply(frozen["text"], batch["text_ids"], batch["text_mask"],
                                      self.bert_cfg, dtype=self.compute_dtype)

    def _noise_loss(self, unet_params, frozen, batch, generator, draws=None, dropout=None,
                    sample_weights=None, train: bool = True):
        return self._noise_loss_emb(unet_params, frozen["vae"], batch["image"],
                                    self._text(frozen, batch), batch["text_mask"],
                                    generator, draws=draws, dropout=dropout,
                                    sample_weights=sample_weights, train=train)

    # -- steps ---------------------------------------------------------------

    def _dropout(self, draws, generator):
        """The step's attention dropout: the injected masks, else
        ``generator`` (none when the rate is 0)."""
        if draws is not None and "dropout" in draws:
            return draws["dropout"]
        return generator if self.spec.attn_dropout > 0 else None

    def _grads(self, batch, draws=None):
        """(loss, gradient tree) of one training batch.  On a mesh: this
        rank's rows of the global batch and of ``draws``, the step's draws
        at the global shape; the loss and the gradients (this rank's
        shards) averaged over the mesh."""
        st = self.state
        mr = self.mesh_run
        gen, params = st.rng, st.params
        if mr is not None:
            gen, draws, params = mr.step_inputs(st, batch["image"].shape[0], draws)
        loss = self._noise_loss(params, self.frozen, batch, gen, draws=draws,
                                dropout=self._dropout(draws, gen))
        paths, leaves = zip(*tree.items(params))
        grads = torch.autograd.grad(loss, leaves)
        loss = loss.detach()
        if mr is not None:
            grads = mr.reduce_grads(paths, grads)
            loss = mr.mean(loss)
        it = iter(grads)
        return loss, tree.map(lambda _: next(it), st.params)

    def _apply_update(self, loss, grads) -> Dict:
        """Optimizer step, then the EMA from the updated params."""
        st = self.state
        stats = self.tx.update(st.params, grads, st.opt_state, layout=st.layout)
        if self.ema_decay > 0:
            ema_update(st.ema, st.params, self.ema_decay)
        st.step += 1
        return {"loss": loss, "grad_norm": stats["grad_norm"]}

    def _step(self, batch, draws=None) -> Dict:
        loss, grads = self._grads(batch, draws)
        return self._apply_update(loss, grads)

    def _val_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.cfg.seed + _VAL_SEED_OFFSET)

    @torch.no_grad()
    def _eval(self, batch, valid: int) -> Dict:
        """Loss over the first ``valid`` samples of ``batch``: the loader
        pads the last eval batch by wraparound, and the padding is weighted
        0, so the mean is exact over real samples.  On a mesh ``batch`` is
        this rank's rows and ``valid`` counts the global batch's."""
        b = batch["image"].shape[0]
        gen, first, params = self._val_generator(), 0, self.state.params
        if self.mesh_run is not None:
            gen, first, params = self.mesh_run.eval_inputs(gen, b, params)
        w = (torch.arange(first, first + b, device=self.device) < valid).float()
        loss = self._noise_loss(params, self.frozen, batch, gen, sample_weights=w,
                                train=False)
        if self.mesh_run is not None:
            loss = self.mesh_run.mean(loss)
        return {"loss": loss}

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

    def train_epoch_fast(self, epoch: int, draws=None) -> Dict[str, float]:
        ys = self._fast_epoch(self._step, draws)
        stats = {"loss": float(np.mean(ys["loss"])), "grad_norm": float(np.mean(ys["grad_norm"])),
                 "grad_norm_max": float(np.max(ys["grad_norm"]))}
        self.metrics.scalars(stats, self.state.step, prefix="diffusion_train/")
        return stats

    def validate_fast(self, epoch: int, draws=None) -> float:
        val = self._fast_validate(lambda batch, gen, d, w: self._noise_loss(
            self.state.params, self.frozen, batch, gen, draws=d, sample_weights=w,
            train=False), draws)
        self.metrics.scalar("diffusion_val/loss", val, self.state.step)
        return val

    # -- loops ---------------------------------------------------------------

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        sums: Dict[str, object] = {}
        count = 0
        thr = Throughput()
        for batch in self.train_loader:
            parts = self._step(self._batch(batch))
            count += 1
            thr.step()
            if count % self.cfg.training.log_every == 0:
                vals = {k: float(v) for k, v in parts.items()}
                self.metrics.scalars(vals, self.state.step, prefix="diffusion_train/")
                self.log.info("epoch %d step %d loss %.4f gnorm %.2f | %.0f b/h",
                              epoch, self.state.step, vals["loss"], vals["grad_norm"],
                              thr.batches_per_hour())
            for k, v in parts.items():
                # loss stays on the device: float() here would wait for it
                sums[k] = sums.get(k, 0.0) + v
        return {k: float(v) / max(count, 1) for k, v in sums.items()}

    def validate(self, epoch: int) -> float:
        total, n = 0.0, 0
        for batch in self.val_loader:
            valid = int(batch["valid"])
            total += float(self._eval(self._batch(batch), valid)["loss"]) * valid
            n += valid
        val = total / max(n, 1)
        self.metrics.scalar("diffusion_val/loss", val, self.state.step)
        return val

    def generate_samples(self, epoch: int, num: int = 8, stride: Optional[int] = None):
        descs = self.ds.full_descriptions[:num]
        ids, mask = self.tokenizer.encode_batch(descs, self.cfg.data.text_len)
        extra = self.cfg.extra or {}
        if stride is None:
            stride = int(extra.get("sample_stride", 50))
        gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed + _SAMPLE_SEED_OFFSET + epoch)
        ids, mask = (torch.from_numpy(a).long().to(self.device) for a in (ids, mask))
        mr = self.mesh_run
        if mr is not None:   # this rank's rows of the grid, then all of them
            gen, (ids, mask) = mr.split_rows(gen, len(descs), ids, mask)
        imgs = self._sample(MeshRun.whole(mr, self.state.sample_params), self.frozen, gen,
                            ids, mask, num=ids.shape[0], stride=stride,
                            sampler=str(extra.get("sample_sampler", "ddim")),
                            steps=int(extra.get("sample_steps", 100)),
                            guidance=float(extra.get("sample_guidance", 0.0)))
        path = self.stage_dir / "samples" / f"epoch_{epoch:04d}.png"
        if mr is None:
            save_image_grid(imgs.float().cpu().numpy(), path, captions=descs)
        else:
            imgs = mr.gather_rows(imgs, len(descs))
            mr.write(lambda: save_image_grid(imgs.float().cpu().numpy(), path,
                                             captions=descs))
        return path

    def skipped_batches(self) -> int:
        """Non-finite rejections plus norm rejections (every group)."""
        return skipped_steps(self.state.opt_state)

    def _meta(self, epoch: int) -> Dict:
        return {"epoch": epoch, "vae_checkpoint": self.vae_ckpt_path,
                "config": self.cfg.to_dict()}

    def save_checkpoint(self, epoch: int, val_loss: float) -> bool:
        tr = self.cfg.training
        allow_best = ((epoch + 1) % max(tr.best_every, 1) == 0
                      or epoch + 1 == tr.diffusion_epochs)
        return self.ckpt.save(self.state, self.state.step,
                              val_loss if allow_best else None,
                              extra_meta=self._meta(epoch),
                              periodic=(epoch + 1) % tr.save_every == 0)

    def load_checkpoint(self, path: Optional[str] = None):
        """Resume the full state a port checkpoint holds; from a checkpoint
        without one (a light best, or another optimizer layout), the params
        and step with a fresh optimizer state."""
        if path is None:
            self.state, meta = self.ckpt.restore(self.state, best=True)
        else:
            self.ckpt.wait()     # every rank: no write of this run is in flight
            meta = load_metadata(path)
            raw = read_checkpoint(path)
            try:
                self.state = self.state.from_checkpoint(raw)
            except (KeyError, ValueError) as e:
                self.log.warning("full restore failed (%s): params-only restore", e)
                params = load_params(path, MeshRun.whole(self.mesh_run, self.state.params))
                self.state = self._fresh_state(params, step=int(meta.get("step", 0)),
                                               rng=self.state.rng)
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.best_val = float(meta.get("metric", float("inf")))

    def train(self) -> Path:
        if self.cfg.training.fast_path and self.mesh is None:
            return self._train_fast()
        tr = self.cfg.training
        epochs = tr.diffusion_epochs
        self.log.info("stage 2: %d epochs, %d train batches/epoch on %s",
                      epochs, len(self.train_loader), self.device)
        for epoch in range(self.start_epoch, epochs):
            t0 = time.time()
            self.train_loader.set_epoch(epoch)
            stats = self.train_epoch(epoch)
            val_loss = self.validate(epoch)
            if val_loss < self.best_val:
                self.best_val = val_loss
            self.save_checkpoint(epoch, val_loss)
            if (epoch + 1) % tr.sample_every == 0:
                self.generate_samples(epoch)
            self.log.info("epoch %d done in %.1fs: train %.4f val %.4f skipped %d",
                          epoch, time.time() - t0, stats.get("loss", 0.0), val_loss,
                          self.skipped_batches())
        self._final_save(epochs)
        self.ckpt.wait()     # the files this run reports are on disk
        return self.ckpt.best_path
