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
- spans (``utils/profiling.span``, no-ops off the profiler), as
  ``DiffusionTrainer`` names them: ``psg.train.step`` around a step,
  ``psg.train.grads`` around ``psg.train.forward`` and
  ``psg.train.backward``, and ``psg.train.optimizer``.
- samples: ``ddpm_sample_x0`` (50 strided steps), then ``vae_decode``.

On the card GroupNorm+SiLU and flash attention run their kernels forward
and differentiate their plain versions backward (``ops``); the sample's
decode runs the spatial kernel.  There is no fast path (nor in the JAX
package): ``training.fast_path`` is not read here.

Randomness: the trainer's ``torch.Generator`` (seeded from ``cfg.seed``,
saved in the train state) draws the reparameterize noise, ``t`` and the
noise, in that order; ``_noise_loss`` and ``_step`` also take them
(``draws``), which is how the tests inject the JAX trainer's.  Validation
draws from a generator seeded the same way for every batch.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
import time
from pathlib import Path
from typing import Dict, Optional

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
from psg_tpu_torch.diffusion.sampling import ddpm_sample_x0
from psg_tpu_torch.diffusion.schedule import make_schedule
from psg_tpu_torch.models import bridge
from psg_tpu_torch.models.bert import bert_config_for
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
from psg_tpu_torch.models.vae import (
    latent_size_for,
    reparameterize,
    vae_decode,
    vae_encoder_apply,
    vae_init,
)
from psg_tpu_torch.nn.layers import prepare_weights
from psg_tpu_torch.serve.generator import resolve_device
from psg_tpu_torch.train.common import MeshRun, get_tokenizer, stage_io
from psg_tpu_torch.train.optim import (
    build_optimizer,
    labels_from_mask,
    make_lr_schedule,
    skipped_steps,
)
from psg_tpu_torch.train.state import TrainState
from psg_tpu_torch.utils.images import save_image_grid
from psg_tpu_torch.utils.profiling import span

SD_UNET_DEFAULT = "weights/sd15_unet.ckpt"
_VAL_SEED_OFFSET = 4           # the validation draws' generator: cfg.seed + 4
_SAMPLE_SEED_OFFSET = 40_000   # sample grid of epoch e: cfg.seed + 40000 + e
_SD_SEED_OFFSET = 3            # the random-init SD UNet: cfg.seed + 3
_SPAN_STEP = "psg.train.step"
_SPAN_GRADS = "psg.train.grads"
_SPAN_FORWARD = "psg.train.forward"
_SPAN_BACKWARD = "psg.train.backward"
_SPAN_OPTIMIZER = "psg.train.optimizer"


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


class SDDiffusionTrainer:
    """``--use-diffusers`` stage-2 trainer."""

    STAGE = "diffusers"

    def __init__(self, cfg: Config, vae_checkpoint_path, experiment_name: str = "pokemon",
                 *, device=None, mesh=None):
        """``mesh``: a ('data', 'model') ``DeviceMesh`` this rank trains on
        (stage 2's mechanism, ``train/common.py::MeshRun``; with a 'model'
        axis the wide SD-UNet and BERT kernels and their moments are sharded
        by ``unet_tp_rules``; the frozen VAE whole on every rank)."""
        self.device = resolve_device(device)
        self.mesh, self.mesh_run = mesh, None
        if self.device.type == "cuda":
            configure_torch(cfg)
        self.cfg = cfg
        self.stage_dir = Path(cfg.experiment_dir) / f"{experiment_name}_diffusers"
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
        self.spec = sd_spec_from_config(cfg)
        self.schedule = make_schedule(m.num_timesteps, m.beta_start, m.beta_end, "cosine")
        if (cfg.extra or {}).get("prediction_type", "eps") != "eps":
            # the SD trainer keeps the reference's eps objective
            raise ValueError("extra.prediction_type != 'eps' is not supported by the "
                             "SD trainer")

        self.vae_ckpt_path = str(vae_checkpoint_path) if vae_checkpoint_path else None
        vae_params, text_params = self._load_stage1(vae_checkpoint_path)
        self.frozen_vae = prepare_weights(vae_params, self.compute_dtype)
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + _SD_SEED_OFFSET)
        sd_params = sd_wrapper_init(gen, self.spec, m.text_embedding_dim,
                                    latent_dim=m.latent_dim, base_params=self._load_sd_base())
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
        if mesh is not None:
            self.mesh_run = MeshRun(mesh, params, tp_min_channels=int(
                (cfg.extra or {}).get("tp_min_channels", 640)))
        self.state = self._fresh_state(params, step=0, rng=torch.Generator(
            device=self.device).manual_seed(cfg.seed))
        self.start_epoch = 0
        self.best_val = float("inf")
        self._time_ids = {}      # batch size -> the [B, 6] time ids on the device

    # -- setup ---------------------------------------------------------------

    def _fresh_state(self, params, *, step: int, rng: torch.Generator) -> TrainState:
        """A state from whole params (cut to this rank's shards on a mesh
        with a 'model' axis)."""
        params = tree.map(lambda t: t.detach().requires_grad_(True), params)
        state = TrainState(step, params, self.tx.init(params), rng)
        return self.mesh_run.place(state) if self.mesh_run is not None else state

    def _load_stage1(self, path):
        """(VAE, text encoder) from the stage-1 checkpoint, which must exist
        and fit; drawn from ``cfg.seed`` when none is named."""
        m = self.cfg.model
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
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

    def _batch(self, batch):
        """A loader batch on the device: this rank's rows on a mesh."""
        if self.mesh_run is not None:
            batch = self.mesh_run.local(batch)
        return sd_batch(batch, self.device)

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

    def _draw(self, draws, name, make):
        if draws is not None and name in draws:
            return torch.as_tensor(draws[name]).to(self.device)
        return make()

    def _noise_loss(self, params, batch, generator, draws=None, sample_weights=None):
        """MSE noise loss.  Draws come from ``generator`` unless ``draws``
        gives them: ``rep_noise`` and ``noise`` (the latent's shape), ``t``
        [B]."""
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
        loss = mse_loss(pred, noise, sample_weights=sample_weights)
        if self.mesh_run is not None:   # averaged over 'data': the global batch's loss
            loss = loss * self.mesh_run.loss_scale(sample_weights, b)
        return loss

    # -- steps ---------------------------------------------------------------

    def _grads(self, batch, draws=None):
        """(loss, gradient tree): every leaf gets a gradient, zero where the
        loss does not reach it (BERT's pooler), as ``jax.value_and_grad``
        gives."""
        st = self.state
        mr = self.mesh_run
        with span(_SPAN_GRADS):
            gen, params = st.rng, st.params
            if mr is not None:
                gen, draws, params = mr.step_inputs(st, batch["image"].shape[0], draws)
            with span(_SPAN_FORWARD):
                loss = self._noise_loss(params, batch, gen, draws=draws)
            paths, leaves = zip(*tree.items(params))
            with span(_SPAN_BACKWARD):
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            grads = [g if g is not None else torch.zeros_like(p)
                     for g, p in zip(grads, leaves)]
            loss = loss.detach()
            if mr is not None:
                grads, loss = mr.reduce_grads(paths, grads), mr.mean(loss)
            it = iter(grads)
            return loss, tree.map(lambda _: next(it), st.params)

    def _apply_update(self, loss, grads) -> Dict:
        with span(_SPAN_OPTIMIZER):
            stats = self.tx.update(self.state.params, grads, self.state.opt_state,
                                   layout=self.state.layout)
        self.state.step += 1
        return {"loss": loss, "grad_norm": stats["grad_norm"]}

    def _step(self, batch, draws=None) -> Dict:
        with span(_SPAN_STEP):
            return self._apply_update(*self._grads(batch, draws))

    @torch.no_grad()
    def _eval(self, batch, valid: int, draws=None) -> Dict:
        """Loss over the first ``valid`` samples of ``batch`` (the loader's
        wraparound padding weighted 0).  On a mesh ``batch`` is this rank's
        rows and ``valid`` counts the global batch's."""
        b = batch["image"].shape[0]
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed + _VAL_SEED_OFFSET)
        params, first, mr = self.state.params, 0, self.mesh_run
        if mr is not None:
            gen, first, params = mr.eval_inputs(gen, b, params)
            draws = mr.local(draws)
        w = (torch.arange(first, first + b, device=self.device) < valid).float()
        loss = self._noise_loss(params, batch, gen, draws=draws, sample_weights=w)
        return {"loss": mr.mean(loss) if mr is not None else loss}

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
                self.metrics.scalars(vals, self.state.step, prefix="diffusers_train/")
                self.log.info("epoch %d step %d loss %.4f | %.0f b/h", epoch,
                              self.state.step, vals["loss"], thr.batches_per_hour())
            for k, v in parts.items():
                # the loss stays on the device: float() here would wait for it
                sums[k] = sums.get(k, 0.0) + v
        return {k: float(v) / max(count, 1) for k, v in sums.items()}

    def validate(self, epoch: int) -> float:
        total, n = 0.0, 0
        for batch in self.val_loader:
            valid = int(batch["valid"])
            total += float(self._eval(self._batch(batch), valid)["loss"]) * valid
            n += valid
        val = total / max(n, 1)
        self.metrics.scalar("diffusers_val/loss", val, self.state.step)
        return val

    def generate_samples(self, epoch: int, num: int = 8, steps: int = 50):
        descs = self.ds.descriptions[:num]
        ids, mask = self.tokenizer.encode_batch(descs, self.cfg.data.text_len)
        gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed + _SAMPLE_SEED_OFFSET + epoch)
        ids, mask = (torch.from_numpy(a).long().to(self.device) for a in (ids, mask))
        mr = self.mesh_run
        if mr is not None:   # this rank's rows of the grid, then all of them
            gen, (ids, mask) = mr.split_rows(gen, len(descs), ids, mask)
        imgs = self._sample(MeshRun.whole(mr, self.state.params), gen, ids, mask,
                            num=ids.shape[0], steps=steps)
        path = self.stage_dir / "samples" / f"epoch_{epoch:04d}.png"
        if mr is None:
            save_image_grid(imgs.float().cpu().numpy(), path, captions=descs)
        else:
            imgs = mr.gather_rows(imgs, len(descs))
            mr.write(lambda: save_image_grid(imgs.float().cpu().numpy(), path,
                                             captions=descs))
        return path

    def skipped_batches(self) -> int:
        return skipped_steps(self.state.opt_state)

    def save_checkpoint(self, epoch: int, val_loss: float) -> bool:
        tr = self.cfg.training
        allow_best = ((epoch + 1) % max(tr.best_every, 1) == 0
                      or epoch + 1 == tr.diffusion_epochs)
        return self.ckpt.save(self.state, self.state.step,
                              val_loss if allow_best else None,
                              extra_meta={"epoch": epoch, "vae_checkpoint": self.vae_ckpt_path,
                                          "config": self.cfg.to_dict()},
                              periodic=(epoch + 1) % tr.save_every == 0)

    def load_checkpoint(self, path: Optional[str] = None):
        """Resume the full state a port checkpoint holds; from one without
        (written by the JAX package), the params and step with a fresh
        optimizer state."""
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

    def train(self) -> Path:
        tr = self.cfg.training
        epochs = tr.diffusion_epochs
        self.log.info("stage 2 (--use-diffusers: the SD UNet, %s): %d epochs, "
                      "%d batches/epoch on %s", self.train_mode, epochs, len(self.train_loader), self.device)
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
            self.log.info("epoch %d done in %.1fs: train %.4f val %.4f skipped %d", epoch,
                          time.time() - t0, stats.get("loss", 0.0), val_loss,
                          self.skipped_batches())
        self.metrics.flush()
        self.ckpt.wait()     # the files this run reports are on disk
        return self.ckpt.best_path
