"""Stage 3: the text encoder fine-tuned through a reconstruction and CLIP
loss, then jointly with the decoder and the UNet (port of
``psg_tpu/train/stage3_final.py``: the classic loader path and the
device-resident fast path).

A step: the text encoder (BERT, projection, LayerNorm), the VAE encoder and
``reparameterize`` without gradient, the decoder with its text
cross-attention, then L1 + 0.1 * MSE against the input plus ``clip_weight``
times the CLIP alignment loss of the reconstruction and its caption, the
backward, and the optimizer (``train/optim.py``).  Diffusion is not in the
loss.  Two phases:

- ``text_encoder``: one group, the whole text encoder at
  ``text_encoder_lr`` (or a tenth of ``learning_rate``); the VAE and the
  UNet are frozen.
- ``joint`` (from epoch ``phase1_epochs``, default ``final_epochs // 2``):
  ``switch_to_joint_training`` adds the decoder (``extra.optimization.
  vae_decoder_lr``) and the UNet (``extra.optimization.unet_lr``), each by
  default a tenth of the text rate, and starts a fresh optimizer state, so
  bias correction and the schedules restart at the switch.  The encoder
  stays frozen.  The UNet is not in the loss: its gradient is 0, so AdamW
  moves it by its weight decay alone.

As in the JAX step every parameter gets a gradient (the decoder's in the
first phase too; zeros for the encoder, the UNet and BERT's unused pooler),
and the logged ``grad_norm`` and the non-finite check cover them all.  Each
group is clipped to ``max_grad_norm``.  On the card GroupNorm+SiLU, flash
attention (BERT, the decoder's wide sites and CLIP's vision tower) and the
decoder's spatial cross-attention run their kernels forward and
differentiate their plain versions backward (``ops``); CLIP's text tower
carries a causal + padding bias and takes ``sdpa_plain``, as the reference
takes ``sdpa_xla``.

CLIP is frozen.  With converted weights (``$PSG_TPU_CLIP`` or
``weights/clip_vit_b32.ckpt``) and CLIP's BPE files (``$PSG_TPU_CLIP_BPE``
or ``weights/``) the loss runs ViT-B/32 on BPE ids; otherwise a CLIP drawn
from a generator seeded 4321 on the WordPiece ids (``ClipConfig.tiny_test``
at the tiny test BERT).  A weight file or directory that is named
(``$PSG_TPU_CLIP``, ``$PSG_TPU_CLIP_BPE``, a VAE or diffusion checkpoint
path) must exist, or the trainer raises; with nothing named the VAE and
text encoder are drawn from ``cfg.seed`` and the UNet from ``cfg.seed + 1``
(stage 1's and stage 2's draws), and the log says so.  The frozen UNet
loads the stage-2 checkpoint's EMA weights where it has them.

Randomness: the trainer's ``torch.Generator`` (seeded ``cfg.seed + 2``,
saved in the train state) draws the reparameterize noise; ``_step`` and
``_eval`` also take it (``draws={'rep_noise': ...}``), which is how the
tests inject the JAX trainer's.  Validation draws from a generator seeded
the same way for every batch, as the JAX trainer folds one fixed key.

With ``training.fast_path`` ``train()`` takes the device-resident path
(``train/fastpath.py``): the split (with CLIP's BPE ids where the dataset
has them) on the device, each step's minibatch drawn, gathered and
augmented there, then the classic step's ``_grads`` and ``_apply_update``;
the switch to the joint phase happens inside the loop at
``phase1_epochs``.  Light best checkpoints (bf16 params on the
``best_every`` cadence) and one full periodic state at the end.  Its draws,
in order: the index uniforms, the augmentation parameters, then the
reparameterize noise; ``train_epoch_fast`` and ``validate_fast`` take them
too (``draws``, one dict a step or a validation batch).

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
from psg_tpu_torch.data.loader import make_loaders
from psg_tpu_torch.diffusion.sampling import ddim_sample, ddpm_sample, dpmpp_2m_sample
from psg_tpu_torch.diffusion.schedule import make_schedule
from psg_tpu_torch.models import bridge
from psg_tpu_torch.models.bert import bert_config_for
from psg_tpu_torch.models.clip import ClipConfig, clip_alignment_loss, clip_init
from psg_tpu_torch.models.losses import l1_loss, mse_loss
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
from psg_tpu_torch.serve.generator import resolve_device
from psg_tpu_torch.text.bpe import ClipBPETokenizer
from psg_tpu_torch.train.common import MeshRun, device_batch, get_tokenizer, stage_io
from psg_tpu_torch.train.fastpath import FastPath
from psg_tpu_torch.train.optim import build_optimizer, make_lr_schedule, skipped_steps
from psg_tpu_torch.train.state import TrainState
from psg_tpu_torch.utils.images import save_image_grid

CLIP_SEED = 4321            # the random CLIP, as the JAX package's PRNGKey(4321)
_STATE_SEED_OFFSET = 2      # the train state's generator: cfg.seed + 2
_VAL_SEED_OFFSET = 3        # the validation draws' generator: cfg.seed + 3
_SAMPLE_SEED_OFFSET = 30_000   # sample grid of epoch e: cfg.seed + 30000 + e


class FinalTrainer(FastPath):
    """Stage-3 trainer."""

    STAGE = "final"
    EPOCHS = "final_epochs"

    def __init__(self, cfg: Config, vae_checkpoint_path, diffusion_checkpoint_path,
                 experiment_name: str = "pokemon", *, device=None, mesh=None):
        """``vae_checkpoint_path``: the stage-1 checkpoint ({vae, text});
        ``diffusion_checkpoint_path``: the stage-2 checkpoint (the UNet).  A
        path that is given must exist and fit; ``None`` draws that part
        from the seed.  ``mesh``: a ('data', 'model') ``DeviceMesh`` this
        rank trains on (stage 2's mechanism, ``train/common.py::MeshRun``;
        with a 'model' axis the wide kernels of all three parts and their
        moments are sharded by ``unet_tp_rules``; CLIP whole on every
        rank)."""
        self.device = resolve_device(device)
        self.mesh, self.mesh_run = mesh, None
        if self.device.type == "cuda":
            configure_torch(cfg)
        self.cfg = cfg
        self.stage_dir = Path(cfg.experiment_dir) / f"{experiment_name}_final"
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
        self.schedule = make_schedule(m.num_timesteps, m.beta_start, m.beta_end,
                                      m.beta_schedule)
        params = self._load_params(vae_checkpoint_path, diffusion_checkpoint_path)

        # BPE ids for a pretrained CLIP only; a random tower reads WordPiece ids
        self.clip_bpe = ClipBPETokenizer.find()
        clip_path = self._clip_ckpt_path()
        if self.clip_bpe is not None and clip_path is not None:
            self.clip_cfg = ClipConfig.b32()._replace(text_vocab=self.clip_bpe.vocab_size)
            self.ds.set_clip_tokenizer(self.clip_bpe)
        else:
            self.clip_bpe = None
            vocab = self.tokenizer.vocab_size
            self.clip_cfg = (ClipConfig.tiny_test(vocab) if "tiny-test" in m.bert_model
                             else ClipConfig.b32()._replace(text_vocab=vocab))
        self.clip_params, clip_src = self._load_clip(clip_path)
        self.log.info("weights: clip=%s (text ids: %s)", clip_src,
                      "CLIP-BPE" if self.clip_bpe else "WordPiece")

        o = cfg.optimization
        spe = max(len(self.train_loader), 1)
        kind = o.scheduler if o.scheduler in ("cosine", "step") else "constant"

        def schedule(lr):
            return make_lr_schedule(kind, lr, total_steps=cfg.training.final_epochs * spe,
                                    steps_per_epoch=spe, warmup_steps=o.warmup_steps,
                                    end_factor=o.lr_end_factor)

        text_lr = o.text_encoder_lr or o.learning_rate * 0.1
        eo = (cfg.extra or {}).get("optimization", {})
        rates = {"text": text_lr, "decoder": eo.get("vae_decoder_lr", text_lr * 0.1),
                 "unet": eo.get("unet_lr", text_lr * 0.1)}
        groups = {g: {"lr_schedule": schedule(lr), "max_grad_norm": o.max_grad_norm}
                  for g, lr in rates.items()}
        self.tx_phase1 = build_optimizer(o, {"text": groups["text"]},
                                         self._labels(params, joint=False))
        self.tx_phase2 = build_optimizer(o, groups, self._labels(params, joint=True))
        self.phase = "text_encoder"
        self.tx = self.tx_phase1
        if mesh is not None:
            self.mesh_run = MeshRun(mesh, params, tp_min_channels=int(
                (cfg.extra or {}).get("tp_min_channels", 640)))
        self.state = self._fresh_state(params, step=0, rng=torch.Generator(
            device=self.device).manual_seed(cfg.seed + _STATE_SEED_OFFSET))
        self.start_epoch = 0
        self.best_val = float("inf")

    # -- setup ---------------------------------------------------------------

    @staticmethod
    def _labels(params, *, joint: bool):
        """The optimizer's labels, in the parameters' key order (the
        optimizer pairs labels with parameters by position)."""
        def like(t, label):
            return tree.map(lambda _: label, t)

        vae = {k: like(v, "decoder" if joint and k == "decoder" else "frozen")
               for k, v in params["vae"].items()}
        return {k: (vae if k == "vae" else like(v, "text") if k == "text"
                    else like(v, "unet" if joint else "frozen"))
                for k, v in params.items()}

    def _fresh_state(self, params, *, step: int, rng: torch.Generator) -> TrainState:
        """A state from whole params (cut to this rank's shards on a mesh
        with a 'model' axis)."""
        params = tree.map(lambda t: t.detach().requires_grad_(True), params)
        state = TrainState(step, params, self.tx.init(params), rng)
        return self.mesh_run.place(state) if self.mesh_run is not None else state

    def _load_params(self, vae_path, diff_path) -> Dict:
        """{vae, text, unet}: the stage-1 and stage-2 checkpoints where given
        (each must exist and fit), else drawn from the seed."""
        m = self.cfg.model
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        vt = {"vae": vae_init(gen, m.latent_dim, m.text_embedding_dim, m.vae_width_scale),
              "text": text_encoder_init(gen, self.bert_cfg, m.text_embedding_dim)}
        unet = unet_init(torch.Generator(device=self.device).manual_seed(self.cfg.seed + 1),
                         self.spec)
        for path, what in ((vae_path, "VAE"), (diff_path, "diffusion")):
            if path is not None and not Path(path).exists():
                raise FileNotFoundError(f"{what} checkpoint not found: {path}")
        if vae_path is None:
            self.log.warning("no VAE checkpoint named: VAE and text drawn from seed %d",
                             self.cfg.seed)
        else:
            vt = load_params(vae_path, vt)
            self.log.info("loaded VAE+text from %s", vae_path)
        if diff_path is None:
            self.log.warning("no diffusion checkpoint named: UNet drawn from seed %d",
                             self.cfg.seed + 1)
        else:
            # the frozen UNet drives generation only: its EMA weights if saved
            unet = load_params(diff_path, unet, prefer_ema=True)
            self.log.info("loaded UNet from %s", diff_path)
        return {"vae": vt["vae"], "text": vt["text"], "unet": unet}

    @staticmethod
    def _clip_ckpt_path() -> Optional[Path]:
        """``$PSG_TPU_CLIP`` (which must exist) or the default path if it
        exists, else None."""
        named = os.environ.get("PSG_TPU_CLIP")
        path = Path(named or "weights/clip_vit_b32.ckpt")
        if path.exists():
            return path
        if named:
            raise FileNotFoundError(f"PSG_TPU_CLIP names a missing file: {path}")
        return None

    def _load_clip(self, path):
        """(params, source): converted weights from ``path``, else drawn from
        seed ``CLIP_SEED``; matmul kernels kept in the compute dtype."""
        template = clip_init(torch.Generator(device=self.device).manual_seed(CLIP_SEED),
                             self.clip_cfg)
        if path is None:
            clip, src = template, "random-init"
        else:
            clip, src = bridge.fit(template, bridge.from_jax(read_checkpoint(path)),
                                   str(path)), "pretrained"
        return prepare_weights(clip, self.compute_dtype), src

    def _batch(self, batch):
        """A loader batch on the device: this rank's rows on a mesh."""
        if self.mesh_run is not None:
            batch = self.mesh_run.local(batch)
        return device_batch(batch, self.device)

    # -- the loss ------------------------------------------------------------

    def _roundtrip(self, params, batch, generator, draws=None):
        """Encode without gradient, decode with the trainable text
        conditioning.  The reparameterize noise comes from ``generator``
        unless ``draws['rep_noise']`` gives it."""
        text_emb = text_encoder_apply(params["text"], batch["text_ids"], batch["text_mask"],
                                      self.bert_cfg, dtype=self.compute_dtype)
        with torch.no_grad():
            mu, logvar = vae_encoder_apply(params["vae"]["encoder"], batch["image"],
                                           dtype=self.compute_dtype)
            noise = None
            if draws is not None and "rep_noise" in draws:
                noise = torch.as_tensor(draws["rep_noise"]).to(self.device)
            latent = reparameterize(generator, mu, logvar, noise=noise)
        return vae_decode(params["vae"], latent.to(text_emb.dtype), text_emb,
                          text_bias=text_bias_from_mask(batch["text_mask"]),
                          image_size=self.cfg.data.image_size, dtype=self.compute_dtype)

    def _forward_loss(self, params, batch, generator, draws=None, sample_weights=None):
        """(total loss, parts)."""
        recon = self._roundtrip(params, batch, generator, draws)
        l1 = l1_loss(recon, batch["image"], sample_weights=sample_weights)
        mse = mse_loss(recon, batch["image"], sample_weights=sample_weights)
        # BPE ids for a pretrained CLIP tower; WordPiece ids otherwise
        clip = clip_alignment_loss(self.clip_params, recon,
                                   batch.get("clip_ids", batch["text_ids"]),
                                   batch.get("clip_mask", batch["text_mask"]),
                                   self.clip_cfg, dtype=self.compute_dtype,
                                   sample_weights=sample_weights)
        total = l1 + 0.1 * mse + self.cfg.training.clip_weight * clip
        parts = {"total_loss": total, "l1_loss": l1, "mse_loss": mse, "clip_loss": clip}
        if self.mesh_run is not None:   # averaged over 'data': the global batch's loss
            scale = self.mesh_run.loss_scale(sample_weights, batch["image"].shape[0])
            total, parts = total * scale, {k: v * scale for k, v in parts.items()}
        return total, parts

    # -- steps ---------------------------------------------------------------

    def _grads(self, batch, draws=None):
        """(loss parts, gradient tree) of one training batch: every leaf
        gets a gradient, zero where the loss does not reach it (the
        encoder, the UNet, BERT's pooler), as ``jax.grad`` gives."""
        st = self.state
        mr = self.mesh_run
        gen, params = st.rng, st.params
        if mr is not None:
            gen, draws, params = mr.step_inputs(st, batch["image"].shape[0], draws)
        loss, parts = self._forward_loss(params, batch, gen, draws)
        paths, leaves = zip(*tree.items(params))
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(p) for g, p in zip(grads, leaves)]
        parts = {k: v.detach() for k, v in parts.items()}
        if mr is not None:
            grads, parts = mr.reduce_grads(paths, grads), mr.mean_parts(parts)
        it = iter(grads)
        return parts, tree.map(lambda _: next(it), st.params)

    def _apply_update(self, parts, grads) -> Dict:
        st = self.state
        stats = self.tx.update(st.params, grads, st.opt_state, layout=st.layout)
        st.step += 1
        return {**parts, "grad_norm": stats["grad_norm"]}

    def _step(self, batch, draws=None) -> Dict:
        parts, grads = self._grads(batch, draws)
        return self._apply_update(parts, grads)

    def _val_generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(
            self.cfg.seed + _VAL_SEED_OFFSET)

    @torch.no_grad()
    def _eval(self, batch, valid: int, draws=None) -> Dict:
        """Loss parts over the first ``valid`` samples of ``batch``: the
        loader pads the last eval batch by wraparound, and the padding is
        weighted 0 in every term.  On a mesh ``batch`` is this rank's rows
        and ``valid`` counts the global batch's."""
        b = batch["image"].shape[0]
        gen, first, params = self._val_generator(), 0, self.state.params
        if self.mesh_run is not None:
            gen, first, params = self.mesh_run.eval_inputs(gen, b, params)
            draws = self.mesh_run.local(draws)
        w = (torch.arange(first, first + b, device=self.device) < valid).float()
        _, parts = self._forward_loss(params, batch, gen, draws, sample_weights=w)
        return self.mesh_run.mean_parts(parts) if self.mesh_run is not None else parts

    @torch.no_grad()
    def _sample(self, params, generator, text_ids, text_mask, *, num: int, steps: int = 50,
                sampler: str = "ddim", initial_latent=None):
        """The text -> sprite chain: DDIM by default, ``'ddpm'`` (the
        reference's strided posterior sampler) or ``'dpmpp'``.
        ``initial_latent`` replaces the generator's first draw."""
        text_emb = text_encoder_apply(params["text"], text_ids, text_mask, self.bert_cfg,
                                      dtype=self.compute_dtype)
        v_pred = (self.cfg.extra or {}).get("prediction_type", "eps") == "v"

        def denoise(x, t):
            out = unet_apply(params["unet"], x.to(text_emb.dtype), t, text_emb, self.spec,
                             text_mask=text_mask, dtype=self.compute_dtype)
            # a v-trained stage-2 base: the samplers consume eps
            return self.schedule.eps_from_v(out, x, t) if v_pred else out

        shape = (num, self.latent_size, self.latent_size, self.cfg.model.latent_dim)
        clamp = self.cfg.model.latent_clamp
        if sampler == "ddpm":
            latents = ddpm_sample(denoise, self.schedule, generator, shape=shape,
                                  initial_latent=initial_latent, num_inference_steps=steps)
        elif sampler == "dpmpp":
            latents = dpmpp_2m_sample(denoise, self.schedule, generator, shape=shape,
                                      initial_latent=initial_latent,
                                      num_inference_steps=steps, clip_x0=clamp)
        else:
            latents = ddim_sample(denoise, self.schedule, generator, shape=shape,
                                  initial_latent=initial_latent, num_inference_steps=steps,
                                  clip_x0=clamp)
        return vae_decode(params["vae"], latents.to(text_emb.dtype), text_emb,
                          text_bias=text_bias_from_mask(text_mask),
                          image_size=self.cfg.data.image_size, dtype=self.compute_dtype)

    # -- phase switch --------------------------------------------------------

    def switch_to_joint_training(self):
        """Unfreeze the decoder and the UNet with a fresh three-group
        optimizer state (counts, moments and schedules from step 0)."""
        self.log.info("switching to joint training (unfreeze decoder + unet)")
        self.phase = "joint"
        self.tx = self.tx_phase2
        self.state.opt_state = None      # the old moments go before the new ones come
        self.state.opt_state = self.tx.init(self.state.params)

    # -- the device-resident fast path (train/fastpath.py) -----------------------

    def train_epoch_fast(self, epoch: int, draws=None) -> Dict[str, float]:
        ys = self._fast_epoch(self._step, draws)
        stats = {k: float(np.mean(v)) for k, v in ys.items()}
        self.metrics.scalars(stats, self.state.step, prefix="final_train/")
        return stats

    def validate_fast(self, epoch: int, draws=None) -> float:
        val = self._fast_validate(lambda batch, gen, d, w: self._forward_loss(
            self.state.params, batch, gen, d, sample_weights=w)[1]["total_loss"], draws)
        self.metrics.scalar("final_val/total_loss", val, self.state.step)
        return val

    def _meta(self, epoch: int) -> Dict:
        # the JAX package's fast path names the phase 'phase', its classic path
        # 'training_phase' (which resuming reads): both are written
        return {"epoch": epoch, "phase": self.phase, "training_phase": self.phase,
                "config": self.cfg.to_dict()}

    def _before_fast_epoch(self, epoch: int) -> None:
        tr = self.cfg.training
        phase1 = tr.phase1_epochs if tr.phase1_epochs is not None else tr.final_epochs // 2
        if epoch >= phase1 and self.phase == "text_encoder":
            self.switch_to_joint_training()

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
                self.metrics.scalars(vals, self.state.step, prefix="final_train/")
                self.log.info("epoch %d step %d loss %.4f clip %.4f | %.0f b/h", epoch,
                              self.state.step, vals["total_loss"], vals["clip_loss"],
                              thr.batches_per_hour())
            for k, v in parts.items():
                # losses stay on the device: float() here would wait for them
                sums[k] = sums.get(k, 0.0) + v
        return {k: float(v) / max(count, 1) for k, v in sums.items()}

    def validate(self, epoch: int) -> float:
        total, n = 0.0, 0
        for batch in self.val_loader:
            valid = int(batch["valid"])
            total += float(self._eval(self._batch(batch), valid)["total_loss"]) * valid
            n += valid
        val = total / max(n, 1)
        self.metrics.scalar("final_val/total_loss", val, self.state.step)
        return val

    def generate_samples(self, epoch: int, num: int = 4, steps: Optional[int] = None) -> Path:
        descs = self.ds.full_descriptions[:num]
        ids, mask = self.tokenizer.encode_batch(descs, self.cfg.data.text_len)
        extra = self.cfg.extra or {}
        if steps is None:
            steps = int(extra.get("sample_steps", 100))
        gen = torch.Generator(device=self.device).manual_seed(
            self.cfg.seed + _SAMPLE_SEED_OFFSET + epoch)
        ids, mask = (torch.from_numpy(a).long().to(self.device) for a in (ids, mask))
        mr = self.mesh_run
        if mr is not None:   # this rank's rows of the grid, then all of them
            gen, (ids, mask) = mr.split_rows(gen, len(descs), ids, mask)
        imgs = self._sample(MeshRun.whole(mr, self.state.params), gen, ids, mask,
                            num=ids.shape[0], steps=steps,
                            sampler=str(extra.get("sample_sampler", "ddim")))
        path = self.stage_dir / "samples" / f"final_epoch_{epoch:04d}.png"
        if mr is None:
            save_image_grid(imgs.float().cpu().numpy(), path, captions=descs)
        else:
            imgs = mr.gather_rows(imgs, len(descs))
            mr.write(lambda: save_image_grid(imgs.float().cpu().numpy(), path,
                                             captions=descs))
        return path

    def skipped_batches(self) -> int:
        """Non-finite rejections plus norm rejections (every group) since the
        optimizer state began (the switch starts a new one)."""
        return skipped_steps(self.state.opt_state)

    def save_checkpoint(self, epoch: int, val_loss: float) -> bool:
        tr = self.cfg.training
        allow_best = ((epoch + 1) % max(tr.best_every, 1) == 0
                      or epoch + 1 == tr.final_epochs)
        return self.ckpt.save(self.state, self.state.step, val_loss if allow_best else None,
                              extra_meta={"epoch": epoch, "training_phase": self.phase,
                                          "config": self.cfg.to_dict()},
                              periodic=(epoch + 1) % tr.save_every == 0)

    def load_checkpoint(self, path: Optional[str] = None):
        """Resume from a stage-3 checkpoint.  A joint-phase one switches
        first and then restores its three-group optimizer state with the
        parameters; from a checkpoint without a port optimizer state (a JAX
        one), the parameters and step with a fresh one."""
        self.ckpt.wait()     # every rank: no write of this run is in flight
        path = Path(path) if path is not None else self.ckpt.best_path
        if not path.exists():
            raise FileNotFoundError(f"no checkpoint at {path}")
        meta = load_metadata(path)
        if meta.get("training_phase") == "joint" and self.phase != "joint":
            self.switch_to_joint_training()
        try:
            self.state = self.state.from_checkpoint(read_checkpoint(path))
        except (KeyError, ValueError) as e:
            self.log.warning("full restore failed (%s): params-only restore", e)
            params = load_params(path, MeshRun.whole(self.mesh_run, self.state.params))
            self.state = self._fresh_state(params, step=int(meta.get("step", 0)),
                                           rng=self.state.rng)
        self.ckpt.best_metric = min(self.ckpt.best_metric,
                                    float(meta.get("metric", float("inf"))))
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.best_val = float(meta.get("metric", float("inf")))
        self.log.info("restored %s checkpoint at epoch %d (val %.4f)", self.phase,
                      self.start_epoch, self.best_val)

    def train(self) -> Path:
        if self.cfg.training.fast_path and self.mesh is None:
            return self._train_fast()
        t = self.cfg.training
        epochs = t.final_epochs
        phase1 = t.phase1_epochs if t.phase1_epochs is not None else epochs // 2
        self.log.info("stage 3: %d epochs (phase1 %d), %d batches/epoch on %s", epochs,
                      phase1, len(self.train_loader), self.device)
        for epoch in range(self.start_epoch, epochs):
            if epoch >= phase1 and self.phase == "text_encoder":
                self.switch_to_joint_training()
            t0 = time.time()
            self.train_loader.set_epoch(epoch)
            stats = self.train_epoch(epoch)
            val_loss = self.validate(epoch)
            if val_loss < self.best_val:
                self.best_val = val_loss
            self.save_checkpoint(epoch, val_loss)
            if (epoch + 1) % t.sample_every == 0:
                self.generate_samples(epoch)
            self.log.info("epoch %d (%s) done in %.1fs: train %.4f val %.4f skipped %d",
                          epoch, self.phase, time.time() - t0, stats.get("total_loss", 0.0),
                          val_loss, self.skipped_batches())
        self.metrics.flush()
        self.ckpt.wait()     # the files this run reports are on disk
        return self.ckpt.best_path
