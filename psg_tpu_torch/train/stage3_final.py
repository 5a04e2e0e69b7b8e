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
from pathlib import Path
from typing import Dict, Optional

import torch

from psg_tpu_torch.core import tree
from psg_tpu_torch.core.checkpoint import load_params, read_checkpoint
from psg_tpu_torch.core.config import Config
from psg_tpu_torch.diffusion.sampling import ddim_sample, ddpm_sample, dpmpp_2m_sample
from psg_tpu_torch.diffusion.schedule import make_schedule
from psg_tpu_torch.models import bridge
from psg_tpu_torch.models.clip import ClipConfig, clip_alignment_loss, clip_init
from psg_tpu_torch.models.losses import l1_loss, mse_loss
from psg_tpu_torch.models.text_encoder import text_encoder_apply, text_encoder_init
from psg_tpu_torch.models.unet import (
    text_bias_from_mask,
    unet_apply,
    unet_init,
    unet_spec_from_config,
)
from psg_tpu_torch.models.vae import reparameterize, vae_decode, vae_encoder_apply, vae_init
from psg_tpu_torch.nn.layers import prepare_weights
from psg_tpu_torch.text.bpe import ClipBPETokenizer
from psg_tpu_torch.train.fastpath import FastPath
from psg_tpu_torch.train.optim import build_optimizer, make_lr_schedule
from psg_tpu_torch.train.trainer import StageTrainer

CLIP_SEED = 4321            # the random CLIP, as the JAX package's PRNGKey(4321)


class FinalTrainer(FastPath, StageTrainer):
    """Stage-3 trainer."""

    STAGE, EPOCHS, LOSS = "final", "final_epochs", "total_loss"
    LOG_LINE = "loss {total_loss:.4f} clip {clip_loss:.4f}"
    STATE_SEED_OFFSET = 2          # the train state's generator: cfg.seed + 2
    VAL_SEED_OFFSET = 3            # the validation draws' generator: cfg.seed + 3
    SAMPLE_SEED_OFFSET = 30_000    # sample grid of epoch e: cfg.seed + 30000 + e
    RESTORE_BEST = False
    GRAD_NORM_MAX = False

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
        self._setup(cfg, experiment_name, device, mesh)
        m = cfg.model
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
        self._start(params)

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

    def _load_params(self, vae_path, diff_path) -> Dict:
        """{vae, text, unet}: the stage-1 and stage-2 checkpoints where given
        (each must exist and fit), else drawn from the seed."""
        m = self.cfg.model
        gen = self._generator()
        vt = {"vae": vae_init(gen, m.latent_dim, m.text_embedding_dim, m.vae_width_scale),
              "text": text_encoder_init(gen, self.bert_cfg, m.text_embedding_dim)}
        unet = unet_init(self._generator(1), self.spec)
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
            latent = reparameterize(generator, mu, logvar,
                                    noise=self._draw(draws, "rep_noise", lambda: None))
        return vae_decode(params["vae"], latent.to(text_emb.dtype), text_emb,
                          text_bias=text_bias_from_mask(batch["text_mask"]),
                          image_size=self.cfg.data.image_size, dtype=self.compute_dtype)

    def _loss(self, params, batch, generator, draws, *, weights=None, train: bool = True):
        """(total loss, parts)."""
        recon = self._roundtrip(params, batch, generator, draws)
        l1 = l1_loss(recon, batch["image"], sample_weights=weights)
        mse = mse_loss(recon, batch["image"], sample_weights=weights)
        # BPE ids for a pretrained CLIP tower; WordPiece ids otherwise
        clip = clip_alignment_loss(self.clip_params, recon,
                                   batch.get("clip_ids", batch["text_ids"]),
                                   batch.get("clip_mask", batch["text_mask"]),
                                   self.clip_cfg, dtype=self.compute_dtype,
                                   sample_weights=weights)
        total = l1 + 0.1 * mse + self.cfg.training.clip_weight * clip
        parts = {"total_loss": total, "l1_loss": l1, "mse_loss": mse, "clip_loss": clip}
        return self._mesh_scaled(weights, batch["image"].shape[0], total, parts)

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

    def _before_epoch(self, epoch: int) -> None:
        if epoch >= self._phase1_epochs() and self.phase == "text_encoder":
            self.switch_to_joint_training()

    def _phase1_epochs(self) -> int:
        tr = self.cfg.training
        return tr.phase1_epochs if tr.phase1_epochs is not None else tr.final_epochs // 2

    # -- loops ---------------------------------------------------------------

    def generate_samples(self, epoch: int, num: int = 4, steps: Optional[int] = None) -> Path:
        extra = self.cfg.extra or {}
        if steps is None:
            steps = int(extra.get("sample_steps", 100))
        return self._save_grid(epoch, self.ds.full_descriptions[:num],
                               f"final_epoch_{epoch:04d}.png",
                               lambda params, gen, ids, mask: self._sample(
                                   params, gen, ids, mask, num=ids.shape[0], steps=steps,
                                   sampler=str(extra.get("sample_sampler", "ddim"))))

    def _meta(self, epoch: int, classic: bool = False) -> Dict:
        # the JAX package's fast path names the phase 'phase', its classic path
        # 'training_phase' (which resuming reads): the fast path writes both
        phase = {} if classic else {"phase": self.phase}
        return {"epoch": epoch, **phase, "training_phase": self.phase,
                "config": self.cfg.to_dict()}

    def _banner(self, epochs: int) -> str:
        return (f"stage 3: {epochs} epochs (phase1 {self._phase1_epochs()}), "
                f"{len(self.train_loader)} batches/epoch on {self.device}")

    def _epoch_name(self, epoch: int) -> str:
        return f"{epoch} ({self.phase})"

    def _before_restore(self, meta: Dict) -> None:
        """A joint-phase checkpoint switches first, then restores its
        three-group optimizer state with the parameters."""
        if meta.get("training_phase") == "joint" and self.phase != "joint":
            self.switch_to_joint_training()
        self.ckpt.best_metric = min(self.ckpt.best_metric,
                                    float(meta.get("metric", float("inf"))))

    def _after_restore(self) -> None:
        self.log.info("restored %s checkpoint at epoch %d (val %.4f)", self.phase,
                      self.start_epoch, self.best_val)
