"""Stage 0 (optional): masked-language-model pretraining of the text tower
(port of ``psg_tpu/train/stage0_mlm.py``).

BERT-style MLM over the caption corpus (each canonical caption and
``extra.mlm_caption_augment`` (8) augmented variants of it), so that stage
1 can start its text encoder from distributional word knowledge instead of
random weights.  Standard masking: 15% of the non-special tokens are
selected; of those 80% become [MASK], 10% a random token, 10% stay;
cross-entropy on the selected positions.  The head is BERT's transform
(dense, tanh-approximated GELU, LayerNorm) with the decoder tied to the word
embedding table plus a free bias.  The loss runs BERT in bf16, as the JAX
step does (``compute_dtype``).

A step draws its minibatch with replacement from the training rows (5% of
the rows are held out by ``RandomState(seed)`` for the validation loss),
then the masks, from the trainer's ``torch.Generator``; ``_step`` and
``_loss`` also take those draws (``draws``), which is how the tests inject
the JAX trainer's.  The optimizer is optax's ``clip_by_global_norm`` then
``adamw`` over a warmup-cosine schedule (b1 0.9, eps 1e-8, no skip and no
non-finite check), every parameter in one group.  Its output,
``{stage_dir}/checkpoints/mlm_best_model.ckpt``, carries ``{"params":
{"text", "mlm"}}``; stage 1 warm-starts from it through
``extra.text_init`` (``load_text_init``), in either package.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from psg_tpu_torch.core import tree
from psg_tpu_torch.core.checkpoint import (
    CheckpointManager,
    params_subtree,
    read_checkpoint,
    wait_for_writes,
)
from psg_tpu_torch.core.config import Config, configure_torch
from psg_tpu_torch.core.metrics import MetricsWriter, setup_logging
from psg_tpu_torch.data.caption_augment import caption_variants
from psg_tpu_torch.data.dataset import PokemonDataset
from psg_tpu_torch.models import bridge
from psg_tpu_torch.models.bert import bert_apply, bert_config_for
from psg_tpu_torch.models.text_encoder import text_encoder_init
from psg_tpu_torch.nn.layers import layer_norm, layer_norm_init, linear, linear_init
from psg_tpu_torch.serve.generator import resolve_device
from psg_tpu_torch.train.common import get_tokenizer
from psg_tpu_torch.train.optim import _warmup_cosine, build_optimizer
from psg_tpu_torch.train.state import TrainState
from psg_tpu_torch.train.trainer import tree_grads

_SEED_OFFSET = 10       # parameters and the train state's generator: cfg.seed + 10
_VAL_SEED_OFFSET = 13   # the validation masks' generator: cfg.seed + 13


def mlm_head_init(gen, hidden: int, vocab_size: int):
    """BERT's MLM transform head; the vocabulary decoder is tied to the word
    embedding table, so only the transform and the output bias are free."""
    return {"transform": linear_init(gen, hidden, hidden, init="torch"),
            "ln": layer_norm_init(hidden, gen.device),
            "bias": torch.zeros(vocab_size, device=gen.device)}


def mlm_logits(text_params, head, input_ids, attention_mask, cfg, *, dtype=None):
    """[B, S] ids -> [B, S, V] vocabulary logits (tied decoder, fp32)."""
    hidden, _ = bert_apply(text_params["bert"], input_ids, attention_mask, cfg, dtype=dtype)
    h = F.gelu(linear(head["transform"], hidden, dtype=dtype).float(), approximate="tanh")
    h = layer_norm(head["ln"], h, eps=1e-12)
    return h @ text_params["bert"]["embeddings"]["word"].float().T + head["bias"]


def apply_bert_masking(generator, ids, mask, *, mask_id: int, vocab_size: int,
                       n_special: int = 5, p_select: float = 0.15, draws=None):
    """80/10/10 BERT masking -> (masked_ids, labels, selected); ``selected``
    marks the loss positions.  Special tokens (ids < n_special) and padding
    are never selected.  The uniforms ``u_select`` and ``u_kind`` and the
    random tokens ``random_ids`` (each ids' shape) come from ``generator``
    unless ``draws`` gives them."""
    draws = draws or {}

    def draw(name, make):
        return torch.as_tensor(draws[name]).to(ids.device) if name in draws else make()

    u_select = draw("u_select", lambda: torch.rand(ids.shape, generator=generator,
                                                   device=ids.device))
    u_kind = draw("u_kind", lambda: torch.rand(ids.shape, generator=generator,
                                               device=ids.device))
    random_ids = draw("random_ids", lambda: torch.randint(
        n_special, vocab_size, ids.shape, generator=generator, device=ids.device))
    maskable = (mask > 0) & (ids >= n_special)
    selected = (u_select < p_select) & maskable
    replaced = torch.where(u_kind < 0.8, torch.full_like(ids, mask_id),
                           torch.where(u_kind < 0.9, random_ids.to(ids.dtype), ids))
    return torch.where(selected, replaced, ids), ids, selected


class _Params:
    """What a stage-0 checkpoint holds: the parameters alone."""

    def __init__(self, params):
        self.params = params

    def to_checkpoint(self):
        return {"params": bridge.to_jax(self.params)}


class MLMPretrainer:
    """Stage-0 trainer."""

    STAGE = "mlm"

    def __init__(self, cfg: Config, experiment_name: str = "pokemon", *, device=None):
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            configure_torch(cfg)
        self.cfg = cfg
        self.stage_dir = Path(cfg.experiment_dir) / f"{experiment_name}_mlm"
        self.ckpt = CheckpointManager(self.stage_dir / "checkpoints", self.STAGE)
        self.log = setup_logging(self.stage_dir / "logs", self.STAGE)
        self.metrics = MetricsWriter(self.stage_dir / "logs")

        ds = PokemonDataset(cfg.data.csv_path, cfg.data.image_dir,
                            image_size=cfg.data.image_size,
                            background_color=cfg.data.background_color,
                            text_len=cfg.data.text_len)
        self.tokenizer = get_tokenizer(cfg, self.stage_dir, corpus=ds.full_descriptions)
        self.bert_cfg = bert_config_for(cfg.model.bert_model, self.tokenizer.vocab_size)
        # the loss runs BERT in bf16 whatever model.compute_dtype says, as the
        # JAX step does; None runs it in fp32
        self.compute_dtype = torch.bfloat16

        # the canonical captions and K variants each (the stage-2 generator,
        # the name kept: MLM wants wording diversity)
        extra = cfg.extra or {}
        k_var = int(extra.get("mlm_caption_augment", 8) or 0)
        texts = list(ds.full_descriptions)
        if k_var > 0:
            for vlist in caption_variants(ds.full_descriptions, k_var,
                                          int(extra.get("caption_aug_seed", cfg.seed)),
                                          p_name_drop=float(extra.get("mlm_name_drop", 0.5))):
                texts.extend(vlist[1:])   # [0] is the canonical caption
        ids, attn = self.tokenizer.encode_batch(texts, cfg.data.text_len)
        # a fixed 5% of the rows held out for the validation loss
        hold = np.random.RandomState(cfg.seed).permutation(ids.shape[0])
        n_val = max(1, ids.shape[0] // 20)

        def rows(idx):
            return tuple(torch.from_numpy(a[idx]).long().to(self.device) for a in (ids, attn))

        self.val_rows, self.train_rows = rows(hold[:n_val]), rows(hold[n_val:])

        gen = torch.Generator(device=self.device).manual_seed(cfg.seed + _SEED_OFFSET)
        params = {"text": text_encoder_init(gen, self.bert_cfg, cfg.model.text_embedding_dim),
                  "mlm": mlm_head_init(gen, self.bert_cfg.hidden_size,
                                       self.tokenizer.vocab_size)}
        o = cfg.optimization
        self.epochs = int(extra.get("mlm_epochs", 60))
        self.batch = int(extra.get("mlm_batch", 64))
        self.steps_per_epoch = max(1, self.train_rows[0].shape[0] // self.batch)
        lr = float(extra.get("mlm_lr", 3e-4))
        total = self.epochs * self.steps_per_epoch
        schedule = _warmup_cosine(0.0, lr, min(500, total // 10 + 1), max(total, 2), lr * 0.1)
        # optax.adamw's own defaults; every update goes through (no
        # apply_if_finite: max_consecutive_errors 0)
        adamw = dataclasses.replace(o, optimizer="adamw", beta1=0.9, eps=1e-8,
                                    mu_dtype=None, skip_grad_norm=None)
        self.tx = build_optimizer(adamw, {"mlm": {"lr_schedule": schedule,
                                                  "max_grad_norm": o.max_grad_norm}},
                                  tree.map(lambda _: "mlm", params), max_consecutive_errors=0)
        params = tree.map(lambda t: t.detach().requires_grad_(True), params)
        self.state = TrainState(0, params, self.tx.init(params), torch.Generator(
            device=self.device).manual_seed(cfg.seed + _SEED_OFFSET))

    # -- the loss ------------------------------------------------------------

    def _loss(self, params, ids, attn, generator, draws=None):
        """Mean cross-entropy over the selected positions."""
        masked, labels, sel = apply_bert_masking(
            generator, ids, attn, mask_id=self.tokenizer.ids["[MASK]"],
            vocab_size=self.tokenizer.vocab_size, draws=draws)
        logits = mlm_logits(params["text"], params["mlm"], masked, attn, self.bert_cfg,
                            dtype=self.compute_dtype)
        nll = -torch.log_softmax(logits, dim=-1).gather(-1, labels[..., None])[..., 0]
        w = sel.float()
        return (nll * w).sum() / w.sum().clamp_min(1.0)

    def _grads(self, draws=None):
        """(loss, gradient tree) of one minibatch drawn with replacement
        (``draws['index']`` gives it): every leaf gets a gradient, zero where
        the loss does not reach it (the projection, the final LayerNorm,
        BERT's pooler), as ``jax.grad`` gives."""
        st = self.state
        ids_all, attn_all = self.train_rows
        idx = (torch.as_tensor(draws["index"]).long().to(self.device)
               if draws is not None and "index" in draws else
               torch.randint(0, ids_all.shape[0], (self.batch,), generator=st.rng,
                             device=self.device))
        loss = self._loss(st.params, ids_all[idx], attn_all[idx], st.rng, draws)
        return loss.detach(), tree_grads(loss, st.params, st.params)

    def _step(self, draws=None):
        loss, grads = self._grads(draws)
        stats = self.tx.update(self.state.params, grads, self.state.opt_state)
        self.state.step += 1
        return {"loss": loss, "grad_norm": stats["grad_norm"]}

    @torch.no_grad()
    def val_loss(self, draws=None) -> float:
        """The held-out rows' loss, with masks from a generator seeded the
        same way every time (as the JAX trainer folds one fixed key)."""
        gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed + _VAL_SEED_OFFSET)
        return float(self._loss(self.state.params, *self.val_rows, gen, draws))

    # -- the loop ------------------------------------------------------------

    def train_epoch(self) -> float:
        losses = [self._step()["loss"] for _ in range(self.steps_per_epoch)]
        return float(torch.stack(losses).mean())

    def train(self) -> Path:
        self.log.info("stage 0 (MLM): %d epochs x %d steps, batch %d, corpus %d rows, "
                      "vocab %d on %s", self.epochs, self.steps_per_epoch, self.batch,
                      int(self.train_rows[0].shape[0]), self.tokenizer.vocab_size,
                      self.device)
        best = float("inf")
        t_start = time.time()
        for epoch in range(self.epochs):
            t0 = time.time()
            tr = self.train_epoch()
            val = self.val_loss()
            self.metrics.scalars({"loss": tr, "val": val}, self.state.step, prefix="mlm/")
            if val < best:
                best = val
                self.ckpt.save(_Params(self.state.params), self.state.step, val,
                               extra_meta={"epoch": epoch, "config": self.cfg.to_dict()},
                               periodic=False)
            self.log.info("epoch %d done in %.1fs: mlm %.4f val %.4f (ppl %.1f)", epoch,
                          time.time() - t0, tr, val, float(np.exp(min(val, 20))))
        self.log.info("stage 0: %d epochs in %.1f min (best val %.4f)", self.epochs,
                      (time.time() - t_start) / 60.0, best)
        self.metrics.flush()
        self.ckpt.wait()     # the files this run reports are on disk
        return self.ckpt.best_path


def load_text_init(path, text_template):
    """The ``text`` subtree of an MLM (or any) checkpoint mapped onto a
    stage-1 template; the file must exist and its ``text`` fit, or this
    raises."""
    wait_for_writes()     # this process may still be writing it
    if not Path(path).exists():
        raise FileNotFoundError(f"extra.text_init checkpoint not found: {path}")
    raw = params_subtree(read_checkpoint(path))
    if "text" not in raw:
        raise ValueError(f"{path}: no 'text' parameters (keys {sorted(raw)})")
    return bridge.fit(text_template, bridge.from_jax(raw["text"]), f"{path}:text")
