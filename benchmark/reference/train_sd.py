"""The plain reference of the ``--use-diffusers`` stage-2 step.

Per step, in float32: the text encoder on the bare description, the frozen
VAE encoder, reparameterize (noise drawn from the job's generator), clamp to
the latent limit, ``t`` uniform and the noise (drawn in that order), the
cosine schedule's ``q_sample``, the SD UNet wrapper, MSE on the noise;
gradients of the trained leaves only; AdamW per group (``optim.AdamW``).
"""

from __future__ import annotations

import torch

from . import draws, tree
from .bert import bert_config_for
from .optim import AdamW, lr_schedule
from .schedule import make_schedule
from .sd_unet import SDUNetSpec, sd_training_mask, sd_wrapper_apply, sd_wrapper_init
from .serve import as_config
from .text_encoder import finetune_mask, text_encoder_apply, text_encoder_init
from .tokenizer import WordPieceTokenizer
from .unet import text_bias_from_mask
from .vae import reparameterize, vae_encoder_apply, vae_init


def sd_spec(raw: dict) -> SDUNetSpec:
    """The SD UNet's shape from the configuration's ``sd_unet`` section."""
    u = raw["sd_unet"]
    return SDUNetSpec(in_channels=u["in_channels"], out_channels=u["out_channels"],
                      channels=tuple(u["block_out_channels"]),
                      layers_per_block=u["layers_per_block"],
                      num_heads=u["attention_head_dim"],
                      cross_attention_dim=u["cross_attention_dim"],
                      norm_groups=u["norm_num_groups"])


def template(raw: dict, vocab_size: int, gen) -> dict:
    """{sd, text, vae}: the trained wrapper, the text encoder and the frozen
    VAE, drawn from ``gen``."""
    m = as_config(raw).model
    return {"sd": sd_wrapper_init(gen, sd_spec(raw), m.text_embedding_dim,
                                  latent_dim=m.latent_dim),
            "text": text_encoder_init(gen, bert_config_for(m.bert_model, vocab_size),
                                      m.text_embedding_dim),
            "vae": vae_init(gen, m.latent_dim, m.text_embedding_dim, m.vae_width_scale)}


def trained_paths(raw: dict, params: dict, vocab_size: int) -> dict:
    """{'unet': [path], 'text': [path]}: the leaves each group trains."""
    m = as_config(raw).model
    mode = ("cross_attention_only" if m.freeze_encoder and m.freeze_decoder
            else "decoder_only" if m.freeze_encoder else "full")
    masks = {"unet": dict(tree.items(sd_training_mask(params["sd"], mode))),
             "text": dict(tree.items(finetune_mask(
                 params["text"], bert_config_for(m.bert_model, vocab_size),
                 m.bert_finetune_strategy)))}
    return {"unet": [f"sd.{p}" for p, on in masks["unet"].items() if on],
            "text": [f"text.{p}" for p, on in masks["text"].items() if on]}


class Job:
    """The reference's training job over given batches."""

    def __init__(self, raw: dict, params: dict, vocab_path, device, *, steps_per_epoch: int):
        self.raw, self.device = raw, torch.device(device)
        cfg = as_config(raw)
        m, o = cfg.model, cfg.optimization
        self.tok = WordPieceTokenizer.from_vocab_file(vocab_path)
        self.bert_cfg = bert_config_for(m.bert_model, self.tok.vocab_size)
        self.spec = sd_spec(raw)
        self.schedule = make_schedule(m.num_timesteps, m.beta_start, m.beta_end, "cosine")
        self.clamp = m.latent_clamp
        self.vae = params["vae"]
        self.params = {"sd": params["sd"], "text": params["text"]}
        leaves = dict(tree.items(self.params))
        self.paths = trained_paths(raw, self.params, self.tok.vocab_size)
        for path in self.paths["unet"] + self.paths["text"]:
            leaves[path].requires_grad_(True)
        total = cfg.training.diffusion_epochs * max(steps_per_epoch, 1)

        def sched(lr):
            return lr_schedule(o.scheduler, lr, total_steps=total,
                               warmup_steps=o.warmup_steps, end_factor=o.lr_end_factor)

        text_lr = o.text_encoder_lr or o.learning_rate * 0.1
        self.opt = AdamW(
            {"unet": {"params": [leaves[p] for p in self.paths["unet"]],
                      "lr": sched(o.learning_rate), "max_norm": o.max_grad_norm,
                      "skip": getattr(o, "skip_grad_norm", None)},
             "text": {"params": [leaves[p] for p in self.paths["text"]],
                      "lr": sched(text_lr), "max_norm": o.max_grad_norm * 0.5,
                      "skip": getattr(o, "skip_grad_norm", None)}},
            b1=o.beta1, b2=o.beta2, eps=o.eps, weight_decay=o.weight_decay)
        self.leaves = leaves

    def desc_ids(self, descriptions):
        ids, mask = self.tok.encode_batch(list(descriptions), as_config(self.raw).data.text_len)
        return ids, mask

    def loss(self, batch, gen):
        emb = text_encoder_apply(self.params["text"], batch["desc_ids"], batch["desc_mask"],
                                 self.bert_cfg)
        with torch.no_grad():
            mu, logvar = vae_encoder_apply(self.vae["encoder"], batch["image"])
            rep = draws.randn(gen, mu.shape, device=self.device)
            latent = reparameterize(None, mu.float(), logvar.float(), noise=rep)
            latent = latent.clamp(-self.clamp, self.clamp)
            t = draws.randint(gen, 0, self.schedule.num_timesteps, (latent.shape[0],),
                              device=self.device).long()
            noise = draws.randn(gen, latent.shape, device=self.device).float()
            noisy = self.schedule.add_noise(latent, noise, t)
        pred = sd_wrapper_apply(self.params["sd"], noisy, t, emb, self.spec,
                                text_bias=text_bias_from_mask(batch["desc_mask"]))
        return (pred.float() - noise).square().mean()

    def step(self, batch, gen):
        """One step; returns (loss, {path: norm of the gradient the update
        used})."""
        loss = self.loss(batch, gen)
        names = ("unet", "text")
        flat = [self.leaves[p] for n in names for p in self.paths[n]]
        # a trained leaf the loss does not reach (BERT's pooler) gets zeros
        grads = [g if g is not None else torch.zeros_like(x) for g, x in
                 zip(torch.autograd.grad(loss, flat, allow_unused=True), flat)]
        split, i = {}, 0
        for n in names:
            k = len(self.paths[n])
            split[n] = list(grads[i:i + k])
            i += k
        used = self.opt.step(split)
        norms = {}
        for n in names:
            for path, g in zip(self.paths[n], used[n] or ()):
                norms[path] = float(g.float().norm())
        return float(loss.detach()), norms
