"""The plain reference of the ``--use-diffusers`` stage-2 step on the SDXL
base UNet, trained in full.

Per step, in float32: the frozen VAE encoder over the batch,
reparameterize (noise drawn from the job's generator), clamp to the latent
limit, ``t`` uniform and the noise (drawn in that order, at the whole
batch's shape), the cosine schedule's ``q_sample``; then, a micro-batch at
a time, the text encoder on the bare description, the SDXL wrapper
(``sdxl_unet.py``) with the constant time ids, and the MSE on the noise
weighted by the micro-batch's share of the batch, its gradients added
into the trained leaves' ``.grad``; AdamW per group (``optim.AdamW``).
Every UNet leaf and the wrapper's projections train (``full``); the text
encoder's leaves by its fine-tune strategy.

Departures from SDXL's own training, as the port runs it: BERT-base in
place of the two CLIP text encoders, the pooled projection of its masked
mean in place of OpenCLIP-bigG's pooled output, 8 latent channels (conv_in
and conv_out tiled and averaged), the constant time ids (S, S, 0, 0, S, S)
of a sprite of size S, and the repo's cosine noise schedule in place of
``scaled_linear`` (``sdxl_unet.py`` lists the model's).  The micro-batches
change only the order of float32 sums.
"""

from __future__ import annotations

import torch

from . import draws, tree
from .bert import bert_config_for
from .optim import AdamW, lr_schedule
from .schedule import make_schedule
from .sdxl_unet import xl_spec, xl_wrapper_apply, xl_wrapper_init
from .serve import as_config
from .text_encoder import finetune_mask, text_encoder_apply, text_encoder_init
from .tokenizer import WordPieceTokenizer
from .unet import text_bias_from_mask
from .vae import reparameterize, vae_encoder_apply, vae_init


def template(raw: dict, vocab_size: int, gen) -> dict:
    """{sd, text, vae}: the trained wrapper, the text encoder and the frozen
    VAE, drawn from ``gen``."""
    m = as_config(raw).model
    return {"sd": xl_wrapper_init(gen, xl_spec(raw["sd_unet"]), m.text_embedding_dim,
                                  latent_dim=m.latent_dim),
            "text": text_encoder_init(gen, bert_config_for(m.bert_model, vocab_size),
                                      m.text_embedding_dim),
            "vae": vae_init(gen, m.latent_dim, m.text_embedding_dim, m.vae_width_scale)}


def trained_paths(raw: dict, params: dict, vocab_size: int) -> dict:
    """{'unet': [path], 'text': [path]}: every leaf of the wrapper, and the
    text encoder's by its fine-tune strategy."""
    m = as_config(raw).model
    if m.freeze_encoder or m.freeze_decoder:
        raise ValueError("the SDXL reference trains the whole UNet (no freeze flags)")
    text = finetune_mask(params["text"], bert_config_for(m.bert_model, vocab_size),
                         m.bert_finetune_strategy)
    return {"unet": [f"sd.{p}" for p, _ in tree.items(params["sd"])],
            "text": [f"text.{p}" for p, on in tree.items(text) if on]}


def time_ids(image_size: int, batch: int, device) -> torch.Tensor:
    s = float(image_size)
    return torch.tensor([s, s, 0.0, 0.0, s, s], device=device).expand(batch, 6)


class Job:
    """The reference's training job over given batches; ``micro_batch``
    rows a forward and backward (None: the whole batch)."""

    def __init__(self, raw: dict, params: dict, vocab_path, device, *, steps_per_epoch: int,
                 micro_batch=None):
        self.raw, self.device = raw, torch.device(device)
        cfg = as_config(raw)
        m, o = cfg.model, cfg.optimization
        self.image_size = cfg.data.image_size
        self.text_len = cfg.data.text_len
        self.micro_batch = micro_batch
        self.tok = WordPieceTokenizer.from_vocab_file(vocab_path)
        self.bert_cfg = bert_config_for(m.bert_model, self.tok.vocab_size)
        self.spec = xl_spec(raw["sd_unet"])
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
        return self.tok.encode_batch(list(descriptions), self.text_len)

    def _noisy(self, batch, gen):
        """(noisy latent, t, noise) of the whole batch."""
        with torch.no_grad():
            mu, logvar = vae_encoder_apply(self.vae["encoder"], batch["image"])
            rep = draws.randn(gen, mu.shape, device=self.device)
            latent = reparameterize(None, mu.float(), logvar.float(), noise=rep)
            latent = latent.clamp(-self.clamp, self.clamp)
            t = draws.randint(gen, 0, self.schedule.num_timesteps, (latent.shape[0],),
                              device=self.device).long()
            noise = draws.randn(gen, latent.shape, device=self.device).float()
            return self.schedule.add_noise(latent, noise, t), t, noise

    def step(self, batch, gen):
        """One step; returns (loss, {path: norm of the gradient the update
        used})."""
        noisy, t, noise = self._noisy(batch, gen)
        b = noisy.shape[0]
        names = ("unet", "text")
        flat = [self.leaves[p] for n in names for p in self.paths[n]]
        ids = time_ids(self.image_size, b, self.device)
        loss = 0.0
        for lo in range(0, b, self.micro_batch or b):
            rows = slice(lo, min(b, lo + (self.micro_batch or b)))
            mask = batch["desc_mask"][rows]
            emb = text_encoder_apply(self.params["text"], batch["desc_ids"][rows], mask,
                                     self.bert_cfg)
            pred = xl_wrapper_apply(self.params["sd"], noisy[rows], t[rows], emb, self.spec,
                                    text_mask=mask, time_ids=ids[rows],
                                    text_bias=text_bias_from_mask(mask))
            part = (pred.float() - noise[rows]).square().mean() * (
                (rows.stop - rows.start) / b)
            torch.autograd.backward(part, inputs=flat)
            loss += float(part.detach())
        # a trained leaf the loss does not reach (BERT's pooler) gets zeros
        grads = [x.grad if x.grad is not None else torch.zeros_like(x) for x in flat]
        for x in flat:
            x.grad = None
        split, i = {}, 0
        for n in names:
            k = len(self.paths[n])
            split[n] = grads[i:i + k]
            i += k
        del grads
        used = self.opt.step(split)
        norms = {}
        for n in names:
            for path, g in zip(self.paths[n], used[n] or ()):
                norms[path] = float(g.float().norm())
        return loss, norms
