"""The plain reference of the stage-2 fast-path step (``train/fastpath.py``).

The training split is worked out again from the raw files: the caption CSV
and the sprite PNGs (composited onto the background and resized as the
dataset reader does), the seeded split, the WordPiece ids of the full
descriptions, and the frozen text encoder's embeddings in float32.  Per step
and in the fast step's order of draws from the job's generator: the
minibatch (the top ``batch`` of ``n`` uniforms), the augmentation
parameters, then the loss's draws (reparameterize noise, ``t``, the noise,
the UNet's attention-dropout masks); the smooth-L1 noise loss; gradients of
the UNet; AdamW (``optim.AdamW``, eps 1e-6) and then the EMA.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
from PIL import Image

from . import draws, tree
from .bert import bert_config_for
from .device_augment import augment_batch, draw_augment_params
from .optim import AdamW, lr_schedule
from .schedule import make_schedule
from .serve import as_config, read_captions
from .text_encoder import text_encoder_apply, text_encoder_init
from .tokenizer import WordPieceTokenizer
from .unet import unet_apply, unet_init, unet_spec_from_config
from .vae import latent_size_for, reparameterize, vae_encoder_apply, vae_init

BACKGROUND = (255, 255, 255)


def template(raw: dict, vocab_size: int, gen) -> dict:
    """{unet, text, vae}: the trained UNet and the frozen text encoder and
    VAE, drawn from ``gen``."""
    cfg = as_config(raw)
    m = cfg.model
    return {"unet": unet_init(gen, unet_spec_from_config(cfg, latent_size_for(
                cfg.data.image_size))),
            "text": text_encoder_init(gen, bert_config_for(m.bert_model, vocab_size),
                                      m.text_embedding_dim),
            "vae": vae_init(gen, m.latent_dim, m.text_embedding_dim, m.vae_width_scale)}


def load_sprite(path, size: int) -> np.ndarray:
    """PNG -> uint8 [size, size, 3], alpha-composited onto white, bilinear."""
    img = Image.open(path)
    if img.mode in ("RGBA", "LA") or (img.mode == "P" and "transparency" in img.info):
        bg = Image.new("RGB", img.size, BACKGROUND)
        if img.mode == "P":
            img = img.convert("RGBA")
        bg.paste(img, mask=img.split()[-1])
        img = bg
    else:
        img = img.convert("RGB")
    if img.size != (size, size):
        img = img.resize((size, size), Image.Resampling.BILINEAR)
    return np.asarray(img, np.uint8)


def train_split(raw: dict, n: int) -> np.ndarray:
    d = as_config(raw).data
    perm = np.random.RandomState(d.seed).permutation(n)
    return perm[:n - int(n * d.val_split) - int(n * d.test_split)]


def smooth_l1(pred, target, beta: float = 0.1):
    d = (pred.float() - target.float()).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta).mean()


class Job:
    def __init__(self, raw: dict, params: dict, vocab_path, device, *, steps_per_epoch: int):
        self.raw, self.device = raw, torch.device(device)
        cfg = as_config(raw)
        m, o, d = cfg.model, cfg.optimization, cfg.data
        self.batch = int(d.batch_size)
        tok = WordPieceTokenizer.from_vocab_file(vocab_path)
        bert = bert_config_for(m.bert_model, tok.vocab_size)
        self.spec = unet_spec_from_config(cfg, latent_size_for(d.image_size))
        self.schedule = make_schedule(m.num_timesteps, m.beta_start, m.beta_end,
                                      m.beta_schedule)
        self.clamp = m.latent_clamp
        self.vae = params["vae"]
        self.unet = params["unet"]
        captions = read_captions(d.csv_path, 10 ** 9)
        idx = train_split(raw, len(captions))
        images = np.stack([load_sprite(Path(d.image_dir) / f"{i + 1:03d}.png", d.image_size)
                           for i in idx])
        self.images = torch.from_numpy(images).to(self.device)
        ids, mask = tok.encode_batch([captions[i] for i in idx], d.text_len)
        self.mask = torch.from_numpy(mask).long().to(self.device)
        ids = torch.from_numpy(ids).long().to(self.device)
        with torch.no_grad():
            self.emb = torch.cat([text_encoder_apply(params["text"], ids[s:s + 64],
                                                     self.mask[s:s + 64], bert).float()
                                  for s in range(0, ids.shape[0], 64)])
        self.leaves = dict(tree.items(self.unet))
        for leaf in self.leaves.values():
            leaf.requires_grad_(True)
        self.ema = {p: t.detach().clone() for p, t in self.leaves.items()}
        self.ema_decay = float(o.ema_decay)
        total = cfg.training.diffusion_epochs * max(steps_per_epoch, 1)
        self.opt = AdamW({"unet": {
            "params": list(self.leaves.values()),
            "lr": lr_schedule(o.scheduler, o.learning_rate, total_steps=total,
                              warmup_steps=o.warmup_steps, end_factor=o.lr_end_factor),
            "max_norm": o.max_grad_norm, "skip": getattr(o, "skip_grad_norm", None)}},
            b1=o.beta1, b2=o.beta2, eps=1e-6, weight_decay=o.weight_decay)

    def loss(self, gen):
        n = self.images.shape[0]
        u = torch.rand(n, generator=gen, device=self.device)
        idx = torch.topk(u, self.batch).indices
        aug = draw_augment_params(gen, self.batch, device=self.device)
        image = augment_batch(self.images[idx], aug, BACKGROUND)
        emb, mask = self.emb[idx], self.mask[idx]
        with torch.no_grad():
            mu, logvar = vae_encoder_apply(self.vae["encoder"], image)
            rep = draws.randn(gen, mu.shape, device=self.device)
            latent = reparameterize(None, mu.float(), logvar.float(), noise=rep)
            latent = latent.clamp(-self.clamp, self.clamp)
            t = draws.randint(gen, 0, self.schedule.num_timesteps, (latent.shape[0],),
                              device=self.device).long()
            noise = draws.randn(gen, latent.shape, device=self.device).float()
            noisy = self.schedule.add_noise(latent, noise, t)
        dropout = gen if self.spec.attn_dropout > 0 else None
        pred = unet_apply(self.unet, noisy, t, emb, self.spec, text_mask=mask,
                          dropout=dropout)
        return smooth_l1(pred, noise)

    def step(self, gen):
        """One step; returns (loss, {path: norm of the gradient the update
        used})."""
        loss = self.loss(gen)
        paths = list(self.leaves)
        grads = torch.autograd.grad(loss, [self.leaves[p] for p in paths])
        used = self.opt.step({"unet": list(grads)})["unet"]
        with torch.no_grad():
            for p in paths:
                self.ema[p].mul_(self.ema_decay).add_(self.leaves[p].detach(),
                                                      alpha=1.0 - self.ema_decay)
        norms = {p: float(g.float().norm()) for p, g in zip(paths, used or ())}
        return float(loss.detach()), norms
