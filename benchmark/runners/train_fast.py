"""Stage 2 on the device-resident fast path (``train/fastpath.py``).

The traffic file gives the job (``overrides`` of the configuration's
``data``, ``training`` and ``optimization`` sections), the synthetic sprite
corpus (``sprites``), the traced window (``trace_seconds``) and the limits
of the numbers compared.  Set-up puts the training split on the device (``_setup_fast_data``); the window
runs the body of ``_fast_epoch``, ``trainer._step(trainer._fast_batch())``,
with the losses read once when it has closed.  The reference works out the
split, the minibatch draws and the augmentation again from the raw files
and the job's generator.
"""

from __future__ import annotations

import torch

from benchmark.counters import model as model_flops
from benchmark.runners import training as T
from benchmark.reference import train_fast as ref_fast, tree as tree_
from benchmark.reference.serve import as_config
from benchmark.reference.unet import unet_apply, unet_spec_from_config
from benchmark.reference.vae import latent_size_for, vae_encoder_apply


class Run(T.TrainingRun):
    REF = ref_fast

    def _build_program(self):
        from psg_tpu_torch.core.config import config_from_dict
        from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer

        tr = DiffusionTrainer(config_from_dict(self.raw), None, device=self.device)
        cfg = as_config(self.raw)
        want = unet_spec_from_config(cfg, latent_size_for(cfg.data.image_size))
        if tuple(tr.spec) != tuple(want):
            raise ValueError(f"the program's UNet {tr.spec} is not the configuration's "
                             f"{want}")
        mine = self._bench_weights()
        self._copy_into(tr.state.params, mine, "unet.")
        if tr.state.ema is not None:
            self._copy_into(tr.state.ema, mine, "unet.")
        self._copy_into(tr.frozen["vae"], mine, "vae.")
        self._copy_into(tr.frozen["text"], mine, "text.")
        del mine
        tr._setup_fast_data()
        self.trainer = tr

    def _next_batch(self):
        return None      # the fast step draws its batch on the device

    def _program_step(self, batch):
        tr = self.trainer
        return tr._step(tr._fast_batch(None))["loss"]

    def _trained_leaves(self):
        params = dict(tree_.items(self.trainer.state.params))
        return {p: params[p] for g in self.trainer.state.opt_state["groups"].values()
                for p in g["mu"]}

    def _ema_leaves(self):
        ema = self.trainer.state.ema
        return dict(tree_.items(ema)) if ema is not None else {}

    def _job_spans(self, spans):
        tr = self.trainer
        spans.wrap(tr, "_grads", "grads")
        spans.wrap(tr, "_apply_update", "optimizer")
        spans.wrap(tr, "_fast_batch", "fast_batch")

    def _reference_steps(self, job) -> T.Readings:
        before = {p: t.detach().clone() for p, t in job.leaves.items()}
        gen = torch.Generator(device=self.device).manual_seed(int(self.raw["seed"]))
        out = T.Readings()
        for k in range(T.CHECKED_STEPS):
            loss, norms = job.step(gen)
            out.losses.append(loss)
            if k == 0:
                out.grad_norms = norms
        out.change_norms = {p: float((job.leaves[p].detach() - before[p]).norm())
                            for p in before}
        if job.ema_decay > 0:
            out.change_norms.update({f"ema.{p}": float((job.ema[p] - before[p]).norm())
                                     for p in before})
        return out

    def _flops(self) -> float:
        """One step's operations in the reference on the meta device: the
        frozen VAE encoder forward, the UNet forward, and its backward to
        every (trained) leaf; the text embeddings are made once at set-up."""
        meta = torch.device("meta")
        cfg = as_config(self.raw)
        m, d = cfg.model, cfg.data
        b, s = self.batch_size, d.text_len
        p = self.template
        lat = latent_size_for(d.image_size)
        spec = unet_spec_from_config(cfg, lat)
        leaves = [t.detach().requires_grad_(True) for _, t in tree_.items(p["unet"])]
        it = iter(leaves)
        unet = tree_.map(lambda _: next(it), p["unet"])

        def step():
            with torch.no_grad():
                vae_encoder_apply(p["vae"]["encoder"], torch.empty(
                    (b, d.image_size, d.image_size, 3), device=meta))
            pred = unet_apply(unet, torch.empty((b, lat, lat, m.latent_dim), device=meta),
                              torch.zeros((b,), dtype=torch.long, device=meta),
                              torch.empty((b, s, m.text_embedding_dim), device=meta), spec,
                              text_mask=torch.ones((b, s), dtype=torch.long, device=meta))
            torch.autograd.grad(pred.float().square().mean(), leaves)

        return model_flops.flops(step)
