"""``--use-diffusers`` stage 2 on the classic loader path.

The traffic file gives the job (``overrides`` of the configuration's
``data``, ``training`` and ``optimization`` sections: the batch among them),
the synthetic sprite corpus (``sprites``), the traced window
(``trace_seconds``) and the limits of the
numbers compared.  The window runs the body of ``train_epoch``,
``trainer._step(trainer._batch(b))``, over the trainer's own loader across
epoch boundaries; no validation, sampling or checkpoint runs in it.

The reference works the checked steps' batches out again from the raw
files: the rows that the loader's seeded split and shuffle put in each
batch, the reference tokenizer's description ids, and the images as the
loader's engine augments them (``reference/host_augment.py``, from the
loader's seeded draws).  Besides the steps' numbers, the loader's batches
are compared with these by themselves: ``loader_rows`` counts rows and ids
that differ, ``loader_image_gap`` is the mean absolute gap of the images,
in steps of one 8-bit level.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from benchmark.counters import model as model_flops
from benchmark.runners import training as T
from benchmark.reference import host_augment, train_sd as ref_sd, tree as tree_
from benchmark.reference.train_fast import BACKGROUND, load_sprite
from benchmark.reference.vae import latent_size_for


class Run(T.TrainingRun):
    REF = ref_sd

    def _build_program(self):
        from psg_tpu_torch.core.config import config_from_dict
        from psg_tpu_torch.train.stage2_sd import SDDiffusionTrainer

        tr = SDDiffusionTrainer(config_from_dict(self.raw), None, device=self.device)
        if tuple(tr.spec) != tuple(ref_sd.sd_spec(self.raw)):
            raise ValueError(f"the program's SD UNet {tr.spec} is not the "
                             f"configuration's {ref_sd.sd_spec(self.raw)}")
        mine = self._bench_weights()
        self._copy_into(tr.state.params, mine, "")
        self._copy_into(tr.frozen_vae, mine, "vae.")
        del mine
        self.trainer = tr
        self._epoch, self._it = 0, None

    def _next_batch(self):
        tr = self.trainer
        while True:
            if self._it is None:
                tr.train_loader.set_epoch(self._epoch)
                self._it = iter(tr.train_loader)
            b = next(self._it, None)
            if b is not None:
                return b
            self._it, self._epoch = None, self._epoch + 1

    def _program_step(self, batch):
        tr = self.trainer
        return tr._step(tr._batch(batch))["loss"]

    def _trained_leaves(self):
        params = dict(tree_.items(self.trainer.state.params))
        return {p: params[p] for g in self.trainer.state.opt_state["groups"].values()
                for p in g["mu"]}

    def _job_spans(self, spans):
        tr = self.trainer
        spans.wrap(tr, "_grads", "grads")
        spans.wrap(tr, "_apply_update", "optimizer")

    def _reference_batches(self, job) -> list:
        """The checked steps' batches from the raw files and the loader's
        seeds: [(rows, images [B, H, W, 3] in [-1, 1], ids, mask)]."""
        d = self.raw["data"]
        n = int(self.job["sprites"])
        perm = np.random.RandomState(d["seed"]).permutation(n)
        train = perm[:n - int(n * d["val_split"]) - int(n * d["test_split"])]
        order = train[np.random.RandomState(d["seed"] + 0).permutation(len(train))]
        descs = [line.partition(";")[2].strip().strip('"') for line in
                 Path(d["csv_path"]).read_text().splitlines() if line.strip()]
        seeds = host_augment.batch_seeds(d["seed"], 0, len(train) // self.batch_size)
        out = []
        for k in range(len(self.batches)):
            rows = order[k * self.batch_size:(k + 1) * self.batch_size]
            sprites = np.stack([load_sprite(Path(d["image_dir"]) / f"{i + 1:03d}.png",
                                            d["image_size"]) for i in rows])
            images = host_augment.augment_batch(sprites, seeds[k], BACKGROUND)
            out.append((rows, images, *job.desc_ids([descs[i] for i in rows])))
        return out

    def _reference_steps(self, job) -> T.Readings:
        before = {p: job.leaves[p].detach().clone() for g in job.paths.values() for p in g}
        gen = torch.Generator(device=self.device).manual_seed(int(self.raw["seed"]))
        out = T.Readings()
        self._ref_batches = self._reference_batches(job)
        for k, (_, images, ids, mask) in enumerate(self._ref_batches):
            batch = {"image": torch.from_numpy(images).to(self.device),
                     "desc_ids": torch.as_tensor(ids).long().to(self.device),
                     "desc_mask": torch.as_tensor(mask).long().to(self.device)}
            loss, norms = job.step(batch, gen)
            out.losses.append(loss)
            if k == 0:
                out.grad_norms = norms
        out.change_norms = {p: float((job.leaves[p].detach() - before[p]).norm())
                            for p in before}
        return out

    def _extra_checks(self, job) -> dict:
        """The loader's checked batches against the reference's: rows whose
        sprite or description ids are not the reference's (``loader_rows``),
        and the mean absolute gap of the images in 8-bit levels
        (``loader_image_gap``)."""
        bad, gap, count = 0, 0.0, 0
        for b, (rows, images, ids, mask) in zip(self.batches, self._ref_batches):
            bad += int((np.asarray(b["national_number"]) != rows + 1).sum())
            bad += int((np.asarray(b["desc_ids"]) != ids).any(axis=1).sum())
            bad += int((np.asarray(b["desc_mask"]) != mask).any(axis=1).sum())
            got = np.asarray(b["image"], np.float64)
            gap += float(np.abs(got - images).sum()) * 127.5
            count += got.size
        limits = self.job["limits"]
        return {"loader_rows": {"value": float(bad), "limit": float(limits["loader_rows"])},
                "loader_image_gap": {"value": gap / max(count, 1),
                                     "limit": float(limits["loader_image_gap"])}}

    def _flops(self) -> float:
        """One step's operations in the reference on the meta device: the
        forward, input gradients where a trained leaf lies upstream, and
        the trained leaves' weight gradients."""
        meta = torch.device("meta")
        m, d = self.raw["model"], self.raw["data"]
        b, s = self.batch_size, d["text_len"]
        p = self.template
        sub = {"sd": p["sd"], "text": p["text"]}
        paths = ref_sd.trained_paths(self.raw, sub, self.vocab_size)
        trained = set(paths["unet"] + paths["text"])
        leaves = {path: (t.detach().requires_grad_(True) if path in trained else t)
                  for path, t in tree_.items(sub)}
        it = iter(leaves.values())
        params = tree_.map(lambda _: next(it), sub)
        bert = ref_sd.bert_config_for(m["bert_model"], self.vocab_size)
        spec = ref_sd.sd_spec(self.raw)
        lat = latent_size_for(d["image_size"])

        def step():
            ids = torch.zeros((b, s), dtype=torch.long, device=meta)
            emb = ref_sd.text_encoder_apply(params["text"], ids, ids, bert)
            with torch.no_grad():
                ref_sd.vae_encoder_apply(p["vae"]["encoder"], torch.empty(
                    (b, d["image_size"], d["image_size"], 3), device=meta))
            pred = ref_sd.sd_wrapper_apply(
                params["sd"], torch.empty((b, lat, lat, m["latent_dim"]), device=meta),
                torch.zeros((b,), dtype=torch.long, device=meta), emb, spec,
                text_bias=torch.zeros((b, 1, 1, s), device=meta))
            torch.autograd.grad(pred.float().square().mean(),
                                [leaves[q] for q in sorted(trained)], allow_unused=True)

        return model_flops.flops(step)
