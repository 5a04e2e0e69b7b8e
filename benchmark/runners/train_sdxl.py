"""``--use-diffusers`` stage 2 on the SDXL base UNet, trained in full, on the
classic loader path.

The job is ``train_sd``'s (the traffic file's ``overrides``, ``sprites``,
``trace_seconds`` and ``limits``; the window runs
``trainer._step(trainer._batch(b))`` over the trainer's own loader across
epoch boundaries; the loader's checked batches are compared by themselves),
with the SDXL reference (``reference/train_sdxl.py``) in place of SD-1.5's.
Besides:

- the program's UNet spec (``sd_spec_from_config``) is compared with the
  configuration's before anything is built: a program that would build
  another UNet stops within seconds;
- the leaves before the checked steps are kept in host memory: the card
  holds the 2.57B-parameter UNet's weights, gradients and two moments;
- the reference runs the checked steps ``reference_micro_batch`` rows at a
  time (the traffic file's; the whole batch without it), so that its
  float32 state and activations fit on one card;
- the traced window adds ranges ``bench.sdunet`` around the trainer's
  ``sd_wrapper_apply`` and ``bench.sdunet.transformer`` around each
  Transformer2D apply (forward only: the backward runs after them).
"""

from __future__ import annotations

import contextlib

import torch

from benchmark.counters import model as model_flops
from benchmark.harness import weights
from benchmark.reference import precision, train_sdxl as ref_xl, tree as tree_
from benchmark.reference.sdxl_unet import xl_spec, xl_wrapper_apply
from benchmark.reference.vae import latent_size_for
from benchmark.runners import train_sd
from benchmark.runners import training as T


def layout(spec):
    """A UNet spec as the numbers both sides must agree on; None for a spec
    without SDXL's per-level layout."""
    try:
        n = len(spec.channels)
        return (spec.in_channels, spec.out_channels, tuple(spec.channels),
                spec.layers_per_block, spec.cross_attention_dim, spec.norm_groups,
                tuple((bool(spec.has_attention(i)), spec.depth(i), spec.heads(i))
                      for i in range(n)),
                bool(spec.linear_projection), spec.addition_time_embed_dim,
                spec.text_embeds_dim)
    except AttributeError:
        return None


class Run(train_sd.Run):
    REF = ref_xl

    def __init__(self, root, cell, seed: int, device, **kw):
        from psg_tpu_torch.core.config import config_from_dict
        from psg_tpu_torch.train.stage2_sd import sd_spec_from_config

        raw = cell.config["config"]
        program = sd_spec_from_config(config_from_dict(raw))
        if layout(program) != layout(xl_spec(raw["sd_unet"])):
            raise ValueError(f"the program's SD UNet {program} is not the configuration's "
                             f"{xl_spec(raw['sd_unet'])}")
        super().__init__(root, cell, seed, device, **kw)

    def _build_program(self):
        from psg_tpu_torch.core.config import config_from_dict
        from psg_tpu_torch.train.stage2_sd import SDDiffusionTrainer

        tr = SDDiffusionTrainer(config_from_dict(self.raw), None, device=self.device)
        mine = self._bench_weights()
        self._copy_into(tr.state.params, mine, "")
        self._copy_into(tr.frozen_vae, mine, "vae.")
        del mine
        self.trainer = tr
        self._epoch, self._it = 0, None

    def _first_steps(self):
        """``TrainingRun._first_steps`` with the leaves before the checked
        steps in host memory."""
        if self.program != "port":
            return super()._first_steps()
        before = {p: t.detach().to("cpu", torch.float32, copy=True)
                  for p, t in self._trained_leaves().items()}
        losses = []
        b2 = self.trainer.tx.b2
        for k in range(T.CHECKED_STEPS):
            batch = self._next_batch()
            self.batches.append(batch)
            losses.append(self._program_step(batch))
            if k == 0:
                for g in self.trainer.state.opt_state["groups"].values():
                    for path, nu in g["nu"].items():
                        self.prog.grad_norms[path] = float(
                            (nu.float().sum() / (1.0 - b2)).sqrt())
        self.prog.change_norms = {
            p: float((t.detach().float() - before[p].to(t.device)).norm())
            for p, t in self._trained_leaves().items()}
        self.prog.losses = [float(x) for x in losses]

    def _reference_readings(self, lowered: bool):
        """``TrainingRun._reference_readings`` a micro-batch at a time; the
        job (its float32 state, about 43 GB) is let go on return, before a
        control's second reading builds another (``_extra_checks`` reads
        the batches only)."""
        params = weights.separate(weights.fill(self.template, self.weight_seed, self.device))
        ctx = precision.lowered(precision.fp8) if lowered else contextlib.nullcontext()
        with precision.float32(), ctx:
            job = self.REF.Job(self.raw, params, self.vocab, self.device,
                               steps_per_epoch=self.steps_per_epoch,
                               micro_batch=self.job.get("reference_micro_batch"))
            del params
            out = self._reference_steps(job)
        return out, None

    def _job_spans(self, spans):
        from psg_tpu_torch.models import sd_unet
        from psg_tpu_torch.train import stage2_sd

        super()._job_spans(spans)
        spans.wrap(stage2_sd, "sd_wrapper_apply", "sdunet")
        spans.wrap(sd_unet, "_transformer_apply", "sdunet.transformer")

    def _flops(self) -> float:
        """One step's operations in the reference on the meta device: the
        forward, input gradients where a trained leaf lies upstream, and
        the trained leaves' weight gradients."""
        meta = torch.device("meta")
        m, d = self.raw["model"], self.raw["data"]
        b, s = self.batch_size, d["text_len"]
        p = self.template
        sub = {"sd": p["sd"], "text": p["text"]}
        paths = ref_xl.trained_paths(self.raw, sub, self.vocab_size)
        trained = set(paths["unet"] + paths["text"])
        leaves = {path: (t.detach().requires_grad_(True) if path in trained else t)
                  for path, t in tree_.items(sub)}
        it = iter(leaves.values())
        params = tree_.map(lambda _: next(it), sub)
        bert = ref_xl.bert_config_for(m["bert_model"], self.vocab_size)
        spec = xl_spec(self.raw["sd_unet"])
        lat = latent_size_for(d["image_size"])

        def step():
            ids = torch.zeros((b, s), dtype=torch.long, device=meta)
            emb = ref_xl.text_encoder_apply(params["text"], ids, ids, bert)
            with torch.no_grad():
                ref_xl.vae_encoder_apply(p["vae"]["encoder"], torch.empty(
                    (b, d["image_size"], d["image_size"], 3), device=meta))
            pred = xl_wrapper_apply(
                params["sd"], torch.empty((b, lat, lat, m["latent_dim"]), device=meta),
                torch.zeros((b,), dtype=torch.long, device=meta), emb, spec,
                text_mask=ids, time_ids=ref_xl.time_ids(d["image_size"], b, meta),
                text_bias=torch.zeros((b, 1, 1, s), device=meta))
            torch.autograd.grad(pred.float().square().mean(),
                                [leaves[q] for q in sorted(trained)], allow_unused=True)

        return model_flops.flops(step)
