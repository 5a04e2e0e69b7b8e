"""What the stage trainers share (``StageTrainer``): the stage-1, 2, 3 and
``--use-diffusers`` trainers of the JAX package each write this out for
themselves; the port writes it once.

A stage provides:

- ``STAGE`` (its directory suffix, checkpoint name and metric prefix),
  ``EPOCHS`` (its epoch count's field of ``cfg.training``), ``LOSS`` (the
  key of the loss it validates and logs) and ``LOG_LINE`` (a step log
  line's values, formatted from the step's record);
- the seed offsets of its generators from ``cfg.seed``:
  ``STATE_SEED_OFFSET`` (the train state's), ``VAL_SEED_OFFSET`` (the
  validation draws', seeded the same for every batch, as the JAX trainers
  fold one fixed key) and ``SAMPLE_SEED_OFFSET`` (the sample grid of epoch
  ``e`` at ``cfg.seed + offset + e``);
- ``_setup`` at the head of its ``__init__``, then its parameters, ``tx``
  (``train/optim.py``) and ``_start(params)``;
- ``_loss(params, batch, generator, draws, *args, weights=None,
  train=True) -> (loss, parts)``: ``parts`` the named scalars a step
  reports, or ``None`` when it reports its loss alone (as ``{'loss': ...}``
  where a dict is wanted).  ``args`` are the stage's step arguments
  (``_epoch_args``: stage 1's KL weight); ``weights`` weight the
  validation batch's padded tail 0; a draw given in ``draws`` replaces the
  generator's, which is how the tests inject the JAX trainer's.  A stage
  whose loss runs on a mesh scales it by ``MeshRun.loss_scale``
  (``_mesh_scaled``);
- ``generate_samples`` (through ``_save_grid``) and ``_banner(epochs)``, the
  classic loop's first log line.

Hooks, the common case by default: ``_epoch_args``, ``_step_extras``,
``_before_epoch``, ``_before_restore``, ``_after_restore``, ``_meta`` and
``_epoch_name``; and the class constants ``MARK_BEST``, ``FINAL_SAVE``,
``RESTORE_BEST`` and ``ema_decay``.

A step, ``_step(batch, *args, draws=None)``, calls ``self._grads`` then
``self._apply_update`` (looked up on the instance, so a caller may wrap
either), under the spans (``utils.profiling``, no-ops off the profiler)::

    psg.train.step
    ├── psg.train.grads       (_grads)
    │   ├── psg.train.forward     (_loss)
    │   └── psg.train.backward    (the backward, in tree_grads)
    └── psg.train.optimizer   (_apply_update, around the optimizer's own spans)
        └── psg.train.ema         (where there is an EMA)
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Dict, Optional

import torch

from psg_tpu_torch.core import tree
from psg_tpu_torch.core.checkpoint import load_metadata, load_params, read_checkpoint
from psg_tpu_torch.core.config import configure_torch
from psg_tpu_torch.core.metrics import Throughput
from psg_tpu_torch.data.dataset import PokemonDataset
from psg_tpu_torch.data.loader import make_loaders
from psg_tpu_torch.models.bert import bert_config_for
from psg_tpu_torch.models.vae import latent_size_for
from psg_tpu_torch.serve.generator import resolve_device
from psg_tpu_torch.train.common import MeshRun, device_batch, get_tokenizer, stage_io
from psg_tpu_torch.train.optim import ema_update, skipped_steps
from psg_tpu_torch.train.state import TrainState
from psg_tpu_torch.utils.images import save_image_grid
from psg_tpu_torch.utils.profiling import span

_SPAN_STEP = "psg.train.step"
_SPAN_GRADS = "psg.train.grads"
_SPAN_FORWARD = "psg.train.forward"
_SPAN_BACKWARD = "psg.train.backward"
_SPAN_OPTIMIZER = "psg.train.optimizer"
_SPAN_EMA = "psg.train.ema"


def tree_grads(loss, params, like, mesh_run: Optional[MeshRun] = None):
    """The gradient of ``loss`` for every leaf of ``params``, zero where the
    loss does not reach a leaf (BERT's pooler), as ``jax.grad`` gives; on a
    mesh this rank's shards averaged over it (``MeshRun.reduce_grads``).
    Returned as a tree shaped like ``like``."""
    paths, leaves = zip(*tree.items(params))
    with span(_SPAN_BACKWARD):
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [g if g is not None else torch.zeros_like(p) for g, p in zip(grads, leaves)]
    if mesh_run is not None:
        grads = mesh_run.reduce_grads(paths, grads)
    it = iter(grads)
    return tree.map(lambda _: next(it), like)


def _named(record) -> Dict:
    """A step's or an evaluation's record as a dict: a bare loss is 'loss'."""
    return record if isinstance(record, dict) else {"loss": record}


class StageTrainer:
    """The stage trainers' base (see the module docstring)."""

    STAGE = EPOCHS = LOSS = LOG_LINE = ""
    STATE_SEED_OFFSET = VAL_SEED_OFFSET = SAMPLE_SEED_OFFSET = 0
    MARK_BEST = False      # the epoch line marks a new best (stage 1's)
    FINAL_SAVE = False     # the classic loop ends with a periodic write (stage 2's, as in JAX)
    RESTORE_BEST = True    # resume the best through CheckpointManager.restore; stage 3
    #                        reads its metadata first, to switch phase before the restore
    ema_decay = 0.0        # > 0: the state tracks an EMA of the parameters
    _to_device = staticmethod(device_batch)

    # -- setup ---------------------------------------------------------------

    def _setup(self, cfg, experiment_name: str, device, mesh) -> None:
        """The head of every stage's ``__init__``: the device, the mesh, the
        stage's directory, checkpoints, log and metrics, the dataset,
        tokenizer and loaders, BERT's config, the compute dtype and the
        latent size."""
        self.device = resolve_device(device)
        self.mesh, self.mesh_run = mesh, None
        if self.device.type == "cuda":
            configure_torch(cfg)
        self.cfg = cfg
        self.stage_dir = Path(cfg.experiment_dir) / f"{experiment_name}_{self.STAGE}"
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
        self.start_epoch, self.best_val = 0, float("inf")

    def _start(self, params) -> None:
        """The train state from the stage's whole ``params`` (after ``tx``):
        on a mesh its ``MeshRun`` first, whose layout (``unet_tp_rules`` at
        ``extra.tp_min_channels``, 640 by default) cuts the state."""
        if self.mesh is not None:
            self.mesh_run = MeshRun(self.mesh, params, tp_min_channels=int(
                (self.cfg.extra or {}).get("tp_min_channels", 640)))
        self.state = self._fresh_state(params, step=0,
                                       rng=self._generator(self.STATE_SEED_OFFSET))

    def _generator(self, offset: int = 0) -> torch.Generator:
        """A generator on the device seeded ``cfg.seed + offset``."""
        return torch.Generator(device=self.device).manual_seed(self.cfg.seed + offset)

    def _fresh_state(self, params, *, step: int, rng: torch.Generator) -> TrainState:
        """A state from whole params, with a fresh optimizer state and, with
        ``ema_decay > 0``, an EMA equal to the params (cut to this rank's
        shards on a mesh with a 'model' axis)."""
        params = tree.map(lambda t: t.detach().requires_grad_(True), params)
        ema = tree.map(lambda t: t.detach().clone(), params) if self.ema_decay > 0 else None
        state = TrainState(step, params, self.tx.init(params), rng, ema)
        return self.mesh_run.place(state) if self.mesh_run is not None else state

    def _batch(self, batch):
        """A loader batch on the device: this rank's rows on a mesh."""
        if self.mesh_run is not None:
            batch = self.mesh_run.local(batch)
        return self._to_device(batch, self.device)

    def _draw(self, draws, name, make):
        """``draws[name]`` on the device where given, else ``make()``."""
        if draws is not None and name in draws:
            return torch.as_tensor(draws[name]).to(self.device)
        return make()

    def _mesh_scaled(self, weights, n: int, loss, parts=None):
        """(loss, parts) scaled on a mesh so that their average over 'data'
        is the global batch's (``MeshRun.loss_scale``); as they are off it."""
        if self.mesh_run is None:
            return loss, parts
        scale = self.mesh_run.loss_scale(weights, n)
        return loss * scale, None if parts is None else {k: v * scale
                                                         for k, v in parts.items()}

    # -- a step ----------------------------------------------------------------

    def _grads(self, batch, *args, draws=None):
        """(record, gradient tree) of one training batch: the record is
        ``_loss``'s parts (or its loss alone), detached; every leaf gets a
        gradient (``tree_grads``).  On a mesh: this rank's rows of the
        global batch and of ``draws``, the step's draws at the global
        shape; the record and the gradients (this rank's shards) averaged
        over the mesh."""
        st, mr = self.state, self.mesh_run
        with span(_SPAN_GRADS):
            gen, params = st.rng, st.params
            if mr is not None:
                gen, draws, params = mr.step_inputs(st, batch["image"].shape[0], draws)
            with span(_SPAN_FORWARD):
                loss, parts = self._loss(params, batch, gen, draws, *args)
            grads = tree_grads(loss, params, st.params, mr)
            return self._record(loss, parts), grads

    def _record(self, loss, parts):
        """The parts, else the loss, detached and averaged over 'data' on a
        mesh."""
        mr = self.mesh_run
        if parts is None:
            loss = loss.detach()
            return loss if mr is None else mr.mean(loss)
        parts = {k: v.detach() for k, v in parts.items()}
        return parts if mr is None else mr.mean_parts(parts)

    def _apply_update(self, record, grads, *args) -> Dict:
        """The optimizer's step, then the EMA from the updated params where
        there is one.  Returns the record with ``grad_norm`` and
        ``_step_extras``."""
        st = self.state
        with span(_SPAN_OPTIMIZER):
            stats = self.tx.update(st.params, grads, st.opt_state, layout=st.layout)
            if self.ema_decay > 0:
                with span(_SPAN_EMA):
                    ema_update(st.ema, st.params, self.ema_decay)
        st.step += 1
        return {**_named(record), "grad_norm": stats["grad_norm"], **self._step_extras(*args)}

    def _step(self, batch, *args, draws=None) -> Dict:
        with span(_SPAN_STEP):
            record, grads = self._grads(batch, *args, draws=draws)
            return self._apply_update(record, grads, *args)

    def _step_extras(self, *args) -> Dict:
        """What a step reports beside its record and ``grad_norm``."""
        return {}

    def _val_generator(self) -> torch.Generator:
        return self._generator(self.VAL_SEED_OFFSET)

    @torch.no_grad()
    def _eval(self, batch, valid: int, *args, draws=None) -> Dict:
        """The record over the first ``valid`` samples of ``batch``: the
        loader pads the last eval batch by wraparound, and the padding is
        weighted 0 in every term, so the mean is exact over real samples.
        On a mesh ``batch`` is this rank's rows and ``valid`` counts the
        global batch's."""
        b = batch["image"].shape[0]
        gen, first, params, mr = self._val_generator(), 0, self.state.params, self.mesh_run
        if mr is not None:
            gen, first, params = mr.eval_inputs(gen, b, params)
            draws = mr.local(draws)
        w = (torch.arange(first, first + b, device=self.device) < valid).float()
        return _named(self._record(*self._loss(params, batch, gen, draws, *args, weights=w,
                                                train=False)))

    # -- the classic loop ------------------------------------------------------

    def _epoch_args(self, epoch: int) -> tuple:
        """The stage's step and evaluation arguments in ``epoch``."""
        return ()

    def train_epoch(self, epoch: int) -> Dict[str, float]:
        args = self._epoch_args(epoch)
        sums: Dict[str, object] = {}
        count = 0
        thr = Throughput()
        for batch in self.train_loader:
            record = self._step(self._batch(batch), *args)
            count += 1
            thr.step()
            if count % self.cfg.training.log_every == 0:
                vals = {k: float(v) for k, v in record.items()}
                self.metrics.scalars(vals, self.state.step, prefix=f"{self.STAGE}_train/")
                self.log.info("epoch %d step %d %s | %.0f b/h", epoch, self.state.step,
                              self.LOG_LINE.format(**vals), thr.batches_per_hour())
            for k, v in record.items():
                # losses stay on the device: float() here would wait for them
                sums[k] = sums.get(k, 0.0) + v
        return {k: float(v) / max(count, 1) for k, v in sums.items()}

    def validate(self, epoch: int) -> float:
        args = self._epoch_args(epoch)
        total, n = 0.0, 0
        for batch in self.val_loader:
            valid = int(batch["valid"])
            total += float(self._eval(self._batch(batch), valid, *args)[self.LOSS]) * valid
            n += valid
        val = total / max(n, 1)
        self.metrics.scalar(f"{self.STAGE}_val/{self.LOSS}", val, self.state.step)
        return val

    def _before_epoch(self, epoch: int) -> None:
        """Runs before each epoch of either loop."""

    def _epoch_name(self, epoch: int) -> str:
        """``epoch`` as the classic loop's epoch line names it."""
        return str(epoch)

    def train(self) -> Path:
        """Every epoch the loader's batches, validation, a checkpoint (a best
        on the ``best_every`` cadence and at the last epoch, a periodic state
        every ``save_every``), and a sample grid every ``sample_every``."""
        tr = self.cfg.training
        epochs = getattr(tr, self.EPOCHS)
        self.log.info(self._banner(epochs))
        for epoch in range(self.start_epoch, epochs):
            self._before_epoch(epoch)
            t0 = time.time()
            self.train_loader.set_epoch(epoch)
            stats = self.train_epoch(epoch)
            val_loss = self.validate(epoch)
            is_best = val_loss < self.best_val
            if is_best:
                self.best_val = val_loss
            self.save_checkpoint(epoch, val_loss)
            if (epoch + 1) % tr.sample_every == 0:
                self.generate_samples(epoch)
            self.log.info("epoch %s done in %.1fs: train %.4f val %.4f%s skipped %d",
                          self._epoch_name(epoch), time.time() - t0,
                          stats.get(self.LOSS, 0.0), val_loss,
                          " (best)" if is_best and self.MARK_BEST else "",
                          self.skipped_batches())
        if self.FINAL_SAVE:
            self._final_save(epochs)
        self.metrics.flush()
        self.ckpt.wait()     # the files this run reports are on disk
        return self.ckpt.best_path

    # -- samples ---------------------------------------------------------------

    def _save_grid(self, epoch: int, descs, name: str, sample) -> Path:
        """The sample grid of ``descs`` at ``samples/name``:
        ``sample(params, generator, ids, mask)`` draws it with the sampling
        params from epoch ``epoch``'s generator.  On a mesh each rank draws
        its rows of the grid; rank 0 writes them all, then a barrier."""
        ids, mask = (torch.from_numpy(a).long().to(self.device)
                     for a in self.tokenizer.encode_batch(descs, self.cfg.data.text_len))
        gen, mr = self._generator(self.SAMPLE_SEED_OFFSET + epoch), self.mesh_run
        if mr is not None:
            gen, (ids, mask) = mr.split_rows(gen, len(descs), ids, mask)
        imgs = sample(MeshRun.whole(mr, self.state.sample_params), gen, ids, mask)
        if mr is not None:
            imgs = mr.gather_rows(imgs, len(descs))
        path = self.stage_dir / "samples" / name
        self._write(lambda: save_image_grid(imgs.float().cpu().numpy(), path, captions=descs))
        return path

    def _write(self, fn):
        """``fn()``; on a mesh on rank 0, then a barrier (``MeshRun.write``)."""
        return fn() if self.mesh_run is None else self.mesh_run.write(fn)

    # -- checkpoints -----------------------------------------------------------

    def skipped_batches(self) -> int:
        """Non-finite rejections plus norm rejections (every group) since the
        optimizer state began."""
        return skipped_steps(self.state.opt_state)

    def _meta(self, epoch: int, classic: bool = False) -> Dict:
        """What a checkpoint of ``epoch`` carries beside its step and metric;
        ``classic``: a checkpoint of the classic loop's ``save_checkpoint``."""
        return {"epoch": epoch, "config": self.cfg.to_dict()}

    def save_checkpoint(self, epoch: int, val_loss: float) -> bool:
        tr = self.cfg.training
        allow_best = ((epoch + 1) % max(tr.best_every, 1) == 0
                      or epoch + 1 == getattr(tr, self.EPOCHS))
        return self.ckpt.save(self.state, self.state.step, val_loss if allow_best else None,
                              extra_meta=self._meta(epoch, classic=True),
                              periodic=(epoch + 1) % tr.save_every == 0)

    def _final_save(self, epochs: int) -> None:
        """A final periodic write whatever the cadence: a run cut into chunks
        must never end without a resume point."""
        if epochs > self.start_epoch:
            self.ckpt.save(self.state, self.state.step, None,
                           extra_meta=self._meta(epochs - 1), periodic=True)

    def _before_restore(self, meta: Dict) -> None:
        """Runs before a restore from a path, with its metadata."""

    def _after_restore(self) -> None:
        """Runs after a restore."""

    def load_checkpoint(self, path: Optional[str] = None):
        """Resume the full state a port checkpoint holds, from ``path`` or
        this stage's best; from a checkpoint without one (a JAX one, a light
        best, another optimizer layout) at ``path``, the params and step with
        a fresh optimizer state."""
        if path is None and self.RESTORE_BEST:
            self.state, meta = self.ckpt.restore(self.state, best=True)
        else:
            self.ckpt.wait()     # every rank: no write of this run is in flight
            path = Path(path) if path is not None else self.ckpt.best_path
            if not path.exists():
                raise FileNotFoundError(f"no checkpoint at {path}")
            meta = load_metadata(path)
            self._before_restore(meta)
            try:
                self.state = self.state.from_checkpoint(read_checkpoint(path))
            except (KeyError, ValueError) as e:
                self.log.warning("full restore failed (%s): params-only restore", e)
                params = load_params(path, MeshRun.whole(self.mesh_run, self.state.params))
                self.state = self._fresh_state(params, step=int(meta.get("step", 0)),
                                               rng=self.state.rng)
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        self.best_val = float(meta.get("metric", float("inf")))
        self._after_restore()
