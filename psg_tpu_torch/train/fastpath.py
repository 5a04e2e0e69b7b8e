"""The device-resident fast training path (port of
``psg_tpu/train/fastpath.py``).

The whole training split lives on the trainer's device (uint8 sprites,
token ids and masks, caption variants and CLIP's BPE ids where the dataset
has them; for a frozen text encoder, stage 2's, its embeddings precomputed
once).  Each step draws its minibatch there, gathers it by index and
augments it there (``data/device_augment.py``), so no data is copied from
the host inside an epoch.  Validation runs over fixed batches padded by
wraparound, with a 0/1 ``weight`` so the mean is exact over real samples.

Epoch semantics differ from the classic loader's: each minibatch is drawn
without replacement within the batch (the top ``batch_size`` of ``n``
uniforms, in their descending order) but independently across steps.

A trainer gains the path by inheriting ``FastPath``; it provides ``cfg``,
``ds``, ``device``, ``state`` (whose ``rng`` is the trainer's generator),
``ckpt``, ``log``, ``metrics``, the two loaders, ``EPOCHS`` (its epoch
count's field of ``cfg.training``), ``_val_generator``, ``_meta``,
``train_epoch_fast``, ``validate_fast``, ``generate_samples`` and
``skipped_batches``.  The order of one fast step's draws
from that generator: the index uniforms, the augmentation parameters, the
caption-variant index (stage 2 with ``extra.caption_augment``), then the
loss's own draws.  Every one of them can be given instead (``draws``:
``uniforms`` [n] or ``idx`` [b], ``augment`` as ``draw_augment_params``
returns it, ``v`` [b], and the loss's keys), which is how the tests inject
the JAX package's.  The span ``psg.train.fast_batch`` covers
``_fast_batch``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from psg_tpu_torch.data.device_augment import (
    augment_batch,
    draw_augment_params,
    normalize_batch,
)
from psg_tpu_torch.utils.profiling import span

_SPAN_FAST_BATCH = "psg.train.fast_batch"
_OPTIONAL = (("clip_ids", "clip_mask"), ("text_ids_aug", "text_mask_aug"))


def _ids(a, device) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).long().to(device)


def device_split(ds, indices, *, device, text_emb_fn: Optional[Callable] = None,
                 chunk: int = 64) -> Dict[str, torch.Tensor]:
    """One split's uint8 images, token ids and masks (and CLIP ids and
    caption variants where ``ds`` has them) on ``device``.
    ``text_emb_fn(ids, mask) -> emb`` precomputes frozen text embeddings in
    chunks of ``chunk`` samples (``text_emb``)."""
    idx = np.asarray(indices)
    out = {"images": torch.from_numpy(np.ascontiguousarray(ds.images[idx])).to(device),
           "text_ids": _ids(ds.text_ids[idx], device),
           "text_mask": _ids(ds.text_mask[idx], device)}
    for ids, mask in _OPTIONAL:
        if getattr(ds, ids, None) is not None:
            out[ids] = _ids(getattr(ds, ids)[idx], device)
            out[mask] = _ids(getattr(ds, mask)[idx], device)
    if text_emb_fn is not None:
        out["text_emb"] = torch.cat([
            text_emb_fn(out["text_ids"][s:s + chunk], out["text_mask"][s:s + chunk])
            for s in range(0, len(idx), chunk)])
    return out


def eval_batches(ds, indices, batch_size: int, *, device) -> Dict[str, torch.Tensor]:
    """Fixed eval batches, [num_batches, batch_size, ...], the last padded
    by wraparound, with ``weight`` [num_batches, batch_size] (0 on the
    padding).  The padding repeats the split cyclically, so a split of
    fewer than half a batch pads too (the JAX package's single wrap raises
    there)."""
    idx = np.asarray(indices)
    n = len(idx)
    nb = (n + batch_size - 1) // batch_size
    padded = np.resize(idx, nb * batch_size)
    weight = np.zeros(nb * batch_size, np.float32)
    weight[:n] = 1.0

    def batched(a):
        return np.ascontiguousarray(a[padded].reshape((nb, batch_size) + a.shape[1:]))

    out = {"images": torch.from_numpy(batched(ds.images)).to(device),
           "text_ids": _ids(batched(ds.text_ids), device),
           "text_mask": _ids(batched(ds.text_mask), device),
           "weight": torch.from_numpy(weight.reshape(nb, batch_size)).to(device)}
    if getattr(ds, "clip_ids", None) is not None:
        out["clip_ids"] = _ids(batched(ds.clip_ids), device)
        out["clip_mask"] = _ids(batched(ds.clip_mask), device)
    return out


def draw_minibatch(generator: Optional[torch.Generator], n: int, batch_size: int, *,
                   device=None, uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Minibatch indices without replacement: the top ``batch_size`` of
    ``n`` uniforms (drawn from ``generator`` unless given), in descending
    order of their uniforms; ``arange(n)`` (drawing nothing) when
    ``batch_size >= n``."""
    if batch_size >= n:
        return torch.arange(n, device=device)
    if uniforms is None:
        uniforms = torch.rand(n, generator=generator, device=device)
    return torch.topk(torch.as_tensor(uniforms, device=device), batch_size).indices


class FastPath:
    """The fast path's data, batches and loops, shared by the stage-1, 2
    and 3 trainers (see the module docstring for what a trainer provides)."""

    caption_augment = 0          # stage 2 sets its caption-variant count

    def _fast_text_emb_fn(self) -> Optional[Callable]:
        """Stage 2 precomputes its frozen text embeddings; stages 1 and 3
        train their text encoder and encode in the step."""
        return None

    def _setup_fast_data(self) -> None:
        """The train split and the eval batches on the device."""
        emb = self._fast_text_emb_fn()
        self._train_data = device_split(self.ds, self.train_loader.indices, device=self.device,
                                        text_emb_fn=None if self.caption_augment else emb)
        ev = eval_batches(self.ds, self.val_loader.indices, self.cfg.data.batch_size,
                          device=self.device)
        if emb is not None:
            nb, bs = ev["text_ids"].shape[:2]
            flat = torch.cat([emb(ids, mask) for ids, mask in zip(ev["text_ids"],
                                                                  ev["text_mask"])])
            ev["text_emb"] = flat.reshape((nb, bs) + flat.shape[1:])
        self._val_data = ev
        self._fast_len = max(len(self.train_loader), 1)

    def _fast_batch(self, draws=None) -> Dict[str, torch.Tensor]:
        """One step's batch, drawn and gathered on the device."""
        d = draws or {}
        with span(_SPAN_FAST_BATCH):
            data, gen = self._train_data, self.state.rng
            n, bs = data["images"].shape[0], self.cfg.data.batch_size
            idx = d.get("idx")
            if idx is None:
                idx = draw_minibatch(gen, n, bs, device=self.device,
                                     uniforms=d.get("uniforms"))
            idx = torch.as_tensor(idx, device=self.device).long()
            images = data["images"][idx]
            if self.cfg.data.augment:
                params = d.get("augment")
                if params is None:
                    params = draw_augment_params(gen, idx.shape[0], device=self.device)
                image = augment_batch(images, params, self.ds.background)
            else:
                image = normalize_batch(images)
            batch = {"image": image}
            if self.caption_augment > 0:
                v = d.get("v")
                if v is None:
                    v = torch.randint(0, self.caption_augment, (idx.shape[0],),
                                      generator=gen, device=self.device)
                v = torch.as_tensor(v, device=self.device).long()
                batch["text_ids"] = data["text_ids_aug"][idx, v]
                batch["text_mask"] = data["text_mask_aug"][idx, v]
            else:
                for k in ("text_ids", "text_mask", "text_emb", "clip_ids", "clip_mask"):
                    if k in data:
                        batch[k] = data[k][idx]
            return batch

    def _fast_epoch(self, step: Callable, draws: Optional[List[Dict]] = None) -> Dict:
        """``step(batch, draws)`` over ``_fast_len`` drawn batches
        (``draws[i]`` for step i when given).  Returns each metric as a list
        over the steps; the metrics a step leaves on the device are stacked
        and read once, after the last step."""
        outs = [step(self._fast_batch(d), d)
                for d in (draws if draws is not None else [None] * self._fast_len)]
        on_device = [k for k, v in outs[0].items() if isinstance(v, torch.Tensor)]
        read = torch.stack([torch.stack([o[k].float() for k in on_device]) for o in outs]
                           ).cpu().T.tolist() if on_device else []
        ys = {k: [float(o[k]) for o in outs] for k in outs[0] if k not in on_device}
        ys.update(zip(on_device, read))
        return ys

    def _fast_validate(self, loss: Callable, draws: Optional[List[Dict]] = None) -> float:
        """The mean of ``loss(batch, generator, draws, weights)`` over the
        eval batches, weighted by their real samples.  One generator
        (``_val_generator``) draws for all of them in turn, so each batch
        has its own draws, as each has its own folded key in the JAX
        package; ``draws[i]`` replaces batch i's."""
        ev = self._val_data
        gen = self._val_generator()
        total = count = torch.zeros((), device=self.device)
        for i in range(ev["images"].shape[0]):
            batch = {k: v[i] for k, v in ev.items() if k not in ("images", "weight")}
            batch["image"] = normalize_batch(ev["images"][i])
            w = ev["weight"][i]
            with torch.no_grad():
                value = loss(batch, gen, draws[i] if draws is not None else None, w)
            total = total + value * w.sum()
            count = count + w.sum()
        return float(total / count.clamp_min(1.0))

    # -- the loop ------------------------------------------------------------

    def _before_fast_epoch(self, epoch: int) -> None:
        """Stage 3 switches to its joint phase here."""

    def save_checkpoint_fast(self, epoch: int, val_loss) -> bool:
        """Best checkpoints light (bf16 sampling params only: all that the
        next stage and serving read) on the ``best_every`` cadence and at
        the last epoch; periodic full states keep their cadence."""
        tr = self.cfg.training
        is_best = False
        if val_loss is not None and ((epoch + 1) % max(tr.best_every, 1) == 0
                                     or epoch + 1 == getattr(tr, self.EPOCHS)):
            is_best = self.ckpt.save_best_light(self.state.sample_params, self.state.step,
                                                val_loss, extra_meta=self._meta(epoch))
        if (epoch + 1) % tr.save_every == 0:
            self.ckpt.save(self.state, self.state.step, None,
                           extra_meta=self._meta(epoch), periodic=True)
        return is_best

    def _final_save(self, epochs: int) -> None:
        """A final periodic write whatever the cadence: a run cut into chunks
        must never end without a resume point."""
        if epochs > self.start_epoch:
            self.ckpt.save(self.state, self.state.step, None,
                           extra_meta=self._meta(epochs - 1), periodic=True)
        self.metrics.flush()

    def _train_fast(self) -> Path:
        """``train()`` on the fast path: validation every ``val_every``
        epochs, a light best on the ``best_every`` cadence, sample grids
        every ``sample_every``, one full state at the end."""
        tr = self.cfg.training
        epochs = getattr(tr, self.EPOCHS)
        self._setup_fast_data()
        self.log.info("%s stage (fast path): %d epochs x %d steps, batch %d on %s", self.STAGE,
                      epochs, self._fast_len, self.cfg.data.batch_size, self.device)
        for epoch in range(self.start_epoch, epochs):
            self._before_fast_epoch(epoch)
            t0 = time.time()
            stats = self.train_epoch_fast(epoch)
            val_loss = None
            if (epoch + 1) % max(tr.val_every, 1) == 0:
                val_loss = self.validate_fast(epoch)
                self.best_val = min(self.best_val, val_loss)
            self.save_checkpoint_fast(epoch, val_loss)
            if (epoch + 1) % tr.sample_every == 0:
                self.generate_samples(epoch)
            dt = time.time() - t0
            self.log.info("epoch %d done in %.1fs (%.1f steps/s): %s val %s skipped %d", epoch,
                          dt, self._fast_len / max(dt, 1e-9),
                          " ".join(f"{k} {v:.4f}" for k, v in stats.items()),
                          "-" if val_loss is None else f"{val_loss:.4f}",
                          self.skipped_batches())
        self._final_save(epochs)
        self.ckpt.wait()     # the files this run reports are on disk
        return self.ckpt.best_path
