"""Batching and host prefetch (port of ``psg_tpu/data/loader.py``).

A thread pool augments uint8 sprites on the host while the previous batch
trains; batches are fixed-shape numpy arrays (images normalized to [-1, 1],
text pre-tokenized), and a small prefetch queue overlaps host work with
device steps.  The caller moves batches to the device.  Every seed and draw
is the JAX loader's, so both packages make bit-equal batches from one
dataset: the train shuffle is ``RandomState(seed + epoch).permutation`` with
drop_last; eval keeps the tail, padded by wraparound, with ``valid``;
augmentation and caption variants draw from ``default_rng(seed*1000 +
epoch)``, one ``spawn``ed child a batch on the threaded path, caption
variants before the image draws.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, Optional

import numpy as np

from psg_tpu_torch.data.augment import augment_sprite
from psg_tpu_torch.data.dataset import PokemonDataset, split_indices


class Loader:
    """Iterable over epochs of batches.

    Train mode: seeded shuffle per epoch + drop_last + augmentation
    (matching the reference train loader, dataset_improved.py:287-294).
    Eval mode: sequential, keeps the tail batch by padding with wraparound
    samples and reporting ``valid`` counts.
    """

    def __init__(self, ds: PokemonDataset, indices: np.ndarray,
                 batch_size: int, *, train: bool, seed: int = 42,
                 augment: bool = True, num_workers: int = 4,
                 prefetch: int = 2, process_index: int = 0,
                 process_count: int = 1):
        self.ds = ds
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.train = train
        self.seed = seed
        self.augment = augment and train
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self._epoch = 0
        # Several processes: ``batch_size`` is the GLOBAL batch; every
        # process runs the same seeded shuffle plan and yields only its
        # contiguous row slice of each global batch.  Augmentation RNG
        # streams are derived per (global batch, process), so draws are
        # deterministic and uncorrelated across processes.
        if batch_size % max(1, process_count):
            raise ValueError(
                f"global batch {batch_size} not divisible by "
                f"process_count={process_count}")
        self.process_index = int(process_index)
        self.process_count = max(1, int(process_count))

    def __len__(self) -> int:
        n = len(self.indices)
        if self.train:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    # -- batch assembly ----------------------------------------------------

    def _make_batch(self, idxs: np.ndarray, valid: int,
                    rng: Optional[np.random.Generator]) -> Dict[str, np.ndarray]:
        # caption variants (ds.set_caption_variants) are drawn HERE, per
        # sample, seeded — before the image-augment draws so the choice is
        # identical whichever image engine (native/python/none) runs
        cap_v = None
        if (self.train and rng is not None
                and getattr(self.ds, "text_ids_aug", None) is not None):
            cap_v = rng.integers(0, self.ds.text_ids_aug.shape[1], len(idxs))
        imgs = self.ds.images[idxs]
        if self.augment and rng is not None:
            from psg_tpu_torch.data import native

            if native.available():
                # native C++ engine: GIL-free, threaded, deterministic in
                # the derived seed (native/augment.cc)
                seed = int(rng.integers(0, 2**62))
                images = native.augment_batch(
                    imgs, seed, self.ds.background, augment=True,
                    num_threads=self.num_workers)
                return self._finish_batch(images, idxs, valid, cap_v)
            imgs = np.stack([
                augment_sprite(im, rng, self.ds.background) for im in imgs
            ])
        images = imgs.astype(np.float32) / 127.5 - 1.0
        return self._finish_batch(images, idxs, valid, cap_v)

    def _finish_batch(self, images, idxs, valid,
                      cap_v=None) -> Dict[str, np.ndarray]:
        batch = {
            "image": images,
            "national_number": np.asarray(
                [self.ds.rows[i]["national_number"] for i in idxs], np.int32),
            "valid": np.int32(valid),
        }
        if self.ds.text_ids is not None:
            if cap_v is not None:  # per-sample caption variant rows
                batch["text_ids"] = self.ds.text_ids_aug[idxs, cap_v]
                batch["text_mask"] = self.ds.text_mask_aug[idxs, cap_v]
            else:
                batch["text_ids"] = self.ds.text_ids[idxs]
                batch["text_mask"] = self.ds.text_mask[idxs]
            batch["desc_ids"] = self.ds.desc_ids[idxs]
            batch["desc_mask"] = self.ds.desc_mask[idxs]
        if getattr(self.ds, "clip_ids", None) is not None:
            batch["clip_ids"] = self.ds.clip_ids[idxs]
            batch["clip_mask"] = self.ds.clip_mask[idxs]
        return batch

    def _epoch_index_batches(self):
        idx = self.indices
        if self.train:
            rng = np.random.RandomState(self.seed + self._epoch)
            idx = idx[rng.permutation(len(idx))]
            n_batches = len(idx) // self.batch_size
            for b in range(n_batches):
                yield idx[b * self.batch_size : (b + 1) * self.batch_size], self.batch_size
        else:
            for start in range(0, len(idx), self.batch_size):
                chunk = idx[start : start + self.batch_size]
                valid = len(chunk)
                if valid < self.batch_size:  # pad w/ wraparound, track valid
                    pad = self.indices[: self.batch_size - valid]
                    chunk = np.concatenate([chunk, pad])
                yield chunk, valid

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # caption variants draw from the same seeded stream even when
        # image augmentation is off
        needs_rng = self.augment or (
            self.train and getattr(self.ds, "text_ids_aug", None) is not None)
        rng = (
            np.random.default_rng(self.seed * 1000 + self._epoch)
            if needs_rng else None
        )
        plan = list(self._epoch_index_batches())
        self._epoch += 1

        if self.process_count > 1:
            # identical global plan on every process (same seed/epoch);
            # keep this process's contiguous row slice of each batch and
            # give it a process-distinct child RNG stream
            local = self.batch_size // self.process_count
            lo = self.process_index * local
            plan = [(idxs[lo:lo + local], valid) for idxs, valid in plan]
            child_rngs = [
                c.spawn(self.process_count)[self.process_index]
                for c in rng.spawn(len(plan))
            ] if rng is not None else [None] * len(plan)
            for (idxs, valid), crng in zip(plan, child_rngs):
                yield self._make_batch(idxs, valid, crng)
            return

        if self.num_workers <= 1 or len(plan) <= 1:
            for idxs, valid in plan:
                yield self._make_batch(idxs, valid, rng)
            return

        # threaded prefetch: each batch gets its own child generator so
        # results are deterministic regardless of thread scheduling
        child_rngs = (
            rng.spawn(len(plan)) if rng is not None else [None] * len(plan)
        )
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        sentinel = object()

        def producer():
            with ThreadPoolExecutor(self.num_workers) as pool:
                futs = [
                    pool.submit(self._make_batch, idxs, valid, crng)
                    for (idxs, valid), crng in zip(plan, child_rngs)
                ]
                for f in futs:
                    q.put(f.result())
            q.put(sentinel)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is sentinel:
                break
            yield item
        t.join()


def make_loaders(cfg, tokenizer=None, ds: Optional[PokemonDataset] = None,
                 process_index: int = 0, process_count: int = 1):
    """Config -> (train, val, test) Loaders + the underlying dataset.

    With several processes every loader yields this process's slice of each
    global batch (one process unless the caller says otherwise).
    """
    d = cfg.data
    proc = {"process_index": int(process_index), "process_count": int(process_count)}
    if ds is None:
        ds = PokemonDataset(
            d.csv_path, d.image_dir, image_size=d.image_size,
            background_color=d.background_color, tokenizer=tokenizer,
            text_len=d.text_len,
        )
    elif tokenizer is not None and ds.tokenizer is not tokenizer:
        ds.set_tokenizer(tokenizer)
    tr, va, te = split_indices(len(ds), d.val_split, d.test_split, seed=d.seed)
    train = Loader(ds, tr, d.batch_size, train=True, seed=d.seed,
                   augment=d.augment, num_workers=d.num_workers,
                   prefetch=d.prefetch, **proc)
    val = Loader(ds, va, d.batch_size, train=False, num_workers=d.num_workers,
                 **proc)
    test = Loader(ds, te, d.batch_size, train=False,
                  num_workers=d.num_workers, **proc)
    return train, val, test, ds
