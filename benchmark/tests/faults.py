"""Faults planted in the timed path, for the tests and for fault readings.

Each is a context manager that patches the port underneath the harness for
as long as it is open:

- ``altered_answer``: a served request returns another seed's sprite;
- ``unchanged_state``: an optimizer step returns its state unchanged;
- ``half_batch``: a training step sees half of its batch, and the mean is
  taken over the rest;
- ``altered_batch``: the classic loader's engine augments each batch from
  another seed than the one the loader drew.
"""

from __future__ import annotations

import contextlib
import importlib

TRAINERS = {"train_sd": ("psg_tpu_torch.train.stage2_sd", "SDDiffusionTrainer", "_batch"),
            "train_fast": ("psg_tpu_torch.train.stage2_diffusion", "DiffusionTrainer",
                           "_fast_batch")}


@contextlib.contextmanager
def _patched(owner, name, value):
    real = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield real
    finally:
        setattr(owner, name, real)


def _trainer(runner: str):
    mod, cls, batch = TRAINERS[runner]
    return getattr(importlib.import_module(mod), cls), batch


@contextlib.contextmanager
def altered_answer(runner: str = "serve"):
    from psg_tpu_torch.serve.generator import PokemonGenerator

    real = PokemonGenerator.generate_from_text

    def altered(self, prompt, *a, seed=None, **kw):
        return real(self, prompt, *a, seed=(seed or 0) + 1, **kw)

    with _patched(PokemonGenerator, "generate_from_text", altered):
        yield


@contextlib.contextmanager
def unchanged_state(runner: str):
    trainer, _ = _trainer(runner)

    def unchanged(self, loss, grads):
        self.state.step += 1
        return {"loss": loss, "grad_norm": 0.0}

    with _patched(trainer, "_apply_update", unchanged):
        yield


@contextlib.contextmanager
def half_batch(runner: str):
    trainer, name = _trainer(runner)
    real = getattr(trainer, name)

    def half(self, *a, **kw):
        out = real(self, *a, **kw)
        n = out["image"].shape[0] // 2
        return {k: v[:n] for k, v in out.items()}

    with _patched(trainer, name, half):
        yield


@contextlib.contextmanager
def altered_batch(runner: str = "train_sd"):
    from psg_tpu_torch.data import native

    real = native.augment_batch

    def altered(images, seed, *a, **kw):
        return real(images, seed + 1, *a, **kw)

    with _patched(native, "augment_batch", altered):
        yield


FAULTS = {"altered_answer": altered_answer, "unchanged_state": unchanged_state,
          "half_batch": half_batch, "altered_batch": altered_batch}
