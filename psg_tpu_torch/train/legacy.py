"""The legacy stage-2 trainer preset (port of ``psg_tpu/train/legacy.py``).

The reference keeps an older DiffusionTrainer beside the improved default:
a linear beta schedule, plain MSE loss and a cosine LR anneal, without the
non-finite machinery.  As in the JAX package it is a configuration preset
of the unified ``DiffusionTrainer``, not a second trainer.
"""

from __future__ import annotations

import copy

from psg_tpu_torch.core.config import Config
from psg_tpu_torch.train.stage2_diffusion import DiffusionTrainer


class LegacyDiffusionTrainer(DiffusionTrainer):
    """DiffusionTrainer with the legacy trainer's choices pinned."""

    def __init__(self, cfg: Config, vae_checkpoint_path, experiment_name: str = "pokemon",
                 *, device=None):
        cfg = copy.deepcopy(cfg)
        cfg.model.beta_schedule = "linear"
        cfg.extra = dict(cfg.extra or {})
        cfg.extra["diffusion_loss"] = "mse"
        cfg.optimization.scheduler = "cosine"
        # the legacy 'cosine' is the plain cosine anneal over the whole run,
        # not OneCycle
        cfg.extra["unet_optimization"] = {**cfg.extra.get("unet_optimization", {}),
                                          "scheduler": "legacy_cosine"}
        super().__init__(cfg, vae_checkpoint_path, experiment_name, device=device)
