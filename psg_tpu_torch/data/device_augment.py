"""Batch normalisation on the device (port of ``normalize_batch`` from
``psg_tpu/data/device_augment.py``; the module's augmentation comes with the
device-resident fast path)."""

from __future__ import annotations

import torch


def normalize_batch(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> float32 in [-1, 1] (the eval path: no
    augmentation)."""
    return images_u8.float() / 127.5 - 1.0
