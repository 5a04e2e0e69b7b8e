"""Seeding (port of ``psg_tpu/utils/seed.py``).

Seeds the host-side Python, numpy and torch generators the data pipeline
and the initialisers use, and returns a ``torch.Generator`` seeded the same
way, the port's counterpart of the JAX package's base ``PRNGKey``.
"""

from __future__ import annotations

import random

import numpy as np
import torch


def set_seed(seed: int, device=None) -> torch.Generator:
    """Seed Python's, numpy's and torch's global generators; return a
    generator on ``device`` (the GPU unless ``device="cpu"``) seeded with
    ``seed``."""
    from psg_tpu_torch.serve.generator import resolve_device

    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)
