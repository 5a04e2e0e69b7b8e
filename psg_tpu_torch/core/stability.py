"""Numerical-stability helpers over parameter trees (port of
``psg_tpu/core/stability.py``).

A non-finite gradient or a gradient whose norm explodes skips the update;
these two reductions decide it (``train/optim.py``).
"""

from __future__ import annotations

import torch

from psg_tpu_torch.core import tree


def global_norm(t) -> torch.Tensor:
    """fp32 L2 norm over every leaf of the tree (0.0 for an empty tree)."""
    xs = [x for x in tree.leaves(t) if x.numel()]
    if not xs:
        return torch.zeros(())
    norms = torch._foreach_norm([x.float() if x.dtype != torch.float32 else x
                                 for x in xs])
    return torch.linalg.vector_norm(torch.stack(norms))


def tree_finite(t) -> torch.Tensor:
    """Boolean scalar: every element of every leaf is finite (a NaN or an
    infinity anywhere makes some leaf's max-abs non-finite)."""
    xs = [x for x in tree.leaves(t) if x.numel()]
    if not xs:
        return torch.tensor(True)
    return torch.isfinite(torch.stack(torch._foreach_norm(xs, float("inf")))).all()
