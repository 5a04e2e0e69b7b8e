"""Plain AdamW with optax's order of operations, for the reference's steps.

Per group of trained leaves and per step: the group's global gradient norm;
a norm above ``skip`` skips the group's update; a norm at or above
``max_norm`` scales the gradient to it; Adam with optax's bias correction,
``eps`` outside the root and decoupled weight decay on the pre-update
parameters; ``p -= lr(count) * update``.  Moments are float32.  The
learning-rate schedules are optax's formulas.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def lr_schedule(kind: str, base_lr: float, *, total_steps: int, warmup_steps: int,
                end_factor: float):
    if kind == "constant":
        return lambda count: base_lr
    if kind == "warmup_cosine":
        warmup = min(max(warmup_steps, 1), max(total_steps - 1, 1))
        init, peak, end = base_lr * 1e-2, base_lr, base_lr * end_factor
        decay_steps = max(total_steps, 2) - warmup
        alpha = 0.0 if peak == 0.0 else end / peak

        def schedule(count):
            if count < warmup:
                frac = 1 - min(max(count, 0), warmup) / warmup
                return (init - peak) * frac + peak
            c = min(float(count - warmup), float(decay_steps))
            return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps))
                           + alpha)
        return schedule
    raise ValueError(f"the reference has no {kind!r} schedule")


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1) - np.power(np.float32(decay), np.float32(count)))


class AdamW:
    """``groups``: name -> dict(params=[leaf], lr=schedule, max_norm, skip)."""

    def __init__(self, groups: dict, *, b1: float, b2: float, eps: float,
                 weight_decay: float):
        self.groups = groups
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        for g in groups.values():
            g["count"] = 0
            g["mu"] = [torch.zeros_like(p) for p in g["params"]]
            g["nu"] = [torch.zeros_like(p) for p in g["params"]]

    @torch.no_grad()
    def step(self, grads: dict) -> dict:
        """``grads``: name -> [gradient of each leaf].  Returns each
        group's gradients as the update used them (after the clip)."""
        used = {}
        for name, g in self.groups.items():
            gs = [x.float() for x in grads[name]]
            norm = float(torch.sqrt(sum((x * x).sum() for x in gs))) if gs else 0.0
            if g.get("skip") is not None and not norm <= g["skip"]:
                used[name] = None
                continue
            if g.get("max_norm") and not norm < g["max_norm"]:
                gs = [x * (g["max_norm"] / norm) for x in gs]
            lr = float(g["lr"](g["count"]))
            g["count"] += 1
            bc1 = _bias_correction(self.b1, g["count"])
            bc2 = _bias_correction(self.b2, g["count"])
            for p, x, m, v in zip(g["params"], gs, g["mu"], g["nu"]):
                m.mul_(self.b1).add_(x, alpha=1 - self.b1)
                v.mul_(self.b2).addcmul_(x, x, value=1 - self.b2)
                upd = (m / bc1) / ((v / bc2).sqrt() + self.eps)
                if self.wd:
                    upd = upd + self.wd * p
                p.sub_(lr * upd)
            used[name] = gs
        return used
