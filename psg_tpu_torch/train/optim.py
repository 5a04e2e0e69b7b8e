"""Optimizer with optax's arithmetic (port of ``psg_tpu/train/optim.py``).

The JAX package builds its optimizer from optax:
``apply_if_finite(multi_transform({group: skip_above_global_norm(chain(
clip_by_global_norm, adamw))}, 'frozen': set_to_zero))``.  This module does
the same arithmetic with ``torch._foreach_*`` over the tensors of a
parameter tree, updating parameters and moments in place (the 655M-parameter
UNet's fp32 params and two moments are 8 GB; in place, no second copy is
made).  It is not ``torch.optim.AdamW``, which has no bf16 first moment and
clips as ``max / (norm + 1e-6)``.

Per step, in optax's order:
1. ``apply_if_finite``: a non-finite gradient anywhere leaves every
   parameter and all optimizer state untouched and counts
   ``notfinite_count`` (consecutive) and ``total_notfinite``; past
   ``max_consecutive_errors`` consecutive ones the update goes through.
2. per group, ``skip_above_global_norm``: a raw gradient norm above
   ``skip_grad_norm`` skips the group's update, keeps its moments and step
   count, and counts ``skipped``;
3. ``clip_by_global_norm``: ``g * max / norm`` where ``norm >= max``;
4. Adam with optax's bias correction, ``eps`` outside the root, the first
   moment stored in ``mu_dtype`` (bf16 or fp32) but updated in fp32 (with
   a bf16 moment, b1 itself rounds to bf16, as in the jitted JAX step);
   AdamW adds ``weight_decay * p`` (the pre-update params);
5. ``-lr(count)`` from the group's schedule, and ``p += u``.
A ``frozen`` group gets no update and has no state.

The skip and non-finite decisions are made on the host: one device-to-host
read a step (the finite flag and the norms, which the trainer logs anyway),
counted as ``host_reads`` (``utils.profiling``) inside the span
``psg.optim.stats``; the span ``psg.optim.adam`` covers the groups' updates.
On a mesh they come from the reduced gradient, so every rank decides the
same: under data parallelism each rank holds the averaged gradient whole;
under tensor parallelism (``layout``, ``parallel/sharding.py``) a sharded
leaf's squares and non-finite count are summed over 'model' first.
"""

from __future__ import annotations

import math
from typing import Callable, Dict

import numpy as np
import torch

from psg_tpu_torch.core import tree
from psg_tpu_torch.core.stability import global_norm, tree_finite
from psg_tpu_torch.utils.profiling import HOST_READS, count, span

_SPAN_STATS = "psg.optim.stats"
_SPAN_ADAM = "psg.optim.adam"

Schedule = Callable[[int], float]


# ---------------------------------------------------------------------------
# learning-rate schedules (optax's formulas, as functions of the step count)
# ---------------------------------------------------------------------------


def _constant(value: float) -> Schedule:
    return lambda count: value


def _cosine_decay(init_value: float, decay_steps: int, alpha: float = 0.0) -> Schedule:
    """optax.cosine_decay_schedule."""
    def schedule(count):
        c = min(float(count), float(decay_steps))
        return init_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps))
                             + alpha)
    return schedule


def _piecewise_constant(init_value: float, boundaries_and_scales: Dict[int, float]) -> Schedule:
    """optax.piecewise_constant_schedule."""
    def schedule(count):
        v = init_value
        for threshold, scale in sorted(boundaries_and_scales.items()):
            if count >= threshold:
                v *= scale
        return v
    return schedule


def _cosine_onecycle(transition_steps: int, peak_value: float, pct_start: float = 0.3,
                     div_factor: float = 25.0, final_div_factor: float = 1e4) -> Schedule:
    """optax.cosine_onecycle_schedule: optax's piecewise cosine
    interpolation from peak/div_factor up to the peak at
    int(pct_start * steps), then down to peak/(div_factor*final_div_factor)
    at ``transition_steps``.  A first segment of length 0 gives NaN, as in
    optax."""
    bounds = np.array([0, int(pct_start * transition_steps), int(transition_steps)])
    values = np.cumprod([peak_value / div_factor, div_factor,
                         1.0 / (div_factor * final_div_factor)])

    def schedule(count):
        with np.errstate(divide="ignore", invalid="ignore"):
            pct = (count - bounds[:-1]) / (bounds[1:] - bounds[:-1])
            interp = values[1:] + (values[:-1] - values[1:]) / 2.0 * (np.cos(np.pi * pct) + 1)
            inside = (bounds[:-1] <= count) & (count < bounds[1:])
            return float(inside.dot(interp) + (bounds[-1] <= count) * values[-1])
    return schedule


def _warmup_cosine(init_value: float, peak_value: float, warmup_steps: int,
                   decay_steps: int, end_value: float) -> Schedule:
    """optax.warmup_cosine_decay_schedule: linear warmup, then cosine decay."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    decay = _cosine_decay(peak_value, decay_steps - warmup_steps, alpha)

    def schedule(count):
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        return decay(count - warmup_steps)
    return schedule


def make_lr_schedule(kind: str, base_lr: float, *, total_steps: int,
                     steps_per_epoch: int = 1, step_size_epochs: int = 30,
                     gamma: float = 0.1, pct_start: float = 0.1,
                     warmup_steps: int = 500, end_factor: float = 0.1) -> Schedule:
    """'constant', 'cosine' (anneal to 0 over total_steps), 'step'
    (x gamma every step_size_epochs), 'onecycle' (OneCycle, pct_start
    warmup), 'warmup_cosine' (linear warmup from 1% of the peak, then cosine
    decay to end_factor * lr)."""
    if kind == "constant":
        return _constant(base_lr)
    if kind == "warmup_cosine":
        warmup = min(max(warmup_steps, 1), max(total_steps - 1, 1))
        return _warmup_cosine(base_lr * 1e-2, base_lr, warmup, max(total_steps, 2),
                              base_lr * end_factor)
    if kind == "cosine":
        return _cosine_decay(base_lr, max(total_steps, 1))
    if kind == "step":
        boundaries = {}
        e = step_size_epochs
        while e * steps_per_epoch < total_steps:
            boundaries[e * steps_per_epoch] = gamma
            e += step_size_epochs
        return _piecewise_constant(base_lr, boundaries)
    if kind == "onecycle":
        return _cosine_onecycle(max(total_steps, 1), base_lr, pct_start=pct_start)
    raise ValueError(f"unknown scheduler {kind!r}")


# ---------------------------------------------------------------------------
# the optimizer
# ---------------------------------------------------------------------------


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count in fp32, as optax computes it (in fp64 it differs by
    1e-5 relative after ~50 steps at decay 0.999)."""
    return float(np.float32(1) - np.power(np.float32(decay), np.float32(count)))


class Optimizer:
    """Multi-group AdamW/Adam over a parameter tree.

    ``groups``: name -> {'lr_schedule': fn, 'max_grad_norm': float|None};
    ``labels``: a tree matching the parameters, each leaf a group name or
    ``'frozen'``.  ``init(params)`` makes the state; ``update(params, grads,
    state)`` applies one step in place and returns the step's numbers.
    """

    def __init__(self, opt_cfg, groups: Dict[str, dict], labels, *,
                 max_consecutive_errors: int = 1000):
        if opt_cfg.optimizer not in ("adamw", "adam"):
            raise ValueError(f"unknown optimizer {opt_cfg.optimizer!r}")
        self.b1, self.b2, self.eps = opt_cfg.beta1, opt_cfg.beta2, opt_cfg.eps
        self.weight_decay = opt_cfg.weight_decay if opt_cfg.optimizer == "adamw" else 0.0
        mu_dtype = getattr(opt_cfg, "mu_dtype", None)
        self.mu_dtype = {None: None, "bfloat16": torch.bfloat16,
                         "float32": torch.float32}[mu_dtype]
        skip = getattr(opt_cfg, "skip_grad_norm", None)
        self.skip_grad_norm = skip if skip is not None and skip > 0 else None
        self.groups = groups
        self.labels = tree.leaves(labels)
        unknown = set(self.labels) - set(groups) - {"frozen"}
        if unknown:
            raise ValueError(f"labels name groups {sorted(unknown)} with no settings")
        self.max_consecutive_errors = max_consecutive_errors

    def _members(self, params, name):
        """(path, param) of the group's leaves, in tree order."""
        pairs = list(tree.items(params))
        if len(pairs) != len(self.labels):
            raise ValueError("labels do not match the parameter tree")
        return [(i, path, p) for i, ((path, p), lab) in enumerate(zip(pairs, self.labels))
                if lab == name]

    def init(self, params) -> dict:
        state = {"notfinite_count": 0, "last_finite": True, "total_notfinite": 0,
                 "groups": {}}
        for name in self.groups:
            members = self._members(params, name)
            state["groups"][name] = {
                "count": 0, "skipped": 0,
                "mu": {path: torch.zeros_like(p, dtype=self.mu_dtype or p.dtype)
                       for _, path, p in members},
                "nu": {path: torch.zeros_like(p) for _, path, p in members}}
        return state

    @torch.no_grad()
    def update(self, params, grads, state, layout=None) -> dict:
        """One step, in place on ``params`` and ``state`` (``grads`` has the
        parameters' structure; its dict order may differ).  ``layout``: the
        ``ShardLayout`` params, moments and grads are cut by, if any.
        Returns ``grad_norm`` (over all gradients), ``finite`` and the
        groups that were ``applied``."""
        paths, p_leaves = zip(*tree.items(params))
        by_path = dict(tree.items(grads))     # matched by path, not by order
        g_leaves = [by_path[path] for path in paths]
        members = {name: [i for i, _, _ in self._members(params, name)]
                   for name in self.groups}
        with span(_SPAN_STATS):
            if layout is not None and layout.sharded:
                vals = _sharded_stats(paths, g_leaves, members, layout)
            else:
                norms = [global_norm([g_leaves[i] for i in idx]).to(g_leaves[0].device)
                         for idx in members.values()]
                count(HOST_READS)
                vals = torch.stack([tree_finite(g_leaves).float().to(g_leaves[0].device),
                                    global_norm(g_leaves).to(g_leaves[0].device),
                                    *norms]).tolist()       # the step's one host read
        finite, grad_norm = vals[0] == 1.0, vals[1]
        group_norm = dict(zip(members, vals[2:]))

        state["notfinite_count"] = 0 if finite else state["notfinite_count"] + 1
        state["total_notfinite"] += 0 if finite else 1
        state["last_finite"] = finite
        applied = []
        if finite or state["notfinite_count"] > self.max_consecutive_errors:
            with span(_SPAN_ADAM):
                for name, idx in members.items():
                    gs = state["groups"][name]
                    gn = group_norm[name]
                    if self.skip_grad_norm is not None and not gn <= self.skip_grad_norm:
                        gs["skipped"] += 1
                        continue
                    self._adam(name, gs, [paths[i] for i in idx],
                               [p_leaves[i] for i in idx], [g_leaves[i] for i in idx], gn)
                    applied.append(name)
        return {"grad_norm": grad_norm, "finite": finite, "applied": applied}

    def _adam(self, name, gs, paths, ps, gs_, gn: float) -> None:
        if not ps:
            return
        max_norm = self.groups[name].get("max_grad_norm")
        if max_norm is not None and max_norm > 0 and not gn < max_norm:
            gs_ = torch._foreach_div(gs_, gn)
            torch._foreach_mul_(gs_, max_norm)
        lr = float(self.groups[name]["lr_schedule"](gs["count"]))
        gs["count"] += 1
        mu, nu = [gs["mu"][p] for p in paths], [gs["nu"][p] for p in paths]
        if self.mu_dtype == torch.bfloat16:
            # as the JAX step computes it under jit: b1, a weakly typed
            # scalar against the bf16 moment, is rounded to bf16 (0.8984375
            # for 0.9), and the product and the sum are fp32
            b1 = float(torch.tensor(self.b1, dtype=torch.bfloat16))
            mu32 = [m.float() for m in mu]
            torch._foreach_mul_(mu32, b1)
        else:
            torch._foreach_mul_(mu, self.b1)
            mu32 = mu
        torch._foreach_add_(mu32, gs_, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, gs_, gs_, value=1 - self.b2)
        denom = torch._foreach_div(nu, _bias_correction(self.b2, gs["count"]))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mu32, _bias_correction(self.b1, gs["count"]))
        torch._foreach_div_(upd, denom)
        if self.weight_decay:
            torch._foreach_add_(upd, ps, alpha=self.weight_decay)
        torch._foreach_add_(ps, upd, alpha=-lr)
        if mu32 is not mu:
            torch._foreach_copy_(mu, mu32)


def _sharded_stats(paths, g_leaves, members, layout) -> list:
    """[finite, global norm, each group's norm] of gradients cut by
    ``layout``: the sharded leaves' squares and non-finite counts summed
    over 'model', the replicated leaves' (the same on every rank) added
    once; one collective and one host read."""
    import torch.distributed as dist

    dev = g_leaves[0].device
    sharded = [paths[i] in layout.dims for i in range(len(paths))]

    def sums(idx):
        """(non-finite count, sum of squares) over the leaves ``idx``."""
        xs = [g_leaves[i] for i in idx if g_leaves[i].numel()]
        if not xs:
            return torch.zeros((), device=dev), torch.zeros((), device=dev)
        bad = (~torch.isfinite(torch.stack(torch._foreach_norm(xs, float("inf"))))).sum()
        sq = torch.stack([n.float() for n in torch._foreach_norm(
            [x.float() if x.dtype != torch.float32 else x for x in xs])]).square().sum()
        return bad.float(), sq

    every = list(range(len(paths)))
    parts = [every] + list(members.values())
    sh = [sums([i for i in idx if sharded[i]]) for idx in parts]
    rep = [sums([i for i in idx if not sharded[i]]) for idx in parts]
    vec = torch.stack([sh[0][0]] + [sq for _, sq in sh])
    dist.all_reduce(vec, group=layout.group)
    bad = vec[0] + rep[0][0]
    norms = (vec[1:] + torch.stack([sq for _, sq in rep])).sqrt()
    count(HOST_READS)
    return torch.cat([(bad == 0).float()[None], norms]).tolist()


@torch.no_grad()
def ema_update(ema, params, decay: float) -> None:
    """EMA of the parameters, in place: ``e = d*e + (1-d)*p``."""
    e = tree.leaves(ema)
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, tree.leaves(params), alpha=1.0 - decay)


def build_optimizer(opt_cfg, groups: Dict[str, dict], labels, *,
                    max_consecutive_errors: int = 1000) -> Optimizer:
    """Multi-group optimizer; see ``Optimizer``."""
    return Optimizer(opt_cfg, groups, labels, max_consecutive_errors=max_consecutive_errors)


def labels_from_mask(mask_tree, trainable_label: str):
    """Boolean fine-tune mask tree -> label tree (``trainable_label`` or
    ``'frozen'``)."""
    return tree.map(lambda t: trainable_label if t else "frozen", mask_tree)


def skipped_steps(state) -> int:
    """Non-finite rejections plus every group's norm rejections."""
    return state["total_notfinite"] + sum(g["skipped"] for g in state["groups"].values())
