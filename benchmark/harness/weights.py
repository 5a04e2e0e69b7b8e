"""Random weights made by the benchmark on the device from a seed.

A parameter tree's structure comes from the reference's initializers run on
the ``meta`` device (shapes only, no memory).  The values are drawn in one
call: a uniform vector over every parameter, from a ``torch.Generator`` on
the device, scaled leaf by leaf in one more call to each leaf's bound, with
norm scales centred on 1.  Leaves are views into that one float32 buffer;
the same tree goes to the program and to the reference.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import tree as tree_


class MetaGenerator(torch.Generator):
    """A generator whose ``device`` is ``meta``: initializers run through it
    build a tree of shapes."""

    @property
    def device(self):
        return torch.device("meta")


def _bound_and_offset(path: str, shape) -> tuple:
    key = path.rsplit(".", 1)[-1]
    if len(shape) == 4:                       # conv kernel, OIHW
        return 1.0 / math.sqrt(shape[1] * shape[2] * shape[3]), 0.0
    if len(shape) == 2 and key in ("w", "weight"):   # linear kernel [in, out]
        return 1.0 / math.sqrt(shape[0]), 0.0
    if len(shape) == 2:                       # embedding tables
        return 0.05, 0.0
    if key in ("scale", "gamma"):             # norm scales
        return 0.05, 1.0
    return 0.02, 0.0                          # biases


def fill(template, seed: int, device) -> dict:
    """A float32 tree of ``template``'s structure on ``device``, drawn from
    ``seed``."""
    leaves = list(tree_.items(template))
    sizes = [leaf.numel() for _, leaf in leaves]
    gen = torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))
    flat = torch.rand(sum(sizes), generator=gen, device=device, dtype=torch.float32)
    spec = [_bound_and_offset(p, tuple(leaf.shape)) for p, leaf in leaves]
    counts = torch.tensor(sizes, device=device)
    bounds = torch.tensor([b for b, _ in spec], device=device)
    offsets = torch.tensor([o for _, o in spec], device=device)
    flat.mul_(2.0).sub_(1.0)
    flat.mul_(bounds.repeat_interleave(counts, output_size=flat.numel()))
    flat.add_(offsets.repeat_interleave(counts, output_size=flat.numel()))
    views = iter(flat.split(sizes))
    return tree_.map(lambda leaf: next(views).view(leaf.shape), template)


def separate(tree) -> dict:
    """The tree with each leaf in memory of its own."""
    return tree_.map(lambda leaf: leaf.clone(), tree)


def count(tree) -> int:
    return sum(leaf.numel() for _, leaf in tree_.items(tree))
