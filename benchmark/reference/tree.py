# Frozen copy of psg_tpu_torch/core/tree.py for the benchmark's plain reference;
# calls into the port's kernels, where it has any, go to plainops.py.
"""Parameter trees: nested dicts and lists of tensors.

The port keeps parameters, gradients, optimizer moments and the EMA as plain
trees in the JAX package's shapes; these helpers walk them in one fixed
order (dict insertion order, list order) and name each leaf by its path,
``enc0.1.res.conv1.w``.  A ``None`` subtree (the SD UNet's ``attentions``
of a level without attention) has no leaves and maps to ``None``.
"""

from __future__ import annotations

from typing import Callable, Iterator, List, Tuple


def items(tree, prefix: str = "") -> Iterator[Tuple[str, object]]:
    """(path, leaf) pairs in tree order."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from items(v, f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items(v, f"{prefix}{i}.")
    elif tree is not None:
        yield prefix[:-1], tree


def leaves(tree) -> List:
    return [leaf for _, leaf in items(tree)]


def map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of trees of one structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)
