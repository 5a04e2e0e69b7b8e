"""Parameter bridge between a ``psg_tpu`` parameter tree and this package's
tree (``from_jax``) and back (``to_jax``, what the checkpoint writer saves).

The JAX package stores conv kernels HWIO and linear kernels ``[in, out]``;
this package keeps ``[in, out]`` for linear kernels (and the fused attention
``in_proj`` ``[C, 3C]``) and stores conv kernels OIHW.  Norm ``scale`` /
``bias``, embedding tables and biases carry over unchanged.  Lists (BERT
``layers``, UNet ``enc{lvl}``/``dec{lvl}``) stay lists; a flax msgpack
checkpoint spells them as dicts keyed ``'0'``, ``'1'``, ..., which become
lists again here.  A ``None`` subtree (msgpack nil: the SD UNet's
``attentions`` of a level without attention) stays ``None`` both ways.
"""

from __future__ import annotations

import numpy as np
import torch


def _is_list_dict(d) -> bool:
    # a set, not sorted(): '10' sorts before '2'
    return isinstance(d, dict) and len(d) > 0 and set(d) == {str(i) for i in range(len(d))}


def _leaf(name, a) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a))
    if name == "w" and t.ndim == 4:  # HWIO -> OIHW
        t = t.permute(3, 2, 0, 1)
    return t.contiguous()


def from_jax(tree, name: str = ""):
    """Convert a JAX-layout parameter tree (numpy arrays or CPU tensors as
    leaves, lists or ``'0'..'n'``-keyed dicts) to this package's layout."""
    if tree is None:
        return None
    if _is_list_dict(tree):
        return [from_jax(tree[str(i)], name) for i in range(len(tree))]
    if isinstance(tree, dict):
        return {k: from_jax(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [from_jax(v, name) for v in tree]
    return _leaf(name, tree)


def to_jax(tree, name: str = ""):
    """Inverse of ``from_jax``: conv kernels OIHW -> HWIO, lists as dicts
    keyed ``'0'``, ``'1'``, ... (flax's state-dict form), leaves as detached
    views of the tensors on their own device, in their own dtype (they share
    the tensors' memory: the checkpoint writer copies them)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: to_jax(v, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_jax(v, name) for i, v in enumerate(tree)}
    t = tree.detach()
    if name == "w" and t.ndim == 4:  # OIHW -> HWIO
        t = t.permute(2, 3, 1, 0)
    return t


def fit(template, tree, path: str = "params"):
    """Check that ``tree`` has ``template``'s structure and leaf shapes and
    return it with the template's dtypes and devices; raise on any mismatch."""
    if template is None or tree is None:
        if template is not tree:
            raise ValueError(f"{path}: expected {type(template).__name__}, "
                             f"got {type(tree).__name__}")
        return None
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
            raise ValueError(f"{path}: expected keys {sorted(template)}, got {got}")
        return {k: fit(template[k], tree[k], f"{path}.{k}") for k in template}
    if isinstance(template, list):
        if not isinstance(tree, list) or len(tree) != len(template):
            raise ValueError(f"{path}: expected a list of {len(template)}")
        return [fit(t, x, f"{path}[{i}]") for i, (t, x) in enumerate(zip(template, tree))]
    if not isinstance(tree, torch.Tensor) or tuple(tree.shape) != tuple(template.shape):
        got = tuple(tree.shape) if isinstance(tree, torch.Tensor) else type(tree).__name__
        raise ValueError(f"{path}: expected shape {tuple(template.shape)}, got {got}")
    return tree.to(device=template.device, dtype=template.dtype)
