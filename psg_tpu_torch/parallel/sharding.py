"""Parameter sharding rules (tensor parallelism; port of
``psg_tpu/parallel/sharding.py``).

The rule is the JAX package's, written in the port's layout
(``models/bridge.py``): a linear kernel ``[in, out]`` shards its output
axis over 'model' when it has at least ``min_channels`` outputs, else its
input axis when that is wide; a conv kernel is OIHW here (HWIO in JAX), so
its output channels are dim 0 and its input channels dim 1.  A leaf whose
sharded dimension does not divide the 'model' axis stays replicated.

The mechanism differs from JAX's, which leaves the compute partition to
GSPMD.  Here the *state* is sharded: each rank holds its shard of every
ruled parameter, of the EMA and of both Adam moments (``shard_state``), so
the bytes a rank keeps fall as the rule says.  For compute,
``ShardLayout.gather`` all-gathers each sharded leaf over 'model' into a
plain tensor (the kernels and their autograd Functions never see a
DTensor), the step runs on the whole parameters, ``ShardLayout.scatter``
reduce-scatters each gradient back to its shard (averaged over 'model',
whose ranks hold the same rows), and the optimizer updates each shard where
it lies.  Compute is not split over 'model'.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard

from psg_tpu_torch.core import tree

Rule = Callable[[str, torch.Tensor], tuple]


def unet_tp_rules(min_channels: int = 640) -> Rule:
    """Rule: shard the output axis of big kernels over 'model' (the input
    axis when only that is wide).  Returns ``fn(path, leaf) -> spec``: one
    entry per leaf dimension, ``'model'`` or None; ``()`` replicates."""

    def rule(path: str, leaf) -> tuple:
        nd = leaf.ndim
        if nd not in (2, 4):
            return ()
        if nd == 4 and path.rsplit(".", 1)[-1] == "w":   # conv, OIHW
            out_dim, in_dim = 0, 1
        else:                                            # [in, out] (and JAX's 4-D layout)
            out_dim, in_dim = nd - 1, nd - 2 if nd == 2 else 2
        for dim in (out_dim, in_dim):
            if leaf.shape[dim] >= min_channels:
                spec = [None] * nd
                spec[dim] = "model"
                return tuple(spec)
        return ()

    return rule


def _model_dim(mesh, rule: Optional[Rule], path: str, leaf) -> Optional[int]:
    """The dimension the rule shards over 'model', None to replicate
    (no rule, no 'model' entry, or a size that does not divide the axis)."""
    if rule is None or not isinstance(leaf, torch.Tensor):
        return None
    spec = rule(path, leaf)
    if "model" not in spec:
        return None
    dim = spec.index("model")
    return dim if leaf.shape[dim] % mesh.size(1) == 0 else None


def _map_with_path(fn, t, prefix: str = ""):
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: _map_with_path(fn, v, f"{prefix}{k}.") for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return [_map_with_path(fn, v, f"{prefix}{i}.") for i, v in enumerate(t)]
    return fn(prefix[:-1], t)


def param_shardings(params, mesh, rule: Optional[Rule] = None):
    """A tree of DTensor placements for ``params``, one per mesh dim
    (('data', 'model')): replicated over 'data'; ``Shard(dim)`` over
    'model' where the rule shards ``dim`` and it divides the axis, else
    ``Replicate()``.  Default (no rule): fully replicated."""
    def place(path, leaf):
        dim = _model_dim(mesh, rule, path, leaf)
        return (Replicate(), Shard(dim) if dim is not None else Replicate())

    return _map_with_path(place, params)


class ShardLayout:
    """Which dimension of each parameter (by path) is sharded over the
    mesh's 'model' axis, and the collectives that move between shards and
    whole tensors."""

    def __init__(self, params, mesh, rule: Optional[Rule] = None):
        self.mesh = mesh
        self.group = mesh.get_group("model")
        self.size = mesh.size(1)
        self.index = mesh.get_local_rank("model")
        self.dims: Dict[str, int] = {}
        self.channels_last = set()     # conv kernels kept NHWC-strided (nn.layers.prepare_weights)
        for path, leaf in tree.items(params):
            dim = _model_dim(mesh, rule, path, leaf)
            if dim is not None and self.size > 1:
                self.dims[path] = dim
                if leaf.ndim == 4 and not leaf.is_contiguous() and leaf.is_contiguous(
                        memory_format=torch.channels_last):
                    self.channels_last.add(path)

    @property
    def sharded(self) -> bool:
        return bool(self.dims)

    def shard(self, params):
        """This rank's shard of each sharded leaf (a contiguous copy; the
        leaf's ``requires_grad`` kept), the other leaves as they are."""
        def cut(path, t):
            dim = self.dims.get(path)
            if dim is None:
                return t
            s = t.detach().chunk(self.size, dim)[self.index].contiguous()
            return s.requires_grad_(t.requires_grad)

        return _map_with_path(cut, params)

    def gather(self, params):
        """Whole tensors: each sharded leaf all-gathered over 'model' (a new
        plain tensor with the shard's ``requires_grad``), the others as
        they are."""
        def whole(path, t):
            dim = self.dims.get(path)
            if dim is None:
                return t
            src = t.detach().movedim(dim, 0).contiguous()
            out = torch.empty((self.size * src.shape[0],) + tuple(src.shape[1:]),
                              dtype=src.dtype, device=src.device)
            dist.all_gather_into_tensor(out, src, group=self.group)
            fmt = (torch.channels_last if path in self.channels_last
                   else torch.contiguous_format)
            return out.movedim(0, dim).contiguous(memory_format=fmt).requires_grad_(
                t.requires_grad)

        return _map_with_path(whole, params)

    def scatter(self, path: str, grad: torch.Tensor) -> torch.Tensor:
        """The whole gradient of the leaf at ``path`` reduce-scattered to
        this rank's shard, averaged over 'model' (every 'model' rank of a
        'data' row computed the same gradient); other leaves unchanged."""
        dim = self.dims.get(path)
        if dim is None:
            return grad
        src = grad.movedim(dim, 0).contiguous()
        out = torch.empty((src.shape[0] // self.size,) + tuple(src.shape[1:]),
                          dtype=src.dtype, device=src.device)
        dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.AVG, group=self.group)
        return out.movedim(0, dim).contiguous()

    def place(self, state):
        """A ``TrainState`` with its params, EMA and Adam moments cut to this
        rank's shards (the moments matched to their params by path); steps,
        counts and the generator stay whole on every rank."""
        def moments(opt):
            if isinstance(opt, dict):
                return {k: ({p: self._cut(p, m) for p, m in v.items()}
                            if k in ("mu", "nu") else moments(v))
                        for k, v in opt.items()}
            return opt

        return replace(state, params=self.shard(state.params),
                       ema=self.shard(state.ema) if state.ema is not None else None,
                       opt_state=moments(state.opt_state), layout=self)

    def _cut(self, path, t):
        dim = self.dims.get(path)
        return t if dim is None else t.chunk(self.size, dim)[self.index].contiguous()

    def unplace(self, state):
        """The whole ``TrainState`` (collective: every rank of the 'model'
        group calls it), without a layout."""
        def moments(opt):
            if isinstance(opt, dict):
                return {k: (self.gather(v) if k in ("mu", "nu") else moments(v))
                        for k, v in opt.items()}
            return opt

        return replace(state, params=self.gather(state.params),
                       ema=self.gather(state.ema) if state.ema is not None else None,
                       opt_state=moments(state.opt_state), layout=None)


def shard_state(state, mesh, rule: Optional[Rule] = None):
    """Place a whole ``TrainState`` on a mesh: params, EMA and Adam moments
    sharded by ``rule`` (replicated without one), scalars and counts
    replicated.  The rule depends on the leaf's path and shape only, so a
    moment lands on the same shard as its parameter and the update stays
    local."""
    return ShardLayout(state.params, mesh, rule).place(state)
