"""The ('data', 'model') device mesh and batch placement (port of
``psg_tpu/parallel/mesh.py``) on ``torch.distributed``.

The JAX package drives one process over every device; the port runs one
process per device (a rank), NCCL between cards and gloo on the CPU
(``parallel/multihost.py`` starts the group).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the group's ranks with
dims ``('data', 'model')``: rank ``d * model + m`` sits at ``(d, m)``.

- ``data``: the batch dimension (DP).  Every rank loads the same global
  batch and keeps its contiguous rows (``shard_batch``); gradients are
  averaged over 'data' (``train/common.py``).
- ``model``: the wide UNet kernels' channel dimension (TP) by
  ``parallel/sharding.py``'s rule.

Placements are DTensor's: ``Shard(0)`` over 'data' for a batch,
``Replicate()`` elsewhere.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

AXES = ("data", "model")


def rank_device() -> torch.device:
    """This rank's device: its card under NCCL, else the CPU."""
    if dist.is_initialized() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def make_mesh(data: int = -1, model: int = 1,
              devices: Optional[Sequence[int]] = None) -> DeviceMesh:
    """A ('data', 'model') mesh over ``devices`` (global ranks; all the
    group's ranks by default).  ``data=-1``: all that ``model`` leaves."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.initialize_distributed first")
    ranks = list(devices) if devices is not None else list(range(dist.get_world_size()))
    n = len(ranks)
    if data == -1:
        if n % model != 0:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    grid = torch.tensor(np.asarray(ranks, np.int64).reshape(data, model))
    return DeviceMesh(rank_device().type, grid, mesh_dim_names=AXES)


def mesh_shape(mesh: DeviceMesh) -> dict:
    """{'data': size, 'model': size}, as the JAX mesh's ``shape``."""
    return {name: mesh.size(i) for i, name in enumerate(AXES)}


def batch_sharding(mesh: DeviceMesh, ndim: int):
    """Axis 0 (the batch) sharded over 'data', replicated over 'model'."""
    if ndim < 1:
        raise ValueError("a batch-sharded array needs a batch axis")
    return (Shard(0), Replicate())


def replicated(mesh: DeviceMesh):
    return (Replicate(), Replicate())


def data_rows(mesh: DeviceMesh, n: int) -> slice:
    """This rank's contiguous rows of an ``n``-row global batch."""
    d = mesh.size(0)
    if n % d:
        raise ValueError(f"batch of {n} rows does not divide the 'data' axis of {d}")
    i = mesh.get_local_rank("data")
    return slice(i * (n // d), (i + 1) * (n // d))


def shard_batch(batch, mesh: DeviceMesh):
    """This rank's rows of a global host batch (a dict, list or array tree),
    as tensors on the rank's device.  0-d entries stay whole."""
    device = rank_device()

    def put(x):
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
        if t.ndim > 0:
            t = t[data_rows(mesh, t.shape[0])]
        return t.to(device)

    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return [shard_batch(v, mesh) for v in batch]
    return put(batch)
