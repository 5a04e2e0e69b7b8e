"""Starting the process group, and the multi-node mesh (port of
``psg_tpu/parallel/multihost.py``).

The port runs one process per device.  ``initialize_distributed`` starts
the ``torch.distributed`` group: NCCL when this rank's device is a card,
gloo on the CPU.  It resolves the layout from, in order:

1. its arguments;
2. ``PSG_TPU_COORDINATOR_ADDRESS`` (``host:port``), ``PSG_TPU_NUM_PROCESSES``
   and ``PSG_TPU_PROCESS_ID``;
3. torchrun's ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``
   (in place of the cloud-TPU markers the JAX package detects).

With none of them it does nothing and returns False, so a single-process
run never pays for it; once the group is up a second call returns True.
Every group is started with a timeout, so a rank that never arrives fails
the others instead of hanging them.

``make_multihost_mesh`` keeps each 'model' group inside one node (torchrun
numbers ranks node by node; ``LOCAL_WORLD_SIZE`` is the ranks a node
runs), so only the 'data' reduction crosses nodes.

``python -m psg_tpu_torch.parallel.multihost <pid> <nprocs> <port>`` is one
rank of a gloo group on localhost: a data-parallel step over a
process-local slice of a global batch, which prints an ``MPSMOKE`` line
that every rank must print identically.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600.0


def _local_index(process_id: int, local_device_ids: Optional[Sequence[int]]) -> int:
    if local_device_ids:
        return int(local_device_ids[0])
    if os.environ.get("LOCAL_RANK") is not None:
        return int(os.environ["LOCAL_RANK"])
    return process_id % max(torch.cuda.device_count(), 1)


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids: Optional[Sequence[int]] = None, *,
                           device=None,
                           timeout_s: float = DEFAULT_TIMEOUT_S) -> bool:
    """Start the process group when a layout is configured; return whether
    one is up.  ``device``: this rank's device type, ``"cuda"`` (NCCL; the
    default, which raises without a card) or ``"cpu"`` (gloo).
    ``local_device_ids``: the card this rank drives (else ``LOCAL_RANK``,
    else the rank modulo the node's cards)."""
    if dist.is_initialized():
        return True
    env = os.environ
    coord = coordinator_address or env.get("PSG_TPU_COORDINATOR_ADDRESS")
    nproc = num_processes if num_processes is not None else env.get("PSG_TPU_NUM_PROCESSES")
    pid = process_id if process_id is not None else env.get("PSG_TPU_PROCESS_ID")
    if coord is None and env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
        coord = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        nproc = nproc if nproc is not None else env["WORLD_SIZE"]
        pid = pid if pid is not None else env.get("RANK")
    if coord is None:
        return False
    if nproc is None or pid is None:
        raise ValueError(f"coordinator {coord} given without the number of processes "
                         f"and this process's id")
    nproc, pid = int(nproc), int(pid)
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass device='cpu' for gloo")
        torch.cuda.set_device(_local_index(pid, local_device_ids))
        backend = "nccl"
    elif device.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"unsupported device {device}")
    dist.init_process_group(backend, init_method=f"tcp://{coord}", world_size=nproc,
                            rank=pid, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def make_multihost_mesh(data: int = -1, model: int = 1):
    """A ('data', 'model') mesh over every rank whose 'model' groups stay
    inside one node.  Single-node, this is ``make_mesh``."""
    from psg_tpu_torch.parallel.mesh import make_mesh

    world = dist.get_world_size() if dist.is_initialized() else 1
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if model > 1 and n_local % model != 0:
        raise ValueError(f"model={model} does not divide the {n_local} per-node "
                         f"ranks: a TP group would straddle nodes")
    return make_mesh(data=data, model=model)


# ---------------------------------------------------------------------------
# Smoke worker: a real multi-process group on localhost.
# ---------------------------------------------------------------------------


def _smoke_worker(process_id: int, num_processes: int, port: int) -> None:
    """One rank of a gloo group on localhost: the group, the mesh, this
    process's slice of a global batch, three SGD steps of a linear model
    whose gradient is averaged over 'data' by the trainers' reducer; prints
    the line the parent compares across ranks."""
    import numpy as np

    from psg_tpu_torch.parallel.mesh import data_rows, mesh_shape
    from psg_tpu_torch.train.common import GradReducer

    torch.set_num_threads(1)
    ok = initialize_distributed(f"127.0.0.1:{port}", num_processes, process_id,
                                device="cpu", timeout_s=120)
    assert ok and dist.get_world_size() == num_processes
    mesh = make_multihost_mesh(data=num_processes, model=1)

    global_batch, feat = 2 * num_processes, 8
    rng = np.random.RandomState(0)
    x_all = torch.from_numpy(rng.randn(global_batch, feat).astype(np.float32))
    y_all = torch.from_numpy(rng.randn(global_batch, 1).astype(np.float32))
    rows = data_rows(mesh, global_batch)
    x, y = x_all[rows], y_all[rows]
    w = torch.zeros(feat, 1, requires_grad=True)
    b = torch.zeros(1, requires_grad=True)
    reducer = GradReducer(mesh.get_group("data"))
    loss = None
    for _ in range(3):
        loss = ((x @ w + b - y) ** 2).mean()
        grads = reducer.mean(list(torch.autograd.grad(loss, [w, b])))
        loss = reducer.mean_scalar(loss.detach())
        with torch.no_grad():
            w -= 0.1 * grads[0]
            b -= 0.1 * grads[1]
    loss_v, w_sum = float(loss), float(w.sum())
    assert np.isfinite(loss_v) and np.isfinite(w_sum)
    print(f"MPSMOKE pid={process_id} loss={loss_v:.10f} wsum={w_sum:.10f} "
          f"procs={dist.get_world_size()} mesh={mesh_shape(mesh)}", flush=True)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import sys

    _smoke_worker(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]))
