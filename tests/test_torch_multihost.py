"""The port's process group and mesh (``psg_tpu_torch/parallel/multihost.py``
and ``mesh.py``) on the CPU with gloo, the twin of tests/test_multihost.py:
the no-op and the resolution order of ``initialize_distributed`` (explicit
arguments, then ``PSG_TPU_*``, then torchrun's variables), its timeout and
its refusal to start NCCL without a card, idempotence on a real one-rank
group, mesh shapes and errors, ``make_multihost_mesh``, the rows
``shard_batch`` keeps, the loader's process slices, and two smoke workers
(``python -m psg_tpu_torch.parallel.multihost``) printing identical lines.
The multi-rank layouts run in tests/test_torch_parallel.py."""

import datetime
import os
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from psg_tpu_torch.data.dataset import PokemonDataset, split_indices
from psg_tpu_torch.data.loader import Loader
from psg_tpu_torch.data.synthetic import write_sprite_corpus
from psg_tpu_torch.parallel import (
    batch_sharding,
    initialize_distributed,
    make_mesh,
    make_multihost_mesh,
    replicated,
    shard_batch,
)
from psg_tpu_torch.parallel import multihost
from psg_tpu_torch.parallel.mesh import data_rows, mesh_shape

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
ENV = ("PSG_TPU_COORDINATOR_ADDRESS", "PSG_TPU_NUM_PROCESSES", "PSG_TPU_PROCESS_ID",
       "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "LOCAL_WORLD_SIZE")


def _port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def clean_env(monkeypatch):
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


@pytest.fixture
def recorded(clean_env):
    """init_process_group recorded instead of run (no group is up)."""
    calls = []
    clean_env.setattr(multihost.dist, "is_initialized", lambda: False)
    clean_env.setattr(multihost.dist, "init_process_group",
                      lambda *a, **kw: calls.append((a, kw)))
    return calls


@pytest.fixture(scope="module")
def group():
    """A real one-rank gloo group in this process, torn down after."""
    assert not dist.is_initialized()
    assert initialize_distributed(f"127.0.0.1:{_port()}", 1, 0, device="cpu", timeout_s=60)
    yield
    dist.destroy_process_group()


def test_initialize_distributed_noop_without_config(clean_env):
    assert initialize_distributed(device="cpu") is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("source", ["args", "psg_env", "torchrun_env"])
def test_initialize_distributed_resolution_order(recorded, clean_env, source):
    """Explicit arguments win over PSG_TPU_*, which win over torchrun's
    variables; gloo on the CPU, always with a timeout."""
    clean_env.setenv("MASTER_ADDR", "10.0.0.3")
    clean_env.setenv("MASTER_PORT", "2222")
    clean_env.setenv("WORLD_SIZE", "8")
    clean_env.setenv("RANK", "5")
    if source != "torchrun_env":
        clean_env.setenv("PSG_TPU_COORDINATOR_ADDRESS", "10.0.0.2:1111")
        clean_env.setenv("PSG_TPU_NUM_PROCESSES", "4")
        clean_env.setenv("PSG_TPU_PROCESS_ID", "3")
    args = ("10.0.0.1:9999", 2, 1) if source == "args" else ()
    assert initialize_distributed(*args, device="cpu", timeout_s=42) is True
    (a, kw), = recorded
    want = {"args": ("10.0.0.1:9999", 2, 1), "psg_env": ("10.0.0.2:1111", 4, 3),
            "torchrun_env": ("10.0.0.3:2222", 8, 5)}[source]
    assert a == ("gloo",)
    assert (kw["init_method"], kw["world_size"], kw["rank"]) == (f"tcp://{want[0]}",
                                                                  *want[1:])
    assert kw["timeout"] == datetime.timedelta(seconds=42)


def test_initialize_distributed_needs_the_whole_layout_and_a_card(recorded, clean_env):
    with pytest.raises(ValueError):
        initialize_distributed("127.0.0.1:1234", device="cpu")
    if not torch.cuda.is_available():      # NCCL is the default: no silent gloo
        with pytest.raises(RuntimeError):
            initialize_distributed("127.0.0.1:1234", 1, 0)
    assert recorded == []


def test_group_is_idempotent_and_meshes_shape_and_raise(group, clean_env):
    assert initialize_distributed("127.0.0.1:1", 7, 3, device="cpu") is True
    assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
    mesh = make_mesh()
    assert mesh_shape(mesh) == {"data": 1, "model": 1}
    assert mesh.mesh_dim_names == ("data", "model") and mesh.device_type == "cpu"
    assert mesh_shape(make_mesh(data=1, model=1, devices=[0])) == {"data": 1, "model": 1}
    with pytest.raises(ValueError):
        make_mesh(data=2, model=1)                 # 2x1 != 1 device
    with pytest.raises(ValueError):
        make_mesh(model=2)                         # 1 device not divisible by 2
    assert mesh_shape(make_multihost_mesh()) == {"data": 1, "model": 1}
    clean_env.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError):                # a TP group would straddle nodes
        make_multihost_mesh(data=1, model=2)
    assert [str(p) for p in batch_sharding(mesh, 4)] == ["S(0)", "R"]
    assert [str(p) for p in replicated(mesh)] == ["R", "R"]


def test_shard_batch_keeps_this_ranks_rows(group):
    mesh = make_mesh()
    batch = {"image": np.arange(24, dtype=np.float32).reshape(4, 6), "valid": np.int32(3),
             "ids": [np.arange(8).reshape(4, 2)]}
    out = shard_batch(batch, mesh)
    assert torch.equal(out["image"], torch.from_numpy(batch["image"]))
    assert int(out["valid"]) == 3 and out["valid"].ndim == 0
    assert torch.equal(out["ids"][0], torch.arange(8).reshape(4, 2))


def test_data_rows_split_contiguously():
    """Rank d of D keeps rows [d*n/D, (d+1)*n/D); a batch that does not
    divide raises."""
    class Mesh:
        def __init__(self, d, i):
            self.d, self.i = d, i

        def size(self, dim):
            return self.d

        def get_local_rank(self, name):
            return self.i

    assert [data_rows(Mesh(4, i), 8) for i in range(4)] == [
        slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]
    with pytest.raises(ValueError):
        data_rows(Mesh(4, 0), 6)


def test_loader_process_slices_partition_global_batch(tmp_path):
    """Every process's Loader yields the same global plan cut into
    contiguous row blocks that concatenate to the single-process batch."""
    csv, images = write_sprite_corpus(tmp_path / "corpus", n=12, seed=0, size=64)
    ds = PokemonDataset(csv, images, image_size=64)
    tr, _, _ = split_indices(len(ds), 0.15, 0.05, seed=42)
    kw = dict(train=True, seed=7, augment=False, num_workers=1)
    whole = list(Loader(ds, tr, 4, **kw))
    parts = [list(Loader(ds, tr, 4, process_index=i, process_count=2, **kw))
             for i in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) > 0
    for b_all, b0, b1 in zip(whole, *parts):
        assert b0["image"].shape[0] == b1["image"].shape[0] == 2
        for k in ("image", "national_number"):
            np.testing.assert_array_equal(b_all[k], np.concatenate([b0[k], b1[k]]))


def test_two_process_smoke_workers_print_identical_lines():
    """``python -m psg_tpu_torch.parallel.multihost <pid> 2 <port>``: a
    two-rank gloo group, a data-parallel step over each process's slice of
    a global batch; both print the same loss and weights."""
    port = _port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "psg_tpu_torch.parallel.multihost",
                               str(i), "2", str(port)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), outs
    lines = [next(ln for ln in o.splitlines() if ln.startswith("MPSMOKE")) for o in outs]
    strip = [re.sub(r"pid=\d+ ", "", ln) for ln in lines]
    assert strip[0] == strip[1], lines
    assert "procs=2" in lines[0] and "'data': 2" in lines[0]
