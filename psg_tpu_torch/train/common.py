"""Helpers every training stage shares (the JAX package keeps them in
``psg_tpu/train/stage1_vae.py``, which stage 2 imports), and a trainer's
part of a mesh (``MeshRun``).

On a mesh the JAX trainers are single-controller: one process loads the
global batch and every draw of a step has the global shape.  The port runs
one process per device, and ``MeshRun`` makes its step equal the
single-process one:

- every rank loads the same global batch and keeps its rows (``batch``);
- every draw is made at the global shape from the step's generator and cut
  to the rank's rows (``draws``, ``core/draws.py``);
- a rank's loss is scaled so that the average over 'data' is the global
  loss, sample weights included (``loss_scale``), and gradients are
  averaged over 'data' through persistent flat buckets (``GradReducer``),
  after each sharded leaf's gradient is reduce-scattered over 'model'
  (``parallel/sharding.py``);
- rank 0 writes checkpoints, logs and sample grids, and a barrier follows
  every checkpoint write (with async writes it moves into
  ``CheckpointManager.wait()``, which every rank calls).
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from psg_tpu_torch.core.checkpoint import CheckpointManager
from psg_tpu_torch.core.draws import RowDraws
from psg_tpu_torch.core.metrics import MetricsWriter, setup_logging
from psg_tpu_torch.parallel.mesh import data_rows, mesh_shape, rank_device
from psg_tpu_torch.parallel.sharding import ShardLayout, unet_tp_rules
from psg_tpu_torch.text.tokenizer import WordPieceTokenizer

_BUCKET_BYTES = 256 << 20


def device_batch(batch, device):
    """A loader batch's image, ids and mask (and CLIP's BPE ids and mask
    where the batch has them) as tensors on ``device``."""
    out = {"image": torch.from_numpy(np.asarray(batch["image"])).to(device)}
    for k in ("text_ids", "text_mask", "clip_ids", "clip_mask"):
        if k in batch:
            out[k] = torch.from_numpy(np.asarray(batch[k])).long().to(device)
    return out


def stage_io(stage_dir: Path, stage: str, mesh=None, device=None):
    """A stage's (checkpoint manager, logger, metrics writer).  On a mesh
    only rank 0 writes and logs, and a barrier follows each checkpoint
    write (or each ``wait()`` with async writes, which ``PSG_TPU_ASYNC_CKPT``
    turns on); the mesh's ranks must run on ``device``'s type."""
    if mesh is not None and rank_device().type != torch.device(device).type:
        raise ValueError(f"the mesh's ranks run on {rank_device()}, not {device}")
    writer = mesh is None or dist.get_rank() == 0
    return (CheckpointManager(stage_dir / "checkpoints", stage, writer=writer,
                              sync=None if mesh is None else agree),
            setup_logging(stage_dir / "logs", stage, writer=writer),
            MetricsWriter(stage_dir / "logs", enabled=writer))


def barrier() -> None:
    """Every rank of the group waits here (on its card under NCCL)."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def agree(failed: bool = False) -> bool:
    """A barrier that also tells every rank whether any rank came with
    ``failed`` (a checkpoint write that raised on the writer rank)."""
    flag = torch.tensor([int(failed)], dtype=torch.int32, device=rank_device())
    dist.all_reduce(flag, op=dist.ReduceOp.MAX)
    return bool(flag.item())


def get_tokenizer(cfg, stage_dir: Path, corpus=None, mesh=None) -> WordPieceTokenizer:
    """vocab.txt resolution: the stage dir, the experiment dir,
    ``config/vocab.txt``; then the pretrained-BERT vocabulary when both
    ``$PSG_TPU_BERT`` and ``$PSG_TPU_BERT_VOCAB`` exist; else a vocabulary
    built from ``corpus``.  The winner is saved to the stage dir, so later
    stages resolve the same one.  On a mesh rank 0 resolves (and saves)
    first, then the others read what it chose."""
    if mesh is not None:
        tok = _get_tokenizer(cfg, stage_dir, corpus) if dist.get_rank() == 0 else None
        barrier()
        return tok if tok is not None else _get_tokenizer(cfg, stage_dir, corpus)
    return _get_tokenizer(cfg, stage_dir, corpus)


def _get_tokenizer(cfg, stage_dir: Path, corpus=None) -> WordPieceTokenizer:
    for cand in (stage_dir / "vocab.txt", Path(cfg.experiment_dir) / "vocab.txt",
                 Path("config/vocab.txt")):
        if cand.exists():
            return WordPieceTokenizer.from_vocab_file(cand)
    bert_ckpt = Path(os.environ.get("PSG_TPU_BERT", "weights/bert_base.ckpt"))
    bert_vocab = Path(os.environ.get("PSG_TPU_BERT_VOCAB", "weights/bert_vocab.txt"))
    if bert_vocab.exists() and bert_ckpt.exists():
        tok = WordPieceTokenizer.from_vocab_file(bert_vocab)
    elif corpus is not None:
        tok = WordPieceTokenizer.from_corpus(corpus)
    else:
        raise FileNotFoundError("no vocab.txt found and no corpus provided")
    stage_dir.mkdir(parents=True, exist_ok=True)
    tok.save_vocab(stage_dir / "vocab.txt")
    return tok


# ---------------------------------------------------------------------------
# data parallelism over a mesh
# ---------------------------------------------------------------------------


class GradReducer:
    """Averages a list of tensors over a process group through flat buckets
    of at most 256 MiB (one collective a bucket, not one a leaf).  The
    buckets are allocated at the first call and kept; the returned tensors
    are views into them, valid until the next call."""

    def __init__(self, group):
        self.group = group
        self._key = None
        self._buckets: List[torch.Tensor] = []
        self._views: List[List[torch.Tensor]] = []
        self._order: List[List[int]] = []

    def _build(self, xs) -> None:
        self._buckets, self._views, self._order = [], [], []
        by_dtype = {}
        for i, x in enumerate(xs):
            by_dtype.setdefault((x.dtype, x.device), []).append(i)
        for (dtype, device), idx in by_dtype.items():
            start = 0
            while start < len(idx):
                size, end = 0, start
                while end < len(idx) and (end == start or size + xs[idx[end]].numel()
                                          * xs[idx[end]].element_size() <= _BUCKET_BYTES):
                    size += xs[idx[end]].numel() * xs[idx[end]].element_size()
                    end += 1
                members = idx[start:end]
                flat = torch.empty(sum(xs[i].numel() for i in members), dtype=dtype,
                                   device=device)
                views, off = [], 0
                for i in members:
                    views.append(flat[off:off + xs[i].numel()].view(xs[i].shape))
                    off += xs[i].numel()
                self._buckets.append(flat)
                self._views.append(views)
                self._order.append(members)
                start = end
        self._key = [(tuple(x.shape), x.dtype, x.device) for x in xs]

    @property
    def bucket_bytes_total(self) -> int:
        return sum(b.numel() * b.element_size() for b in self._buckets)

    def mean(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        xs = list(xs)
        if [(tuple(x.shape), x.dtype, x.device) for x in xs] != self._key:
            self._build(xs)
        out: List[Optional[torch.Tensor]] = [None] * len(xs)
        for flat, views, members in zip(self._buckets, self._views, self._order):
            torch._foreach_copy_(views, [xs[i] for i in members])
            dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=self.group)
            for i, v in zip(members, views):
                out[i] = v
        return out

    def mean_scalar(self, x: torch.Tensor) -> torch.Tensor:
        x = x.detach().clone()
        dist.all_reduce(x, op=dist.ReduceOp.AVG, group=self.group)
        return x

    def sum_scalar(self, x: torch.Tensor) -> torch.Tensor:
        x = x.detach().clone()
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=self.group)
        return x


class MeshRun:
    """A trainer's (or the generator's) part of a ('data', 'model') mesh:
    its rows, its draws, the collectives of a step, and whether it writes.

    ``params`` and ``rule`` give the tensor-parallel layout (over 'model',
    ``parallel/sharding.py``); the default rule is ``unet_tp_rules`` at
    ``tp_min_channels`` when the mesh has a 'model' axis above 1."""

    def __init__(self, mesh, params=None, rule=None, *, tp_min_channels: int = 640):
        self.mesh = mesh
        self.shape = mesh_shape(mesh)
        self.n_data = self.shape["data"]
        self.data_group = mesh.get_group("data")
        if rule is None and self.shape["model"] > 1:
            rule = unet_tp_rules(tp_min_channels)
        self.layout = ShardLayout(params, mesh, rule) if params is not None else None
        self.reducer = GradReducer(self.data_group)
        self.writer = dist.get_rank() == 0

    # -- rows and draws ------------------------------------------------------

    def rows(self, n: int) -> slice:
        return data_rows(self.mesh, n)

    def local(self, batch):
        """This rank's rows of every batch-shaped array or tensor of a
        (nested) batch; 0-d entries and plain values stay whole."""
        if isinstance(batch, dict):
            return {k: self.local(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return [self.local(v) for v in batch]
        if isinstance(batch, (np.ndarray, torch.Tensor)) and batch.ndim > 0:
            return batch[self.rows(batch.shape[0])]
        return batch

    def draws(self, generator, n_local: int) -> RowDraws:
        """Draws at the global batch (``n_local`` rows a rank) cut to this
        rank's rows."""
        n = n_local * self.n_data
        return RowDraws(generator, self.rows(n), n)

    def gather_rows(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """Every rank's rows all-gathered over 'data', cut to ``n``."""
        x = x.contiguous()
        out = torch.empty((self.n_data * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=self.data_group)
        return out[:n]

    # -- a step ----------------------------------------------------------------

    def gather(self, params):
        """The whole parameters for compute (all-gathered over 'model')."""
        return self.layout.gather(params) if self.layout is not None else params

    def loss_scale(self, sample_weights, n_local: int):
        """The factor that makes a rank's loss, averaged over 'data', the
        loss of the global batch.  A loss ``sum(l*w) / max(sum(w), 1)`` over
        the rank's rows times ``D * max(s, 1) / max(S, 1)`` (s the rank's
        weight sum, S the global one, D ranks) averages to the global
        ``sum(l*w) / max(S, 1)``; without weights (equal rows) the factor
        is 1."""
        if sample_weights is None:
            return 1.0
        s = sample_weights.detach().float().sum()
        total = self.reducer.sum_scalar(s)
        return self.n_data * s.clamp_min(1.0) / total.clamp_min(1.0)

    def reduce_grads(self, paths, grads) -> List[torch.Tensor]:
        """Whole gradients -> this rank's shards, averaged over 'model' and
        'data'."""
        if self.layout is not None:
            grads = [self.layout.scatter(p, g) for p, g in zip(paths, grads)]
        return self.reducer.mean(grads)

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` averaged over 'data' (a scaled loss -> the global loss)."""
        return self.reducer.mean_scalar(x)

    @staticmethod
    def whole(mesh_run, params):
        """``params`` whole: gathered over 'model' on a mesh, else as they are."""
        return mesh_run.gather(params) if mesh_run is not None else params

    def place(self, state):
        """The train state cut by the layout (params, EMA, moments)."""
        if self.layout is None or not self.layout.sharded:
            return state
        return self.layout.place(state)

    def split_rows(self, generator, n: int, *xs):
        """For a job of ``n`` rows (a sample grid, a batch request) padded to
        a multiple of 'data' by repeating its last row: draws at the global
        shape of the ``n`` real rows cut to this rank's rows of the padded
        job, and this rank's rows of each ``x``."""
        n_pad = -(-n // self.n_data) * self.n_data
        rows = self.rows(n_pad)
        pad = [x[-1:].expand((n_pad - n,) + tuple(x.shape[1:])) for x in xs]
        return (RowDraws(generator, rows, n_pad, n),
                [torch.cat([x, p])[rows] for x, p in zip(xs, pad)])

    def step_inputs(self, state, n_local: int, draws):
        """(generator, draws, params) of a training step on this rank: the
        step's draws at the global shape, this rank's rows of injected
        ``draws``, the whole params."""
        return (self.draws(state.rng, n_local), self.local(draws),
                self.gather(state.params))

    def eval_inputs(self, generator, n_local: int, params):
        """(generator, first row, params) of a validation batch on this
        rank: the draws at the global shape, the global index of this
        rank's first row (to weight the padded tail), the whole params."""
        return (self.draws(generator, n_local), self.rows(n_local * self.n_data).start,
                self.gather(params))

    def mean_parts(self, parts: dict) -> dict:
        """Each scalar of ``parts`` averaged over 'data' (one collective)."""
        keys = list(parts)
        vals = self.mean(torch.stack([parts[k].detach().float() for k in keys]))
        return dict(zip(keys, vals.unbind(0)))

    def write(self, fn):
        """``fn()`` on rank 0, then a barrier; returns its result there."""
        out = fn() if self.writer else None
        self.barrier()
        return out

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank."""
        x = x.clone()
        dist.broadcast(x, src=0)
        return x

    def barrier(self) -> None:
        barrier()
