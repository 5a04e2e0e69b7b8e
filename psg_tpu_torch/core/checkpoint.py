"""``psg_tpu`` checkpoints without JAX (port of ``psg_tpu/core/checkpoint.py``).

A ``psg_tpu`` checkpoint is flax msgpack: a msgpack map whose arrays are
ext type 1 holding ``(shape, dtype name, raw bytes)``, whose lists were
written as maps keyed ``'0'``, ``'1'``, ..., and whose arrays above 1 GiB
are split into ``__msgpack_chunked_array__`` maps.  bf16 arrays (light
checkpoints) come back as torch bf16 tensors.  Beside it, a JSON sidecar
(``.json``) holds the step, stage, metric, epoch, VAE checkpoint, config and
``light`` flag.

The writer (``save_state``, ``CheckpointManager``) writes the same format,
so the JAX package reads what the port trains: parameters and EMA in the JAX
layout (``bridge.to_jax``) under ``params`` and ``ema``; the optimizer state
under ``opt_state`` in the port's own layout, which only the port resumes
from.  Writes are atomic (temporary file, then rename) and a failed write
raises.  Unlike the JAX loader, a checkpoint the caller named that cannot be
read or does not fit the requested architecture raises; it never turns into
random weights.

Async writes (``save_state(..., async_write=True)``, and
``CheckpointManager(async_writes=True)`` or ``PSG_TPU_ASYNC_CKPT=1``; off by
default, as in the JAX package): the caller's thread copies the state into
host memory that nothing else writes (a manager keeps these buffers, pinned
for tensors on the card, and reuses them), and one background thread
serializes that copy and renames it into place.  One write is in flight at
a time: the next write, every read here and interpreter exit join it first,
and its error is raised there once, as ``RuntimeError`` chained from it.  A
sync write that fails raises at once (the JAX package keeps that error for
the next wait as well).  The bytes are the same either way.
"""

from __future__ import annotations

import atexit
import json
import os
import struct
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import msgpack
import numpy as np
import torch

from psg_tpu_torch.core import tree as tree_util
from psg_tpu_torch.models import bridge

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_MAX_EXT_BYTES = 2 ** 32 - 1   # a msgpack ext value's limit


def _array(data: bytes):
    shape, dtype_name, buffer = msgpack.unpackb(data, raw=True)
    shape = tuple(shape)
    if dtype_name == b"bfloat16":
        raw = np.frombuffer(buffer, dtype=np.int16).reshape(shape)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _ext_hook(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _array(data)
    if code == _EXT_NPSCALAR:
        return _array(data)[()]
    raise ValueError(f"unsupported msgpack ext type {code} in checkpoint")


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get("__msgpack_chunked_array__"):
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate([np.asarray(c) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_checkpoint(path):
    """Decode a flax msgpack checkpoint into a raw tree (dicts of numpy
    arrays / bf16 tensors, lists still as ``'0'..'n'``-keyed dicts), after
    any write in flight."""
    wait_for_writes()
    data = Path(path).read_bytes()
    return _unchunk(msgpack.unpackb(data, ext_hook=_ext_hook, raw=False,
                                    strict_map_key=False))


def params_subtree(raw, prefer_ema: bool = False):
    """The parameter subtree of a checkpointed state: its ``ema`` entry when
    asked for and present and non-empty (sampling weights), else ``params``,
    else the whole tree (bare-params checkpoints)."""
    if prefer_ema:
        ema = raw.get("ema")
        if isinstance(ema, dict) and ema:
            return ema
    return raw.get("params", raw)


def load_params(path, template, *, prefer_ema: bool = False):
    """Read ``path`` and map its parameters onto ``template`` (this package's
    layout); raise if the file cannot be read or does not fit."""
    raw = params_subtree(read_checkpoint(path), prefer_ema)
    return bridge.fit(template, bridge.from_jax(raw), str(path))


def load_serving_params(vae_ckpt, diff_ckpt, template):
    """The serving set ``{vae, text, unet}`` from a checkpoint pair.

    - the same path for both: a stage-3 'final' bundle carrying all three;
    - otherwise the VAE checkpoint carries ``{vae, text}`` and the diffusion
      checkpoint the UNet (its EMA weights when the state tracked them).

    A ``None`` path keeps that part of ``template``.  Returns
    ``(params, loaded)`` with ``loaded`` one of "final-bundle", "pair",
    "vae-only", "unet-only", "none".
    """
    wait_for_writes()
    for p in (vae_ckpt, diff_ckpt):
        if p is not None and not Path(p).exists():
            raise FileNotFoundError(f"checkpoint not found: {p}")
    if vae_ckpt is not None and str(vae_ckpt) == str(diff_ckpt):
        return load_params(vae_ckpt, template), "final-bundle"
    out = dict(template)
    loaded = []
    if vae_ckpt is not None:
        vt = load_params(vae_ckpt, {"vae": template["vae"], "text": template["text"]})
        out["vae"], out["text"] = vt["vae"], vt["text"]
        loaded.append("vae")
    if diff_ckpt is not None:
        out["unet"] = load_params(diff_ckpt, template["unet"], prefer_ema=True)
        loaded.append("unet")
    tag = {(): "none", ("vae",): "vae-only", ("unet",): "unet-only",
           ("vae", "unet"): "pair"}[tuple(loaded)]
    return out, tag


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

_DIRECT_BYTES = 1 << 16   # arrays from this size on are written from their own buffer

# the background write in flight (one at a time) and the error it left
_pending: Optional[threading.Thread] = None
_pending_error: Optional[BaseException] = None
_lock = threading.Lock()


def wait_for_writes() -> None:
    """Join the background write in flight, if any, and raise its error
    (once) as ``RuntimeError`` chained from it."""
    global _pending, _pending_error
    with _lock:
        thread, _pending = _pending, None
    if thread is not None:
        thread.join()
    with _lock:
        err, _pending_error = _pending_error, None
    if err is not None:
        raise RuntimeError("async checkpoint write failed") from err


atexit.register(wait_for_writes)   # joins only: a mesh's group may be gone by then


def _array_parts(a):
    """(shape, dtype name, C-contiguous numpy buffer) as flax packs an array."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return list(t.shape), "bfloat16", t.view(torch.int16).numpy()
        a = t.numpy()
    a = np.asarray(a, order="C")
    return list(a.shape), a.dtype.name, a


def _payload(shape, dtype_name, buf) -> bytes:
    return msgpack.packb((shape, dtype_name, buf.tobytes()), use_bin_type=True)


def _write_array(f, packer: msgpack.Packer, a) -> None:
    """One array as an ext value.  From 64 KiB on, msgpack's ext 32 and bin
    32 headers are written here and the array's buffer after them, with no
    copy (a ``write`` of a buffer lets other threads run); the bytes are
    msgpack's."""
    shape, dtype_name, buf = _array_parts(a)
    if buf.nbytes < _DIRECT_BYTES:
        f.write(packer.pack(msgpack.ExtType(_EXT_NDARRAY, _payload(shape, dtype_name, buf))))
        return
    head = (b"\x93" + packer.pack(shape) + packer.pack(dtype_name)
            + b"\xc6" + struct.pack(">I", buf.nbytes))
    size = len(head) + buf.nbytes
    if size > _MAX_EXT_BYTES:
        raise ValueError(f"array of {size} bytes exceeds msgpack's ext limit")
    f.write(b"\xc9" + struct.pack(">Ib", size, _EXT_NDARRAY) + head)
    f.write(memoryview(buf).cast("B"))


def _write(f, packer: msgpack.Packer, obj) -> None:
    """Stream ``obj`` to ``f`` one array at a time.  (flax splits arrays
    above 1 GiB into chunks; its reader takes them whole as well, so this
    writer does not, and raises only past msgpack's 4 GiB limit.)"""
    if isinstance(obj, dict):
        f.write(packer.pack_map_header(len(obj)))
        for k, v in obj.items():
            f.write(packer.pack(str(k)))
            _write(f, packer, v)
    elif isinstance(obj, (list, tuple)):
        _write(f, packer, {str(i): v for i, v in enumerate(obj)})
    elif isinstance(obj, (torch.Tensor, np.ndarray)):
        _write_array(f, packer, obj)
    elif isinstance(obj, np.generic):
        payload = _payload(*_array_parts(np.asarray(obj)))
        f.write(packer.pack(msgpack.ExtType(_EXT_NPSCALAR, payload)))
    else:
        f.write(packer.pack(obj))


def _write_files(paths, tree, sidecar: Optional[str]) -> None:
    """``tree`` to each of ``paths`` (temporary file, then rename) and
    ``sidecar`` (JSON text) beside each."""
    for path in paths:
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(path.suffix + f".{os.getpid()}.tmp")
        try:
            with open(tmp, "wb") as f:
                _write(f, msgpack.Packer(use_bin_type=True, strict_types=True), tree)
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)
        if sidecar is not None:
            side = path.with_suffix(".json")
            side_tmp = side.with_suffix(f".json.{os.getpid()}.tmp")
            side_tmp.write_text(sidecar)
            os.replace(side_tmp, side)


def _background(paths, tree, sidecar) -> None:
    global _pending_error
    try:
        _write_files(paths, tree, sidecar)
    except BaseException as e:   # raised by the next wait_for_writes()
        with _lock:
            _pending_error = e


def _snapshot(tree, buffers: Dict, path=()):
    """``tree`` with every tensor copied into a host buffer of ``buffers``
    (made at the first use of its path, shape and dtype; pinned for a tensor
    on the card) and every numpy array copied, in new containers: what a
    background write may read while the caller's state moves on."""
    if isinstance(tree, dict):
        return {k: _snapshot(v, buffers, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_snapshot(v, buffers, path + (i,)) for i, v in enumerate(tree)]
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        key = (path, tuple(t.shape), t.dtype, t.device)
        if key not in buffers:
            buffers[key] = torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda)
        return buffers[key].copy_(t, non_blocking=t.is_cuda)
    if isinstance(tree, np.ndarray):
        return tree.copy()
    return tree


def _start_write(paths, tree, sidecar: Optional[str], buffers: Dict) -> None:
    """Snapshot ``tree`` (the copies from the card complete before this
    returns) and write it to ``paths`` in a background thread.  The caller
    has joined the write before."""
    global _pending
    snap = _snapshot(tree, buffers)
    for dev in {t.device for _, t in tree_util.items(tree) if isinstance(t, torch.Tensor)
                and t.is_cuda}:
        torch.cuda.current_stream(dev).synchronize()
    thread = threading.Thread(target=_background, args=(list(paths), snap, sidecar),
                              name="checkpoint-writer", daemon=False)
    with _lock:
        _pending = thread
    thread.start()


def save_state(path, state: Dict[str, Any], metadata: Optional[Dict[str, Any]] = None, *,
               async_write: bool = False) -> None:
    """Write ``state`` (a tree of tensors, numpy arrays and plain values) as
    flax msgpack at ``path``, atomically, and ``metadata`` as its sidecar;
    after any write in flight.  ``async_write``: copy ``state`` now and
    write the copy in the background."""
    path = Path(path)
    sidecar = None if metadata is None else json.dumps(metadata, indent=2)
    wait_for_writes()
    if async_write:
        _start_write([path], state, sidecar, {})
    else:
        _write_files([path], state, sidecar)


def load_metadata(path) -> Dict[str, Any]:
    wait_for_writes()
    p = Path(path).with_suffix(".json")
    return json.loads(p.read_text()) if p.exists() else {}


class CheckpointManager:
    """Best-model checkpoint and keep-last-N periodic rotation for one
    training stage, at ``{dir}/{stage}_best_model.ckpt`` and
    ``{dir}/{stage}_step_NNNNNNNN.ckpt``.  ``save`` takes a state with a
    ``to_checkpoint`` method (``train.state.TrainState``).

    ``async_writes`` (``None``: ``PSG_TPU_ASYNC_CKPT=1``; off by default):
    ``save`` and ``save_best_light`` copy the state into this manager's host
    buffers and return; one background thread writes the periodic and the
    best file from that copy.  ``wait()`` joins it; ``restore`` and every
    reader of this module wait first.

    On a mesh every rank keeps the same books and calls ``save`` (a sharded
    state's ``to_checkpoint`` is a collective); only the ``writer`` rank
    writes.  ``sync(failed)`` is a barrier that returns whether any rank
    came with ``failed`` (``train.common.agree``), so a write that fails on
    the writer raises on every rank.  It follows every sync write, so no
    rank reads a file before it is whole; with async writes it moves into
    ``wait()``, which every rank calls before any rank reads or saves."""

    def __init__(self, directory, stage: str, keep: int = 5,
                 async_writes: Optional[bool] = None, *, writer: bool = True, sync=None):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.stage = stage
        self.keep = keep
        self.best_metric = float("inf")
        if async_writes is None:
            async_writes = os.environ.get("PSG_TPU_ASYNC_CKPT", "") == "1"
        self.async_writes = bool(async_writes)
        self.writer = writer
        self.sync = sync
        self._buffers: Dict = {}     # the async snapshots' host memory, reused

    @property
    def best_path(self) -> Path:
        return self.dir / f"{self.stage}_best_model.ckpt"

    def latest_path(self) -> Optional[Path]:
        cks = self._periodic()
        return cks[-1] if cks else None

    def _periodic(self) -> List[Path]:
        return sorted(self.dir.glob(f"{self.stage}_step_*.ckpt"),
                      key=lambda p: int(p.stem.split("_")[-1]))

    def _meta(self, step: int, metric, extra_meta) -> Dict[str, Any]:
        meta = {"step": int(step), "time": time.time(), "stage": self.stage}
        if metric is not None:
            meta["metric"] = float(metric)
        meta.update(extra_meta or {})
        return meta

    def _write(self, paths, tree, meta) -> None:
        """``tree`` to ``paths``, after the caller joined the write before."""
        sidecar = json.dumps(meta, indent=2)
        if self.async_writes:
            _start_write(paths, tree, sidecar, self._buffers)
        else:
            _write_files(paths, tree, sidecar)

    def save(self, state, step: int, metric: Optional[float] = None,
             extra_meta: Optional[Dict[str, Any]] = None, periodic: bool = True) -> bool:
        """Write a periodic checkpoint (rotating out all but the newest
        ``keep``) and, when ``metric`` beats the best so far, the best one.
        Returns True if this became the new best."""
        meta = self._meta(step, metric, extra_meta)
        is_best = metric is not None and metric < self.best_metric
        if not (periodic or is_best):
            return False
        self.wait()     # the write before this one is whole (rotation counts it), or raises
        if not self.writer and getattr(state, "layout", None) is not None:
            state.layout.unplace(state)     # the gathers of to_checkpoint every rank joins
        if is_best:
            self.best_metric = float(metric)
        if self.writer:
            tree = state.to_checkpoint()
            paths, victims = [], []
            if periodic:
                new_path = self.dir / f"{self.stage}_step_{step:08d}.ckpt"
                existing = [p for p in self._periodic() if p != new_path]
                victims = [*existing, new_path][:-self.keep]
                paths.append(new_path)
            if is_best:
                paths.append(self.best_path)
            try:
                self._write(paths, tree, meta)
            except Exception:
                if self.sync is not None and not self.async_writes:
                    self.sync(True)     # the other ranks raise with this one
                raise
            for old in victims:
                old.unlink(missing_ok=True)
                old.with_suffix(".json").unlink(missing_ok=True)
        if self.sync is not None and not self.async_writes and self.sync(False):
            raise RuntimeError("checkpoint write failed on the writer rank")
        return is_best

    def save_best_light(self, sample_params, step: int, metric: float,
                        extra_meta: Optional[Dict[str, Any]] = None) -> bool:
        """Best-model write carrying only the sampling parameters in bf16
        (what serving and the next stage read); returns True if written."""
        if metric >= self.best_metric:
            return False
        if not self.writer:
            raise RuntimeError("a light best is written by a single process only")
        wait_for_writes()
        self.best_metric = float(metric)
        meta = {**self._meta(step, metric, None), "light": True, **(extra_meta or {})}
        light = tree_util.map(
            lambda t: t.to(torch.bfloat16) if t.dtype == torch.float32 else t, sample_params)
        self._write([self.best_path], {"params": bridge.to_jax(light)}, meta)
        return True

    def wait(self) -> None:
        """Join this process's write in flight and raise its error.  With
        async writes on a mesh every rank then meets at ``sync`` and learns
        whether the writer's write failed, so every rank raises (none is left
        in the barrier, or in the next step's collective)."""
        mesh = self.async_writes and self.sync is not None
        try:
            wait_for_writes()
        except RuntimeError:
            if mesh:
                self.sync(True)
            raise
        if mesh and self.sync(False):
            raise RuntimeError("async checkpoint write failed on the writer rank")

    def restore(self, target, best: bool = True):
        """(state, metadata) from the best or the newest periodic
        checkpoint; ``target.from_checkpoint`` maps it onto the caller's
        state.  Every rank of a mesh calls it."""
        self.wait()
        path = self.best_path if best else self.latest_path()
        if path is None or not path.exists():
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        meta = load_metadata(path)
        self.best_metric = meta.get("metric", float("inf"))
        return target.from_checkpoint(read_checkpoint(path)), meta
