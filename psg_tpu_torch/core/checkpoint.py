"""Read ``psg_tpu`` checkpoints without JAX (read side of
``psg_tpu/core/checkpoint.py``).

A ``psg_tpu`` checkpoint is flax msgpack: a msgpack map whose arrays are
ext type 1 holding ``(shape, dtype name, raw bytes)``, whose lists were
written as maps keyed ``'0'``, ``'1'``, ..., and whose arrays above 1 GiB
are split into ``__msgpack_chunked_array__`` maps.  bf16 arrays (light
checkpoints) come back as torch bf16 tensors.

Unlike the JAX loader, a checkpoint the caller named that cannot be read or
does not fit the requested architecture raises; it never turns into random
weights.
"""

from __future__ import annotations

from pathlib import Path

import msgpack
import numpy as np
import torch

from psg_tpu_torch.models import bridge

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3


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
    arrays / bf16 tensors, lists still as ``'0'..'n'``-keyed dicts)."""
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
