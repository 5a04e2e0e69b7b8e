"""Train state (port of ``psg_tpu/train/state.py``): everything a stage
needs to resume, in one object the checkpoint writer saves.

- ``step``       optimizer steps taken (a Python int);
- ``params``     the trained parameter tree (fp32);
- ``opt_state``  the optimizer's state (``train/optim.py``);
- ``rng``        the trainer's ``torch.Generator`` (saved as its state);
- ``ema``        the EMA of the parameters for sampling, or ``None``;
- ``layout``     on a mesh with a 'model' axis, the ``ShardLayout`` the
                 params, EMA and Adam moments are cut by (each rank holds
                 its shards; ``parallel/sharding.py``), else ``None``.

``to_checkpoint`` lays it out as the JAX package's ``TrainState`` is saved:
``params`` and ``ema`` in the JAX layout, so ``psg_tpu``'s ``load_params``
and ``load_sample_params`` read them; ``opt_state`` and ``rng`` in the
port's own layout, which only ``from_checkpoint`` reads back.  A sharded
state is gathered first, so a checkpoint is the same from any mesh; both
are collectives then, which every rank of the mesh calls.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

import numpy as np
import torch

from psg_tpu_torch.core import tree
from psg_tpu_torch.models import bridge


@dataclass
class TrainState:
    step: int
    params: Any
    opt_state: Dict[str, Any]
    rng: torch.Generator
    ema: Optional[Any] = None
    layout: Optional[Any] = None

    @property
    def sample_params(self):
        """EMA params when tracked, else the live params."""
        return self.ema if self.ema is not None else self.params

    def to_checkpoint(self) -> Dict[str, Any]:
        """The checkpoint tree: its tensors are detached views of the state,
        on its device, which the checkpoint writer copies."""
        if self.layout is not None:
            return self.layout.unplace(self).to_checkpoint()
        return {"step": np.asarray(self.step, np.int32),
                "params": bridge.to_jax(self.params),
                "opt_state": _opt_to_checkpoint(self.opt_state),
                "rng": self.rng.get_state().numpy(),
                "ema": bridge.to_jax(self.ema) if self.ema is not None else {}}

    def from_checkpoint(self, raw) -> "TrainState":
        """This state's structure, shapes, dtypes and devices filled from a
        checkpoint it wrote; raises on any mismatch.  A sharded state is
        filled whole and cut to its shards again."""
        if self.layout is not None:
            return self.layout.place(self.layout.unplace(self).from_checkpoint(raw))
        params = tree.map(lambda t, ref: t.requires_grad_(ref.requires_grad),
                          bridge.fit(self.params, bridge.from_jax(raw["params"]), "params"),
                          self.params)
        ema = None
        if self.ema is not None:
            ema = bridge.fit(self.ema, bridge.from_jax(raw["ema"]), "ema")
        opt_state = _opt_from_checkpoint(self.opt_state, raw["opt_state"])
        self.rng.set_state(torch.from_numpy(np.array(raw["rng"], np.uint8)))
        return replace(self, step=int(raw["step"]), params=params, ema=ema,
                       opt_state=opt_state)


def _opt_to_checkpoint(state):
    """Tensors detached; plain values as they are."""
    return tree.map(lambda x: x.detach() if isinstance(x, torch.Tensor) else x, state)


def _opt_from_checkpoint(template, raw):
    if isinstance(template, dict):
        if set(template) != set(raw):
            raise ValueError(f"opt_state: expected keys {sorted(template)}, "
                             f"got {sorted(raw)}")
        return {k: _opt_from_checkpoint(v, raw[k]) for k, v in template.items()}
    if isinstance(template, torch.Tensor):
        t = raw if isinstance(raw, torch.Tensor) else torch.from_numpy(np.array(raw))
        if tuple(t.shape) != tuple(template.shape):
            raise ValueError(f"opt_state: shape {tuple(t.shape)} != "
                             f"{tuple(template.shape)}")
        return t.to(device=template.device, dtype=template.dtype)
    return type(template)(raw)
