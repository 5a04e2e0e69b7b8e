"""Noise schedule (port of ``psg_tpu/diffusion/schedule.py``).

Tables are fp32, built with numpy on the host in the reference's order of
operations, and kept as CPU tensors: the samplers read per-step scalars from
them, and the per-sample gathers (``add_noise``, ``velocity``,
``eps_from_v``) read a copy on the model's device, made once per table and
device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch

_F32 = np.float32


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """``jnp.linspace(start, stop, num)`` in fp32, bit for bit.

    JAX computes ``start * (1 - i/div) + stop * (i/div)`` and XLA rewrites it
    to ``fma(i, stop * r, start * (1 - i * r))`` with ``r = fp32(1/div)``.
    ``torch.linspace``, numpy's fp64 linspace cast to fp32 and the formula
    as written all round some entries differently, which moves integer
    timestep tables (``round(linspace(T-1, 0, steps))``) by one step.
    """
    if num == 1:
        return np.array([start], _F32)
    div = num - 1
    i = np.arange(div, dtype=_F32)
    r = _F32(1) / _F32(div)
    s, e = _F32(start), _F32(stop)
    head = s * (_F32(1) - i * r)
    # single-rounding multiply-add: the fp32 product is exact in fp64
    out = (i.astype(np.float64) * np.float64(e * r) + head.astype(np.float64))
    return np.concatenate([out.astype(_F32), [e]]).astype(_F32)


@dataclass(frozen=True)
class DiffusionSchedule:
    """Precomputed diffusion tables (fp32 CPU tensors, length T)."""

    betas: torch.Tensor
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas: torch.Tensor
    posterior_variance: torch.Tensor
    _on_device: Dict = field(default_factory=dict, compare=False, repr=False)

    @property
    def num_timesteps(self) -> int:
        return self.betas.shape[0]

    def _at(self, table, timesteps, like):
        """table[timesteps] on ``like``'s device, shaped to broadcast over it."""
        shape = (-1,) + (1,) * (like.ndim - 1)
        key = (id(table), like.device)
        if key not in self._on_device:
            self._on_device[key] = table.to(like.device)
        return self._on_device[key][timesteps.long()].reshape(shape)

    def add_noise(self, x0, noise, timesteps):
        """q_sample: sqrt(acp_t) x0 + sqrt(1-acp_t) eps, in fp32."""
        return (self._at(self.sqrt_alphas_cumprod, timesteps, x0) * x0.float()
                + self._at(self.sqrt_one_minus_alphas_cumprod, timesteps, x0)
                * noise.float())

    def velocity(self, x0, noise, timesteps):
        """v-prediction target: sqrt(acp_t) eps - sqrt(1-acp_t) x0, in fp32."""
        return (self._at(self.sqrt_alphas_cumprod, timesteps, x0) * noise.float()
                - self._at(self.sqrt_one_minus_alphas_cumprod, timesteps, x0)
                * x0.float())

    def eps_from_v(self, v, x_t, timesteps):
        """eps = sqrt(acp_t) v + sqrt(1-acp_t) x_t for a v-prediction model."""
        shape = (-1,) + (1,) * (v.ndim - 1)
        t = timesteps.cpu().long()
        sa = self.sqrt_alphas_cumprod[t].to(v.device).reshape(shape)
        so = self.sqrt_one_minus_alphas_cumprod[t].to(v.device).reshape(shape)
        return sa * v.float() + so * x_t.float()


def _cosine_betas(timesteps: int, beta_start: float, beta_end: float,
                  s: float = 0.008):
    """Nichol & Dhariwal cosine schedule, clipped into [beta_start, beta_end]."""
    x = linspace_f32(0.0, timesteps, timesteps + 1)
    acp = np.cos(((x / _F32(timesteps)) + _F32(s)) / _F32(1 + s)
                 * _F32(math.pi) * _F32(0.5)) ** 2
    acp = acp / acp[0]
    betas = _F32(1) - (acp[1:] / acp[:-1])
    return np.clip(betas, _F32(beta_start), _F32(beta_end)).astype(_F32)


def make_schedule(num_timesteps: int = 1000, beta_start: float = 1e-4,
                  beta_end: float = 0.02, kind: str = "cosine") -> DiffusionSchedule:
    if kind == "linear":
        betas = linspace_f32(beta_start, beta_end, num_timesteps)
    elif kind == "cosine":
        betas = _cosine_betas(num_timesteps, beta_start, beta_end)
    else:
        raise ValueError(f"unknown beta schedule {kind!r}")
    alphas = (_F32(1) - betas).astype(_F32)
    acp = np.cumprod(alphas, dtype=_F32)
    acp_prev = np.concatenate([np.ones(1, _F32), acp[:-1]])
    sqrt_acp = np.maximum(np.sqrt(acp), _F32(1e-8))
    sqrt_om = np.maximum(np.sqrt(_F32(1) - acp), _F32(1e-8))
    post_var = np.maximum(betas * (_F32(1) - acp_prev) / (_F32(1) - acp), _F32(1e-20))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=_F32))  # noqa: E731
    return DiffusionSchedule(
        betas=t(betas),
        alphas=t(alphas),
        alphas_cumprod=t(acp),
        alphas_cumprod_prev=t(acp_prev),
        sqrt_alphas_cumprod=t(sqrt_acp),
        sqrt_one_minus_alphas_cumprod=t(sqrt_om),
        sqrt_recip_alphas=t(np.sqrt(_F32(1) / alphas)),
        posterior_variance=t(post_var),
    )
