"""Samplers on the serving path (port of ``psg_tpu/diffusion/sampling.py``):
DDIM and DPM-Solver++(2M).

A Python loop over the steps takes the place of ``lax.scan``; the per-step
coefficients are fp32 host scalars from tables built as the reference builds
them.  ``generator`` (a ``torch.Generator`` on the model's device) takes the
place of the PRNG key: it draws the prior when no ``initial_latent`` is
given.  Both samplers are deterministic from there (DDIM at eta 0: the
reference's eta > 0 has no caller and is not ported).  Both take
``denoise_fn(x_t, t_batch) -> eps_hat``; classifier-free guidance lives in
that function (the generator fuses both branches into one UNet call).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from psg_tpu_torch.diffusion.schedule import DiffusionSchedule, linspace_f32

_F32 = np.float32


def _init_latent(generator, shape, initial_latent):
    if initial_latent is not None:
        return initial_latent.float()
    return torch.randn(shape, generator=generator, device=generator.device)


def _t_batch(t: int, b: int, device):
    return torch.full((b,), int(t), dtype=torch.int32, device=device)


def ddim_timesteps(num_timesteps: int, steps: int) -> np.ndarray:
    """round(linspace(T-1, 0, steps)) as int32, the reference's table."""
    return np.round(linspace_f32(num_timesteps - 1, 0, steps)).astype(np.int32)


def ddim_sample(denoise_fn: Callable, schedule: DiffusionSchedule, generator=None,
                shape=None, initial_latent=None, num_inference_steps: int = 50,
                clip_x0: Optional[float] = None):
    """DDIM (Song et al. 2020) at eta 0: jumps between visited timesteps
    through the predicted x0.

        x0_hat = (x_t - sqrt(1-acp_t) eps) / sqrt(acp_t)      [clip opt.]
        x_next = sqrt(acp_next) x0_hat + sqrt(1-acp_next) eps
    """
    T = schedule.num_timesteps
    steps = min(num_inference_steps, T)
    x = _init_latent(generator, shape, initial_latent)
    b = x.shape[0]

    ts = ddim_timesteps(T, steps)
    acp = schedule.alphas_cumprod.numpy()
    acp_t = acp[ts]
    acp_next = np.concatenate([acp[ts[1:]], np.ones(1, _F32)])
    s_om = np.sqrt(np.maximum(_F32(1) - acp_t, _F32(0)))
    r_acp = _F32(1) / np.sqrt(acp_t)
    s_next = np.sqrt(acp_next)
    dir_coeff = np.sqrt(np.maximum(_F32(1) - acp_next, _F32(0)))

    for i in range(steps):
        tb = _t_batch(ts[i], b, x.device)
        eps = denoise_fn(x, tb).float()
        x0_hat = (x - float(s_om[i]) * eps) * float(r_acp[i])
        if clip_x0 is not None:
            x0_hat = x0_hat.clamp(-clip_x0, clip_x0)
        x = float(s_next[i]) * x0_hat + float(dir_coeff[i]) * eps
    return x


def dpmpp_2m_sample(denoise_fn: Callable, schedule: DiffusionSchedule,
                    generator=None, shape=None, initial_latent=None,
                    num_inference_steps: int = 25,
                    clip_x0: Optional[float] = None):
    """DPM-Solver++(2M) (Lu et al. 2022), data-prediction multistep form.

        D_i     = (x_i - sigma_i eps_i) / alpha_i          [clip opt.]
        Dhat_i  = (1 + 1/(2 r_i)) D_i - 1/(2 r_i) D_{i-1},  r_i = h_{i-1}/h_i
        x_{i+1} = (sigma_{i+1}/sigma_i) x_i + alpha_{i+1} (1 - e^{-h_{i+1}}) Dhat_i

    The final (virtual) target is acp=1, where the update lands on Dhat.
    Tables are built in fp64 and used in fp32, as in the reference.
    """
    T = schedule.num_timesteps
    steps = min(num_inference_steps, T)
    x = _init_latent(generator, shape, initial_latent)
    b = x.shape[0]

    ts = np.round(np.linspace(T - 1, 0, steps)).astype(np.int64)
    acp = schedule.alphas_cumprod.numpy().astype(np.float64)[ts]
    alpha = np.sqrt(acp)
    sigma = np.sqrt(1.0 - acp)
    lam = np.log(alpha) - np.log(np.maximum(sigma, 1e-12))
    alpha_n = np.concatenate([alpha[1:], [1.0]])
    sigma_n = np.concatenate([sigma[1:], [0.0]])
    h = np.concatenate([lam[1:], [np.inf]]) - lam
    c_x = np.where(sigma > 0, sigma_n / np.maximum(sigma, 1e-12), 0.0)
    c_d = alpha_n * (1.0 - np.exp(-h))
    with np.errstate(divide="ignore", invalid="ignore"):
        r = np.concatenate([[1.0], h[:-1]]) / h
        w_cur = 1.0 + 1.0 / (2.0 * r)
    # the first step has no history and the final step (h=inf -> r=0) is
    # taken first-order
    w_cur[0] = 1.0
    w_cur = np.where(~np.isfinite(w_cur) | (r <= 0), 1.0, w_cur)
    w_prev = 1.0 - w_cur
    sig, r_alpha, cx, cd, wc, wp = (np.asarray(v, _F32) for v in
                                    (sigma, 1.0 / alpha, c_x, c_d, w_cur, w_prev))

    d_prev = torch.zeros_like(x)
    for i in range(steps):
        tb = _t_batch(ts[i], b, x.device)
        eps = denoise_fn(x, tb).float()
        d = (x - float(sig[i]) * eps) * float(r_alpha[i])
        if clip_x0 is not None:
            d = d.clamp(-clip_x0, clip_x0)
        # the first step has no history: Euler, whatever the table says
        wc_eff, wp_eff = (float(wc[i]), float(wp[i])) if i > 0 else (1.0, 0.0)
        d_hat = wc_eff * d + wp_eff * d_prev
        x = float(cx[i]) * x + float(cd[i]) * d_hat
        d_prev = d
    return x
