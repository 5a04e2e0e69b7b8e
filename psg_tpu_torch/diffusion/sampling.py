"""The six samplers (port of ``psg_tpu/diffusion/sampling.py``).

- ``ddim_sample``          DDIM at eta 0, the quality default;
- ``dpmpp_2m_sample``      DPM-Solver++(2M);
- ``ddpm_sample``          canonical posterior-variance DDPM, strided;
- ``ddpm_sample_fast``     every ``stride``-th timestep with sqrt(beta) renoise;
- ``ddpm_sample_x0``       x0-prediction form with posterior variance;
- ``ddpm_sample_renoise``  the reference's gradio variant: denoise fully, then
                           renoise toward the next step's single-step alpha.

A Python loop over the steps takes the place of ``lax.scan``; the per-step
coefficients are fp32 host scalars from tables built as the reference builds
them, and each sampler's timestep table (``*_timesteps``) is the reference's
exactly.  ``generator`` (a ``torch.Generator`` on the model's device) takes the
place of the PRNG key: it draws the prior when no ``initial_latent`` is
given, and the four DDPM-family samplers draw one gaussian a step from it
unless ``noises`` ([steps, *x.shape]) gives them, which is how the tests
inject the reference's draws.  DDIM (eta 0: the reference's eta > 0 has no
caller and is not ported) and DPM-Solver++ are deterministic from the
initial latent.  All take ``denoise_fn(x_t, t_batch) -> eps_hat``.  The
generator puts classifier-free guidance inside that function (both branches
in one UNet call, for DDIM and DPM-Solver++); the trainer's DDIM sample
grids use the unfused form instead, ``ddim_sample``'s ``guidance_scale``
with ``uncond_denoise_fn``: eps = (1 + g) eps_cond - g eps_uncond.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from psg_tpu_torch.core import draws
from psg_tpu_torch.diffusion.schedule import DiffusionSchedule, linspace_f32

_F32 = np.float32


def _init_latent(generator, shape, initial_latent):
    if initial_latent is not None:
        return initial_latent.float()
    return draws.randn(generator, shape)


def _t_batch(t: int, b: int, device):
    return torch.full((b,), int(t), dtype=torch.int32, device=device)


def _step_noise(noises, i, x, generator):
    if noises is not None:
        return noises[i].to(x.device).float()
    return draws.randn(generator, x.shape, device=x.device)


def ddim_timesteps(num_timesteps: int, steps: int) -> np.ndarray:
    """round(linspace(T-1, 0, steps)) as int32, the reference's table."""
    return np.round(linspace_f32(num_timesteps - 1, 0, steps)).astype(np.int32)


def ddpm_timesteps(num_timesteps: int, steps: int) -> np.ndarray:
    """max(T-1 - i*(T//steps), 0) for i < steps."""
    stride = max(1, num_timesteps // steps)
    return np.maximum(num_timesteps - 1 - np.arange(steps) * stride, 0).astype(np.int32)


def fast_timesteps(num_timesteps: int, stride: int) -> np.ndarray:
    """T-1-((T-1) % stride), ..., stride, 0: every stride-th timestep."""
    T = num_timesteps
    return np.arange(T - (T - 1) % stride - 1, -1, -stride).astype(np.int32)


def fast_stride(num_timesteps: int, steps: int) -> int:
    """The stride the generator gives ``ddpm_sample_fast`` for ``steps``."""
    return max(1, num_timesteps // steps)


def x0_timesteps(num_timesteps: int, steps: Optional[int]) -> np.ndarray:
    """T-1 down to 0 by T//steps: may hold more entries than ``steps``
    (5 for T 50 and 4 steps)."""
    T = num_timesteps
    step = 1 if steps is None or steps >= T else T // steps
    return np.arange(T - 1, -1, -step).astype(np.int32)


def renoise_timesteps(num_timesteps: int, steps: int) -> np.ndarray:
    """linspace(T-1, 0, steps) truncated to int32."""
    return linspace_f32(num_timesteps - 1, 0, steps).astype(np.int32)


def _guided(denoise_fn, x, tb, guidance_scale: float, uncond_denoise_fn):
    """eps, with unfused classifier-free guidance when asked for."""
    eps = denoise_fn(x, tb).float()
    if guidance_scale > 0.0 and uncond_denoise_fn is not None:
        eps_u = uncond_denoise_fn(x, tb).float()
        eps = (1.0 + guidance_scale) * eps - guidance_scale * eps_u
    return eps


def ddim_sample(denoise_fn: Callable, schedule: DiffusionSchedule, generator=None,
                shape=None, initial_latent=None, num_inference_steps: int = 50,
                clip_x0: Optional[float] = None, guidance_scale: float = 0.0,
                uncond_denoise_fn: Optional[Callable] = None):
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
        eps = _guided(denoise_fn, x, tb, float(guidance_scale), uncond_denoise_fn)
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


def ddpm_sample(denoise_fn: Callable, schedule: DiffusionSchedule, generator=None,
                shape=None, initial_latent=None,
                num_inference_steps: Optional[int] = None, noises=None):
    """Posterior-variance DDPM at the strided timesteps ``ddpm_timesteps``:

    - t > 0:  x = 1/sqrt(a_t) (x - b_t/sqrt(1-acp_t) eps) + sqrt(postvar_t) z
    - t == 0: x = x - eps
    """
    T = schedule.num_timesteps
    steps = num_inference_steps or T
    x = _init_latent(generator, shape, initial_latent)
    b = x.shape[0]
    ts = ddpm_timesteps(T, steps)
    sra = schedule.sqrt_recip_alphas.numpy()[ts]
    coeff = schedule.betas.numpy()[ts] / schedule.sqrt_one_minus_alphas_cumprod.numpy()[ts]
    sigma = np.sqrt(schedule.posterior_variance.numpy()[ts])
    for i, t in enumerate(ts):
        eps = denoise_fn(x, _t_batch(t, b, x.device)).float()
        noise = _step_noise(noises, i, x, generator)
        if t > 0:
            x = float(sra[i]) * (x - float(coeff[i]) * eps) + float(sigma[i]) * noise
        else:
            x = x - eps
    return x


def ddpm_sample_fast(denoise_fn: Callable, schedule: DiffusionSchedule, generator=None,
                     shape=None, initial_latent=None, stride: int = 50, noises=None):
    """Visits every ``stride``-th timestep (``fast_timesteps``); after each
    update re-adds sqrt(beta_t) noise for t > 0.  (The reference's
    ``renoise=False`` switch has no caller and is not ported.)"""
    x = _init_latent(generator, shape, initial_latent)
    b = x.shape[0]
    ts = fast_timesteps(schedule.num_timesteps, stride)
    c1 = _F32(1) / np.sqrt(schedule.alphas.numpy()[ts])
    c2 = schedule.betas.numpy()[ts] / schedule.sqrt_one_minus_alphas_cumprod.numpy()[ts]
    sigma = np.sqrt(schedule.betas.numpy()[ts])
    for i, t in enumerate(ts):
        eps = denoise_fn(x, _t_batch(t, b, x.device)).float()
        x = float(c1[i]) * (x - float(c2[i]) * eps)
        noise = _step_noise(noises, i, x, generator)
        if t > 0:
            x = x + float(sigma[i]) * noise
    return x


def ddpm_sample_x0(denoise_fn: Callable, schedule: DiffusionSchedule, generator=None,
                   shape=None, initial_latent=None,
                   num_inference_steps: Optional[int] = None, noises=None):
    """x0-prediction form at the timesteps ``x0_timesteps``:

        x0_hat = (x_t - sqrt(1-acp_t) eps) / sqrt(acp_t)
        x_{t-1} = sqrt(acp_{t-1}) x0_hat + sqrt(1-acp_{t-1}) eps
                  + sqrt(postvar_t) z   (t > 0)
    """
    x = _init_latent(generator, shape, initial_latent)
    b = x.shape[0]
    ts = x0_timesteps(schedule.num_timesteps, num_inference_steps)
    acp_all = schedule.alphas_cumprod.numpy()
    acp = acp_all[ts]
    acp_prev = np.where(ts > 0, acp_all[np.maximum(ts - 1, 0)], _F32(1)).astype(_F32)
    s_om = np.sqrt(_F32(1) - acp)
    r_acp = _F32(1) / np.sqrt(acp)
    s_acp_prev = np.sqrt(acp_prev)
    s_om_prev = np.sqrt(_F32(1) - acp_prev)
    sigma = np.sqrt(schedule.posterior_variance.numpy()[ts])
    for i, t in enumerate(ts):
        eps = denoise_fn(x, _t_batch(t, b, x.device)).float()
        x0_hat = (x - float(s_om[i]) * eps) * float(r_acp[i])
        x = float(s_acp_prev[i]) * x0_hat + float(s_om_prev[i]) * eps
        noise = _step_noise(noises, i, x, generator)
        if t > 0:
            x = x + float(sigma[i]) * noise
    return x


def ddpm_sample_renoise(denoise_fn: Callable, schedule: DiffusionSchedule,
                        generator=None, shape=None, initial_latent=None,
                        num_inference_steps: int = 50, noises=None):
    """The reference's serving sampler: at each of ``renoise_timesteps``
    denoise fully with the single-step alpha, then (but for the last step
    and a next timestep of 0) renoise toward the NEXT timestep with
    sqrt(alpha_next) / sqrt(1 - alpha_next)."""
    x = _init_latent(generator, shape, initial_latent)
    b = x.shape[0]
    ts = renoise_timesteps(schedule.num_timesteps, num_inference_steps)
    next_ts = np.concatenate([ts[1:], np.zeros(1, np.int32)])
    alphas = schedule.alphas.numpy()
    coeff = (_F32(1) - alphas[ts]) / schedule.sqrt_one_minus_alphas_cumprod.numpy()[ts]
    r_alpha = _F32(1) / np.sqrt(alphas[ts])
    s_an = np.sqrt(alphas[next_ts])
    s_oman = np.sqrt(_F32(1) - alphas[next_ts])
    for i, t in enumerate(ts):
        eps = denoise_fn(x, _t_batch(t, b, x.device)).float()
        noise = _step_noise(noises, i, x, generator)
        x = (x - float(coeff[i]) * eps) * float(r_alpha[i])
        if i < len(ts) - 1 and next_ts[i] > 0:
            x = float(s_an[i]) * x + float(s_oman[i]) * noise
    return x
