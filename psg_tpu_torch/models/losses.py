"""Loss functions (port of ``psg_tpu/models/losses.py``).

Stage 1 trains the VAE on L1 + VGG perceptual + annealed KL
(``vae_loss``); stage 2 regresses the noise (or the velocity) with
SmoothL1(beta=0.1), or MSE.  Every loss is
computed in fp32.  ``sample_weights`` [B] turns the mean into a
sample-weighted one: eval uses it to exclude the wraparound-padded tail of
its last batch, so the loss does not depend on the batch size.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from psg_tpu_torch.models.vgg import vgg16_features
from psg_tpu_torch.nn.resize import bilinear_resize


def _per_sample_mean(x):
    """Mean over all non-batch axes -> [B]."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def _reduce(elementwise, sample_weights):
    if sample_weights is None:
        return elementwise.mean()
    w = sample_weights.float()
    return (_per_sample_mean(elementwise) * w).sum() / w.sum().clamp_min(1.0)


def l1_loss(pred, target, sample_weights=None):
    return _reduce((pred.float() - target.float()).abs(), sample_weights)


def mse_loss(pred, target, sample_weights=None):
    return _reduce((pred.float() - target.float()).square(), sample_weights)


def smooth_l1_loss(pred, target, beta: float = 0.1, sample_weights=None):
    """0.5 x^2 / beta where |x| < beta, else |x| - beta/2 (torch's SmoothL1Loss)."""
    d = (pred.float() - target.float()).abs()
    return _reduce(torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta),
                   sample_weights)


def kl_divergence(mu, logvar, sample_weights=None):
    """Mean-normalized KL: -0.5 (1 + logvar - mu^2 - e^logvar), averaged."""
    mu, logvar = mu.float(), logvar.float()
    return _reduce(-0.5 * (1.0 + logvar - mu.square() - logvar.exp()), sample_weights)


def kl_divergence_free_bits(mu, logvar, free_bits: float = 0.1, sample_weights=None):
    """Per-dimension KL floored at ``free_bits``, averaged."""
    mu, logvar = mu.float(), logvar.float()
    kl = -0.5 * (1.0 + logvar - mu.square() - logvar.exp())
    return _reduce(kl.clamp_min(free_bits), sample_weights)


def kl_anneal_weight(epoch, *, start: int, end: int, w_start: float, w_end: float) -> float:
    """Linear KL annealing over epochs, in fp32 as the JAX package computes it."""
    t = torch.clamp((torch.tensor(float(epoch)) - start) / max(end - start, 1), 0.0, 1.0)
    return float(w_start + t * (w_end - w_start))


def perceptual_loss(vgg_params, generated01, target01, *, weights=(1.0, 1.0), dtype=None,
                    sample_weights=None):
    """VGG16 feature L1 at taps 8 and 15: inputs in [0, 1], clamped, resized
    to 224 when under 200 px (the 215 images are not)."""
    g = generated01.clamp(0.0, 1.0)
    t = target01.clamp(0.0, 1.0)
    if g.shape[1] < 200:
        g = bilinear_resize(g, (224, 224))
        t = bilinear_resize(t, (224, 224))
    loss = torch.zeros((), device=g.device)
    for a, b, w in zip(vgg16_features(vgg_params, g, dtype=dtype),
                       vgg16_features(vgg_params, t, dtype=dtype), weights):
        loss = loss + w * l1_loss(a, b, sample_weights=sample_weights)
    return loss


def vae_loss(vgg_params, generated, target, mu, logvar, *, reconstruction_weight: float = 1.0,
             perceptual_weight: float = 0.01, kl_weight, free_bits: Optional[float] = None,
             dtype=None, sample_weights=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """L1 + perceptual + KL with an annealed ``kl_weight`` (free bits when
    given).  generated/target in [-1, 1]; the perceptual term sees [0, 1]."""
    recon = l1_loss(generated, target, sample_weights=sample_weights)
    perc = perceptual_loss(vgg_params, (generated + 1.0) / 2.0, (target + 1.0) / 2.0,
                           dtype=dtype, sample_weights=sample_weights)
    if free_bits is not None:
        kl = kl_divergence_free_bits(mu, logvar, free_bits, sample_weights=sample_weights)
    else:
        kl = kl_divergence(mu, logvar, sample_weights=sample_weights)
    total = reconstruction_weight * recon + perceptual_weight * perc + kl_weight * kl
    return total, {"total_loss": total, "reconstruction_loss": recon,
                   "perceptual_loss": perc, "kl_loss": kl}
