"""Loss functions (port of ``psg_tpu/models/losses.py``, all but the VGG
perceptual loss and ``vae_loss``, which come with stage 1).

Stage 2 regresses the noise (or the velocity) with SmoothL1(beta=0.1), or
MSE; the KL terms and their annealing serve the VAE stage.  Every loss is
computed in fp32.  ``sample_weights`` [B] turns the mean into a
sample-weighted one: eval uses it to exclude the wraparound-padded tail of
its last batch, so the loss does not depend on the batch size.
"""

from __future__ import annotations

import torch


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
