"""Sprite-quality and text-conditioning metrics (a copy of
``psg_tpu/eval/metrics.py``; numpy and PIL only).

Small, dependency-free measurements tailored to the dataset's structure
(sprites on a flat background), for regression-tracking trained checkpoints:

- ``silhouette_iou`` — foreground-mask overlap: does the generated sprite
  occupy the same silhouette as the reference sprite?
- ``color_histogram_similarity`` — histogram intersection over foreground
  RGB: does it use the right palette?
- ``downsampled_l1`` — low-frequency structure + color proximity.
- ``pairwise_conditioning_scores`` — the conditioning test: generate one
  sprite per dataset caption, score every generated sprite against every
  real sprite, and check that the matched pair wins (retrieval@1 /
  matched-vs-mismatched margin).  Random or unconditioned generations
  score at chance; a text-conditioned model scores above it.
  ``conditioning_report``'s ``retrieval_at_1`` is the ``eval.retrieval_at_1``
  stamp that ``serve.hub`` ranks checkpoints by.

All images are [-1, 1] float arrays of shape [H, W, 3].
"""

from __future__ import annotations

from math import comb as _comb
from typing import Dict, Optional, Sequence

import numpy as np


def _foreground_mask(img: np.ndarray, background: Optional[Sequence[float]] = None,
                     threshold: float = 0.15) -> np.ndarray:
    """Pixels further than ``threshold`` (L-inf, in [-1,1] units) from the
    background color.  Dataset sprites are alpha-composited onto a flat
    background (``data.dataset``), so this recovers the silhouette."""
    bg = np.asarray(background if background is not None else (1.0, 1.0, 1.0),
                    np.float32)
    return np.max(np.abs(np.asarray(img, np.float32) - bg), axis=-1) > threshold


def silhouette_iou(a: np.ndarray, b: np.ndarray,
                   background: Optional[Sequence[float]] = None) -> float:
    ma, mb = _foreground_mask(a, background), _foreground_mask(b, background)
    union = np.logical_or(ma, mb).sum()
    if union == 0:
        return 1.0
    return float(np.logical_and(ma, mb).sum() / union)


def color_histogram_similarity(a: np.ndarray, b: np.ndarray, bins: int = 8,
                               background: Optional[Sequence[float]] = None) -> float:
    """Histogram intersection (in [0,1]) of joint-RGB histograms over
    foreground pixels."""

    def hist(img):
        m = _foreground_mask(img, background)
        if not m.any():
            return np.zeros(bins ** 3, np.float64)
        px = np.clip((np.asarray(img, np.float32)[m] + 1.0) / 2.0, 0.0, 1.0)
        idx = np.minimum((px * bins).astype(np.int64), bins - 1)
        flat = (idx[:, 0] * bins + idx[:, 1]) * bins + idx[:, 2]
        h = np.bincount(flat, minlength=bins ** 3).astype(np.float64)
        return h / h.sum()

    return float(np.minimum(hist(a), hist(b)).sum())


def downsampled_l1(a: np.ndarray, b: np.ndarray, size: int = 32) -> float:
    """Mean |a-b| after box-downsampling both to ``size``² — low-frequency
    structure + color distance, robust to pixel-level texture noise."""

    def down(img):
        from PIL import Image

        arr = np.clip((np.asarray(img, np.float32) + 1.0) / 2.0, 0.0, 1.0)
        im = Image.fromarray((arr * 255.0 + 0.5).astype(np.uint8))
        im = im.resize((size, size), Image.Resampling.BOX)
        return np.asarray(im, np.float32) / 255.0 * 2.0 - 1.0

    return float(np.mean(np.abs(down(a) - down(b))))


def _pair_score(g: np.ndarray, r: np.ndarray,
                background: Optional[Sequence[float]] = None) -> float:
    """Scalar similarity in [0,1]: palette + silhouette + structure."""
    hist = color_histogram_similarity(g, r, background=background)
    iou = silhouette_iou(g, r, background=background)
    l1 = downsampled_l1(g, r)  # in [0,2]
    return float((hist + iou + (1.0 - l1 / 2.0)) / 3.0)


def pairwise_conditioning_scores(generated: Sequence[np.ndarray],
                                 real: Sequence[np.ndarray],
                                 background: Optional[Sequence[float]] = None,
                                 ) -> np.ndarray:
    """[N_gen, N_real] similarity matrix (``_pair_score``); row i is
    the generation conditioned on real sprite i's caption."""
    n, m = len(generated), len(real)
    s = np.zeros((n, m), np.float64)
    for i in range(n):
        for j in range(m):
            s[i, j] = _pair_score(generated[i], real[j], background)
    return s


def conditioning_report(generated: Sequence[np.ndarray],
                        real: Sequence[np.ndarray],
                        names: Optional[Sequence[str]] = None,
                        background: Optional[Sequence[float]] = None) -> Dict:
    """Aggregate conditioning evidence for matched (generated_i, real_i)
    pairs.  ``retrieval_at_1`` is the fraction of generations whose best
    match across all real sprites is their own caption's sprite (chance =
    1/N); ``margin`` is matched-minus-mean-mismatched similarity."""
    s = pairwise_conditioning_scores(generated, real, background)
    n = s.shape[0]
    diag = np.diag(s)
    off = (s.sum(axis=1) - diag) / max(s.shape[1] - 1, 1)
    report = {
        "n": int(n),
        "matched_mean": float(diag.mean()),
        "mismatched_mean": float(off.mean()),
        "margin": float((diag - off).mean()),
        "retrieval_at_1": float((s.argmax(axis=1) == np.arange(n)).mean()),
        "chance_retrieval": float(1.0 / max(s.shape[1], 1)),
    }
    # Exact binomial tail: P(X >= hits) with X ~ Binomial(n, 1/m) — the
    # probability of retrieving this many captions' own sprites by chance.
    hits = int((s.argmax(axis=1) == np.arange(n)).sum())
    p = 1.0 / max(s.shape[1], 1)
    report["retrieval_p_value"] = float(sum(
        _comb(n, k) * p**k * (1 - p) ** (n - k) for k in range(hits, n + 1)))
    # matched-pair per-metric means: the blended _pair_score hides which
    # component moved, so report each
    k = min(len(generated), len(real))
    report["matched_silhouette_iou"] = float(np.mean(
        [silhouette_iou(generated[i], real[i], background) for i in range(k)]))
    report["matched_color_histogram"] = float(np.mean(
        [color_histogram_similarity(generated[i], real[i],
                                    background=background) for i in range(k)]))
    report["matched_downsampled_l1"] = float(np.mean(
        [downsampled_l1(generated[i], real[i]) for i in range(k)]))
    if names is not None:
        report["per_sprite"] = {
            str(names[i]): {"matched": float(diag[i]), "mismatched": float(off[i])}
            for i in range(n)
        }
    return report
