"""Train-time augmentations (host-side, numpy/PIL): a copy of
``psg_tpu/data/augment.py``, with the same draws from the same generator.

Reproduces the reference's torchvision pipeline
(dataset_improved.py:150-158): RandomHorizontalFlip(0.5),
RandomRotation(±10°), ColorJitter(brightness/contrast/saturation 0.1,
hue 0.05), RandomResizedCrop(scale 0.9-1.0, ratio 0.9-1.1).

Runs on uint8 arrays with an explicit ``np.random.Generator`` so epochs are
reproducible from a seed; executed by the loader's worker threads while the
card computes.  The native engine (``data/native.py``) takes its place when
its library builds.
"""

from __future__ import annotations

import numpy as np
from PIL import Image, ImageEnhance


def _hflip(img: np.ndarray) -> np.ndarray:
    return img[:, ::-1]


def _rotate(img: np.ndarray, degrees: float, fill) -> np.ndarray:
    pil = Image.fromarray(img)
    out = pil.rotate(degrees, resample=Image.Resampling.BILINEAR,
                     fillcolor=tuple(int(v) for v in fill))
    return np.asarray(out, np.uint8)


def _color_jitter(img: np.ndarray, rng: np.random.Generator,
                  brightness=0.1, contrast=0.1, saturation=0.1, hue=0.05) -> np.ndarray:
    pil = Image.fromarray(img)
    # torchvision applies the four jitters in random order; order effects at
    # these small magnitudes are negligible, we use a fixed order.
    b = 1.0 + rng.uniform(-brightness, brightness)
    c = 1.0 + rng.uniform(-contrast, contrast)
    s = 1.0 + rng.uniform(-saturation, saturation)
    h = rng.uniform(-hue, hue)
    pil = ImageEnhance.Brightness(pil).enhance(b)
    pil = ImageEnhance.Contrast(pil).enhance(c)
    pil = ImageEnhance.Color(pil).enhance(s)
    if abs(h) > 1e-6:
        hsv = np.asarray(pil.convert("HSV"), np.int16)
        hsv[..., 0] = (hsv[..., 0] + int(h * 255)) % 256
        pil = Image.fromarray(hsv.astype(np.uint8), "HSV").convert("RGB")
    return np.asarray(pil, np.uint8)


def _random_resized_crop(img: np.ndarray, rng: np.random.Generator,
                         out_size: int, scale=(0.9, 1.0), ratio=(0.9, 1.1)) -> np.ndarray:
    h, w = img.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = area * rng.uniform(*scale)
        aspect = np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1])))
        cw = int(round(np.sqrt(target_area * aspect)))
        ch = int(round(np.sqrt(target_area / aspect)))
        if cw <= w and ch <= h:
            top = rng.integers(0, h - ch + 1)
            left = rng.integers(0, w - cw + 1)
            crop = img[top : top + ch, left : left + cw]
            pil = Image.fromarray(crop).resize(
                (out_size, out_size), Image.Resampling.BILINEAR)
            return np.asarray(pil, np.uint8)
    # fallback: center crop
    pil = Image.fromarray(img).resize((out_size, out_size), Image.Resampling.BILINEAR)
    return np.asarray(pil, np.uint8)


def augment_sprite(img: np.ndarray, rng: np.random.Generator,
                   background=(255, 255, 255)) -> np.ndarray:
    """uint8 [H,W,3] -> augmented uint8 [H,W,3] (same size)."""
    out_size = img.shape[0]
    if rng.random() < 0.5:
        img = _hflip(img)
    img = _rotate(img, float(rng.uniform(-10, 10)), background)
    img = _color_jitter(img, rng)
    img = _random_resized_crop(img, rng, out_size)
    return img
