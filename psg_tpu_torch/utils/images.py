"""Image helpers: [-1, 1] arrays <-> PIL, sample grids (port of
``psg_tpu/utils/images.py``)."""

from __future__ import annotations

import math
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
from PIL import Image


def to_uint8(img) -> np.ndarray:
    """[-1,1] float [H,W,3] -> uint8 (NaN maps to mid-grey, not garbage)."""
    arr = np.asarray(img, np.float32)
    arr = np.clip((np.nan_to_num(arr) + 1.0) / 2.0, 0.0, 1.0)
    return (arr * 255.0 + 0.5).astype(np.uint8)


def tensor_to_pil(img) -> Image.Image:
    return Image.fromarray(to_uint8(img))


def pil_to_array(image: Image.Image, size: int = 215) -> np.ndarray:
    """PIL -> fp32 [H,W,3] in [-1,1]: LANCZOS resize, RGB convert,
    Normalize(0.5, 0.5)."""
    image = image.resize((size, size), Image.Resampling.LANCZOS)
    if image.mode != "RGB":
        image = image.convert("RGB")
    arr = np.asarray(image, np.float32) / 255.0
    return (arr - 0.5) * 2.0


def save_image_grid(images, path, *, ncols: Optional[int] = None,
                    pad: int = 2, captions: Optional[Sequence[str]] = None) -> None:
    """images: [N,H,W,3] in [-1,1] -> one PNG grid; with ``captions``, a
    sidecar ``.txt`` lists them."""
    images = np.asarray(images)
    n, h, w = images.shape[:3]
    ncols = ncols or int(math.ceil(math.sqrt(n)))
    nrows = int(math.ceil(n / ncols))
    grid = np.full((nrows * (h + pad) - pad, ncols * (w + pad) - pad, 3), 255, np.uint8)
    for i in range(n):
        r, c = divmod(i, ncols)
        grid[r * (h + pad): r * (h + pad) + h,
             c * (w + pad): c * (w + pad) + w] = to_uint8(images[i])
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(grid).save(path)
    if captions:
        path.with_suffix(".txt").write_text(
            "\n".join(f"{i}: {c}" for i, c in enumerate(captions)))
