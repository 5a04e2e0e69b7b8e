"""Image helpers: [-1, 1] arrays -> PIL (port of ``psg_tpu/utils/images.py``)."""

from __future__ import annotations

import numpy as np
from PIL import Image


def to_uint8(img) -> np.ndarray:
    """[-1,1] float [H,W,3] -> uint8 (NaN maps to mid-grey, not garbage)."""
    arr = np.asarray(img, np.float32)
    arr = np.clip((np.nan_to_num(arr) + 1.0) / 2.0, 0.0, 1.0)
    return (arr * 255.0 + 0.5).astype(np.uint8)


def tensor_to_pil(img) -> Image.Image:
    return Image.fromarray(to_uint8(img))
