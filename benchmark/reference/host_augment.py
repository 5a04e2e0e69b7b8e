"""The loader's host augmentation, worked out again in NumPy.

The classic loader (``data/loader.py``) augments each batch with a C++
engine: per sprite, from a seed derived from the batch's seed, a horizontal
flip, a rotation of up to 10 degrees (bilinear, background fill), a colour
jitter (brightness, contrast, saturation, a hue rotation about the grey
axis) and a random resized crop, then ``(v - 127.5) / 127.5``.  This is the
same algorithm written from its description, step by step in the engine's
float32 and float64 arithmetic and order, with the C library's own
``cosf``/``sinf`` and ``exp``, so that it gives the engine's bytes.  The
batch seeds are the loader's: a ``default_rng(seed * 1000 + epoch)``
spawns one child a batch, and each child draws its batch's seed.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import math
from decimal import Decimal, getcontext

import numpy as np

M64 = (1 << 64) - 1
GOLDEN = 0x9E3779B97F4A7C15
F = np.float32

_libm = ctypes.CDLL(ctypes.util.find_library("m"))
for _name in ("cosf", "sinf"):
    getattr(_libm, _name).restype = ctypes.c_float
    getattr(_libm, _name).argtypes = [ctypes.c_float]


def _cosf(x) -> np.float32:
    return F(_libm.cosf(float(x)))


def _sinf(x) -> np.float32:
    return F(_libm.sinf(float(x)))


def _log_exact(x: str) -> float:
    """ln(x) rounded once to a double, as a compiler folds ``std::log(0.9)``."""
    getcontext().prec = 60
    return float(Decimal(x).ln())


LOG_09, LOG_11 = _log_exact("0.9"), _log_exact("1.1")
PI_F = F(math.pi)


class Rng:
    """splitmix64-seeded xorshift128+."""

    def __init__(self, seed: int):
        st = seed & M64
        outs = []
        for _ in range(2):
            st = (st + GOLDEN) & M64
            z = st
            z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & M64
            z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & M64
            outs.append(z ^ (z >> 31))
        self.s0, self.s1 = outs

    def next(self) -> int:
        x, y = self.s0, self.s1
        self.s0 = y
        x = (x ^ (x << 23)) & M64
        self.s1 = x ^ y ^ (x >> 17) ^ (y >> 26)
        return (self.s1 + y) & M64

    def uniform(self, lo: float = 0.0, hi: float = 1.0) -> float:
        u = (self.next() >> 11) * (1.0 / 9007199254740992.0)
        return u if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * u


def _sample(img: np.ndarray, fy: np.ndarray, fx: np.ndarray, bg) -> np.ndarray:
    """Bilinear samples of ``img`` [h, w, 3] uint8 at float32 (fy, fx); the
    background outside, rounded half up and truncated to uint8."""
    h, w, _ = img.shape
    outside = (fx < -1) | (fy < -1) | (fx > w) | (fy > h)
    x0 = np.floor(fx).astype(np.int64)
    y0 = np.floor(fy).astype(np.int64)
    ax = fx - x0.astype(F)
    ay = fy - y0.astype(F)
    one = F(1)
    acc = np.zeros(fx.shape + (3,), F)
    bgf = np.asarray(bg, np.uint8)
    for dy in (0, 1):
        for dx in (0, 1):
            wgt = ((ax if dx else one - ax) * (ay if dy else one - ay))[..., None]
            xx, yy = x0 + dx, y0 + dy
            inside = (xx >= 0) & (xx < w) & (yy >= 0) & (yy < h)
            v = np.where(inside[..., None], img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)],
                         bgf).astype(F)
            acc = acc + wgt * v
    out = np.clip(acc + F(0.5), F(0), F(255)).astype(np.uint8)
    out[outside] = bgf
    return out


def _rotate(src: np.ndarray, degrees: np.float32, bg) -> np.ndarray:
    h, w, _ = src.shape
    rad = degrees * PI_F / F(180)
    cs, sn = _cosf(rad), _sinf(rad)
    cy, cx = F((h - 1) * 0.5), F((w - 1) * 0.5)
    y, x = np.meshgrid(np.arange(h, dtype=F), np.arange(w, dtype=F), indexing="ij")
    dx, dy = x - cx, y - cy
    sxf = cs * dx + sn * dy + cx
    syf = (-sn) * dx + cs * dy + cy
    return _sample(src, syf, sxf, bg)


def _color_jitter(buf: np.ndarray, rng: Rng) -> np.ndarray:
    b = F(1) + F(rng.uniform(-0.1, 0.1))
    c = F(1) + F(rng.uniform(-0.1, 0.1))
    s = F(1) + F(rng.uniform(-0.1, 0.1))
    hshift = F(rng.uniform(-0.05, 0.05))
    p = buf.reshape(-1, 3).astype(np.float64)
    mean = np.cumsum(0.299 * p[:, 0] + 0.587 * p[:, 1] + 0.114 * p[:, 2])[-1] / len(p)
    theta = hshift * F(2) * PI_F
    ch, sh = _cosf(theta), _sinf(theta)
    one3 = F(1) / F(3)
    sq3 = np.sqrt(F(1) / F(3))
    k = F(1) - ch
    m = [ch + k * one3, one3 * k - sq3 * sh, one3 * k + sq3 * sh,
         one3 * k + sq3 * sh, ch + one3 * k, one3 * k - sq3 * sh,
         one3 * k - sq3 * sh, one3 * k + sq3 * sh, ch + one3 * k]
    mf = F(mean)
    r, g, bl = (buf.reshape(-1, 3)[:, i].astype(F) * b for i in range(3))
    r, g, bl = (mf + (v - mf) * c for v in (r, g, bl))
    gray = F(0.299) * r + F(0.587) * g + F(0.114) * bl
    r, g, bl = (gray + (v - gray) * s for v in (r, g, bl))
    out = np.stack([m[0] * r + m[1] * g + m[2] * bl,
                    m[3] * r + m[4] * g + m[5] * bl,
                    m[6] * r + m[7] * g + m[8] * bl], axis=-1)
    return np.clip(out, F(0), F(255)).astype(np.uint8).reshape(buf.shape)


def _random_resized_crop(src: np.ndarray, rng: Rng, bg) -> np.ndarray:
    h, w, _ = src.shape
    ch, cw, top, left = h, w, 0, 0
    for _ in range(10):
        area = float(h * w) * rng.uniform(0.9, 1.0)
        aspect = math.exp(rng.uniform(LOG_09, LOG_11))
        tw = math.floor(math.sqrt(area * aspect) + 0.5)
        th = math.floor(math.sqrt(area / aspect) + 0.5)
        if tw <= w and th <= h:
            cw, ch = tw, th
            top = int(rng.uniform() * (h - th + 1))
            left = int(rng.uniform() * (w - tw + 1))
            break
    y, x = np.meshgrid(np.arange(h, dtype=F), np.arange(w, dtype=F), indexing="ij")
    sy = (y + F(0.5)) * F(ch) / F(h) - F(0.5) + F(top)
    sx = (x + F(0.5)) * F(cw) / F(w) - F(0.5) + F(left)
    return _sample(src, sy, sx, bg)


def augment_one(img: np.ndarray, seed: int, bg) -> np.ndarray:
    """uint8 [h, w, 3] -> float32 [h, w, 3] in [-1, 1]."""
    rng = Rng(seed)
    a = img.copy()
    if rng.uniform() < 0.5:
        a = a[:, ::-1].copy()
    b = _rotate(a, F(rng.uniform(-10.0, 10.0)), bg)
    b = _color_jitter(b, rng)
    a = _random_resized_crop(b, rng, bg)
    return (a.astype(F) - F(127.5)) / F(127.5)


def augment_batch(images: np.ndarray, seed: int, bg) -> np.ndarray:
    """A batch as the engine makes it: image ``i`` from ``seed + golden *
    (i + 1)``."""
    return np.stack([augment_one(im, (seed + GOLDEN * (i + 1)) & M64, bg)
                     for i, im in enumerate(images)])


def batch_seeds(data_seed: int, epoch: int, n_batches: int) -> list:
    """Each batch's engine seed, as the threaded loader draws them."""
    rng = np.random.default_rng(data_seed * 1000 + epoch)
    return [int(child.integers(0, 2 ** 62)) for child in rng.spawn(n_batches)]
