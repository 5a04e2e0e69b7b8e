# Frozen copy of psg_tpu_torch/data/device_augment.py for the benchmark's plain reference;
# calls into the port's kernels, where it has any, go to plainops.py.
"""Train-time augmentation on the device (port of
``psg_tpu/data/device_augment.py``): RandomHorizontalFlip(0.5),
RandomRotation(+-10 degrees), RandomResizedCrop(scale 0.9-1.0, ratio
0.9-1.1) and ColorJitter(brightness, contrast, saturation 0.1, hue 0.05) on
a uint8 batch that already lies on the device, for the fast path
(``train/fastpath.py``).

As in the JAX package, and unlike the host augmentation (``augment.py``):

- rotation and the resized crop are one inverse affine warp with one
  bilinear resample; a source point outside ``[0, size - 1]`` takes the
  whole background colour (not ``F.grid_sample``, which would blend the
  border with zeros);
- hue is rotated in YIQ space (one folded 3x3 matrix per sample);
- contrast centres on the image's mean luma, in fp32.

The draws are apart from the arithmetic: ``draw_augment_params`` draws each
sample's ten numbers from a ``torch.Generator`` in ``_augment_one``'s key
order (flip, angle, area, log aspect, the two centre offsets, brightness,
contrast, saturation, hue), and ``augment_batch`` applies given ones, so a
caller can hand it the JAX package's draws.  All arithmetic is fp32.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from .layers import channel_constant

# Rec.601 luma, what PIL uses for L-mode conversions
_LUMA = (0.299, 0.587, 0.114)
_TO_YIQ = ((0.299, 0.587, 0.114),
           (0.596, -0.274, -0.322),
           (0.211, -0.523, 0.312))
_FROM_YIQ = ((1.0, 0.956, 0.621),
             (1.0, -0.272, -0.647),
             (1.0, -1.106, 1.703))

PARAM_NAMES = ("flip", "angle", "area", "log_aspect", "center_y", "center_x",
               "brightness", "contrast", "saturation", "hue")


def normalize_batch(images_u8: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> float32 in [-1, 1] (the eval path: no
    augmentation)."""
    return images_u8.float() / 127.5 - 1.0


def draw_augment_params(generator: torch.Generator, b: int, *, device=None,
                        degrees: float = 10.0,
                        scale: Tuple[float, float] = (0.9, 1.0),
                        ratio: Tuple[float, float] = (0.9, 1.1),
                        jitter: Tuple[float, ...] = (0.1, 0.1, 0.1, 0.05)
                        ) -> Dict[str, torch.Tensor]:
    """Each sample's draws, [b] each: ``flip`` (bool), ``angle`` (degrees),
    ``area`` (fraction of the image), ``log_aspect``, ``center_y`` and
    ``center_x`` (in [-1, 1]), and the jitter offsets ``brightness``,
    ``contrast``, ``saturation`` and ``hue`` (hue in turns).  One [10, b]
    uniform draw, its rows in ``PARAM_NAMES`` order."""
    u = torch.rand((len(PARAM_NAMES), b), generator=generator, device=device)
    bj, cj, sj, hj = jitter
    lo = (0.0, -degrees, scale[0], math.log(ratio[0]), -1.0, -1.0, -bj, -cj, -sj, -hj)
    hi = (1.0, degrees, scale[1], math.log(ratio[1]), 1.0, 1.0, bj, cj, sj, hj)
    out = {name: lo_ + (hi_ - lo_) * row
           for name, lo_, hi_, row in zip(PARAM_NAMES, lo, hi, u)}
    out["flip"] = u[0] < 0.5
    return out


def _affine_coords(size: int, angle, scale_hw, center_shift):
    """Output pixel -> source coordinates for rotate(angle) then
    crop(scale) + resize, both about the image centre.  ``angle`` [B] in
    radians (counter-clockwise), ``scale_hw`` and ``center_shift`` pairs of
    [B] (the crop's extent as a fraction of the image, its centre's offset
    in pixels).  Returns (yi, xi), each [B, size, size]."""
    c = (size - 1) / 2.0
    grid = torch.arange(size, dtype=torch.float32, device=angle.device)
    ys, xs = grid[None, :, None], grid[None, None, :]

    def col(t):
        return t[:, None, None]

    y = (ys - c) * col(scale_hw[0]) + col(center_shift[0])
    x = (xs - c) * col(scale_hw[1]) + col(center_shift[1])
    ca, sa = col(torch.cos(angle)), col(torch.sin(angle))
    return ca * y - sa * x + c, sa * y + ca * x + c


def _bilinear_sample(img, yi, xi, fill):
    """img [B, H, W, 3] fp32; source points outside the image take ``fill``
    [3].  Explicit gathers of the four neighbours of the clamped point."""
    b, h, w = img.shape[:3]
    inb = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
    yc = yi.clamp(0.0, h - 1)
    xc = xi.clamp(0.0, w - 1)
    y0f, x0f = torch.floor(yc), torch.floor(xc)
    y0, x0 = y0f.long(), x0f.long()
    y1 = (y0 + 1).clamp_max(h - 1)
    x1 = (x0 + 1).clamp_max(w - 1)
    wy = (yc - y0f)[..., None]
    wx = (xc - x0f)[..., None]
    bi = torch.arange(b, device=img.device)[:, None, None]
    v00, v01 = img[bi, y0, x0], img[bi, y0, x1]
    v10, v11 = img[bi, y1, x0], img[bi, y1, x1]
    out = (v00 * (1 - wy) * (1 - wx) + v01 * (1 - wy) * wx
           + v10 * wy * (1 - wx) + v11 * wy * wx)
    return torch.where(inb[..., None], out, fill)


def _hue_rotation(x, radians):
    """Rotate hue by ``radians`` [B] in YIQ space (luma-preserving): x
    [B, H, W, 3] times the per-sample matrix from_yiq @ rot @ to_yiq, its
    entries summed from Python constants (no constant tensor is uploaded)."""
    cu, su = torch.cos(radians), torch.sin(radians)
    f, t = _FROM_YIQ, _TO_YIQ
    m = torch.stack([torch.stack([f[d][0] * t[0][c]
                                  + f[d][1] * (cu * t[1][c] - su * t[2][c])
                                  + f[d][2] * (su * t[1][c] + cu * t[2][c])
                                  for c in range(3)], -1)
                     for d in range(3)], -2)                          # [B, 3, 3]
    return torch.einsum("bhwc,bdc->bhwd", x, m)


def _luma(x):
    return x[..., 0] * _LUMA[0] + x[..., 1] * _LUMA[1] + x[..., 2] * _LUMA[2]


def augment_batch(images_u8: torch.Tensor, params: Dict[str, torch.Tensor],
                  background_u8=(255, 255, 255)) -> torch.Tensor:
    """uint8 [B, H, W, 3] -> float32 [B, H, W, 3] in [-1, 1], augmented with
    ``params`` (``draw_augment_params``'s keys, [B] each)."""
    size = images_u8.shape[1]
    dev = images_u8.device
    p = {k: torch.as_tensor(v, device=dev) for k, v in params.items()}
    img = images_u8.float() / 255.0
    fill = channel_constant([v / 255.0 for v in background_u8], img)

    img = torch.where(p["flip"][:, None, None, None], img.flip(2), img)

    ang = p["angle"].float() * math.pi / 180.0
    area = p["area"].float()
    aspect = torch.exp(p["log_aspect"].float())
    cw = torch.sqrt(area * aspect).clamp_max(1.0)     # fraction of the width
    ch = torch.sqrt(area / aspect).clamp_max(1.0)     # fraction of the height
    dy = p["center_y"].float() * ((1.0 - ch) * (size - 1) / 2.0)
    dx = p["center_x"].float() * ((1.0 - cw) * (size - 1) / 2.0)
    yi, xi = _affine_coords(size, ang, (ch, cw), (dy, dx))
    img = _bilinear_sample(img, yi, xi, fill)

    def col(t):
        return t.float()[:, None, None, None]

    # ColorJitter with PIL's enhance semantics, then the clip
    img = img * (1.0 + col(p["brightness"]))
    gray_mean = _luma(img).mean(dim=(1, 2))[:, None, None, None]
    img = (img - gray_mean) * (1.0 + col(p["contrast"])) + gray_mean
    gray = _luma(img)[..., None]
    img = (img - gray) * (1.0 + col(p["saturation"])) + gray
    img = _hue_rotation(img, p["hue"].float() * 2.0 * math.pi)
    return img.clamp(0.0, 1.0) * 2.0 - 1.0
