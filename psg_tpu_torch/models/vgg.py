"""VGG16 features for the perceptual loss (port of ``psg_tpu/models/vgg.py``).

torchvision's ``vgg16().features`` up to ReLU index 15, tapped at ReLUs 8
and 15; 2x2 max pools after ReLUs 3 and 8, which floor odd sizes (215 ->
107 -> 53) as the JAX package's VALID ``reduce_window`` does.  ImageNet
normalisation is applied inside.  With no converted weights a fixed-seed
random init stands in: random VGG features still define a perceptual metric
and keep the loss's plumbing identical.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F

from psg_tpu_torch.nn.layers import channel_constant, conv2d, conv2d_init

# (torchvision features index, cin, cout); pools at indices 4 and 9
_CONVS = (
    (0, 3, 64),
    (2, 64, 64),
    (5, 64, 128),
    (7, 128, 128),
    (10, 128, 256),
    (12, 256, 256),
    (14, 256, 256),
)
_POOL_AFTER = {3, 8}   # ReLUs 3 and 8 are followed by MaxPool (4, 9)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg16_init(gen):
    return {f"conv{idx}": conv2d_init(gen, cin, cout, 3, init="torch")
            for idx, cin, cout in _CONVS}


def vgg16_features(params, x, taps: Sequence[int] = (8, 15), *,
                   dtype=None) -> List[torch.Tensor]:
    """x: [B, H, W, 3] in [0, 1] -> the feature maps at torchvision's layer
    indices ``taps``, convolutions in ``dtype``."""
    x = (x - channel_constant(IMAGENET_MEAN, x)) / channel_constant(IMAGENET_STD, x)
    feats = []
    for conv_idx, _cin, _cout in _CONVS:
        x = torch.relu(conv2d(params[f"conv{conv_idx}"], x, stride=1, padding=1,
                              dtype=dtype))
        relu_idx = conv_idx + 1
        if relu_idx in taps:
            feats.append(x)
        if relu_idx in _POOL_AFTER:
            x = F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        if relu_idx >= max(taps):
            break
    return feats
