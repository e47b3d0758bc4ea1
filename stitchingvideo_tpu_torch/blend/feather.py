"""Feather (distance-transform weighted) blending, and the plain paste.

Port of `stitchingvideo_tpu/blend/feather.py` (FeatherBlender, reference
src/blenders.cpp:115-186, createWeightMap :427-432): weight =
min(L1-distance-transform(mask) * sharpness, 1), weighted accumulate,
normalize by total weight.

Canvas formulation: all images pre-placed on the output canvas
[N, H, W, 3] with masks [N, H, W]. The weighted sum runs over the cameras
in order, one elementwise multiply-add a camera (no matrix product, so no
TF32 on the card, and the same roundings on the CPU and on CUDA).
`paste_blend` is the `'no'` blend: the seam masks as 0/1 weights.
"""
from __future__ import annotations

import torch

from ..ops.distance import distance_transform_l1

WEIGHT_EPS = 1e-5  # blenders.cpp WEIGHT_EPS


def feather_weights(masks: torch.Tensor,
                    sharpness: float = 0.02) -> torch.Tensor:
    """[N, H, W] float32 weights from boolean masks."""
    m = masks.to(torch.float32)
    return torch.clamp(distance_transform_l1(masks) * sharpness, max=1.0) * m


def sum_in_order(xs) -> torch.Tensor:
    """xs[0] + xs[1] + ... , left to right (a reduction kernel may take
    another order on another device)."""
    acc = xs[0]
    for x in xs[1:]:
        acc = acc + x
    return acc


def weighted_sum(images: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum_n images[n] * weights[n][..., None] in float32, in camera order:
    [N, H, W, C] x [N, H, W] -> [H, W, C]."""
    return sum_in_order([images[i].to(torch.float32) * weights[i][..., None]
                         for i in range(images.shape[0])])


def feather_blend(images: torch.Tensor, weights: torch.Tensor):
    """(pano [H, W, 3] float32, mask [H, W] bool) from canvas-placed
    images [N, H, W, 3] and weights [N, H, W]."""
    acc = weighted_sum(images, weights)
    wsum = sum_in_order(weights)
    pano = acc / (wsum[..., None] + WEIGHT_EPS)
    return pano, wsum > WEIGHT_EPS


def paste_blend(images: torch.Tensor, masks: torch.Tensor):
    """The 'no' blend: (pano [H, W, 3] float32, mask [H, W] bool) from
    canvas-placed images [N, H, W, 3] under their seam masks [N, H, W] bool,
    summed in camera order and divided by the owners' count (at least 1)."""
    w = masks.to(torch.float32)
    tot = sum_in_order(w)
    pano = weighted_sum(images, w) / torch.clamp(tot[..., None], min=1.0)
    return pano, tot > 0
