"""Multi-band (Laplacian pyramid) blending.

Port of `stitchingvideo_tpu/blend/multiband.py` (MultiBandBlender, reference
src/blenders.cpp:189-377, with `num_bands = ceil(log2(blend_width)) - 1`
chosen by the caller exactly as the reference CLI does,
stitching_detailed.cpp:731-750): the band-count and padding rules, and
`multiband_blend`, the full-canvas blend of the stitcher's `'multiband'`
compose and of the runtime's full blend.

Like the JAX package, each image's pyramid is built over the full canvas
with normalized convolution (pyr(img * m) / pyr(m)), so masked-out black
pixels never bleed into coarse bands. The cameras are accumulated in order,
band tensors updated in place.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..ops import pyramid as pyr
from .feather import WEIGHT_EPS, sum_in_order, weighted_sum


def num_bands_for(dst_area_px: float, blend_strength: float = 5.0) -> int:
    """Reference band-count rule (CLI :731-750)."""
    blend_width = float(np.sqrt(dst_area_px) * blend_strength / 100.0)
    if blend_width < 1.0:
        return 0
    return max(int(np.ceil(np.log2(blend_width))) - 1, 0)


def pad_for_bands(h: int, w: int, bands: int) -> Tuple[int, int]:
    """Canvas size rounded up to a multiple of 2^bands (blenders.cpp:250-260)."""
    q = 1 << bands
    return -(-h // q) * q, -(-w // q) * q


def multiband_blend(images: torch.Tensor, masks: torch.Tensor, bands: int):
    """(pano [H, W, 3] float32, mask [H, W] bool).

    images: [N, H, W, 3] canvas-placed (H, W multiples of 2^bands);
    masks: [N, H, W] bool."""
    if bands == 0:
        w = masks.to(torch.float32)
        ws = sum_in_order(w)
        return (weighted_sum(images, w) / (ws[..., None] + WEIGHT_EPS),
                ws > WEIGHT_EPS)

    H, W = images.shape[1:3]
    dev = images.device
    band_acc = [torch.zeros((H >> lv, W >> lv, 3), dtype=torch.float32,
                            device=dev) for lv in range(bands + 1)]
    wsum_acc = [torch.zeros((H >> lv, W >> lv), dtype=torch.float32,
                            device=dev) for lv in range(bands + 1)]
    for idx in range(images.shape[0]):
        img = images[idx].to(torch.float32)
        m = masks[idx].to(torch.float32)
        # normalized Gaussian pyramid of the image under its mask
        gp_m = pyr.gaussian_pyramid(m, bands)
        gp_im = pyr.gaussian_pyramid(img * m[..., None], bands)
        gp_norm = [gm / torch.clamp(g, min=WEIGHT_EPS)[..., None]
                   for gm, g in zip(gp_im, gp_m)]
        # Laplacian bands of the normalized image
        laps = [gp_norm[lv] - pyr.pyr_up(gp_norm[lv + 1])
                for lv in range(bands)]
        laps.append(gp_norm[bands])
        for ba, wa, lap, g in zip(band_acc, wsum_acc, laps, gp_m):
            ba += lap * g[..., None]
            wa += g

    norm = [b / (w[..., None] + WEIGHT_EPS)
            for b, w in zip(band_acc, wsum_acc)]
    return pyr.collapse_laplacian(norm), wsum_acc[0] > WEIGHT_EPS
