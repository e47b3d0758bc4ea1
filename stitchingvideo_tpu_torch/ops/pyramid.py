"""Gaussian/Laplacian pyramids with OpenCV 5-tap kernel parity.

Port of `stitchingvideo_tpu/ops/pyramid.py` (cv::pyrDown/pyrUp as used by
MultiBandBlender, reference src/blenders.cpp:189-377, createLaplacePyr
:435-489, restoreImageFromLaplacePyr :520-530). Kernel = [1 4 6 4 1]/16
separable, BORDER_REFLECT_101 edges; pyrUp uses the same kernel scaled by 4
over a zero-stuffed upsample. Sizes are kept even (the blender pads its ROI
to a multiple of 2^num_bands), so every level is exactly half the last.
The filtering is `ops/filters.py` `sep_filter2d`, in float32.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .filters import sep_filter2d

_K5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """Blur + decimate by 2. img [H, W(, C)] with H, W even."""
    return sep_filter2d(img, _K5, _K5)[::2, ::2]


def pyr_up(img: torch.Tensor) -> torch.Tensor:
    """Zero-stuff upsample x2 + blur with 4 * kernel."""
    H, W = img.shape[:2]
    up = torch.zeros((H * 2, W * 2) + tuple(img.shape[2:]), dtype=img.dtype,
                     device=img.device)
    up[::2, ::2] = img
    return sep_filter2d(up, _K5 * 2.0, _K5 * 2.0)


def gaussian_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """[img, down1, ..., down_levels] (levels + 1 entries)."""
    pyr = [img]
    for _ in range(levels):
        pyr.append(pyr_down(pyr[-1]))
    return pyr


def laplacian_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Laplacian pyramid: levels band-pass images + the final low-pass
    (createLaplacePyr, blenders.cpp:435-489)."""
    pyr = gaussian_pyramid(img, levels)
    out = [pyr[i] - pyr_up(pyr[i + 1]) for i in range(levels)]
    out.append(pyr[levels])
    return out


def collapse_laplacian(pyr: List[torch.Tensor]) -> torch.Tensor:
    """Inverse of laplacian_pyramid (restoreImageFromLaplacePyr)."""
    img = pyr[-1]
    for lvl in reversed(pyr[:-1]):
        img = pyr_up(img) + lvl
    return img
