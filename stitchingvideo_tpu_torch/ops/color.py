"""Color conversions with OpenCV coefficient parity.

Port of `stitchingvideo_tpu/ops/color.py`."""
from __future__ import annotations

import torch

# cv::cvtColor RGB2GRAY coefficients
_R, _G, _B = 0.299, 0.587, 0.114


def rgb_to_gray(img: torch.Tensor) -> torch.Tensor:
    """[...,3] RGB -> [...] gray, float32."""
    img = img.to(torch.float32)
    return _R * img[..., 0] + _G * img[..., 1] + _B * img[..., 2]


def bgr_to_gray(img: torch.Tensor) -> torch.Tensor:
    """[...,3] BGR (OpenCV order, as the reference ingests) -> gray."""
    img = img.to(torch.float32)
    return _B * img[..., 0] + _G * img[..., 1] + _R * img[..., 2]
