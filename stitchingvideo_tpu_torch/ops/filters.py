"""Separable filtering and morphology primitives.

Port of `stitchingvideo_tpu/ops/filters.py`: the cv:: filtering calls the
reference leans on (sepFilter2D, exposure_compensate.cpp:224-235; Sobel,
seam_finders.cpp; dilate, CLI driver :726). Filters pad 'reflect101'
(OpenCV's BORDER_DEFAULT) unless stated and run as depthwise convolutions;
dilate and erode are max pools.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _pad2d(x: torch.Tensor, ph: int, pw: int,
           mode: str = "reflect101") -> torch.Tensor:
    """Pad the first two axes of [H, W, ...] by (ph, pw) on both sides."""
    if ph == 0 and pw == 0:
        return x
    if mode == "constant":
        pad = [0, 0] * (x.dim() - 2) + [pw, pw, ph, ph]
        return F.pad(x, pad)
    # index remaps: torch's 'reflect' is reflect101 but takes no pad wider
    # than the axis, and its 'replicate' wants a batch axis
    def idx(n, p):
        i = torch.arange(-p, n + p, device=x.device)
        if mode == "edge":
            return i.clamp(0, n - 1)
        if mode == "reflect101":
            period = 2 * (n - 1) if n > 1 else 1
            m = torch.remainder(i, period)
            return torch.where(m < n, m, period - m)
        if mode == "reflect":
            m = torch.remainder(i, 2 * n)
            return torch.where(m < n, m, 2 * n - 1 - m)
        raise ValueError(f"unknown pad mode {mode}")

    return x[idx(x.shape[0], ph)][:, idx(x.shape[1], pw)]


def sep_filter2d(img: torch.Tensor, kx: np.ndarray, ky: np.ndarray,
                 border: str = "reflect101") -> torch.Tensor:
    """Separable filter; img [H,W] or [H,W,C], float compute."""
    squeeze = img.dim() == 2
    if squeeze:
        img = img[..., None]
    C = img.shape[2]
    kx = torch.as_tensor(np.asarray(kx, np.float32).reshape(-1),
                         device=img.device)
    ky = torch.as_tensor(np.asarray(ky, np.float32).reshape(-1),
                         device=img.device)
    rx, ry = (kx.shape[0] - 1) // 2, (ky.shape[0] - 1) // 2
    x = _pad2d(img.to(torch.float32), ry, rx, border)
    x = x.permute(2, 0, 1)[None]                       # [1, C, H', W']
    x = F.conv2d(x, ky.reshape(1, 1, -1, 1).expand(C, 1, -1, 1), groups=C)
    x = F.conv2d(x, kx.reshape(1, 1, 1, -1).expand(C, 1, 1, -1), groups=C)
    out = x[0].permute(1, 2, 0)
    return out[..., 0] if squeeze else out


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8  # OpenCV convention
    r = (ksize - 1) / 2
    x = np.arange(ksize) - r
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    k = gaussian_kernel(ksize, sigma)
    return sep_filter2d(img, k, k)


def sobel(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    """3x3 Sobel derivative (cv::Sobel ksize=3 parity)."""
    smooth = np.array([1, 2, 1], np.float32)
    deriv = np.array([-1, 0, 1], np.float32)
    return sep_filter2d(img, deriv if dx else smooth, deriv if dy else smooth)


def box_filter(img: torch.Tensor, ksize: int,
               normalize: bool = True) -> torch.Tensor:
    k = np.ones(ksize, np.float32)
    if normalize:
        k /= ksize
    return sep_filter2d(img, k, k)


def _pool(x: torch.Tensor, ksize: int) -> torch.Tensor:
    """ksize x ksize max over the first two axes of [H, W, ...], padded
    with -inf (max_pool2d's own padding)."""
    shape = x.shape
    x4 = x.reshape(shape[0], shape[1], -1).permute(2, 0, 1)[None]
    out = F.max_pool2d(x4, ksize, stride=1, padding=ksize // 2)
    return out[0].permute(1, 2, 0).reshape(shape)


def dilate(mask: torch.Tensor, ksize: int = 3,
           iterations: int = 1) -> torch.Tensor:
    """Binary/gray dilation with a ksize x ksize rect kernel (cv::dilate)."""
    x = mask.to(torch.float32)
    for _ in range(iterations):
        x = _pool(x, ksize)
    return x.to(mask.dtype)


def erode(mask: torch.Tensor, ksize: int = 3) -> torch.Tensor:
    return (-_pool(-mask.to(torch.float32), ksize)).to(mask.dtype)
