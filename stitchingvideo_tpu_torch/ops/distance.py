"""Exact L1 (city-block) distance transform.

Port of `stitchingvideo_tpu/ops/distance.py`. The L1 transform is separable:
a vertical min-plus pass, then a horizontal one. The reference runs each pass
as two sequential scans (`carry = min(carry + 1, row)`), H + W dependent
steps. Here the same min-plus

    d[i] = min_j (src[j] + |i - j|)
         = min(i + min_{j<=i}(src[j] - j),  -i + min_{j>=i}(src[j] + j))

is two `torch.cummin` calls an axis, batched over any leading dimensions, so
a registration costs a handful of launches on the card. Every value is a
small integer held in float32, so the result is bit-equal to the scans'.
"""
from __future__ import annotations

import torch


def _minplus_1d(src: torch.Tensor, dim: int) -> torch.Tensor:
    """d[i] = min_j (src[j] + |i - j|) along `dim`."""
    n = src.shape[dim]
    shape = [1] * src.dim()
    shape[dim] = n
    i = torch.arange(n, dtype=src.dtype, device=src.device).reshape(shape)
    down = i + torch.cummin(src - i, dim).values
    up = torch.cummin((src + i).flip(dim), dim).values.flip(dim) - i
    return torch.minimum(down, up)


def distance_transform_l1(mask: torch.Tensor) -> torch.Tensor:
    """Distance of each True pixel to the nearest False pixel (L1 metric).

    mask: [..., H, W] bool; leading dimensions are a batch. An all-True
    image returns H + W + 1 everywhere, as the reference does."""
    H, W = mask.shape[-2:]
    big = float(H + W + 1)
    src = mask.to(torch.float32) * big
    d = _minplus_1d(_minplus_1d(src, -2), -1)
    return d.clamp(max=big)
