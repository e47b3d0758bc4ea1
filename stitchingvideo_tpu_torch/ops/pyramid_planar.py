"""Planar ([C, H, W]) Gaussian / Laplacian pyramid steps.

Port of `stitchingvideo_tpu/ops/pyramid_planar.py` (OpenCV's 5-tap kernel,
even sizes). The JAX package applies each step as two banded matrices on the
TPU's matrix unit, outside any Pallas kernel; `_down_mat` and `_up_mat` are
those matrices, copied, and they are the spec of the borders: a decimation
reflects (101) on both sides, an upsample reflects on the left and replicates
the edge on the right. Here the same taps run as strided shifted adds, which
do the 5 (down) or 2-3 (up) multiplies an output needs instead of a row of
the banded matrix, and meet no TF32 or cuDNN algorithm choice on the card:
every operation is an elementwise float32 multiply or add, rounded the same
on the CPU and on CUDA.

Rounding points, as `_mm_axes` has them: the H pass runs first. With
bfloat16 input the taps (k/16, their doubles and border sums: all exact in
bfloat16) multiply bfloat16 values, sums are float32, and the H pass's result
is rounded to bfloat16 before the W pass; the W pass's float32 result is
rounded to `out_dtype` (bfloat16 unless given). With float32 input
everything stays float32. Against the matrix form the sums are taken in
another order: float32 results agree to rounding (1e-3 absolute on 0..255
data), bfloat16 results but for a rare value one bfloat16 step away
(`tests/test_torch_pyramid.py`).
"""
from __future__ import annotations

from functools import lru_cache
from typing import List

import numpy as np
import torch

_K5 = np.array([1.0, 4.0, 6.0, 4.0, 1.0], np.float32) / 16.0


@lru_cache(maxsize=64)
def _down_mat(n: int) -> np.ndarray:
    """[n, n//2] banded decimation matrix: out[i] = sum_k K5[k] x[r(2i+k-2)]
    with reflect-101 borders."""
    m = n // 2
    D = np.zeros((n, m), np.float32)
    for i in range(m):
        for k in range(5):
            j = 2 * i + k - 2
            if j < 0:
                j = -j
            elif j >= n:
                j = 2 * (n - 1) - j
            D[j, i] += _K5[k]
    return D


@lru_cache(maxsize=64)
def _up_mat(n: int) -> np.ndarray:
    """[n, 2n] zero-stuff upsample matrix: even output 2i takes
    2 (k0 x[i-1] + k2 x[i] + k4 x[i+1]), odd output 2i+1 takes
    2 (k1 x[i] + k3 x[i+1]); left of x[0] reflects to x[1], right of x[n-1]
    replicates x[n-1] (the stuffed array ends in a zero)."""
    U = np.zeros((n, 2 * n), np.float32)
    for i in range(n):
        for k, off in ((0, -1), (2, 0), (4, 1)):   # even output 2i
            j = i + off
            j = 1 if j < 0 else (n - 1 if j >= n else j)
            U[j, 2 * i] += 2.0 * _K5[k]
        for k, off in ((1, 0), (3, 1)):            # odd output 2i+1
            U[min(i + off, n - 1), 2 * i + 1] += 2.0 * _K5[k]
    return U


def _weighted_sum(terms) -> torch.Tensor:
    """float32 sum of weight * view over (view, weight) pairs, left to right,
    each product and each sum a separate rounded operation."""
    acc = None
    for view, w in terms:
        t = view.to(torch.float32) * float(w)
        acc = t if acc is None else acc.add_(t)
    return acc


def _down_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """Blur + 2:1 decimate along `axis` (reflect-101): float32."""
    n = x.shape[axis]
    if n < 4 or n % 2:
        raise ValueError(f"pyr_down needs an even size >= 4, got {n}")
    xp = torch.cat([x.narrow(axis, 2, 1), x.narrow(axis, 1, 1), x,
                    x.narrow(axis, n - 2, 1), x.narrow(axis, n - 3, 1)],
                   dim=axis)
    sl = [slice(None)] * x.dim()

    def s(k):
        sl[axis] = slice(k, k + n, 2)
        return xp[tuple(sl)]

    return _weighted_sum((s(k), _K5[k]) for k in range(5))


def _up_axis(x: torch.Tensor, axis: int) -> torch.Tensor:
    """1:2 zero-stuff + blur (x2 kernel) along `axis`: float32."""
    n = x.shape[axis]
    if n < 2:
        raise ValueError(f"pyr_up needs a size >= 2, got {n}")
    xp = torch.cat([x.narrow(axis, 1, 1), x, x.narrow(axis, n - 1, 1)],
                   dim=axis)

    def s(off):
        return xp.narrow(axis, off, n)

    k = 2.0 * _K5
    even = _weighted_sum(((s(0), k[0]), (s(1), k[2]), (s(2), k[4])))
    odd = _weighted_sum(((s(1), k[1]), (s(2), k[3])))
    shape = list(x.shape)
    shape[axis] = 2 * n
    return torch.stack([even, odd], dim=axis + 1).reshape(shape)


def _resample(x: torch.Tensor, step, out_dtype) -> torch.Tensor:
    """`step` along H, then along W, with `_mm_axes`'s rounding points."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"pyramids take float32 or bfloat16, got {x.dtype}")
    h, w = x.dim() - 2, x.dim() - 1
    return step(step(x, h).to(x.dtype), w).to(out_dtype or x.dtype)


def pyr_down_p(x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """[..., H, W] -> [..., H//2, W//2] (H, W even)."""
    return _resample(x, _down_axis, out_dtype)


def pyr_up_p(x: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """[..., H, W] -> [..., 2H, 2W]: zero-stuff upsample.

    out_dtype overrides the output type without changing the working type:
    bfloat16 input with float32 output keeps the W pass's float32 sums."""
    return _resample(x, _up_axis, out_dtype)


def gaussian_pyramid_p(x: torch.Tensor, levels: int) -> List[torch.Tensor]:
    pyr = [x]
    for _ in range(levels):
        pyr.append(pyr_down_p(pyr[-1]))
    return pyr


def collapse_laplacian_p(pyr: List[torch.Tensor]) -> torch.Tensor:
    img = pyr[-1]
    for lvl in reversed(pyr[:-1]):
        img = pyr_up_p(img) + lvl
    return img
