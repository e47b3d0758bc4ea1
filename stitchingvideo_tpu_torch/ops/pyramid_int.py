"""Fixed-point (CV_16S) image pyramids, bit-compatible with cv::pyrDown/pyrUp.

Port of `stitchingvideo_tpu/ops/pyramid_int.py`: the integer pyramid path of
MultiBandBlender's CV_16S weight mode (reference src/blenders.cpp:189-377,
createLaplacePyr :435-489, restoreImageFromLaplacePyr :520-530). OpenCV's
pyrDown/pyrUp on integer types compute the separable [1 4 6 4 1] kernel in
integer arithmetic and cast with FixPtCast: pyrDown rounds with
(acc + 128) >> 8 (2-D kernel sum 256), pyrUp with (acc + 32) >> 6 (zero-
stuffed conv, 2-D contribution sum 64). The shifts are arithmetic shifts of
int32 (floor on negative values), never divisions. Borders are index
gathers: BORDER_REFLECT_101 (torch's reflect pad takes no integer tensor).
All shapes are even (the blender pads every ROI to a multiple of
2^num_bands), so each level is exactly half/double the previous.

Everything is int32, so the same code is exact on the CPU and on CUDA.
"""
from __future__ import annotations

from typing import List

import torch

from .filters import _pad2d


def _gather_hw(x: torch.Tensor, iy: torch.Tensor,
               ix: torch.Tensor) -> torch.Tensor:
    """x[iy][:, ix] over the two leading (H, W) axes."""
    return x.index_select(0, iy).index_select(1, ix)


def _conv5(x: torch.Tensor, dim: int) -> torch.Tensor:
    """VALID conv with integer taps [1, 4, 6, 4, 1] along `dim`."""
    n = x.shape[dim] - 4

    def sl(o):
        return x.narrow(dim, o, n)

    return sl(0) + 4 * sl(1) + 6 * sl(2) + 4 * sl(3) + sl(4)


def pyr_down_i16(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrDown on CV_16S data (values kept in int32). H, W even."""
    x = _pad2d(img.to(torch.int32), 2, 2, "reflect101")
    x = _conv5(_conv5(x, 0), 1)[::2, ::2]
    return torch.bitwise_right_shift(x + 128, 8)   # FixPtCast<int, short, 8>


def pyr_up_i16(img: torch.Tensor) -> torch.Tensor:
    """cv::pyrUp on CV_16S data: zero-stuffed x2 upsample + [1 4 6 4 1]
    conv, rounded with (acc + 32) >> 6. Output is exactly 2H x 2W.

    Border quirk (the reference verified it bit-level against cv2.pyrUp):
    the top/left border is BORDER_REFLECT_101 but the bottom/right border
    replicates the last row/column."""
    x = img.to(torch.int32)

    def idx(n):
        # [reflect101(-1), 0 .. n-1, n-1]
        return torch.cat([torch.tensor([min(1, n - 1)]), torch.arange(n),
                          torch.tensor([n - 1])]).to(x.device)

    x = _gather_hw(x, idx(x.shape[0]), idx(x.shape[1]))
    up = torch.zeros((x.shape[0] * 2, x.shape[1] * 2) + tuple(x.shape[2:]),
                     dtype=torch.int32, device=x.device)
    up[::2, ::2] = x                                  # up[2k] = src[k-1]
    # dst(y) = sum_i k[i] * up_global(y + i - 2); up_global -2 is up[0]
    out = _conv5(_conv5(up, 0), 1)
    return torch.bitwise_right_shift(out + 32, 6)   # FixPtCast<int, short, 6>


def create_laplace_pyr_i16(img: torch.Tensor,
                           levels: int) -> List[torch.Tensor]:
    """createLaplacePyr for CV_16S input (blenders.cpp:435-489, else-branch):
    the Gaussian pyrDown chain, then pyr[i] -= pyrUp(pyr[i + 1])."""
    g = weight_pyr_i16(img, levels)
    out = [g[i] - pyr_up_i16(g[i + 1]) for i in range(levels)]
    out.append(g[levels])
    return out


def restore_laplace_i16(pyr: List[torch.Tensor]) -> torch.Tensor:
    """restoreImageFromLaplacePyr (blenders.cpp:520-530)."""
    img = pyr[-1]
    for lvl in reversed(pyr[:-1]):
        img = pyr_up_i16(img) + lvl
    return img


def weight_pyr_i16(weight: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Gaussian pyramid of a CV_16S map (feed, blenders.cpp:285-300)."""
    g = [weight.to(torch.int32)]
    for _ in range(levels):
        g.append(pyr_down_i16(g[-1]))
    return g
