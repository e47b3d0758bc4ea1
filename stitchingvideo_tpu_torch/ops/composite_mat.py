"""Frame layout helpers of the hot loop.

Port of `frames_to_planar_i8` and `planar_to_hwc` from
`stitchingvideo_tpu/ops/pallas/composite_mat.py`: the kernels read
channel-planar int8 frames (value - 128) and write channel-planar uint8.
"""
from __future__ import annotations

import torch


def frames_to_planar_i8(frames: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8 -> [..., 3, H, W] int8 (value - 128)."""
    x = frames.movedim(-1, -3).to(torch.int16) - 128
    return x.to(torch.int8).contiguous()


def planar_to_hwc(pano_planar: torch.Tensor) -> torch.Tensor:
    """[3, H, W] -> [H, W, 3] (display/export convenience; not the hot path)."""
    return pano_planar.permute(1, 2, 0)
