"""Tiled remap of a single image: the on-the-fly composite kernel with a
one-camera LUT.

Port of `stitchingvideo_tpu/ops/pallas/remap.py`. Any smooth backward map
(rotation warps, undistortion, map compositions) goes through
`composite_tiled`; a map that the tile build cannot represent gives `None`,
and the caller takes a plain remap instead.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..video.lut import CompositeLUT
from .composite import build_tiled_lut, composite_tiled


def remap_tiled(image: torch.Tensor, xmap: torch.Tensor, ymap: torch.Tensor,
                valid: Optional[torch.Tensor] = None
                ) -> Optional[torch.Tensor]:
    """Bilinear remap of one [H, W, 3] uint8 image through the tiled kernel
    (on a CUDA image) or its plain version (on a CPU image).

    Returns None when the map is not tile-representable: the image is
    smaller than the source window, or a tile overflows it. Out-of-source or
    invalid pixels come back as 0 (border-constant semantics)."""
    H, W = image.shape[:2]
    x = xmap.to(image.device, torch.float32)
    y = ymap.to(image.device, torch.float32)
    inb = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    if valid is not None:
        inb = inb & valid.to(image.device)
    zero = torch.zeros((), dtype=torch.float32, device=image.device)
    lut = CompositeLUT(cam_idx=torch.where(inb, 0, -1).to(torch.int32),
                       src_x=torch.where(inb, x, zero),
                       src_y=torch.where(inb, y, zero),
                       gain=torch.ones_like(x))
    try:
        tlut = build_tiled_lut(lut, (H, W))
    except ValueError:
        return None
    if tlut.n_fallback != 0:
        return None
    return composite_tiled(image[None], tlut)
