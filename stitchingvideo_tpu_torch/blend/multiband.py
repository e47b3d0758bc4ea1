"""Multi-band blending: the band-count and padding rules.

Port of the parts of `stitchingvideo_tpu/blend/multiband.py` that the video
mode needs. `multiband_blend` (the still path's full-canvas blend) is not
ported yet (ROADMAP.md, queue 1, item 19).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

WEIGHT_EPS = 1e-5


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
