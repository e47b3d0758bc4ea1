"""OpenCV-faithful MultiBandBlender (CV_16S fixed-point weight path).

Port of `stitchingvideo_tpu/blend/multiband_cv.py`: cv::detail::
MultiBandBlender's prepare/feed/blend semantics (reference
src/blenders.cpp:189-377) with the CV_16S weight type (the cv2 default).
Every convention that shapes the output bits is reproduced:

- prepare: num_bands cropped to ceil(log2(max(W, H))), dst ROI padded to a
  multiple of 2^bands (blenders.cpp:204-233).
- feed: per-image sub-ROI = image rect grown by gap = 3*2^bands, clamped to
  the dst ROI, top-left aligned down to a 2^bands grid, size padded up to a
  2^bands multiple, shifted back inside the ROI (:250-270); image bordered
  with BORDER_REFLECT, mask with BORDER_CONSTANT (:277-300); weights are the
  mask as CV_16S plus 1 where nonzero (so 255 -> 256); Laplacian bands
  accumulate as (value * weight) >> 8 (:343-370).
- blend: per-band (value << 8) / (weight + 1) with C trunc division
  (normalizeUsingWeightMap :407-424), pyramid collapse, crop to the final
  ROI, mask = weight > 0 (:360-377).

The band pyramids are int32 tensors on the blender's device; each feed adds
an image's bands into them in place at its per-level origin. The sub-ROI
bookkeeping is host integers (floor shifts of possibly negative corners).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.pyramid_int import (_gather_hw, create_laplace_pyr_i16,
                               pyr_up_i16, weight_pyr_i16)
from ..ops.remap import BORDER_REFLECT, _map_index


def _feed_bands(img16: torch.Tensor, w16: torch.Tensor, bands: int):
    """One image's weighted Laplacian bands and weight pyramid (int32)."""
    src = create_laplace_pyr_i16(img16, bands)
    wp = weight_pyr_i16(w16, bands)
    acc = [torch.bitwise_right_shift(s * w[..., None], 8)
           for s, w in zip(src, wp)]
    return acc, wp


def _feed_accum(dst_l, dst_w, img_b16, w_b16, offs, bands) -> None:
    """Compute one image's bands and add them into the pyramids dst_l,
    dst_w in place; offs[i] = (y_tl >> i, x_tl >> i) is the per-level
    sub-ROI origin."""
    acc, wp = _feed_bands(img_b16.to(torch.int32), w_b16.to(torch.int32),
                          bands)
    for i in range(bands + 1):
        oy, ox = int(offs[i][0]), int(offs[i][1])
        hh, ww = acc[i].shape[:2]
        dst_l[i][oy:oy + hh, ox:ox + ww] += acc[i]
        dst_w[i][oy:oy + hh, ox:ox + ww] += wp[i]


def _normalize_band(band: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(v << 8) / (w + 1) with C-style truncation toward zero."""
    return torch.div(band * 256, (w + 1)[..., None], rounding_mode="trunc")


def _blend_final(dst_l, dst_w, fh: int, fw: int):
    """Normalize all bands, collapse the pyramid, crop, zero-fill."""
    norm = [_normalize_band(b, w) for b, w in zip(dst_l, dst_w)]
    img = norm[-1]
    for lvl in reversed(norm[:-1]):
        img = pyr_up_i16(img) + lvl
    pano = img[:fh, :fw]
    mask = dst_w[0][:fh, :fw] > 0
    pano = torch.where(mask[..., None], pano, torch.zeros_like(pano))
    return pano.to(torch.int16), mask


def _pad_hw(x: torch.Tensor, top: int, bottom: int, left: int, right: int,
            border: str) -> torch.Tensor:
    """Pad the two leading (H, W) axes by an index gather (`border` one of
    ops.remap's border modes)."""
    def idx(n, lo, hi):
        return _map_index(torch.arange(-lo, n + hi, device=x.device), n,
                          border)
    return _gather_hw(x, idx(x.shape[0], top, bottom),
                      idx(x.shape[1], left, right))


class MultiBandBlenderCV:
    """Drop-in analogue of cv2.detail_MultiBandBlender (CV_16S weights).

    device: 'cuda' unless given; with no CUDA present the default raises."""

    def __init__(self, num_bands: int = 5, device=None):
        self.actual_num_bands = num_bands
        self.num_bands = num_bands
        self.device = resolve_device(device, "MultiBandBlenderCV")

    # ------------------------------------------------------------------
    def prepare(self, dst_roi: Tuple[int, int, int, int]) -> None:
        """dst_roi = (x, y, width, height) in panorama coordinates."""
        x, y, w, h = dst_roi
        self.final_roi = (x, y, w, h)
        max_len = float(max(w, h))
        self.num_bands = min(self.actual_num_bands,
                             int(np.ceil(np.log(max_len) / np.log(2.0))))
        q = 1 << self.num_bands
        w += (q - w % q) % q
        h += (q - h % q) % q
        self.roi = (x, y, w, h)
        self.dst_laplace: List[torch.Tensor] = []
        self.dst_weights: List[torch.Tensor] = []
        hh, ww = h, w
        for _ in range(self.num_bands + 1):
            self.dst_laplace.append(torch.zeros((hh, ww, 3), dtype=torch.int32,
                                                device=self.device))
            self.dst_weights.append(torch.zeros((hh, ww), dtype=torch.int32,
                                                device=self.device))
            hh, ww = (hh + 1) // 2, (ww + 1) // 2

    # ------------------------------------------------------------------
    def _sub_roi(self, tl: Tuple[int, int], h: int, w: int):
        """feed's sub-ROI bookkeeping (blenders.cpp:250-270): border pads +
        per-level accumulator origins for an image rect at tl of size h x w.
        Host integers: the shifts floor negative corners as C++'s do."""
        nb = self.num_bands
        rx, ry, rw, rh = self.roi
        brx_roi, bry_roi = rx + rw, ry + rh
        gap = 3 * (1 << nb)

        tlx = max(rx, tl[0] - gap)
        tly = max(ry, tl[1] - gap)
        brx = min(brx_roi, tl[0] + w + gap)
        bry = min(bry_roi, tl[1] + h + gap)

        tlx = rx + (((tlx - rx) >> nb) << nb)
        tly = ry + (((tly - ry) >> nb) << nb)
        width = brx - tlx
        height = bry - tly
        width += ((1 << nb) - width % (1 << nb)) % (1 << nb)
        height += ((1 << nb) - height % (1 << nb)) % (1 << nb)
        brx = tlx + width
        bry = tly + height
        dx = max(brx - brx_roi, 0)
        dy = max(bry - bry_roi, 0)
        tlx -= dx
        brx -= dx
        tly -= dy
        bry -= dy

        pads = (tl[1] - tly, tl[0] - tlx, bry - tl[1] - h, brx - tl[0] - w)
        offs = [((tly - ry) >> i, (tlx - rx) >> i) for i in range(nb + 1)]
        return pads, offs

    def feed_dev(self, img_dev: torch.Tensor, mask_dev: torch.Tensor,
                 tl: Tuple[int, int]) -> None:
        """img [h, w, 3] int16-valued (CV_16S) and mask [h, w] uint8,
        tensors on the blender's device, at tl = (x, y) panorama
        coordinates of the image rect; border pads, weighting, pyramids and
        accumulation all run there (a host array goes in as a CPU tensor on
        a CPU blender). The reference's host `feed` has no copy here."""
        h, w = img_dev.shape[:2]
        (top, left, bottom, right), offs = self._sub_roi(tl, h, w)
        img_b = _pad_hw(img_dev.to(torch.int16), top, bottom, left, right,
                        BORDER_REFLECT)
        weight = mask_dev.to(torch.int16)
        weight = torch.where(mask_dev != 0, weight + 1, weight)
        w_b = torch.nn.functional.pad(weight, (left, right, top, bottom))
        _feed_accum(self.dst_laplace, self.dst_weights, img_b, w_b, offs,
                    self.num_bands)

    # ------------------------------------------------------------------
    def blend(self) -> Tuple[np.ndarray, np.ndarray]:
        """Returns (panorama int16-valued [H, W, 3] int32, mask bool), on
        the host."""
        _, _, fw, fh = self.final_roi
        pano, mask = _blend_final(self.dst_laplace, self.dst_weights, fh, fw)
        return pano.cpu().numpy().astype(np.int32), mask.cpu().numpy()
