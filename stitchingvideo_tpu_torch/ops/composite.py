"""Tile build of the seam-select hot loop.

Port of the build half of `stitchingvideo_tpu/ops/pallas/composite.py`
(`_build` / `build_tiled_lut`). The panorama is cut into 8x128 tiles; each
tile gets at most two source cameras, a source window per camera (origins
aligned to 8 rows / 128 columns) and a 32-column band offset inside the
window. A tile whose pixels span more than two cameras, or overflow their
window, is a fallback tile. The port's kernel gathers its taps directly and
needs no windows, but the fallback flags decide which pixels take the exact
float overlay, so every integer field here is bit-exact with the JAX build.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

TILE_H = 8
TILE_W = 128
P = TILE_H * TILE_W          # 1024 pixels per tile
WIN_H = 80
WIN_W = 384
VXW = 256                    # width of the hat band inside the window
BAND_STEP = 32
ALIGN_Y = 8
ALIGN_X = 128


@dataclasses.dataclass
class TiledLUT:
    """Tile-major composite LUT + per-tile window metadata.

    sx, sy, gain: [T, P] float32 (sx/sy clipped to the frame)
    cidx:         [T, P] int32 (-1 = uncovered)
    tile_cam:     [T*2] int32  up to two source cameras per tile (flat)
    tile_org:     [T*4] int32  (oy_a, ox_a, oy_b, ox_b) window origins (flat)
    tile_band:    [T*2] int32  32-granular band offsets within the window
    fallback:     [T] bool     tile not representable by two windows
    n_fallback:   int          count of fallback tiles
    """
    sx: torch.Tensor
    sy: torch.Tensor
    gain: torch.Tensor
    cidx: torch.Tensor
    tile_cam: torch.Tensor
    tile_org: torch.Tensor
    tile_band: torch.Tensor
    fallback: torch.Tensor
    n_fallback: int
    grid_hw: Tuple[int, int]
    pano_hw: Tuple[int, int]
    frame_hw: Tuple[int, int]


def _floor_div(x: torch.Tensor, d: int) -> torch.Tensor:
    return torch.div(x, d, rounding_mode="floor")


def _origin(mask, coord, size: int, limit: int, align: int):
    """Aligned window origin over the masked pixels + its overflow flag."""
    inf = torch.tensor(float("inf"), device=coord.device)
    lo = torch.where(mask, coord, inf).amin(dim=1)
    lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    o = _floor_div(torch.floor(lo).to(torch.int32) - 1, align) * align
    o = o.clamp(0, (limit - size) // align * align)
    hi = torch.where(mask, coord, -inf).amax(dim=1)
    # a coord exactly on the last window row/col has a zero-weight second tap
    # outside the window, which the TPU's hat matrix never forms
    overflow = torch.isfinite(hi) & (hi > o.to(torch.float32) + size - 1)
    return o, overflow, lo, hi


def build_tiled_lut(lut, frame_hw: Tuple[int, int]) -> TiledLUT:
    """From a CompositeLUT (video/lut.py). frame_hw = (H, W) of camera frames."""
    fh, fw = (int(x) for x in frame_hw)
    if fh < WIN_H or fw < WIN_W:
        raise ValueError(f"camera frames {(fh, fw)} smaller than the source "
                         f"window ({WIN_H}, {WIN_W}); use kernel='gather'")
    Hp, Wp = lut.shape
    nty = -(-Hp // TILE_H)
    ntx = -(-Wp // TILE_W)
    Hq, Wq = nty * TILE_H, ntx * TILE_W

    def tiles(a, fill):
        a = F.pad(a, (0, Wq - Wp, 0, Hq - Hp), value=fill)
        return a.reshape(nty, TILE_H, ntx, TILE_W).permute(0, 2, 1, 3) \
                .reshape(nty * ntx, P)

    camf = tiles(lut.cam_idx, -1)
    # edge pixels may carry coords in (W-1, W-0.5); clamp to the last source
    # pixel (the gather clamps its taps identically)
    sxt = tiles(lut.src_x, 0.0).clamp(0.0, fw - 1.0)
    syt = tiles(lut.src_y, 0.0).clamp(0.0, fh - 1.0)
    gt = tiles(lut.gain, 1.0)
    valid = camf >= 0

    big = 1 << 20
    cam_a = torch.where(valid, camf, big).amin(dim=1)
    cam_a = torch.where(cam_a == big, 0, cam_a)
    cam_b = torch.where(valid, camf, -1).amax(dim=1)
    cam_b = torch.where(cam_b < 0, cam_a, cam_b)
    middle = valid & (camf != cam_a[:, None]) & (camf != cam_b[:, None])
    fallback = middle.any(dim=1)

    orgs, bands = [], []
    for cam_s in (cam_a, cam_b):
        m = valid & (camf == cam_s[:, None])
        oy, ovy, _, _ = _origin(m, syt, WIN_H, fh, ALIGN_Y)
        ox, ovx, lo, hi = _origin(m, sxt, WIN_W, fw, ALIGN_X)
        boff = (_floor_div(torch.floor(lo).to(torch.int32) - 1 - ox,
                           BAND_STEP) * BAND_STEP).clamp(0, WIN_W - VXW)
        ovb = torch.isfinite(hi) & \
            (hi > (ox + boff).to(torch.float32) + VXW - 1)
        orgs += [oy, ox]
        bands.append(boff)
        fallback = fallback | ovy | ovx | ovb

    i32 = torch.int32
    return TiledLUT(
        sx=sxt, sy=syt, gain=gt, cidx=camf.to(i32),
        tile_cam=torch.stack([cam_a, cam_b], dim=1).to(i32).reshape(-1),
        tile_org=torch.stack(orgs, dim=1).to(i32).reshape(-1),
        tile_band=torch.stack(bands, dim=1).to(i32).reshape(-1),
        fallback=fallback, n_fallback=int(fallback.sum()),
        grid_hw=(nty, ntx), pano_hw=(Hp, Wp), frame_hw=(fh, fw))
