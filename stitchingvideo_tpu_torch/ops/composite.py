"""Tile build of the seam-select hot loop, and its on-the-fly kernel.

Port of `stitchingvideo_tpu/ops/pallas/composite.py`. The build half
(`_build` / `build_tiled_lut`): the panorama is cut into 8x128 tiles; each
tile gets at most two source cameras, a source window per camera (origins
aligned to 8 rows / 128 columns) and a 32-column band offset inside the
window. A tile whose pixels span more than two cameras, or overflow their
window, is a fallback tile. The port's kernels gather their taps directly and
need no windows, but the fallback flags decide which pixels take the exact
float overlay, so every integer field here is bit-exact with the JAX build.

The compose half (`composite_tiled`, `kernel='tiled'`): the reference's
kernel builds hat weights `max(0, 1 - |w - s|)` from the float source
coordinates inside the kernel, rounds the x-hats to bfloat16, keeps the
y-hats in float32, and contracts them against bfloat16 frames with float32
accumulation. Only two hats an axis are non-zero, so the port's kernel
(`csrc/composite_tiled.cu`) gathers four taps and repeats that arithmetic
with every step rounded as the reference rounds it. It reads uint8 frames:
the reference's bfloat16 frames hold the same values, exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from . import _cuda

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
    n_cams:       int          highest camera index + 1
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
    n_cams: int = 0


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


def window(mask, sy, sx, fh: int, fw: int):
    """One tile slot's source window over its masked pixels ([T, P] each):
    aligned origins (oy, ox), the 32-granular band offset inside the window,
    and whether the pixels overflow the window or the band."""
    oy, ovy, _, _ = _origin(mask, sy, WIN_H, fh, ALIGN_Y)
    ox, ovx, lo, hi = _origin(mask, sx, WIN_W, fw, ALIGN_X)
    boff = (_floor_div(torch.floor(lo).to(torch.int32) - 1 - ox,
                       BAND_STEP) * BAND_STEP).clamp(0, WIN_W - VXW)
    ovb = torch.isfinite(hi) & (hi > (ox + boff).to(torch.float32) + VXW - 1)
    return oy, ox, boff, ovy | ovx | ovb


def tile(a: torch.Tensor, fill, grid_hw) -> torch.Tensor:
    """[Hp, Wp] -> [T, P] tile-major, row-major within a tile, padded."""
    nty, ntx = grid_hw
    Hp, Wp = a.shape
    a = F.pad(a, (0, ntx * TILE_W - Wp, 0, nty * TILE_H - Hp), value=fill)
    return a.reshape(nty, TILE_H, ntx, TILE_W).permute(0, 2, 1, 3) \
            .reshape(nty * ntx, P)


def untile(a: torch.Tensor, grid_hw, pano_hw) -> torch.Tensor:
    """[T, P, ...] tile-major -> [Hp, Wp, ...] on the panorama."""
    nty, ntx = grid_hw
    Hp, Wp = pano_hw
    rest = a.shape[2:]
    a = a.reshape(nty, ntx, TILE_H, TILE_W, *rest).transpose(1, 2)
    return a.reshape(nty * TILE_H, ntx * TILE_W, *rest)[:Hp, :Wp]


def build_tiled_lut(lut, frame_hw: Tuple[int, int]) -> TiledLUT:
    """From a CompositeLUT (video/lut.py). frame_hw = (H, W) of camera frames."""
    fh, fw = (int(x) for x in frame_hw)
    if fh < WIN_H or fw < WIN_W:
        raise ValueError(f"camera frames {(fh, fw)} smaller than the source "
                         f"window ({WIN_H}, {WIN_W}); use kernel='gather'")
    Hp, Wp = lut.shape
    grid = nty, ntx = -(-Hp // TILE_H), -(-Wp // TILE_W)

    camf = tile(lut.cam_idx, -1, grid)
    # edge pixels may carry coords in (W-1, W-0.5); clamp to the last source
    # pixel (the gather clamps its taps identically)
    sxt = tile(lut.src_x, 0.0, grid).clamp(0.0, fw - 1.0)
    syt = tile(lut.src_y, 0.0, grid).clamp(0.0, fh - 1.0)
    gt = tile(lut.gain, 1.0, grid)
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
        oy, ox, boff, ovf = window(valid & (camf == cam_s[:, None]), syt, sxt,
                                   fh, fw)
        orgs += [oy, ox]
        bands.append(boff)
        fallback = fallback | ovf

    i32 = torch.int32
    return TiledLUT(
        sx=sxt, sy=syt, gain=gt, cidx=camf.to(i32),
        tile_cam=torch.stack([cam_a, cam_b], dim=1).to(i32).reshape(-1),
        tile_org=torch.stack(orgs, dim=1).to(i32).reshape(-1),
        tile_band=torch.stack(bands, dim=1).to(i32).reshape(-1),
        fallback=fallback, n_fallback=int(fallback.sum()),
        grid_hw=(nty, ntx), pano_hw=(Hp, Wp), frame_hw=(fh, fw),
        n_cams=int(camf.max()) + 1 if camf.numel() else 0)


def concat_tiled_luts(luts, cams) -> TiledLUT:
    """Concatenate per-piece single-camera TiledLUTs into one multi-camera
    LUT, so that one launch warps every piece (the multiband window stack).

    Each input LUT was built against one camera (cam_idx in {0, -1});
    tile_cam and cidx are rewritten to the real camera index `cams[p]`. All
    pieces must share grid and frame shapes. The result's panorama is the
    pieces' tile grids stacked along rows."""
    nty, ntx = luts[0].grid_hw
    fhw = luts[0].frame_hw
    if not all(l.grid_hw == (nty, ntx) and l.frame_hw == fhw for l in luts):
        raise ValueError("pieces differ in grid or frame shape")

    def cat(f):
        return torch.cat([getattr(l, f) for l in luts], dim=0)

    return TiledLUT(
        sx=cat("sx"), sy=cat("sy"), gain=cat("gain"),
        cidx=torch.cat([torch.where(l.cidx >= 0, int(c), -1).to(torch.int32)
                        for l, c in zip(luts, cams)], dim=0),
        tile_cam=torch.cat([torch.full_like(l.tile_cam, int(c))
                            for l, c in zip(luts, cams)], dim=0),
        tile_org=cat("tile_org"), tile_band=cat("tile_band"),
        fallback=cat("fallback"),
        n_fallback=sum(l.n_fallback for l in luts),
        grid_hw=(len(luts) * nty, ntx),
        pano_hw=(len(luts) * nty * TILE_H, ntx * TILE_W), frame_hw=fhw,
        n_cams=max(int(c) for c in cams) + 1)


# -- the on-the-fly kernel (kernel='tiled') ---------------------------------

TILED = _cuda.CudaKernel("composite_tiled", _cuda.COMPOSITE_TILED)


def _hat(tap: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """The reference's hat weight of integer position `tap` for coord `s`."""
    return (1.0 - (tap - s).abs()).clamp(min=0.0)


def _check_tiled(planar: torch.Tensor, tlut: TiledLUT) -> None:
    if planar.dtype != torch.uint8 or planar.dim() != 4 \
            or planar.shape[1] != 3:
        raise ValueError("expected [N, 3, H, W] uint8 frames, got "
                         f"{tuple(planar.shape)} {planar.dtype}")
    if tuple(planar.shape[2:]) != tuple(tlut.frame_hw):
        raise ValueError(f"frames are {tuple(planar.shape[2:])}, the LUT was "
                         f"built for {tuple(tlut.frame_hw)}")
    if tlut.n_fallback != 0:
        raise ValueError(f"the LUT has {tlut.n_fallback} fallback tiles and "
                         "the tiled kernel has no fallback path; use "
                         "kernel='mat2' or 'gather'")
    if planar.device != tlut.sx.device:
        raise ValueError(f"frames on {planar.device}, LUT on "
                         f"{tlut.sx.device}")
    if not planar.is_contiguous():
        raise ValueError("frames must be contiguous")
    if planar.shape[0] < tlut.n_cams:
        raise ValueError(f"the LUT addresses {tlut.n_cams} cameras, got "
                         f"{planar.shape[0]}")


def composite_tiled_plain(planar_u8: torch.Tensor,
                          tlut: TiledLUT) -> torch.Tensor:
    """Plain PyTorch version of the kernel, step for step: [N, 3, H, W] uint8
    -> [Hp, Wp, 3] uint8. The CPU path, and the version the kernel is held
    against on the card."""
    _check_tiled(planar_u8, tlut)
    N, _, H, W = planar_u8.shape
    sx, sy = tlut.sx, tlut.sy
    x0f, y0f = torch.floor(sx), torch.floor(sy)

    def bf16(w):
        return w.to(torch.bfloat16).to(torch.float32)

    wx0, wx1 = bf16(_hat(x0f, sx)), bf16(_hat(x0f + 1.0, sx))
    wy0, wy1 = _hat(y0f, sy), _hat(y0f + 1.0, sy)
    x0, y0 = x0f.long(), y0f.long()
    # the tap past the frame has weight 0 (sx, sy are clipped to the frame)
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    covered = tlut.cidx >= 0
    flat = planar_u8.reshape(-1)
    out = torch.zeros(tuple(sx.shape) + (3,), dtype=torch.uint8,
                      device=sx.device)
    for c in range(3):
        base = (tlut.cidx.clamp(min=0).long() * 3 + c) * (H * W)

        def tap(yi, xi):
            return flat[base + yi * W + xi].to(torch.float32)

        r0 = tap(y0, x0) * wx0 + tap(y0, x1) * wx1
        r1 = tap(y1, x0) * wx0 + tap(y1, x1) * wx1
        v = (r0 * wy0 + r1 * wy1) * tlut.gain
        v = torch.where(covered, v, torch.zeros((), device=v.device))
        out[..., c] = torch.round(v).clamp(0, 255).to(torch.uint8)
    return untile(out, tlut.grid_hw, tlut.pano_hw).contiguous()


def composite_tiled_planar(planar_u8: torch.Tensor,
                           tlut: TiledLUT) -> torch.Tensor:
    """[N, 3, H, W] uint8 planar frames -> [Hp, Wp, 3] uint8 panorama (the
    reference takes the same values as bfloat16). On a CUDA tensor it
    launches the kernel; on a CPU tensor it runs the plain version. Raises
    `ValueError` on a LUT with fallback tiles: like the reference's, this
    kernel has no fallback path."""
    if planar_u8.device.type == "cpu":
        return composite_tiled_plain(planar_u8, tlut)
    if planar_u8.device.type != "cuda":
        raise ValueError(f"no kernel for device {planar_u8.device}")
    _check_tiled(planar_u8, tlut)
    N, _, H, W = planar_u8.shape
    Hp, Wp = tlut.pano_hw
    out = torch.empty((Hp, Wp, 3), dtype=torch.uint8, device=planar_u8.device)
    TILED.launch(*(t.data_ptr() for t in (planar_u8, tlut.sx, tlut.sy,
                                          tlut.gain, tlut.cidx, out)),
                 N, H, W, tlut.grid_hw[1], tlut.sx.shape[0], Hp, Wp,
                 torch.cuda.current_stream(planar_u8.device).cuda_stream)
    return out


def composite_tiled(frames: torch.Tensor, tlut: TiledLUT) -> torch.Tensor:
    """[N, H, W, 3] uint8 frames -> [Hp, Wp, 3] uint8 panorama."""
    return composite_tiled_planar(frames.permute(0, 3, 1, 2).contiguous(),
                                  tlut)
