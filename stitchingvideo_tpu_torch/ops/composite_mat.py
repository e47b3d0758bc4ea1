"""The single-class materialized seam-select composite (`kernel='mat'`), and
the frame layout helpers of the hot loop.

Port of `stitchingvideo_tpu/ops/pallas/composite_mat.py`. The reference
materializes, per 8x128 tile, int8 hat matrices over one 80x384 source
window per camera slot (`_materialize`), slices the 256-wide band out of the
window inside the kernel and contracts in bfloat16, which is exact on int8
values. Per pixel that is

    ((sum of integer weights x int8 taps) * f32(1/16129) + 128) * gain*covered

with the pixel's own slot selected (the other slot's finite value is
multiplied by 0). The port keeps the reference's build, window by window
(`_materialize`'s band-local coordinates, its clips, its weights), and stores
the two non-zeros an axis of each hat matrix per pixel, in global frame
coordinates: 12 bytes a pixel, and, as mat2's state does, the staging table
of those taps (`ops/staging.py`). Its kernel is mat2's staged kernel without
the fallback path (`csrc/composite_mat2.cu`): each block of 32x32 pixels
stages the source boxes its pixels tap into shared memory and gathers the
four taps there.

Like the reference's, this kernel has no fallback path: a tile whose pixels
overflow their window is composed wrong by the clipped weights. The
reference's runtime never hands it such a LUT; `composite_mat_planar` raises
on one.

The kernels read channel-planar int8 frames (value - 128) and write
channel-planar uint8 (`frames_to_planar_i8`, `planar_to_hwc`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from . import _cuda
from .composite import VXW, WIN_H, TiledLUT, build_tiled_lut, untile
from .composite_mat2 import (UNCOVERED, _taps, check_frames, check_packable,
                             check_staged, pack_taps, seam_select_plain,
                             unpack_taps, with_staging_table)

# launch counters of the kernel's two entry points
MAT_SINGLE = _cuda.CudaKernel("composite_mat_planar", _cuda.COMPOSITE_MAT)
MAT_BATCHED = _cuda.CudaKernel("composite_mat_planar_batched",
                               _cuda.COMPOSITE_MAT)


def frames_to_planar_i8(frames: torch.Tensor) -> torch.Tensor:
    """[..., H, W, 3] uint8 -> [..., 3, H, W] int8 (value - 128)."""
    x = frames.movedim(-1, -3).to(torch.int16) - 128
    return x.to(torch.int8).contiguous()


def planar_to_hwc(pano_planar: torch.Tensor) -> torch.Tensor:
    """[3, H, W] -> [H, W, 3] (display/export convenience; not the hot path)."""
    return pano_planar.permute(1, 2, 0)


@dataclasses.dataclass
class MatLUT:
    """Per-pixel state of the mat composite, row-major on the panorama.

    tap_xy: [Hp*Wp] int32  y0 << 16 | x0, the top-left tap in the frame
    tap_cw: [Hp*Wp] int32  cam << 16 | a << 8 | ay, or UNCOVERED (-1)
    gc:     [Hp*Wp] f32    gain * covered
    n_fallback: fallback tiles of the tile build (the kernel takes none)
    stage_table: [blocks, 2, 4] int32  the kernel's staging table
                            (`ops/staging.py`), None on a state built
                            without it (the wrappers refuse one on the
                            card); the plain version does not read it
    stage_bytes: shared memory of one stage;  n_direct: direct-gather blocks
    """
    tap_xy: torch.Tensor
    tap_cw: torch.Tensor
    gc: torch.Tensor
    n_fallback: int
    n_cams: int
    pano_hw: Tuple[int, int]
    frame_hw: Tuple[int, int]
    stage_table: Optional[torch.Tensor] = None
    stage_bytes: int = 0
    n_direct: int = 0

    @property
    def device(self) -> torch.device:
        return self.tap_cw.device

    def fields(self) -> dict:
        return unpack_taps(self.tap_xy, self.tap_cw)


def window_taps(local, org, size: int):
    """One axis of the reference's weight build (`_mat_chunk`): the
    window-local coordinate clipped to the window, its tap and first-tap
    weight, and the tap back in frame coordinates (`org` is the window's
    integer origin). On the window's last row/column the clip leaves no
    fraction, so the first tap carries the whole 127."""
    t0, w = _taps(local.clamp(0.0, size - 1.0))
    return t0 + org, w


def _materialize(tlut: TiledLUT) -> MatLUT:
    check_packable(tlut.frame_hw)
    T = tlut.sx.shape[0]
    cam = tlut.cidx
    tile_cam = tlut.tile_cam.reshape(T, 2)
    org = tlut.tile_org.reshape(T, 4)
    band = tlut.tile_band.reshape(T, 2)
    is_a = cam == tile_cam[:, 0:1]
    oy = torch.where(is_a, org[:, 0:1], org[:, 2:3])
    ox = torch.where(is_a, org[:, 1:2], org[:, 3:4])
    boff = torch.where(is_a, band[:, 0:1], band[:, 1:2])
    # x is band-local: the reference slices its window at the band offset
    f32 = torch.float32
    x0, a = window_taps(tlut.sx - ox.to(f32) - boff.to(f32), ox + boff, VXW)
    y0, ay = window_taps(tlut.sy - oy.to(f32), oy, WIN_H)
    covered = cam >= 0
    tap_xy, tap_cw = pack_taps(cam, x0, a, y0, ay)
    tap_cw = torch.where(covered, tap_cw, UNCOVERED)

    def flat(a):
        return untile(a, tlut.grid_hw, tlut.pano_hw).reshape(-1).contiguous()

    return with_staging_table(MatLUT(
        tap_xy=flat(tap_xy), tap_cw=flat(tap_cw),
        gc=flat(tlut.gain * covered.to(torch.float32)),
        n_fallback=tlut.n_fallback, n_cams=tlut.n_cams,
        pano_hw=tlut.pano_hw, frame_hw=tlut.frame_hw))


def build_mat_lut(lut, frame_hw: Tuple[int, int]) -> MatLUT:
    """From a CompositeLUT, on the LUT's device."""
    return _materialize(build_tiled_lut(lut, frame_hw))


def _check(planar_b: torch.Tensor, ml: MatLUT) -> None:
    check_frames(planar_b, ml)
    if ml.n_fallback != 0:
        raise ValueError(f"the LUT has {ml.n_fallback} fallback tiles and "
                         "the mat kernel has no fallback path; use "
                         "kernel='mat2' or 'gather'")


def composite_mat_plain(planar_b_i8: torch.Tensor, ml: MatLUT) -> torch.Tensor:
    """Plain PyTorch version of the kernel: [B, N, 3, H, W] int8 (value-128)
    -> [B, 3, Hp, Wp] uint8. The CPU path, and the version the kernel is
    held against on the card."""
    _check(planar_b_i8, ml)
    out = seam_select_plain(planar_b_i8, ml.tap_xy, ml.tap_cw, ml.gc)
    return out.reshape(planar_b_i8.shape[0], 3, *ml.pano_hw)


def _composite(planar_b: torch.Tensor, ml: MatLUT,
               kernel: _cuda.CudaKernel) -> torch.Tensor:
    if planar_b.device.type == "cpu":
        return composite_mat_plain(planar_b, ml)
    if planar_b.device.type != "cuda":
        raise ValueError(f"no kernel for device {planar_b.device}")
    _check(planar_b, ml)
    planar_b = check_staged(planar_b, (ml.tap_xy, ml.tap_cw, ml.gc),
                            ml.stage_table)
    B, N, _, H, W = planar_b.shape
    Hp, Wp = ml.pano_hw
    out = torch.empty((B, 3, Hp, Wp), dtype=torch.uint8,
                      device=planar_b.device)
    kernel.launch(*(t.data_ptr() for t in (planar_b, ml.tap_xy, ml.tap_cw,
                                           ml.gc, ml.stage_table, out)),
                  B, N, H, W, Hp, Wp, ml.stage_bytes,
                  torch.cuda.current_stream(planar_b.device).cuda_stream)
    return out


def composite_mat_planar(planar_i8: torch.Tensor, ml: MatLUT) -> torch.Tensor:
    """One frame set: [N, 3, H, W] int8 (value-128) -> [3, Hp, Wp] uint8.
    On a CUDA tensor it launches the kernel (B = 1); on a CPU tensor it runs
    the plain version. Raises `ValueError` when the LUT has fallback tiles
    (`ml.n_fallback != 0`): the kernel has no fallback path."""
    return _composite(planar_i8[None], ml, MAT_SINGLE)[0]


def composite_mat_planar_batched(planar_b_i8: torch.Tensor,
                                 ml: MatLUT) -> torch.Tensor:
    """Micro-batch: [B, N, 3, H, W] int8 -> [B, 3, Hp, Wp] uint8, per frame
    set bit-identical to `composite_mat_planar` (the reference maps the
    single-frame kernel over the batch). One launch: the LUT is read once
    for B frame sets."""
    return _composite(planar_b_i8, ml, MAT_BATCHED)


def composite_mat(frames: torch.Tensor, ml: MatLUT) -> torch.Tensor:
    """[N, H, W, 3] uint8 -> planar uint8 panorama [3, Hp, Wp]."""
    return composite_mat_planar(frames_to_planar_i8(frames), ml)
