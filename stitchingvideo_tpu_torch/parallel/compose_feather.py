"""The feather blend (K4) over canvas row bands.

Port of `stitchingvideo_tpu/parallel/compose_feather.py`. The reference's
feather state is tile-group-major, so its bands are contiguous slices, and
only its fallback arrays need bucketing to a count every band shares. The
port's `FeatherMatLUT` is per pixel and row-major on the panorama: a band is
a row slice of both slots' taps and weights and of the per-tile metadata,
with the fallback entries whose pixels fall in the band (rebased as
`parallel/compose_mat2.py` rebases them) and a staging table of its own.
The blend LUT's rows are padded first (`pad_blend_rows_for_shards`, the
reference's), so the bands cover the reference's shards' rows. No
collective: each band composes on its device and stream, joined in row
order.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.composite import TILE_H
from ..ops.composite_feather import (BLEND_FILLS, BlendLUT, FeatherMatLUT,
                                     with_feather_staging)
from ..ops.composite_mat2 import FALLBACK
from ..video.lut import pad_rows, shard_rows
from .compose_mat2 import fallback_range
from .mesh import Banded, Mesh, cut_rows, placed


def pad_blend_rows_for_shards(blut: BlendLUT, n_shards: int) -> BlendLUT:
    """Pad the blend LUT with inactive rows (cam -1, gw 0) so that the tile
    grid splits into n_shards equal row bands of whole tile groups."""
    H, W = blut.shape
    Hp = shard_rows(H, W, n_shards)
    if Hp == H:
        return blut
    return blut.map(lambda k, a: pad_rows(a, Hp, BLEND_FILLS[k]))


def band_of(ml: FeatherMatLUT, r0: int, r1: int, device) -> FeatherMatLUT:
    """Rows [r0, r1) of a per-pixel feather state as a state of their own on
    `device`, staging table included."""
    ntx = ml.grid_hw[1]
    Wp = ml.pano_hw[1]
    p0, p1 = r0 * Wp, r1 * Wp
    t0, t1 = r0 // TILE_H * ntx, r1 // TILE_H * ntx
    i0, i1 = fallback_range(ml.fb_pix, p0, p1)
    tap_cw = ml.tap_cw[:, p0:p1]
    tap_xy = ml.tap_xy[:, p0:p1].clone()
    tap_xy[0] = torch.where(tap_cw[0] == FALLBACK, tap_xy[0] - i0, tap_xy[0])

    def tiles(a, k):
        return a.reshape(-1, k)[t0:t1].reshape(-1)

    fallback = ml.fallback[t0:t1]
    return with_feather_staging(placed(dataclasses.replace(
        ml, tap_xy=tap_xy, tap_cw=tap_cw, gw=ml.gw[:, p0:p1],
        fb_pix=ml.fb_pix[i0:i1] - p0, fb_cam=ml.fb_cam[i0:i1],
        fb_sx=ml.fb_sx[i0:i1], fb_sy=ml.fb_sy[i0:i1], fb_gw=ml.fb_gw[i0:i1],
        tile_cam=tiles(ml.tile_cam, 2), tile_org=tiles(ml.tile_org, 4),
        tile_band=tiles(ml.tile_band, 2), fallback=fallback,
        n_fallback=int(fallback.sum()), grid_hw=((r1 - r0) // TILE_H, ntx),
        pano_hw=(r1 - r0, Wp), stage_table=None, stage_bytes=0, n_direct=0),
        device))


def shard_feather_lut(ml: FeatherMatLUT, mesh: Mesh, Hp: int) -> Banded:
    """Cut a feather state built from a row-padded blend LUT (its staging
    table is not read) into the canvas axis's row bands; `Hp` the rows
    before the padding. `run_banded(composite_feather_planar, ...)` and
    `run_banded(composite_feather_planar_batched, ...)` (K4) compose it."""
    return cut_rows(ml, mesh, Hp, band_of)
