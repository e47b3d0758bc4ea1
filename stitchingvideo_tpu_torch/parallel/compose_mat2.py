"""The seam-select (mat2) composite over canvas row bands.

Port of `stitchingvideo_tpu/parallel/compose_mat2.py`: the default kernel
(`kernel='auto'`) with the panorama split into horizontal bands, one a
canvas device, fallback tiles included. The reference needs pad groups, a
scratch output slot, bucketed class counts and per-band membership of the
easy and hard classes, because `shard_map` runs one shape-identical program
on every device and its state is tile-group-major. The port's state is per
pixel and row-major on the panorama (`ops/composite_mat2.py`), so a band is
a row slice of `tap_xy`, `tap_cw` and `gc`, with

  - the fallback entries whose pixels fall in the band, their pixel indices
    rebased to the band's first pixel and the fallback pixels' `tap_xy`
    (their index into the entries) to the band's first entry;
  - a staging table of its own, built from the band's taps.

Bands are cut at the reference's row boundaries (the panorama padded with
`pad_lut_rows_for_shards`), so each band covers the panorama rows of the
reference's shard and its fallback tiles are whole. Each band's kernel runs
on its device and stream (`parallel/mesh.py` `run_bands`); the bands are
joined in row order on the first device (`run_banded`). Nothing is communicated between
bands: every output pixel is an independent gather.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops.composite import TILE_H, TILE_W
from ..ops.composite_mat2 import FALLBACK, MatLUT2, with_staging_table
from .mesh import Banded, Mesh, cut_rows, placed


def fallback_range(fb_pix: torch.Tensor, p0: int, p1: int) -> Tuple[int, int]:
    """The entries [i0, i1) of the ascending fallback pixels in [p0, p1)."""
    edges = torch.searchsorted(fb_pix, torch.tensor([p0, p1],
                                                    device=fb_pix.device))
    return int(edges[0]), int(edges[1])


def fallback_tiles(fb_pix: torch.Tensor, Wp: int) -> int:
    """Fallback tiles that the fallback pixels `fb_pix` (row-major on a
    panorama Wp wide, whole tile rows) make up."""
    ntx = -(-Wp // TILE_W)
    tid = (fb_pix // Wp // TILE_H) * ntx + (fb_pix % Wp) // TILE_W
    return int(torch.unique(tid).numel())


def band_of(ml: MatLUT2, r0: int, r1: int, device) -> MatLUT2:
    """Rows [r0, r1) of a per-pixel mat2 state as a state of their own on
    `device`, staging table included."""
    Wp = ml.pano_hw[1]
    p0, p1 = r0 * Wp, r1 * Wp
    i0, i1 = fallback_range(ml.fb_pix, p0, p1)
    tap_cw = ml.tap_cw[p0:p1]
    tap_xy = torch.where(tap_cw == FALLBACK, ml.tap_xy[p0:p1] - i0,
                         ml.tap_xy[p0:p1])
    fb_pix = ml.fb_pix[i0:i1] - p0
    return with_staging_table(placed(dataclasses.replace(
        ml, tap_xy=tap_xy, tap_cw=tap_cw, gc=ml.gc[p0:p1], fb_pix=fb_pix,
        fb_cam=ml.fb_cam[i0:i1], fb_sx=ml.fb_sx[i0:i1],
        fb_sy=ml.fb_sy[i0:i1], fb_gain=ml.fb_gain[i0:i1],
        n_fallback=fallback_tiles(fb_pix, Wp), pano_hw=(r1 - r0, Wp),
        stage_table=None, stage_bytes=0, n_direct=0), device))


def shard_mat2_lut(ml: MatLUT2, mesh: Mesh, Hp: int) -> Banded:
    """Cut a mat2 state on a band-padded panorama (its staging table is not
    read) into the canvas axis's row bands, each on its device; `Hp` the
    rows before the padding. `run_banded(composite_mat2_planar, ...)` (K2)
    and `run_banded(composite_mat2_planar_batched, ...)` (K1) compose it."""
    return cut_rows(ml, mesh, Hp, band_of)
