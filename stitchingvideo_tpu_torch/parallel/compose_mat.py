"""The single-class (mat, K5) composite over canvas row bands.

Port of `stitchingvideo_tpu/parallel/compose_mat.py`. The reference shards
its tile-group-major state over the 'canvas' axis, so that each device
composes a horizontal band of the panorama. The port's `MatLUT` is per pixel
and row-major, so a band is a row slice of its taps and gains with a staging
table of its own, composed on its device and stream and joined in row order
(`parallel/compose_mat2.py` says how the bands are cut). The kernel has no
fallback path, and neither has its sharded form: a state with fallback tiles
is refused by every band's launch.
"""
from __future__ import annotations

import dataclasses

from ..ops.composite_mat import MatLUT
from ..ops.composite_mat2 import with_staging_table
from .mesh import Banded, Mesh, cut_rows, placed


def band_of(ml: MatLUT, r0: int, r1: int, device) -> MatLUT:
    """Rows [r0, r1) of a per-pixel mat state as a state of their own on
    `device`, staging table included."""
    Wp = ml.pano_hw[1]
    p0, p1 = r0 * Wp, r1 * Wp
    return with_staging_table(placed(dataclasses.replace(
        ml, tap_xy=ml.tap_xy[p0:p1], tap_cw=ml.tap_cw[p0:p1],
        gc=ml.gc[p0:p1], pano_hw=(r1 - r0, Wp), stage_table=None,
        stage_bytes=0, n_direct=0), device))


def shard_mat_lut(ml: MatLUT, mesh: Mesh, Hp: int) -> Banded:
    """Cut a mat state on a band-padded panorama (its staging table is not
    read) into the canvas axis's row bands, each on its device; `Hp` the
    rows before the padding. `run_banded(composite_mat_planar, ...)` and
    `run_banded(composite_mat_planar_batched, ...)` (K5) compose it."""
    return cut_rows(ml, mesh, Hp, band_of)
