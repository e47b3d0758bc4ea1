"""The multiband video blend over piece groups.

Port of `stitchingvideo_tpu/parallel/compose_multiband.py`. The multiband
frame path (`blend/multiband_video.py`) stacks each virtual camera's window
("piece") along the rows of one warp state, so a group of pieces is a row
band of that state: each canvas band takes `Nv / ndev` pieces
(`build_multiband_state(..., pad_pieces_to=ndev)` pads Nv with empty
pieces). On its device and stream each band

  1. warps its pieces with `composite_mat2_planar_pieces`;
  2. builds their normalised window pyramids;
  3. accumulates its partial band canvases and its partial level-0 canvas,
     cropped to the true [CHp >> l, CWp >> l] canvas (the port's canvas
     accumulation clips there as it adds);

then the partials are summed in band order on the mesh's first device (the
reference's psum over 'canvas') and collapsed there once, as the
single-device path collapses. The sum runs in another order than the
single-device path's piece-by-piece accumulation, so float32 values can
differ in their last bits: ROADMAP.md section 3 states the tolerance.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..blend.multiband_video import (MultibandVideoState, band_canvases,
                                     collapse_bands, level0_canvas,
                                     to_panorama, window_pyramids)
from ..ops.composite_mat2 import MatLUT2, composite_mat2_planar_pieces
from .compose_mat2 import band_of
from .mesh import Mesh, run_bands


@dataclasses.dataclass
class ShardedMultiband:
    """A multiband state cut into piece groups: band b's warp state, masks,
    mask pyramid and window origins on canvas device b; the canvas
    reciprocals on the first device."""
    warp: Tuple[MatLUT2, ...]
    m0: Tuple[torch.Tensor, ...]
    gm: Tuple[Tuple[torch.Tensor, ...], ...]
    piece_ax: Tuple[Tuple[int, ...], ...]
    recip: Tuple[torch.Tensor, ...]
    canvas_hw: Tuple[int, int]
    out_hw: Tuple[int, int]
    bands: int
    pd: int
    mesh: Mesh


def shard_multiband_state(st: MultibandVideoState,
                          mesh: Mesh) -> ShardedMultiband:
    """Split a MultibandVideoState into the canvas axis's piece groups.
    Each group's warp state has its own staging table; the whole stack's is
    not read, so a caller keeps the result and drops `st`."""
    devs = mesh.canvas_devices
    ndev = len(devs)
    Nv = len(st.piece_cam)
    if Nv % ndev:
        raise ValueError(f"Nv={Nv} pieces not divisible by canvas={ndev} "
                         "(build_multiband_state(pad_pieces_to=ndev))")
    pd = Nv // ndev
    rows = pd * st.buf_hw[0]
    groups = [slice(b * pd, (b + 1) * pd) for b in range(ndev)]
    return ShardedMultiband(
        warp=tuple(band_of(st.warp_lut, b * rows, (b + 1) * rows, d)
                   for b, d in enumerate(devs)),
        m0=tuple(st.m0[g].to(d) for g, d in zip(groups, devs)),
        gm=tuple(tuple(lv[g].to(d) for lv in st.gm)
                 for g, d in zip(groups, devs)),
        piece_ax=tuple(tuple(st.piece_ax[g]) for g in groups),
        recip=tuple(r.to(devs[0]) for r in st.recip),
        canvas_hw=st.canvas_hw, out_hw=st.out_hw, bands=st.bands, pd=pd,
        mesh=mesh)


def multiband_sharded_frame(planar_i8: torch.Tensor, smb: ShardedMultiband,
                            crop_yx: Tuple[int, int] = (0, 0)
                            ) -> torch.Tensor:
    """[N, 3, H, W] int8 planar frames -> blended [3, outH, outW] uint8:
    each piece group's partial canvases on its device, summed in band order
    and collapsed on the frames' device."""

    def partials(b, planar):
        x = composite_mat2_planar_pieces(planar, smb.warp[b], smb.pd)[None]
        norms = window_pyramids(x, smb.gm[b], smb.bands)
        band = band_canvases(norms, smb.gm[b], smb.piece_ax[b],
                             smb.canvas_hw, smb.bands)
        return band + [level0_canvas(x, norms[1], smb.m0[b], smb.piece_ax[b],
                                     smb.canvas_hw)]

    parts = run_bands(smb.mesh, planar_i8, partials)
    total = parts[0]
    for p in parts[1:]:
        total = [t + q for t, q in zip(total, p)]
    C = collapse_bands(total[:-1], smb.recip, smb.bands)
    return to_panorama(total[-1], C, smb.recip[0], crop_yx, smb.out_hw)[0]
