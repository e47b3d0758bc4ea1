"""Multiband blending as a video mode: per-frame Laplacian blending through
registration-cached state.

Port of `stitchingvideo_tpu/blend/multiband_video.py`. Per-camera content
lives in a narrow window of the canvas, so all per-camera terms (the warped
window, its mask-normalised pyramids, the Laplacians, the level-1 -> level-0
upsample) are computed on tight per-camera window grids and only accumulated
onto canvas grids. A camera whose seam-owned footprint falls into clusters
further apart than SPLIT_GAP (the 360-degree wrap-around camera) is split
into one virtual camera ("piece") a cluster. Level 0 needs no per-camera
normalisation: its mask pyramid level is the binary seam partition, so
band_0 is the seam composite minus the accumulated per-window upsamples.
Pyramid levels are stored in bfloat16 (sums in float32, canvas accumulators
float32).

Per frame set:
  1. the warp stage, the one hand-written kernel of the mode
     (`composite_mat2_planar_pieces_batched`, csrc/composite_mat2.cu): every
     piece warped into its window, uint8-quantised, as bfloat16, the seam
     mask folded into the LUT's coverage;
  2. the window Gaussian pyramids, normalised by the cached mask pyramids;
  3. Laplacian contributions accumulated onto canvas band grids, in piece
     order, and collapsed coarse to fine;
  4. level 0 folded into window space, one canvas accumulation, crop, round
     half to even, clamp.
Stages 2-4 are plain PyTorch, as they are plain XLA in the JAX package.

A build runs on the registration's device. The geometry (pieces, window
origins, copy rectangles) is host arithmetic on the footprints' column
occupancy; the per-piece LUTs and masks are cut on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..ops import pyramid_planar as ppyr
from ..ops.composite import build_tiled_lut, concat_tiled_luts
from ..ops.composite_mat2 import (MatLUT2,
                                  composite_mat2_planar_pieces_batched,
                                  materialize2_used)
from ..video.lut import CompositeLUT
from .multiband import WEIGHT_EPS, num_bands_for, pad_for_bands

# extra window width (canvas px) kept on each side of a camera's footprint:
# level-l Gaussian tails spread ~4*2^l px, so 256 keeps levels <= 6 exact
# and truncates only the outermost tail of band 7
MARGIN = 256
# footprint column gaps wider than this split a camera into virtual cameras
# (the 360-degree wrap-around case); narrower gaps stay one window
SPLIT_GAP = 384


@dataclasses.dataclass
class MultibandVideoState:
    """Registration-cached state of the windowed multiband frame path.

    warp_lut:  the per-pixel mat2 state of the window stack (frame ->
               windows, gain and seam mask folded in)
    m0:        [Nv, Hb, Wb] bfloat16 binary seam & valid masks
    gm:        per level, [Nv, Hb >> l, Wb >> l] float32 window mask pyramid
    recip:     per level, [CHp >> l, CWp >> l] float32 1 / (wsum + eps)
    piece_cam, piece_ax: each piece's camera and window origin (canvas x)
    canvas_hw: the band-padded canvas (CHp, CWp); buf_hw: a window (Hb, Wb);
    out_hw: the cropped output; pad_w: the align-padded canvas width
    """
    warp_lut: MatLUT2
    m0: torch.Tensor
    gm: Tuple[torch.Tensor, ...]
    recip: Tuple[torch.Tensor, ...]
    piece_cam: Tuple[int, ...]
    piece_ax: Tuple[int, ...]
    canvas_hw: Tuple[int, int]
    buf_hw: Tuple[int, int]
    out_hw: Tuple[int, int]
    bands: int
    pad_w: int = 0

    def to(self, device) -> "MultibandVideoState":
        return dataclasses.replace(
            self, warp_lut=self.warp_lut.to(device), m0=self.m0.to(device),
            gm=tuple(g.to(device) for g in self.gm),
            recip=tuple(r.to(device) for r in self.recip))


def _column_pieces(valid: np.ndarray) -> List[Tuple[int, int]]:
    """[Hr, Wr] footprint -> list of (x0, x1) ROI column spans. One span per
    contiguous column run; runs separated by <= SPLIT_GAP are merged. Splits
    at every wide gap: a footprint the seams carve into k clusters yields k
    virtual cameras (collapsing them to one span would inflate the shared
    window width toward the full canvas)."""
    cols = np.flatnonzero(valid.any(axis=0))
    if cols.size == 0:
        return []
    # diff between consecutive covered columns = uncovered gap + 1
    gaps = np.flatnonzero(np.diff(cols) - 1 > SPLIT_GAP)
    starts = np.concatenate([[0], gaps + 1])
    ends = np.concatenate([gaps, [cols.size - 1]])
    return [(int(cols[s]), int(cols[e]) + 1) for s, e in zip(starts, ends)]


def build_multiband_state(reg, frame_hw: Tuple[int, int],
                          blend_strength: float = 5.0, crop=None,
                          pad_pieces_to: int = 0):
    """From a Registration -> (MultibandVideoState, crop_yx), on the
    registration's device.
    crop=(y0, y1, x0, x1) applies the RT crop margins to the output (canvas
    and pyramids keep the full extent, so the blend is unchanged).
    pad_pieces_to: round the piece count up to a multiple with empty pieces
    (all-uncovered windows, zero masks), so that the piece axis splits evenly
    across devices."""
    dev = reg.device
    n = reg.n_cameras
    CW, CH = reg.canvas_wh
    bands = num_bands_for(float(CW * CH), blend_strength)
    if bands < 1:
        raise ValueError("canvas too small for banded blending")
    CHp, CWp = pad_for_bands(CH, CW, bands)
    align = max(128, 1 << bands)
    CHb = -(-CHp // align) * align      # window height = full canvas height
    CWb = -(-CWp // align) * align
    Hr, Wr = reg.roi_hw

    seam = reg.seam_masks & reg.valid
    seam_cols = seam.any(dim=1).cpu().numpy()           # [n, Wr]
    corners = reg.corners.cpu().numpy()

    # -- virtual-camera windows: extents follow the seam-owned footprint
    # (valid-but-unowned content contributes nothing anywhere)
    pieces = []                       # (cam, cx0, cx1, x0r, x1r)
    for i in range(n):
        cx = int(corners[i, 0])
        for x0r, x1r in _column_pieces(seam_cols[i][None]):
            cx0 = max(0, cx + x0r)
            cx1 = min(CWb, cx + x1r)
            if cx1 <= cx0:
                continue
            pieces.append((i, cx0, cx1, x0r, x1r))
    if not pieces:
        raise ValueError("no valid camera footprints")
    Wb = min(CWb, -(-(max(c1 - c0 for _, c0, c1, _, _ in pieces)
                      + 2 * MARGIN) // align) * align)
    Nv = len(pieces)

    def filled(value, dtype):
        return torch.full((CHb, Wb), value, dtype=dtype, device=dev)

    piece_cam, piece_ax, luts = [], [], []
    m_w = torch.zeros((Nv, CHb, Wb), dtype=torch.float32, device=dev)
    for p, (i, cx0, cx1, x0r, x1r) in enumerate(pieces):
        cx, cy = int(corners[i, 0]), int(corners[i, 1])
        ax = max(0, cx0 - MARGIN) // align * align
        ax = min(ax, CWb - Wb)
        if ax + Wb < cx1:             # window must cover the footprint
            ax = min(CWb - Wb, -(-(cx1 - Wb) // align) * align)
        assert ax >= 0 and ax + Wb >= cx1 and ax <= cx0, (ax, cx0, cx1, Wb)
        piece_cam.append(i)
        piece_ax.append(int(ax))

        # ROI -> window copy rectangles (full canvas height; content is
        # clipped at the true canvas extent CHp/CWp)
        ry0, ry1 = max(0, -cy), min(Hr, CHp - cy)
        rc0 = max(x0r, ax - cx)
        rc1 = min(x1r, ax + Wb - cx, CWp - cx)
        wy, wx = cy + ry0, (cx + rc0) - ax
        hh, ww = ry1 - ry0, rc1 - rc0
        if hh <= 0 or ww <= 0:
            raise ValueError(f"camera {i}: empty window piece")
        roi = (i, slice(ry0, ry1), slice(rc0, rc1))
        win = (slice(wy, wy + hh), slice(wx, wx + ww))

        # the seam mask is folded into the LUT's coverage: seam-unowned
        # pixels are uncovered (-1) and the warp kernel writes exact 0 there
        sv = seam[roi]
        cam_idx = filled(-1, torch.int32)
        cam_idx[win] = torch.where(sv, 0, -1).to(torch.int32)
        sx, sy, gg = (filled(v, torch.float32) for v in (0.0, 0.0, 1.0))
        sx[win] = reg.xmaps[roi]
        sy[win] = reg.ymaps[roi]
        gg[win] = reg.gain_maps[roi]
        m_w[(p,) + win] = sv.to(torch.float32)
        # window-overflow tiles (strong local warp curvature) are fine: the
        # pieces kernel takes the exact float gather on them
        luts.append(build_tiled_lut(CompositeLUT(cam_idx, sx, sy, gg),
                                    frame_hw))

    if pad_pieces_to and Nv % pad_pieces_to:
        n_dummy = -Nv % pad_pieces_to
        empty = build_tiled_lut(
            CompositeLUT(filled(-1, torch.int32), filled(0.0, torch.float32),
                         filled(0.0, torch.float32),
                         filled(1.0, torch.float32)), frame_hw)
        piece_cam += [0] * n_dummy
        piece_ax += [0] * n_dummy
        luts += [empty] * n_dummy
        m_w = torch.cat([m_w, m_w.new_zeros((n_dummy, CHb, Wb))])
        Nv += n_dummy

    warp_lut = materialize2_used(concat_tiled_luts(luts, piece_cam))
    gm, recip = _mask_state(m_w, tuple(piece_ax), (CHp, CWp), bands)
    y0, y1, x0, x1 = crop if crop is not None else (0, CH, 0, CW)
    st = MultibandVideoState(
        warp_lut=warp_lut, m0=m_w.to(torch.bfloat16), gm=gm, recip=recip,
        piece_cam=tuple(piece_cam), piece_ax=tuple(piece_ax),
        canvas_hw=(CHp, CWp), buf_hw=(CHb, Wb),
        out_hw=(y1 - y0, x1 - x0), bands=bands, pad_w=CWb)
    return st, (y0, x0)


def _accumulate(acc: torch.Tensor, win: torch.Tensor, piece_ax,
                lvl: int) -> torch.Tensor:
    """acc[b, c, :h, a:a + w] += win[b, p, c, :h, :w] for every piece p at
    a = piece_ax[p] >> lvl, clipped at the canvas, in place and in piece
    order (pieces overlap, so the order matters)."""
    hl, wl = acc.shape[-2:]
    hb, wb = win.shape[-2:]
    for p, ax in enumerate(piece_ax):
        a = ax >> lvl
        acc[..., :min(hb, hl), a:a + wb] += \
            win[:, p, :, :min(hb, hl), :min(wb, wl - a)]
    return acc


def _mask_state(m_w: torch.Tensor, piece_ax, canvas_hw, bands: int):
    """Window mask pyramids + canvas normalisation reciprocals."""
    CHp, CWp = canvas_hw
    gm = tuple(ppyr.gaussian_pyramid_p(m_w, bands))
    recip = []
    for lvl, g in enumerate(gm):
        ws = torch.zeros((1, 1, CHp >> lvl, CWp >> lvl), dtype=torch.float32,
                         device=m_w.device)
        _accumulate(ws, g[None, :, None], piece_ax, lvl)
        recip.append(1.0 / (ws[0, 0] + WEIGHT_EPS))
    return gm, tuple(recip)


def multiband_blend_windows(x: torch.Tensor, st: MultibandVideoState,
                            crop_yx: Tuple[int, int] = (0, 0),
                            on_stage: Optional[Callable[[str], None]] = None
                            ) -> torch.Tensor:
    """Stages 2-4 on warped windows x [B, Nv, 3, Hb, Wb] bfloat16 (the warp
    stage's output) -> blended [B, 3, outH, outW] uint8. `on_stage(name)` is
    called after each stage (a timing hook)."""
    if x.dtype != torch.bfloat16 or x.dim() != 5 or \
            tuple(x.shape[1:]) != (len(st.piece_cam), 3) + tuple(st.buf_hw):
        raise ValueError(
            f"expected [B, {len(st.piece_cam)}, 3, {st.buf_hw[0]}, "
            f"{st.buf_hw[1]}] bfloat16 windows, got {tuple(x.shape)} "
            f"{x.dtype}")
    mark = on_stage or (lambda name: None)
    norms = window_pyramids(x, st.gm, st.bands)
    mark("pyramids")
    band = band_canvases(norms, st.gm, st.piece_ax, st.canvas_hw, st.bands)
    C = collapse_bands(band, st.recip, st.bands)
    del band
    mark("canvas")
    B0 = level0_canvas(x, norms[1], st.m0, st.piece_ax, st.canvas_hw)
    del norms
    out = to_panorama(B0, C, st.recip[0], crop_yx, st.out_hw)
    mark("level0")
    return out


def window_pyramids(x: torch.Tensor, gm, bands: int) -> list:
    """The windows' Gaussian pyramids normalised by their mask pyramids `gm`
    (bf16 / f32 -> f32 -> bf16): [None] + one [B, Nv, 3, Hb >> l, Wb >> l]
    bfloat16 level a band."""
    gp = ppyr.gaussian_pyramid_p(x, bands)
    return [None] + [
        (gp[lvl] / gm[lvl].clamp(min=WEIGHT_EPS)[None, :, None])
        .to(torch.bfloat16) for lvl in range(1, bands + 1)]


def band_canvases(norms, gm, piece_ax, canvas_hw, bands: int) -> list:
    """The band canvases of levels >= 1: sum_p lap_p * gm_p placed at
    ax >> lvl, in piece order; one [B, 3, CHp >> l, CWp >> l] float32 a
    level."""
    CHp, CWp = canvas_hw
    f32 = torch.float32
    B = norms[1].shape[0]
    band = []
    for lvl in range(1, bands + 1):
        lap = norms[lvl].to(f32)
        if lvl < bands:
            lap -= ppyr.pyr_up_p(norms[lvl + 1], f32)
        contrib = lap.mul_(gm[lvl][None, :, None])
        acc = torch.zeros((B, 3, CHp >> lvl, CWp >> lvl), dtype=f32,
                          device=lap.device)
        band.append(_accumulate(acc, contrib, piece_ax, lvl))
    return band


def collapse_bands(band, recip, bands: int) -> torch.Tensor:
    """Collapse the band canvases coarse..1 on canvas grids."""
    C = band[-1] * recip[bands]
    for lvl in range(bands - 1, 0, -1):
        C = ppyr.pyr_up_p(C) + band[lvl - 1] * recip[lvl]
    return C


def level0_canvas(x: torch.Tensor, norm1: torch.Tensor, m0, piece_ax,
                  canvas_hw) -> torch.Tensor:
    """Level 0: band_0 = sum_p place(x_p - up(norm_1)_p * m_p), x being the
    seam composite restricted to its window and u the level-0 correction;
    one canvas accumulation, [B, 3, CHp, CWp] float32."""
    f32 = torch.float32
    u_all = ppyr.pyr_up_p(norm1, f32).mul_(m0[None, :, None].to(f32))
    d_all = x.to(f32).sub_(u_all)
    del u_all
    return _accumulate(torch.zeros((x.shape[0], 3) + tuple(canvas_hw),
                                   dtype=f32, device=x.device),
                       d_all, piece_ax, 0)


def to_panorama(B0: torch.Tensor, C: torch.Tensor, recip0: torch.Tensor,
                crop_yx, out_hw) -> torch.Tensor:
    """Level 0 plus the collapsed bands, cropped, rounded half to even and
    clamped: [B, 3, outH, outW] uint8."""
    pano = B0 * recip0 + ppyr.pyr_up_p(C)
    oy, ox = crop_yx
    oh, ow = out_hw
    return torch.round(pano[:, :, oy:oy + oh, ox:ox + ow]).clamp_(0, 255) \
        .to(torch.uint8)


def multiband_video_frames_batched(planar_b_i8: torch.Tensor,
                                   st: MultibandVideoState,
                                   crop_yx: Tuple[int, int] = (0, 0),
                                   on_stage: Optional[Callable[[str], None]]
                                   = None) -> torch.Tensor:
    """[B, N, 3, H, W] int8 planar frames (value-128, see
    composite_mat.frames_to_planar_i8) -> blended [B, 3, outH, outW] uint8.
    The whole chain runs batched; per frame set it gives what
    `multiband_video_frame` gives."""
    x = composite_mat2_planar_pieces_batched(planar_b_i8, st.warp_lut,
                                             len(st.piece_cam))
    if on_stage is not None:
        on_stage("warp")
    return multiband_blend_windows(x, st, crop_yx, on_stage)


def multiband_video_frame(planar_i8: torch.Tensor, st: MultibandVideoState,
                          crop_yx: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """[N, 3, H, W] int8 planar frames -> blended [3, outH, outW] uint8: the
    B = 1 slice of the batched path (one code path)."""
    return multiband_video_frames_batched(planar_i8[None], st, crop_yx)[0]
