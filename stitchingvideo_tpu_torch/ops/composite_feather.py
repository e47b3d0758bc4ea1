"""Feather blending in the video hot loop (`compose_mode='feather'`).

Port of `stitchingvideo_tpu/ops/pallas/composite_feather.py`. Every panorama
pixel blends the two cameras of highest feather weight (`build_blend_lut`:
L1 distance transform of each camera's owned mask, times sharpness, capped
at 1, the top two renormalized, times the exposure gain):

    out = val_a * gw_a + val_b * gw_b + 128 * (gw_a + gw_b)

on int8 frames (value - 128). The reference gives every 8x128 tile two
camera slots (its lowest and highest camera), a source window per slot, and
int8 hat matrices per slot and pixel; a tile whose pixels name a third
camera, or overflow a window, takes an exact float dual gather instead
(`_fb_blend_values`). The port keeps that build tile by tile and window by
window, because it decides which pixels take which path and with which
weights, and stores per pixel and slot the hat matrices' two non-zeros an
axis in global frame coordinates: tap origin, camera and integer weights,
and the float weight `gw`, 24 bytes a pixel. Its kernel
(`csrc/composite_feather.cu`) gathers four taps a live slot from the source
boxes that each block of 32x32 pixels stages into shared memory (the staging
table, `ops/staging.py`, with a box for each camera of the block); the band
offset is folded into the tap address, so it reads the frames as they are,
with no shifted copies. A slot that is not live for a pixel (`gw == 0`)
adds nothing: the reference multiplies a finite value by 0 there.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..video.lut import roi_placer
from . import _cuda
from .composite import (P, TILE_H, TILE_W, VXW, WIN_H, WIN_W, tile, untile,
                        window)
from .composite_mat import window_taps
from .composite_mat2 import (FALLBACK, UNCOVERED, bilinear_taps, check_frames,
                             check_packable, check_staged, int_tap_values,
                             pack_taps, to_u8, unpack_taps)
from .distance import distance_transform_l1
from .staging import staging_table

# launch counters of the kernel's two entry points
FEATHER_SINGLE = _cuda.CudaKernel("composite_feather_planar",
                                  _cuda.COMPOSITE_FEATHER)
FEATHER_BATCHED = _cuda.CudaKernel("composite_feather_planar_batched",
                                   _cuda.COMPOSITE_FEATHER)

_FIELDS = ("cam_a", "sx_a", "sy_a", "gw_a", "cam_b", "sx_b", "sy_b", "gw_b")


@dataclasses.dataclass
class BlendLUT:
    """Per-panorama-pixel dual-slot blend table (canvas space).

    cam_*: int32, -1 = slot inactive. gw_* = normalized feather weight x
    exposure gain (0 where inactive); gw_a + gw_b is the pixel's total gain.
    """
    cam_a: torch.Tensor
    sx_a: torch.Tensor
    sy_a: torch.Tensor
    gw_a: torch.Tensor
    cam_b: torch.Tensor
    sx_b: torch.Tensor
    sy_b: torch.Tensor
    gw_b: torch.Tensor

    @property
    def shape(self):
        return tuple(self.cam_a.shape)

    def map(self, fn) -> "BlendLUT":
        """fn(name, tensor) applied to every field."""
        return BlendLUT(*(fn(k, getattr(self, k)) for k in _FIELDS))

    def crop(self, y0: int, y1: int, x0: int, x1: int) -> "BlendLUT":
        return self.map(lambda _k, a: a[y0:y1, x0:x1].contiguous())

    def to(self, device) -> "BlendLUT":
        return self.map(lambda _k, a: a.to(device))


def build_blend_lut(reg, sharpness: float = 0.02) -> BlendLUT:
    """Canvas-space dual-slot LUT from a Registration, on its device.

    Weights follow FeatherBlender::createWeightMap: min(L1 distance transform
    of the owned mask * sharpness, 1), computed on the canvas."""
    CW, CH = reg.canvas_wh
    n = reg.n_cameras
    dev = reg.device
    place, (HP, WP) = roi_placer(reg)
    f32 = torch.float32

    own = torch.stack([place(i, reg.seam_masks[i] & reg.valid[i], False)
                       for i in range(n)])
    sharp = torch.tensor(sharpness, dtype=f32, device=dev)
    w = (distance_transform_l1(own) * sharp).clamp(max=1.0) * own
    sx = [place(i, reg.xmaps[i], 0.0) for i in range(n)]
    sy = [place(i, reg.ymaps[i], 0.0) for i in range(n)]
    g = [place(i, reg.gain_maps[i], 1.0) for i in range(n)]

    # top-2 cameras per pixel by feather weight (strict >: first wins ties)
    w1 = torch.zeros((HP, WP), dtype=f32, device=dev)
    w2 = torch.zeros((HP, WP), dtype=f32, device=dev)
    c1 = torch.full((HP, WP), -1, dtype=torch.int32, device=dev)
    c2 = torch.full((HP, WP), -1, dtype=torch.int32, device=dev)
    for i in range(n):
        wi = w[i]
        gt1 = wi > w1
        gt2 = ~gt1 & (wi > w2)
        c2 = torch.where(gt1, c1, torch.where(gt2, i, c2))
        w2 = torch.where(gt1, w1, torch.where(gt2, wi, w2))
        c1 = torch.where(gt1, i, c1)
        w1 = torch.where(gt1, wi, w1)

    s = w1 + w2
    zero = torch.zeros((), dtype=f32, device=dev)
    wa = torch.where(s > 0, w1 / s.clamp(min=1e-20), zero)
    wb = torch.where(s > 0, w2 / s.clamp(min=1e-20), zero)

    def take(a, c):
        # equality-masked select, camera by camera
        out = a[0]
        for i in range(1, n):
            out = torch.where(c == i, a[i], out)
        return out

    act_a = (c1 >= 0) & (wa > 0)
    act_b = (c2 >= 0) & (wb > 0)

    def cut(a):
        return a[:CH, :CW].contiguous()

    return BlendLUT(
        cam_a=cut(torch.where(act_a, c1, -1)),
        sx_a=cut(take(sx, c1)), sy_a=cut(take(sy, c1)),
        gw_a=cut(torch.where(act_a, wa * take(g, c1), zero)),
        cam_b=cut(torch.where(act_b, c2, -1)),
        sx_b=cut(take(sx, c2)), sy_b=cut(take(sy, c2)),
        gw_b=cut(torch.where(act_b, wb * take(g, c2), zero)))


@dataclasses.dataclass
class FeatherMatLUT:
    """Per-pixel dual-slot state of the feather composite, row-major on the
    panorama; slot 0 is the tile's lowest camera, slot 1 its highest.

    tap_xy: [2, Hp*Wp] int32  y0 << 16 | x0 of the slot's top-left tap; in
                              slot 0 of a fallback-tile pixel, its index
                              into fb_*
    tap_cw: [2, Hp*Wp] int32  cam << 16 | a << 8 | ay of a live slot;
                              UNCOVERED (-1) where the slot is not live;
                              FALLBACK (-2) in slot 0 of a fallback-tile pixel
    gw:     [2, Hp*Wp] f32    the slot's weight (0 where not live)
    fb_pix: [F] int64         panorama pixels of the fallback tiles, in order
    fb_cam: [F, 2] int32      their two cameras (-1 = inactive)
    fb_sx, fb_sy, fb_gw: [F, 2] f32  their clipped source coords and weights
    tile_cam [T*2], tile_org [T*4], tile_band [T*2] int32, fallback [T] bool:
        the reference's per-tile window metadata (`_materialize_feather`)
    stage_table: [blocks, 2, 4] int32  the kernel's staging table
        (`ops/staging.py`), over the live slots of both slots; the plain
        version does not read it
    stage_bytes: shared memory of one stage;  n_direct: direct-gather blocks
    """
    tap_xy: torch.Tensor
    tap_cw: torch.Tensor
    gw: torch.Tensor
    fb_pix: torch.Tensor
    fb_cam: torch.Tensor
    fb_sx: torch.Tensor
    fb_sy: torch.Tensor
    fb_gw: torch.Tensor
    tile_cam: torch.Tensor
    tile_org: torch.Tensor
    tile_band: torch.Tensor
    fallback: torch.Tensor
    n_fallback: int
    n_cams: int
    grid_hw: Tuple[int, int]
    pano_hw: Tuple[int, int]
    frame_hw: Tuple[int, int]
    stage_table: torch.Tensor
    stage_bytes: int
    n_direct: int

    @property
    def device(self) -> torch.device:
        return self.tap_cw.device

    def fields(self, slot: int) -> dict:
        return unpack_taps(self.tap_xy[slot], self.tap_cw[slot])


def _tile_fields(blut: BlendLUT, frame_hw):
    """Per-tile dual-slot assignment + the >2-camera classification."""
    fh, fw = frame_hw
    Hp, Wp = blut.shape
    grid = -(-Hp // TILE_H), -(-Wp // TILE_W)
    camA, camB = tile(blut.cam_a, -1, grid), tile(blut.cam_b, -1, grid)
    gwA, gwB = tile(blut.gw_a, 0.0, grid), tile(blut.gw_b, 0.0, grid)
    sxA = tile(blut.sx_a, 0.0, grid).clamp(0.0, fw - 1.0)
    syA = tile(blut.sy_a, 0.0, grid).clamp(0.0, fh - 1.0)
    sxB = tile(blut.sx_b, 0.0, grid).clamp(0.0, fw - 1.0)
    syB = tile(blut.sy_b, 0.0, grid).clamp(0.0, fh - 1.0)

    actA = (camA >= 0) & (gwA > 0)
    actB = (camB >= 0) & (gwB > 0)
    big = 1 << 20
    cand_lo = torch.minimum(torch.where(actA, camA, big).amin(dim=1),
                            torch.where(actB, camB, big).amin(dim=1))
    lo = torch.where(cand_lo == big, 0, cand_lo)
    cand_hi = torch.maximum(torch.where(actA, camA, -1).amax(dim=1),
                            torch.where(actB, camB, -1).amax(dim=1))
    hi = torch.where(cand_hi < 0, lo, cand_hi)
    mid = (actA & (camA != lo[:, None]) & (camA != hi[:, None])) | \
          (actB & (camB != lo[:, None]) & (camB != hi[:, None]))
    fallback = mid.any(dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=gwA.device)

    def slot_fields(c_s, is_second):
        # each pixel's contribution to this TILE slot
        from_a = actA & (camA == c_s[:, None])
        from_b = actB & (camB == c_s[:, None])
        gw = torch.where(from_a, gwA, torch.where(from_b, gwB, zero))
        sx = torch.where(from_a, sxA, torch.where(from_b, sxB, zero))
        sy = torch.where(from_a, syA, torch.where(from_b, syB, zero))
        if is_second:
            # single-camera tile: everything is already in slot 0
            gw = torch.where((hi != lo)[:, None], gw, zero)
        return gw, sx, sy

    return (lo, hi, fallback, slot_fields(lo, False), slot_fields(hi, True),
            (camA, camB, gwA, gwB, sxA, syA, sxB, syB), grid)


def build_feather_mat(blut: BlendLUT, frame_hw: Tuple[int, int]
                      ) -> FeatherMatLUT:
    """The kernel's state from a BlendLUT, on the LUT's device."""
    fh, fw = (int(x) for x in frame_hw)
    if fh < WIN_H or fw < WIN_W:
        raise ValueError(f"frames {(fh, fw)} smaller than window "
                         f"({WIN_H},{WIN_W})")
    check_packable((fh, fw))
    lo, hi, fallback, s0, s1, raw, grid = _tile_fields(blut, (fh, fw))
    pano_hw = blut.shape
    T = lo.shape[0]
    f32 = torch.float32

    def flat(a):
        return untile(a, grid, pano_hw).reshape(-1)

    xy, cw, gws, orgs, bands = [], [], [], [], []
    for cam_s, (gw, sx, sy) in ((lo, s0), (hi, s1)):
        live = gw > 0
        oy, ox, boff, ovf = window(live, sy, sx, fh, fw)
        fallback = fallback | ovf
        xo = (ox + boff)[:, None]
        x0, a = window_taps(sx - xo.to(f32), xo, VXW)
        y0, ay = window_taps(sy - oy[:, None].to(f32), oy[:, None], WIN_H)
        tap_xy, tap_cw = pack_taps(cam_s[:, None], x0, a, y0, ay)
        xy.append(flat(tap_xy))
        cw.append(flat(torch.where(live, tap_cw, UNCOVERED)))
        gws.append(flat(gw))
        orgs += [oy, ox]
        bands.append(boff)

    fb = flat(fallback[:, None].expand(T, P))
    fb_pix = torch.nonzero(fb).reshape(-1)
    fb_index = torch.cumsum(fb, 0, dtype=torch.int32) - 1
    xy[0] = torch.where(fb, fb_index, xy[0])
    cw[0] = torch.where(fb, FALLBACK, cw[0])
    cw[1] = torch.where(fb, UNCOVERED, cw[1])
    camA, camB, gwA, gwB, sxA, syA, sxB, syB = raw

    def pick2(a, b):
        return torch.stack([flat(a)[fb_pix], flat(b)[fb_pix]], dim=1) \
            .contiguous()

    i32 = torch.int32
    n_cams = int(max(blut.cam_a.max(), blut.cam_b.max())) + 1 \
        if fb.numel() else 0
    taps = []
    for s in range(2):
        live = torch.nonzero(cw[s] >= 0).reshape(-1)
        taps.append((live, cw[s][live] >> 16, xy[s][live] & 0xFFFF,
                     xy[s][live] >> 16))
    table, stage_bytes, n_direct = staging_table(taps, pano_hw, (fh, fw))
    return FeatherMatLUT(
        tap_xy=torch.stack(xy).contiguous(),
        tap_cw=torch.stack(cw).contiguous(),
        gw=torch.stack(gws).contiguous(),
        fb_pix=fb_pix,
        fb_cam=pick2(torch.where(gwA > 0, camA, -1),
                     torch.where(gwB > 0, camB, -1)),
        fb_sx=pick2(sxA, sxB), fb_sy=pick2(syA, syB), fb_gw=pick2(gwA, gwB),
        tile_cam=torch.stack([lo, hi], dim=1).to(i32).reshape(-1),
        tile_org=torch.stack(orgs, dim=1).to(i32).reshape(-1),
        tile_band=torch.stack(bands, dim=1).to(i32).reshape(-1),
        fallback=fallback, n_fallback=int(fallback.sum()), n_cams=n_cams,
        grid_hw=grid, pano_hw=pano_hw, frame_hw=(fh, fw), stage_table=table,
        stage_bytes=stage_bytes, n_direct=n_direct)


def _fb_blend_values(planar_b: torch.Tensor, ml: FeatherMatLUT) -> torch.Tensor:
    """Exact dual-slot bilinear gather of the fallback tiles' pixels,
    [B, 3, F] f32, in the reference's order: the int8 values interpolated in
    float32, 128 added afterwards, times the slot's weight, slot 0 + slot 1."""
    B, N, _, H, W = planar_b.shape
    flat = planar_b.reshape(B, -1)
    zero = torch.zeros((), dtype=torch.float32, device=planar_b.device)

    def slot(s):
        cam = ml.fb_cam[:, s].clamp(min=0).long()
        gw = torch.where(ml.fb_cam[:, s] >= 0, ml.fb_gw[:, s], zero)
        x0, y0, x1, y1, fx, fy = bilinear_taps(ml.fb_sx[:, s], ml.fb_sy[:, s],
                                               H, W)

        def chan(c):
            base = cam * (3 * H * W) + c * (H * W)

            def g(yi, xi):
                return flat[:, base + yi * W + xi].to(torch.float32)

            v8 = ((1 - fx) * (1 - fy) * g(y0, x0) + fx * (1 - fy) * g(y0, x1)
                  + (1 - fx) * fy * g(y1, x0) + fx * fy * g(y1, x1))
            return (v8 + 128.0) * gw

        return torch.stack([chan(c) for c in range(3)], dim=1)

    return slot(0) + slot(1)


def composite_feather_plain(planar_b_i8: torch.Tensor,
                            ml: FeatherMatLUT) -> torch.Tensor:
    """Plain PyTorch version of the kernel, step for step:
    [B, N, 3, H, W] int8 (value-128) -> [B, 3, Hp, Wp] uint8. The CPU path,
    and the version the kernel is held against on the card."""
    check_frames(planar_b_i8, ml)
    B = planar_b_i8.shape[0]
    npix = ml.tap_cw.shape[1]
    dev = planar_b_i8.device
    gsum = 128.0 * (ml.gw[0] + ml.gw[1])
    acc = torch.zeros((B, 3, npix), dtype=torch.float32, device=dev)
    for s in range(2):
        sel = torch.nonzero(ml.tap_cw[s] >= 0).reshape(-1)
        value = int_tap_values(planar_b_i8, ml.fields(s), sel)
        gw = ml.gw[s][sel]
        for c in range(3):
            # slot 0 writes v0 * gw0; slot 1 adds v1 * gw1 to it
            acc[:, c, sel] = acc[:, c, sel] + value(c) * gw
    out = to_u8(acc + gsum)
    if ml.fb_pix.numel():
        out[:, :, ml.fb_pix] = to_u8(_fb_blend_values(planar_b_i8, ml))
    return out.reshape(B, 3, *ml.pano_hw)


def _composite(planar_b: torch.Tensor, ml: FeatherMatLUT,
               kernel: _cuda.CudaKernel) -> torch.Tensor:
    if planar_b.device.type == "cpu":
        return composite_feather_plain(planar_b, ml)
    if planar_b.device.type != "cuda":
        raise ValueError(f"no kernel for device {planar_b.device}")
    check_frames(planar_b, ml)
    planar_b = check_staged(planar_b, (ml.tap_xy, ml.tap_cw, ml.gw),
                            ml.stage_table)
    B, N, _, H, W = planar_b.shape
    Hp, Wp = ml.pano_hw
    out = torch.empty((B, 3, Hp, Wp), dtype=torch.uint8,
                      device=planar_b.device)
    kernel.launch(*(t.data_ptr() for t in (
                      planar_b, ml.tap_xy, ml.tap_cw, ml.gw, ml.fb_cam,
                      ml.fb_sx, ml.fb_sy, ml.fb_gw, ml.stage_table, out)),
                  B, N, H, W, Hp, Wp, ml.stage_bytes,
                  torch.cuda.current_stream(planar_b.device).cuda_stream)
    return out


def composite_feather_planar(planar_i8: torch.Tensor,
                             ml: FeatherMatLUT) -> torch.Tensor:
    """One frame set: [N, 3, H, W] int8 (value-128) -> feather-blended
    [3, Hp, Wp] uint8. On a CUDA tensor it launches the kernel (B = 1); on a
    CPU tensor it runs the plain version."""
    return _composite(planar_i8[None], ml, FEATHER_SINGLE)[0]


def composite_feather_planar_batched(planar_b_i8: torch.Tensor,
                                     ml: FeatherMatLUT) -> torch.Tensor:
    """Micro-batch: [B, N, 3, H, W] int8 -> [B, 3, Hp, Wp] uint8, per frame
    set bit-identical to `composite_feather_planar` (the reference maps the
    single-frame kernel over the batch). One launch: the state is read once
    for B frame sets."""
    return _composite(planar_b_i8, ml, FEATHER_BATCHED)


def composite_blend_gather(frames: torch.Tensor,
                           blut: BlendLUT) -> torch.Tensor:
    """Plain dual gather through the blend LUT: [N, H, W, C] -> [Hp, Wp, C]
    float32. Exact (no weight quantization): the oracle of the feather
    kernel."""
    n, H, W, C = frames.shape
    flat = frames.reshape(n * H * W, C).float()
    zero = torch.zeros((), dtype=torch.float32, device=frames.device)

    def slot(cam_idx, sx, sy, gw):
        base = cam_idx.clamp(min=0).long() * (H * W)
        x0, y0, x1, y1, fx, fy = bilinear_taps(sx, sy, H, W)

        def g(yi, xi):
            return flat[(base + yi * W + xi).reshape(-1)] \
                .reshape(*cam_idx.shape, C)

        v = ((1 - fx) * (1 - fy))[..., None] * g(y0, x0) \
            + (fx * (1 - fy))[..., None] * g(y0, x1) \
            + ((1 - fx) * fy)[..., None] * g(y1, x0) \
            + (fx * fy)[..., None] * g(y1, x1)
        return v * torch.where(cam_idx >= 0, gw, zero)[..., None]

    return slot(blut.cam_a, blut.sx_a, blut.sy_a, blut.gw_a) + \
        slot(blut.cam_b, blut.sx_b, blut.sy_b, blut.gw_b)
