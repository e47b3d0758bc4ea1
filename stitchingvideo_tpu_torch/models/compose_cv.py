"""OpenCV-faithful still compositing (the pixel-parity compose path).

Port of `stitchingvideo_tpu/models/compose_cv.py`: the reference CLI's
compositing flow, stage for stage
(stitching/OpenCV2.4.11-Stitching/stitching_detailed.cpp:545-764):

  seam-scale warps (INTER_LINEAR/BORDER_REFLECT image, NEAREST/CONSTANT mask)
  -> BlocksGainCompensator feed (:586-590)
  -> seam finder (:594-637)
  -> per image at compose scale (:656-753):
       warp image + mask, apply block gains, convert to CV_16S,
       dilate seam mask 3x3 + bilinear-resize to the warped size,
       AND with the warp mask, feed MultiBandBlender
  -> blend (:757-762).

Every rounding/border convention that shapes the output bits is reproduced
(see blend/multiband_cv.py and photometric/exposure_cv.py). The seam-scale
stage works on host arrays, as the reference's does; the compose loop is
device-resident: warps, gains, seam-mask resizes, the CV_16S conversion and
the blend run on `device`, and only the seam masks go up and the panorama
comes back.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..blend.feather import feather_blend, feather_weights, paste_blend
from ..blend.multiband_cv import MultiBandBlenderCV
from ..config import StitchConfig
from ..device import resolve_device
from ..geometry import projections as proj
from ..geometry.warp import detect_result_roi, rasterize_backward_map
from ..ops.remap import remap
from ..photometric.exposure import gain_compensator
from ..photometric.exposure_cv import (BlocksGainCompensatorCV,
                                       _resize_linear, _resize_linear_dev)
from ..seams.dp import dp_seams
from ..seams.graphcut import graphcut_seams
from ..seams.voronoi import voronoi_seams
from ..utils.timing import GLOBAL_TRACER as _tracer
from .camera import Cameras


def _scale_for(megapix: float, w: int, h: int) -> float:
    if megapix <= 0:
        return 1.0
    return min(1.0, float(np.sqrt(megapix * 1e6 / (w * h))))


def _resize_u8(img: np.ndarray, scale: float) -> np.ndarray:
    """cv::resize INTER_LINEAR analogue for uint8 images (host)."""
    if scale == 1.0:
        return img
    h, w = img.shape[:2]
    nh, nw = max(1, round(h * scale)), max(1, round(w * scale))
    chans = [np.clip(np.rint(_resize_linear(img[..., c].astype(np.float32),
                                            nh, nw)), 0, 255)
             for c in range(img.shape[2])]
    return np.stack(chans, -1).astype(np.uint8)


def _warp_image_dev(img: np.ndarray, kind: str, scale: float, K: np.ndarray,
                    R: np.ndarray, device=None):
    """warper->warp parity on `device`: (warped uint8, mask uint8, corner).
    Image remap INTER_LINEAR/BORDER_REFLECT, mask NEAREST/CONSTANT over the
    exact detectResultRoi rect (warpers_inl.hpp:63-99, CLI :710-716). The
    maps come from `proj.camera_maps` in float32, as the reference's do."""
    device = resolve_device(device, "_warp_image_dev")
    h, w = img.shape[:2]
    tlx, tly, brx, bry = detect_result_roi(kind, scale, K, R, (w, h),
                                           device=device)
    shape = (bry - tly + 1, brx - tlx + 1)
    _, k_rinv = proj.camera_maps(
        torch.as_tensor(np.asarray(K, np.float32), device=device),
        torch.as_tensor(np.asarray(R, np.float32), device=device))
    xm, ym, valid = rasterize_backward_map(
        kind, scale, k_rinv,
        torch.tensor([tlx, tly], dtype=torch.float32, device=device), shape)
    src = torch.tensor(np.asarray(img), device=device)
    warped = remap(src.to(torch.float32), xm, ym, interp="linear",
                   border="reflect")
    ones = torch.ones((h, w), dtype=torch.float32, device=device)
    m = remap(ones, xm, ym, interp="nearest", border="constant")
    mask = ((m > 0) & valid).to(torch.uint8) * 255
    warped_u8 = torch.where((mask > 0)[..., None],
                            torch.clamp(torch.round(warped), 0, 255),
                            torch.zeros_like(warped)).to(torch.uint8)
    return warped_u8, mask, (tlx, tly)


def _warp_image(img: np.ndarray, kind: str, scale: float, K: np.ndarray,
                R: np.ndarray, device=None
                ) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """Host-array variant of _warp_image_dev (seam-scale stage)."""
    wd, md, corner = _warp_image_dev(img, kind, scale, K, R, device)
    return wd.cpu().numpy(), md.cpu().numpy(), corner


def _canvas_extent(corners, hw_sizes):
    """(x0, y0, x1, y1) of rects at corners (x, y) of sizes (h, w)."""
    x0 = min(c[0] for c in corners)
    y0 = min(c[1] for c in corners)
    x1 = max(c[0] + s[1] for c, s in zip(corners, hw_sizes))
    y1 = max(c[1] + s[0] for c, s in zip(corners, hw_sizes))
    return x0, y0, x1, y1


def _place(arrays, corners, origin, canvas_hw):
    """Host arrays [h, w, ...] placed on a zero [n, H, W, ...] canvas."""
    out = np.zeros((len(arrays),) + tuple(canvas_hw) + arrays[0].shape[2:],
                   arrays[0].dtype)
    for i, a in enumerate(arrays):
        y, x = corners[i][1] - origin[1], corners[i][0] - origin[0]
        out[i, y:y + a.shape[0], x:x + a.shape[1]] = a
    return out


def compose_panorama_cv(images: Sequence[np.ndarray], cams: Cameras,
                        warped_image_scale: float, work_scale: float,
                        cfg: StitchConfig, device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Faithful compose: images are the kept full-resolution host frames;
    cams are work-scale cameras from registration. Returns (pano uint8,
    mask bool) on the host. device: 'cuda' unless given."""
    dev = resolve_device(device, "compose_panorama_cv")
    kind = cfg.compose.warp_type
    h0, w0 = images[0].shape[:2]
    seam_scale = _scale_for(cfg.scales.seam_megapix, w0, h0)
    compose_scale = _scale_for(cfg.scales.compose_megapix, w0, h0)
    seam_work_aspect = seam_scale / work_scale
    compose_work_aspect = compose_scale / work_scale
    n = len(images)
    K_all = cams.K().cpu().numpy().astype(np.float64)
    R_all = cams.R.cpu().numpy()

    # ---- seam-scale warps (CLI :545-580) ----
    with _tracer.span("seam_prep"):
        s_scale = warped_image_scale * seam_work_aspect
        s_warped, s_masks, s_corners = [], [], []
        for i in range(n):
            img_s = _resize_u8(images[i], seam_scale)
            K = K_all[i].copy()
            K[0] *= seam_work_aspect
            K[1] *= seam_work_aspect
            wi, mi, ci = _warp_image(img_s, kind, s_scale, K, R_all[i], dev)
            s_warped.append(wi)
            s_masks.append(mi)
            s_corners.append(ci)
        sx0, sy0, sx1, sy1 = _canvas_extent(s_corners,
                                            [m.shape for m in s_masks])
        canvas_hw = (sy1 - sy0, sx1 - sx0)
        canvas_imgs = _place([w.astype(np.float32) for w in s_warped],
                             s_corners, (sx0, sy0), canvas_hw)
        canvas_masks = _place([m > 0 for m in s_masks], s_corners,
                              (sx0, sy0), canvas_hw)

    # ---- exposure compensation feed (CLI :586-590) ----
    with _tracer.span("exposure_compensation"):
        ec = cfg.compose.expos_comp
        comp: Optional[BlocksGainCompensatorCV] = None
        gains1: Optional[np.ndarray] = None
        if ec == "gain_blocks":
            comp = BlocksGainCompensatorCV(cfg.compose.expos_block_size,
                                           cfg.compose.expos_block_size)
            comp.feed(s_corners, s_warped, s_masks)
        elif ec == "gain":
            # single gain per image (GainCompensator), canvas-form stats
            gains1 = gain_compensator(
                torch.from_numpy(canvas_imgs).to(dev),
                torch.from_numpy(canvas_masks).to(dev)).cpu().numpy()

    # ---- seam finding on the seam-scale canvas (CLI :594-637) ----
    with _tracer.span("seam_finding"):
        sf = cfg.compose.seam_find
        if sf == "voronoi":
            seam_canvas = voronoi_seams(
                torch.from_numpy(canvas_masks).to(dev)).cpu().numpy()
        elif sf in ("gc_color", "gc_colorgrad"):
            seam_canvas = graphcut_seams(
                canvas_imgs, canvas_masks,
                "color" if sf == "gc_color" else "colorgrad")
        elif sf in ("dp_color", "dp_colorgrad"):
            seam_canvas = dp_seams(
                canvas_imgs, canvas_masks,
                "color" if sf == "dp_color" else "colorgrad")
        elif sf == "no":
            seam_canvas = canvas_masks.copy()
        else:
            raise ValueError(f"unknown seam finder {sf}")
        seam_masks = []
        for i in range(n):
            y, x = s_corners[i][1] - sy0, s_corners[i][0] - sx0
            hh, ww = s_masks[i].shape
            seam_masks.append(
                seam_canvas[i, y:y + hh, x:x + ww].astype(np.uint8) * 255)

    # ---- compose loop at full/compose scale (CLI :656-753), on dev ----
    with _tracer.span("compositing"):
        c_scale = warped_image_scale * compose_work_aspect
        c_corners: List[Tuple[int, int]] = []
        c_sizes: List[Tuple[int, int]] = []          # (h, w)
        warped_s16: List[torch.Tensor] = []
        fed_masks: List[torch.Tensor] = []
        for i in range(n):
            img_c = _resize_u8(images[i], compose_scale)
            K = K_all[i].copy()
            K[0] *= compose_work_aspect
            K[1] *= compose_work_aspect
            img_w, mask_w, corner = _warp_image_dev(img_c, kind, c_scale, K,
                                                    R_all[i], dev)
            if comp is not None:
                img_w = comp.apply_dev(i, img_w)
            elif gains1 is not None:
                img_w = torch.clamp(torch.round(img_w.to(torch.float32)
                                                * float(gains1[i])), 0, 255) \
                    .to(torch.uint8)
            # dilate + resize the seam mask, AND with warp mask (CLI :726-728)
            sm = torch.from_numpy(_dilate3(seam_masks[i])).to(dev)
            hh, ww = mask_w.shape
            sm_r = torch.clamp(torch.round(_resize_linear_dev(
                sm.to(torch.float32), hh, ww)), 0, 255).to(torch.uint8)
            fed = torch.where(mask_w > 0, sm_r, torch.zeros_like(sm_r))
            c_corners.append(corner)
            c_sizes.append((hh, ww))
            warped_s16.append(img_w.to(torch.int16))
            fed_masks.append(fed)

        # result ROI over compose corners/sizes (util.cpp resultRoi)
        x0, y0, x1, y1 = _canvas_extent(c_corners, c_sizes)
        bt = cfg.compose.blend_type
        if bt == "multiband":
            blend_width = float(np.sqrt((x1 - x0) * (y1 - y0)) *
                                cfg.compose.blend_strength / 100.0)
            if blend_width < 1.0:
                bt = "no"
            else:
                bands = max(int(np.ceil(np.log2(blend_width))) - 1, 0)
        if bt == "multiband":
            mb = MultiBandBlenderCV(bands, dev)
            mb.prepare((x0, y0, x1 - x0, y1 - y0))
            for i in range(n):
                mb.feed_dev(warped_s16[i], fed_masks[i], c_corners[i])
            pano16, mask = mb.blend()
            return np.clip(pano16, 0, 255).astype(np.uint8), mask
        # feather / no: canvas blends (FeatherBlender parity lives in
        # blend/feather.py; the still path reuses it at canvas scale)
        H, W = y1 - y0, x1 - x0
        imgs_c = torch.zeros((n, H, W, 3), dtype=torch.float32, device=dev)
        seams_c = torch.zeros((n, H, W), dtype=torch.bool, device=dev)
        for i in range(n):
            y, x = c_corners[i][1] - y0, c_corners[i][0] - x0
            hh, ww = c_sizes[i]
            imgs_c[i, y:y + hh, x:x + ww] = warped_s16[i].to(torch.float32)
            seams_c[i, y:y + hh, x:x + ww] = fed_masks[i] > 0
        if bt == "feather":
            wgt = feather_weights(seams_c, cfg.compose.feather_sharpness)
            pano, mask = feather_blend(imgs_c, wgt)
        else:
            pano, mask = paste_blend(imgs_c, seams_c)
        pano = torch.clamp(torch.round(pano), 0, 255).to(torch.uint8)
        return pano.cpu().numpy(), mask.cpu().numpy()


def _dilate3(mask: np.ndarray) -> np.ndarray:
    """cv::dilate 3x3 rect kernel on a uint8 mask (CLI :726)."""
    p = np.pad(mask, 1, mode="constant")
    out = mask
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            out = np.maximum(out, p[dy:dy + mask.shape[0],
                                    dx:dx + mask.shape[1]])
    return out
