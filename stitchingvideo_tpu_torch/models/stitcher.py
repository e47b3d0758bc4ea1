"""Stitcher facade: frames -> `Registration` -> panorama.

Port of `stitchingvideo_tpu/models/stitcher.py` (cv::Stitcher::
estimateTransform and composePanorama, reference src/stitcher.cpp:91-316,
and the CLI flow stitching_detailed.cpp:545-764). Registration runs at
work_megapix, seams and exposure at seam_megapix, the per-pixel fields at
compose_megapix, linked by work_scale / seam_scale / compose_work_aspect
(SURVEY §5.7).

Frames are resized on the device with OpenCV's INTER_LINEAR arithmetic
(`ops/resize.py`, bit-exact against `cv2.resize`, which the JAX package
uses); features, matching and the bundle adjustment are
`register/pipeline.py`; the seam-scale warps, the canvas, the gains and the
compose-scale fields are tensor programs on the device, and the graph cut
runs on the host (`seams/graphcut.py`). Every shape is bucketed and sticky
(`_sticky`, `freeze_shapes`): the output size of a video stream must not
change across re-registrations.

Phase 2 composes a panorama: `compose_panorama` warps the frames through a
`Registration`'s maps and gains and blends them on the canvas
(`_remap_gain_batch`, `_blend_on_canvas`, also the runtime's full blend);
`stitch` runs both phases, or with `cfg.compose.faithful` (the default) the
OpenCV-faithful still path: registration at the work scale, then
`models/compose_cv.py`.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..blend.feather import feather_blend, feather_weights, paste_blend
from ..blend.multiband import multiband_blend, num_bands_for, pad_for_bands
from ..config import StitchConfig
from ..device import resolve_device
from ..geometry.warp import (_np_camera_maps, detect_result_roi_batch,
                             rasterize_backward_map)
from ..ops.filters import dilate
from ..ops.homography import matmul_highest
from ..ops.remap import remap
from ..ops.resize import resize_u8
from ..photometric.exposure import (blocks_gain_maps, gain_compensator,
                                    upsample_gain)
from ..register.pipeline import (RegistrationResult, _pad_to_bucket,
                                 compute_features, estimate_cameras,
                                 match_all_pairs, register_images)
from ..seams.dp import dp_seams
from ..seams.graphcut import graphcut_seams_banded
from ..seams.voronoi import voronoi_seams
from ..utils.timing import GLOBAL_TRACER as _tracer, maybe_sync as _msync
from .camera import Cameras
from .compose_cv import _scale_for, compose_panorama_cv
from .registration import Registration


def _bucket(x: int, q: int = 64) -> int:
    """Round a shape up to a bucket, so that re-registrations with slightly
    shifted ROIs keep their shapes."""
    return -(-x // q) * q


def _center_gauge(cams: Cameras, kind: str) -> Cameras:
    """Rotate all cameras about the panorama's vertical axis so the rig's
    azimuth span sits as far as possible from lon = ±pi.

    For the atan2-based projections (cylindrical/spherical/mercator) a
    camera whose warped footprint straddles the ±pi seam gets a forward ROI
    spanning the whole wrap, and the canvas inflates with duplicated
    content at both ends (the reference binary has the same flaw: OpenCV
    detectResultRoi, warpers_inl.hpp:144-163, never re-gauges). The
    estimated geometry has a free global-yaw gauge: centring the largest
    azimuth gap at ±pi is invisible to every pairwise relation and to wave
    correction (a rotation about the wave-corrected vertical)."""
    if kind not in ("cylindrical", "spherical", "mercator"):
        return cams
    R = cams.R.cpu().numpy().astype(np.float64)
    yaw = np.arctan2(R[:, 0, 2], R[:, 2, 2])
    order = np.sort(yaw)
    gaps = np.diff(np.concatenate([order, order[:1] + 2 * np.pi]))
    g = int(np.argmax(gaps))
    mid_gap = order[g] + gaps[g] / 2.0          # azimuth of the largest gap
    delta = float((mid_gap + np.pi + np.pi) % (2 * np.pi) - np.pi)
    # new yaw = yaw - delta puts mid_gap at ±pi. A full-wrap rig (gap ~ 0)
    # cannot avoid the seam; a near-identity shift is skipped to keep the
    # placement byte-stable across re-registrations.
    if gaps[g] < 0.05 or abs(delta) < 0.02:
        return cams
    c, s = np.cos(-delta), np.sin(-delta)
    Ry = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]], np.float64)
    Rn = (Ry[None] @ R).astype(np.float32)
    return Cameras(focal=cams.focal, aspect=cams.aspect, ppx=cams.ppx,
                   ppy=cams.ppy, R=torch.from_numpy(Rn).to(cams.R.device),
                   t=cams.t)


def _resize_all(images, scale: float, device=None) -> List[np.ndarray]:
    """Resize host frames by `scale` on `device` with cv2's INTER_LINEAR
    arithmetic (the reference's own resample, CLI stitching_detailed.cpp:
    381, :546; bit for bit what the JAX package gets from `cv2.resize`);
    returns host arrays. Same-shape frames go up as one batch."""
    if scale == 1.0:
        return [np.asarray(im) for im in images]
    device = resolve_device(device, "_resize_all")
    h, w = images[0].shape[:2]
    if any(im.shape != images[0].shape for im in images):
        return [r for im in images for r in _resize_all([im], scale, device)]
    x = torch.from_numpy(np.stack([np.asarray(im) for im in images])) \
        .to(device)
    gray = x.dim() == 3
    out = resize_u8(x[..., None] if gray else x,
                    (max(1, round(h * scale)), max(1, round(w * scale))))
    out = (out[..., 0] if gray else out).cpu().numpy()
    return list(out)


def _affine_weights(n_in: int, n_out: int, inv_scale: torch.Tensor,
                    translation: torch.Tensor) -> torch.Tensor:
    """[..., n_in, n_out] linear-resample weights of
    `jax.image.scale_and_translate(..., method='linear', antialias=False)`
    (a triangle kernel, columns normalised, zero where the sample lies
    outside the input); inv_scale and translation [...] float32."""
    dev = inv_scale.device
    inv = inv_scale[..., None]
    sample_f = ((torch.arange(n_out, dtype=torch.float32, device=dev) + 0.5)
                * inv - translation[..., None] * inv - 0.5)   # [..., n_out]
    x = (sample_f[..., None, :]
         - torch.arange(n_in, dtype=torch.float32, device=dev)[:, None]) \
        .abs()
    w = torch.clamp(1.0 - x, min=0.0)
    total = w.sum(dim=-2, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total,
                                    torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[..., None, :], w, torch.zeros_like(w))


def _scale_and_translate(img: torch.Tensor, out_hw: Tuple[int, int],
                         inv_scale: torch.Tensor, ty: torch.Tensor,
                         tx: torch.Tensor) -> torch.Tensor:
    """[n, H, W] -> [n, *out_hw]: the resampling-matrix products XLA
    lowers `scale_and_translate` to, in float64 and rounded once (no
    TF32)."""
    wy = _affine_weights(img.shape[-2], out_hw[0], inv_scale, ty)
    wx = _affine_weights(img.shape[-1], out_hw[1], inv_scale, tx)
    return matmul_highest(matmul_highest(wy.transpose(-1, -2), img), wx)


def _compose_fields_batch(kind, scale, k_rinvs, corners, wh, roi_hw, shape,
                          seam_canvas, gain_canvas, canvas_origin, ratio):
    """All cameras' compose-scale fields in one pass: backward maps,
    validity, and the seam-mask and gain-map transfers from the seam
    canvas. The transfer is an affine resample (in_pos = out * ratio +
    corner * ratio - origin), written as resampling-matrix products."""
    Hr, Wr = shape
    dev = k_rinvs.device
    xm, ym, valid = rasterize_backward_map(kind, scale, k_rinvs, corners,
                                           (Hr, Wr))
    w_src = wh[:, 0, None, None]
    h_src = wh[:, 1, None, None]
    inb = (xm > -0.5) & (xm < w_src - 0.5) & (ym > -0.5) & (ym < h_src - 0.5)
    yy_r = torch.arange(Hr, device=dev)[None, :] < roi_hw[:, 0, None]
    xx_r = torch.arange(Wr, device=dev)[None, :] < roi_hw[:, 1, None]
    v = valid & inb & (yy_r[:, :, None] & xx_r[:, None, :])
    one = torch.ones((), dtype=torch.float32, device=dev)
    cy = corners[:, 1] * ratio - canvas_origin[1]
    cx = corners[:, 0] * ratio - canvas_origin[0]
    inv_scale = one / (one / ratio).expand_as(cy)
    half = 0.5 * ratio - 0.5

    def affine(img, c_shift):
        return _scale_and_translate(img, (Hr, Wr), inv_scale,
                                    (half - (cy + c_shift)) / ratio,
                                    (half - (cx + c_shift)) / ratio)

    sm = dilate(seam_canvas.permute(1, 2, 0), 3).permute(2, 0, 1) \
        .to(torch.float32)
    seam_r = affine(sm, 0.0)              # zero border = remap 'constant'
    # replicate border for the gain: a 2 px edge pad, its origin shifted
    gpad = torch.nn.functional.pad(gain_canvas[:, None], (2, 2, 2, 2),
                                   mode="replicate")[:, 0]
    gain_r = affine(gpad, 2.0)
    return xm, ym, v, (seam_r > 0.05) & v, gain_r


def _seam_canvas_place(warped, masks, rel_corners, canvas_hw):
    """Place the seam-scale warps [n, hh, ww, 3] and masks [n, hh, ww] on
    the canvas (SH, SW) at their corners (x, y)."""
    SH, SW = canvas_hw
    n, hh, ww = masks.shape
    dev = masks.device
    ci = torch.zeros((n, SH + hh, SW + ww, 3), dtype=torch.float32,
                     device=dev)
    cm = torch.zeros((n, SH + hh, SW + ww), dtype=torch.bool, device=dev)
    for i, (x, y) in enumerate(rel_corners):
        # the start clamp of jax.lax.dynamic_update_slice
        x, y = min(max(int(x), 0), SW), min(max(int(y), 0), SH)
        ci[i, y:y + hh, x:x + ww] = warped[i].to(torch.float32)
        cm[i, y:y + hh, x:x + ww] = masks[i]
    return ci[:, :SH, :SW], cm[:, :SH, :SW]


def _seam_warp_batch(images, kind, scale, k_rinvs, corners, shape,
                     src_hw=None):
    """All cameras' seam-scale warps: image linear/reflect from its
    bucket-padded frame, and the mask (remap of ones, nearest/constant),
    which is the nearest-tap in-range test of the true (H, W) = src_hw
    extent (reads just past it hit the reflect-101 pad, what a
    border='reflect' resample of the unpadded image reads)."""
    xm, ym, valid = rasterize_backward_map(kind, scale, k_rinvs, corners,
                                           shape)
    w = torch.stack([remap(images[i], xm[i], ym[i], interp="linear",
                           border="reflect") for i in range(len(images))])
    H, W = src_hw if src_hw is not None else images.shape[1:3]
    inb = (xm > -0.5) & (xm < W - 0.5) & (ym > -0.5) & (ym < H - 0.5)
    return w, inb & valid


class Stitcher:
    """High-level stitcher. See module docstring.

    device: 'cuda' unless given; with no CUDA present the default raises.
    `device="cpu"` runs every stage on the CPU."""

    def __init__(self, config: Optional[StitchConfig] = None, device=None):
        self.cfg = config or StitchConfig()
        self.device = resolve_device(device, "Stitcher")
        self._last_result: Optional[RegistrationResult] = None
        self._last_work_scale: float = 1.0
        self._shape_memo: dict = {}
        self._shapes_frozen: bool = False

    def _sticky(self, name: str, value: int) -> int:
        """Session-sticky shape: never shrinks, so a re-registration whose
        ROIs jitter around a bucket boundary keeps its shapes; frozen, it
        returns the memo."""
        if self._shapes_frozen and name in self._shape_memo:
            return self._shape_memo[name]
        v = max(int(value), self._shape_memo.get(name, 0))
        self._shape_memo[name] = v
        return v

    def freeze_shapes(self) -> None:
        """Freeze every sticky shape at its current value: later
        registrations reuse the first successful registration's canvas and
        ROI shapes even if their true extents drift past a bucket boundary
        (the reference's model stabilization keeps the first registration's
        panorama geometry the same way, 64-bit RT program :447-532
        `imgMatready` guard). Content drifting beyond a frozen extent is clipped at the
        canvas edge."""
        self._shapes_frozen = True

    # accessor parity with cv::Stitcher (stitcher.hpp:58-174)
    def cameras(self) -> Optional[Cameras]:
        """Estimated cameras of the last estimate_transform (work scale)."""
        return self._last_result.cameras if self._last_result else None

    def component(self) -> Optional[List[int]]:
        """Indices of images kept in the panorama (biggest component)."""
        return self._last_result.indices if self._last_result else None

    def work_scale(self) -> float:
        return self._last_work_scale

    # ------------------------------------------------------------------
    # Phase 1: estimate_transform (stitcher.cpp:91-112)
    # ------------------------------------------------------------------
    def estimate_transform(self, images: Sequence[np.ndarray], seed: int = 0
                           ) -> Tuple[Registration, RegistrationResult,
                                      float]:
        """Host frames -> (Registration at compose scale on the device, the
        cameras' RegistrationResult, compose_scale)."""
        cfg = self.cfg
        dev = self.device
        h0, w0 = images[0].shape[:2]
        work_scale = _scale_for(cfg.scales.work_megapix, w0, h0)
        seam_scale = _scale_for(cfg.scales.seam_megapix, w0, h0)
        seam_work_aspect = seam_scale / work_scale

        self._last_work_scale = work_scale
        work_imgs = _resize_all(images, work_scale, dev)
        with _tracer.span("find_features"):
            # compute_features fetches the detector's outputs to the host,
            # which syncs its work into this span
            feats = compute_features(work_imgs, cfg, dev)
        with _tracer.span("pairwise_matching"):
            pairs = match_all_pairs(feats, cfg, seed, dev)
        with _tracer.span("estimate_cameras"):
            reg = estimate_cameras(feats, pairs, cfg, dev)
        self._last_result = reg
        kept = reg.indices
        full_kept = [images[i] for i in kept]
        n = len(kept)

        cams = reg.cameras  # work-scale intrinsics, centred pp re-added
        warped_image_scale = reg.warped_image_scale
        kind = cfg.compose.warp_type
        cams = _center_gauge(cams, kind)

        # ---- seam-scale warps (CLI :545-580) ----
        with _tracer.span("seam_prep"):
            seam_imgs = _resize_all(full_kept, seam_scale, dev)
            seam_shapes = [im.shape[:2] for im in seam_imgs]
            s_scale = warped_image_scale * seam_work_aspect
            K_all = cams.K().cpu().numpy().astype(np.float64)
            R_all = cams.R.cpu().numpy()
            Ks_s = K_all.copy()
            Ks_s[:, 0] *= seam_work_aspect
            Ks_s[:, 1] *= seam_work_aspect
            rois_s = detect_result_roi_batch(
                kind, s_scale, list(Ks_s), list(R_all),
                [(sh[1], sh[0]) for sh in seam_shapes], device=dev)
            k_rinvs = torch.from_numpy(
                _np_camera_maps(Ks_s.astype(np.float32), R_all)[1]).to(dev)
            s_corners = [(tlx, tly) for tlx, tly, _brx, _bry in rois_s]
            s_shapes = [(_bucket(bry - tly + 1), _bucket(brx - tlx + 1))
                        for tlx, tly, brx, bry in rois_s]
            shape = (self._sticky("seam_h", max(s[0] for s in s_shapes)),
                     self._sticky("seam_w", max(s[1] for s in s_shapes)))
            corners_s = torch.tensor(s_corners, dtype=torch.float32,
                                     device=dev)
            if len(set(seam_shapes)) == 1:
                # one upload and one pass for all cameras, bucket-padded
                # as the reference pads (its shape buckets)
                wb, mb = _seam_warp_batch(
                    torch.from_numpy(np.stack([_pad_to_bucket(im)
                                               for im in seam_imgs]))
                    .to(dev), kind, s_scale, k_rinvs, corners_s, shape,
                    src_hw=tuple(seam_imgs[0].shape[:2]))
            else:
                s_warped, s_masks = [], []
                for i in range(n):
                    h_t, w_t = seam_imgs[i].shape[:2]
                    padded = torch.from_numpy(
                        _pad_to_bucket(seam_imgs[i])).to(dev)
                    xm, ym, valid = rasterize_backward_map(
                        kind, s_scale, k_rinvs[i], corners_s[i], shape)
                    # true-extent ones on the zero pad: the mask warp keeps
                    # the true in-range semantics on the padded array
                    ones = torch.zeros(padded.shape[:2], device=dev)
                    ones[:h_t, :w_t] = 1.0
                    s_warped.append(remap(padded, xm, ym, interp="linear",
                                          border="reflect"))
                    s_masks.append((remap(ones, xm, ym, interp="nearest",
                                          border="constant") > 0) & valid)
                wb = torch.stack(s_warped)
                mb = torch.stack(s_masks)

            sx0 = min(c[0] for c in s_corners)
            sy0 = min(c[1] for c in s_corners)
            sx1 = max(c[0] + shape[1] for c in s_corners)
            sy1 = max(c[1] + shape[0] for c in s_corners)
            SH = self._sticky("canvas_sh", _bucket(sy1 - sy0))
            SW = self._sticky("canvas_sw", _bucket(sx1 - sx0))
            canvas_imgs, canvas_masks = _seam_canvas_place(
                wb, mb, [(c[0] - sx0, c[1] - sy0) for c in s_corners],
                (SH, SW))
            _msync(canvas_imgs, canvas_masks)

        # ---- exposure compensation at seam scale (CLI :586-590) ----
        with _tracer.span("exposure_compensation"):
            ec = cfg.compose.expos_comp
            if ec == "gain":
                gains = gain_compensator(canvas_imgs, canvas_masks)
                gain_canvas = gains[:, None, None].expand(n, SH, SW) \
                    .to(torch.float32)
            elif ec == "gain_blocks":
                bs = cfg.compose.expos_block_size
                gmaps = blocks_gain_maps(canvas_imgs, canvas_masks, bs)
                gain_canvas = upsample_gain(gmaps, (SH, SW), bs)
            else:
                gain_canvas = torch.ones((n, SH, SW), dtype=torch.float32,
                                         device=dev)
            _msync(gain_canvas)

        # ---- seam finding at seam scale (CLI :594-637) ----
        with _tracer.span("seam_finding"):
            sf = cfg.compose.seam_find
            if sf == "voronoi":
                seam_canvas = voronoi_seams(canvas_masks)
            elif sf in ("gc_color", "gc_colorgrad"):
                # the BK max-flow is host-sequential (SURVEY §7.3): only the
                # pairwise-overlap bands go to the host, uint8-quantized
                imgs_u8 = torch.clamp(torch.round(canvas_imgs), 0, 255) \
                    .to(torch.uint8)
                seam_canvas = graphcut_seams_banded(
                    imgs_u8, canvas_masks,
                    "color" if sf == "gc_color" else "colorgrad",
                    sticky=self._shape_memo.setdefault("seam_band", {}))
            elif sf in ("dp_color", "dp_colorgrad"):
                imgs_np = torch.clamp(torch.round(canvas_imgs), 0, 255) \
                    .to(torch.uint8).cpu().numpy().astype(np.float32)
                seam_canvas = torch.from_numpy(dp_seams(
                    imgs_np, canvas_masks.cpu().numpy(),
                    "color" if sf == "dp_color" else "colorgrad")).to(dev)
            elif sf == "no":
                seam_canvas = canvas_masks
            else:
                raise ValueError(f"unknown seam finder {sf}")
            _msync(seam_canvas)

        # ---- compose-scale warp fields (CLI :656-716) ----
        with _tracer.span("warp_field_build"):
            compose_scale = _scale_for(cfg.scales.compose_megapix, w0, h0)
            compose_work_aspect = compose_scale / work_scale
            c_scale = warped_image_scale * compose_work_aspect

            Ks = K_all.copy()
            Ks[:, 0] *= compose_work_aspect
            Ks[:, 1] *= compose_work_aspect
            c_sizes = [(round(full_kept[i].shape[1] * compose_scale),
                        round(full_kept[i].shape[0] * compose_scale))
                       for i in range(n)]
            rois_c = detect_result_roi_batch(kind, c_scale, list(Ks),
                                             list(R_all), c_sizes,
                                             device=dev)
            c_corners = [(tlx, tly) for tlx, tly, _brx, _bry in rois_c]
            c_shapes = [(bry - tly + 1, brx - tlx + 1)
                        for tlx, tly, brx, bry in rois_c]
            if any(h <= 0 or w <= 0 for h, w in c_shapes):
                raise AssertionError(
                    f"non-positive compose ROI shape: {c_shapes} (rois "
                    f"{rois_c}): a zero-area clip window drops a camera")

            Hr = self._sticky("roi_h",
                              _bucket(max(s[0] for s in c_shapes), 128))
            Wr = self._sticky("roi_w",
                              _bucket(max(s[1] for s in c_shapes), 128))

            k_rinvs_c = _np_camera_maps(Ks.astype(np.float32), R_all)[1]

            def f32(a):
                return torch.as_tensor(np.asarray(a, np.float32), device=dev)

            xmaps, ymaps, valids, seam_rois, gain_rois = \
                _compose_fields_batch(
                    kind, c_scale, f32(k_rinvs_c), f32(c_corners),
                    f32(c_sizes),
                    torch.tensor(c_shapes, dtype=torch.int32, device=dev),
                    (Hr, Wr), seam_canvas, gain_canvas, f32([sx0, sy0]),
                    f32(s_scale / c_scale))

            # the canvas, bucketed and sticky so that re-registrations with
            # slightly shifted corners keep canvas_wh
            cx0 = min(c[0] for c in c_corners)
            cy0 = min(c[1] for c in c_corners)
            cx1 = max(c[0] + s[1] for c, s in zip(c_corners, c_shapes))
            cy1 = max(c[1] + s[0] for c, s in zip(c_corners, c_shapes))
            CW = self._sticky("pano_w", _bucket(cx1 - cx0))
            CH = self._sticky("pano_h", _bucket(cy1 - cy0))
            # the true covered extent, sticky so that the RT crop computed
            # from it keeps its shape; everything beyond it is bucket pad
            EW = self._sticky("ext_w", min(cx1 - cx0, CW))
            EH = self._sticky("ext_h", min(cy1 - cy0, CH))
            corners = torch.tensor([[c[0] - cx0, c[1] - cy0]
                                    for c in c_corners], dtype=torch.int32,
                                   device=dev)

            cams_c = Cameras(
                focal=cams.focal * compose_work_aspect,
                aspect=cams.aspect,
                ppx=cams.ppx * compose_work_aspect,
                ppy=cams.ppy * compose_work_aspect,
                R=cams.R, t=cams.t)
            _msync(xmaps, seam_rois, gain_rois)
        return Registration(
            cameras=cams_c, corners=corners, valid=valids, xmaps=xmaps,
            ymaps=ymaps, seam_masks=seam_rois, gain_maps=gain_rois,
            canvas_wh=(CW, CH), roi_hw=(Hr, Wr), warp_kind=kind,
            warp_scale=float(c_scale), extent_wh=(EW, EH),
            src_indices=tuple(int(i) for i in reg.indices),
        ), reg, compose_scale

    # ------------------------------------------------------------------
    # Phase 2: compose_panorama (stitcher.cpp:114-316)
    # ------------------------------------------------------------------
    def compose_panorama(self, images: Sequence[np.ndarray], reg: Registration,
                         reg_result: Optional[RegistrationResult] = None,
                         compose_scale: float = 1.0
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Host frames through a compose-scale registration -> (pano uint8,
        mask bool) on the host."""
        cfg = self.cfg
        if reg_result is not None:
            images = [images[i] for i in reg_result.indices]
        imgs = _resize_all(images, compose_scale, self.device)
        n = reg.n_cameras
        # pad inputs to a common shape for the batched remap
        Hs = max(im.shape[0] for im in imgs)
        Ws = max(im.shape[1] for im in imgs)
        batch = np.zeros((n, Hs, Ws, 3), np.float32)
        for i, im in enumerate(imgs):
            batch[i, :im.shape[0], :im.shape[1]] = im
        warped = _remap_gain_batch(torch.from_numpy(batch).to(self.device),
                                   reg.xmaps, reg.ymaps, reg.gain_maps)
        pano, mask = _blend_on_canvas(
            warped, reg.seam_masks, reg.valid, reg.corners.cpu().numpy(),
            reg.canvas_wh, cfg.compose.blend_type, cfg.compose.blend_strength,
            cfg.compose.feather_sharpness)
        return (torch.clamp(torch.round(pano), 0, 255).to(torch.uint8)
                .cpu().numpy(), mask.cpu().numpy())

    def stitch(self, images: Sequence[np.ndarray],
               seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """Host frames -> (pano uint8, mask bool) on the host."""
        if self.cfg.compose.faithful:
            # the OpenCV-faithful still path: registration at the work
            # scale, then the CLI's compose flow; no Registration is built
            cfg = self.cfg
            h0, w0 = images[0].shape[:2]
            work_scale = _scale_for(cfg.scales.work_megapix, w0, h0)
            self._last_work_scale = work_scale
            work_imgs = _resize_all(images, work_scale, self.device)
            with _tracer.span("registration"):
                reg = register_images(work_imgs, cfg, seed, self.device)
            self._last_result = reg
            kept = [images[i] for i in reg.indices]
            return compose_panorama_cv(kept, reg.cameras,
                                       float(reg.warped_image_scale),
                                       work_scale, cfg, device=self.device)
        reg, reg_result, compose_scale = self.estimate_transform(images, seed)
        return self.compose_panorama(images, reg, reg_result, compose_scale)


def _remap_gain_batch(images: torch.Tensor, xmaps: torch.Tensor,
                      ymaps: torch.Tensor, gains: torch.Tensor
                      ) -> torch.Tensor:
    """[N, H, W, 3] + maps -> warped [N, Hr, Wr, 3] float32 with gains
    applied."""
    return torch.stack([
        remap(images[i], xmaps[i], ymaps[i], interp="linear",
              border="reflect") * gains[i][..., None]
        for i in range(images.shape[0])])


def _blend_on_canvas(warped, seam_masks, valids, corners, canvas_wh,
                     blend_type: str, blend_strength: float,
                     sharpness: float):
    """Place per-camera ROIs on the canvas at their host corners and blend:
    (pano [CH, CW, 3] float32, mask [CH, CW] bool) on warped's device."""
    CW, CH = canvas_wh
    n, Hr, Wr = warped.shape[:3]
    dev = warped.device
    if blend_type == "multiband":
        bands = num_bands_for(float(CW * CH), blend_strength)
        CHp, CWp = pad_for_bands(CH, CW, bands)
    else:
        CHp, CWp = CH, CW

    canvas_imgs = torch.zeros((n, CHp, CWp, 3), dtype=torch.float32,
                              device=dev)
    canvas_seams = torch.zeros((n, CHp, CWp), dtype=torch.bool, device=dev)
    for i in range(n):
        x, y = int(corners[i][0]), int(corners[i][1])
        h = min(Hr, CHp - y)
        w = min(Wr, CWp - x)
        canvas_imgs[i, y:y + h, x:x + w] = \
            (warped[i] * valids[i][..., None])[:h, :w]
        canvas_seams[i, y:y + h, x:x + w] = (seam_masks[i] & valids[i])[:h, :w]

    if blend_type == "no":
        pano, mask = paste_blend(canvas_imgs, canvas_seams)
    elif blend_type == "feather":
        pano, mask = feather_blend(canvas_imgs,
                                   feather_weights(canvas_seams, sharpness))
    elif blend_type == "multiband":
        pano, mask = multiband_blend(canvas_imgs, canvas_seams, bands)
    else:
        raise ValueError(f"unknown blend type {blend_type}")
    return pano[:CH, :CW], mask[:CH, :CW]
