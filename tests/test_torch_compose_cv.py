"""The port's OpenCV-faithful still compose against the JAX package's, on the
CPU (`stitchingvideo_tpu_torch/models/compose_cv.py`,
`photometric/exposure_cv.py`).

Stated tolerances:
  - `BlocksGainCompensatorCV` (the same numpy code, float64 solves): gain
    grids equal; `apply_dev` within one uint8 step of the reference's
    `apply_dev` and of its host `apply` on <= 0.1% of values;
  - `_resize_linear`: equal; `_resize_linear_dev` (two-tap gathers, the
    second tap a fused multiply-add, as XLA's CPU matrix product rounds at
    most of the reference's shapes) within 3 float32 ulps of the
    reference's (measured 0 at 30x60 and 37x61 grids, 3 at 9x12, where XLA
    rounds without the fused multiply-add); the reference's own host and
    device resizes are 3 ulps apart;
  - `_dilate3`: equal, and equal to cv2.dilate;
  - `_warp_image_dev`: the ROI corner and shape equal, or one bound 1 apart
    where one float32 ulp of the forward map crosses an integer (ROADMAP.md
    section 3); masks equal on the shared rect; warped uint8 images within
    one step on <= 0.1% of values;
  - `compose_panorama_cv` from identical cameras (the JAX package's
    registration of the 3 x 320x240 scene), blend multiband / feather / no
    x seam gc_color / voronoi / dp_color, and the single-gain compensator:
    the reference's own kernel gate, median <= 1 and >= 99.9% within 4,
    masks apart on <= 0.5% of pixels (measured: max 1 step on <= 9e-6 of
    the values, masks equal).
"""
import dataclasses

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stitchingvideo_tpu.config import StitchConfig as JStitchConfig
from stitchingvideo_tpu.models import compose_cv as jcc
from stitchingvideo_tpu.models.stitcher import _resize_all as j_resize_all
from stitchingvideo_tpu.models.stitcher import _scale_for
from stitchingvideo_tpu.photometric import exposure_cv as jex
from stitchingvideo_tpu.register.pipeline import \
    register_images as j_register_images
from stitchingvideo_tpu.utils import synthetic as jsyn
from stitchingvideo_tpu_torch import StitchConfig
from stitchingvideo_tpu_torch.models import compose_cv as cc
from stitchingvideo_tpu_torch.models.camera import Cameras
from stitchingvideo_tpu_torch.photometric import exposure_cv as ex

from tests.test_torch_register import _slice_cfg


def _ulps(a, b) -> int:
    a = np.ascontiguousarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.ascontiguousarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _gain_inputs():
    """tests/test_parity_cv.py's three overlapping crops of one blurred
    image, at three exposures."""
    rng = np.random.default_rng(0)
    corners = [(0, 0), (180, 15), (360, -10)]
    base = cv2.GaussianBlur(rng.integers(40, 200, (400, 900, 3))
                            .astype(np.uint8), (31, 31), 9)
    imgs, masks = [], []
    for i, (cx, cy) in enumerate(corners):
        h, w = 260, 300
        crop = base[100 + cy:100 + cy + h, cx:cx + w]
        imgs.append(np.clip(crop.astype(np.float32) * (0.8 + 0.15 * i),
                            0, 255).astype(np.uint8))
        m = np.zeros((h, w), np.uint8)
        m[5:-5, 3:-3] = 255
        masks.append(m)
    return corners, imgs, masks


def test_blocks_gain_compensator_matches():
    corners, imgs, masks = _gain_inputs()
    ours = ex.BlocksGainCompensatorCV()
    ours.feed(corners, imgs, masks)
    ref = jex.BlocksGainCompensatorCV()
    ref.feed(corners, imgs, masks)
    for i in range(3):
        np.testing.assert_array_equal(ours.gain_grid(i), ref.gain_grid(i))
        got = ours.apply_dev(i, torch.from_numpy(imgs[i])).numpy()
        assert got.dtype == np.uint8
        # against the reference's device and host applies
        for want in (np.asarray(ref.apply_dev(i, jnp.asarray(imgs[i]))),
                     ref.apply(i, imgs[i])):
            d = np.abs(got.astype(int) - want.astype(int))
            assert d.max() <= 1 and (d > 0).mean() <= 1e-3, \
                (d.max(), (d > 0).mean())


@pytest.mark.parametrize("gh,gw,h,w", [(9, 12, 288, 384), (5, 7, 131, 97),
                                       (30, 60, 250, 500), (37, 61, 400, 700),
                                       (3, 1, 10, 1), (240, 320, 252, 330)])
def test_resize_linear_matches(gh, gw, h, w):
    rng = np.random.default_rng(gh * gw)
    g = rng.uniform(0.5, 1.5, (gh, gw)).astype(np.float32)
    if gh > 100:                        # a seam mask, as compose resizes it
        g = (rng.uniform(0, 1, (gh, gw)) > 0.5).astype(np.float32) * 255
    np.testing.assert_array_equal(ex._resize_linear(g, h, w),
                                  jex._resize_linear(g, h, w))
    # the taps are the reference's resampling matrices' entries
    for n_out, n_in in ((h, gh), (w, gw)):
        cols, wts = ex._resample_taps(n_out, n_in)
        dense = np.zeros((n_out, n_in), np.float32)
        np.add.at(dense, (np.arange(n_out)[:, None], cols), wts)
        np.testing.assert_array_equal(dense,
                                      jex._resample_matrix(n_out, n_in))
    got = ex._resize_linear_dev(torch.from_numpy(g), h, w)
    assert got.dtype == torch.float32 and tuple(got.shape) == (h, w)
    want = np.asarray(jex._resize_linear_dev(jnp.asarray(g), h, w))
    assert _ulps(got.numpy(), want) <= 3
    if (gh, gw) in ((30, 60), (37, 61)):
        np.testing.assert_array_equal(got.numpy(), want)


def test_dilate3_matches():
    rng = np.random.default_rng(6)
    m = ((rng.uniform(0, 1, (47, 61)) > 0.9) * 255).astype(np.uint8)
    got = cc._dilate3(m)
    np.testing.assert_array_equal(got, jcc._dilate3(m))
    np.testing.assert_array_equal(got, cv2.dilate(m, np.ones((3, 3),
                                                             np.uint8)))


@pytest.mark.parametrize("kind", ["cylindrical", "spherical", "plane"])
def test_warp_image_dev_matches(kind):
    """tests/test_parity_cv.py's warp: a blurred 320x240 image, f = 210."""
    rng = np.random.default_rng(7)
    img = cv2.GaussianBlur(rng.integers(0, 256, (240, 320, 3))
                           .astype(np.uint8), (5, 5), 1.5)
    K = np.array([[210.0, 0, 160.0], [0, 210.0, 120.0], [0, 0, 1]])
    R = cv2.Rodrigues(np.array([0.05, 0.4, 0.02]))[0].astype(np.float32)
    wd, md, corner = cc._warp_image_dev(img, kind, 210.0, K, R,
                                        device="cpu")
    want, wmask, wcorner = jcc._warp_image(img, kind, 210.0, K, R)
    assert wd.dtype == md.dtype == torch.uint8
    h = min(wd.shape[0], want.shape[0])
    w = min(wd.shape[1], want.shape[1])
    assert all(abs(a - b) <= 1 for a, b in
               zip(corner + tuple(wd.shape[:2]), wcorner + want.shape[:2]))
    if corner == wcorner:
        np.testing.assert_array_equal(md.numpy()[:h, :w], wmask[:h, :w])
        d = np.abs(wd.numpy()[:h, :w].astype(int)
                   - want[:h, :w].astype(int))
        assert d.max() <= 1 and (d > 0).mean() <= 1e-3, \
            (d.max(), (d > 0).mean())
    host = cc._warp_image(img, kind, 210.0, K, R, device="cpu")
    np.testing.assert_array_equal(host[0], wd.numpy())
    np.testing.assert_array_equal(host[1], md.numpy())


@pytest.fixture(scope="module")
def scene():
    """The JAX package's registration of the 3 x 320x240 scene (the slice
    tests' config): both compose paths take its cameras."""
    views = jsyn.make_scene(n=3, img_wh=(320, 240), fov_deg=55,
                            overlap_frac=0.4, seed=2)[0]
    jcfg = _slice_cfg(JStitchConfig)
    ws = _scale_for(jcfg.scales.work_megapix, 320, 240)
    res = j_register_images(j_resize_all(views, ws), jcfg, seed=0)
    assert res.indices == [0, 1, 2]
    c = res.cameras
    cams = Cameras.create(*(np.array(getattr(c, k))
                            for k in ("focal", "ppx", "ppy")),
                          R=np.array(c.R), aspect=np.array(c.aspect),
                          device="cpu")
    return [views[i] for i in res.indices], res, cams, ws


@pytest.mark.parametrize("blend,seam,expos", [
    (b, s, "gain_blocks") for b in ("multiband", "feather", "no")
    for s in ("gc_color", "voronoi", "dp_color")] + [
    ("feather", "voronoi", "gain")])
def test_compose_panorama_cv_matches(scene, blend, seam, expos):
    views, res, cams, ws = scene
    compose = dict(blend_type=blend, seam_find=seam, expos_comp=expos)
    jcfg, cfg = (c.replace(compose=dataclasses.replace(c.compose, **compose))
                 for c in (_slice_cfg(JStitchConfig),
                           _slice_cfg(StitchConfig)))
    want, wmask = jcc.compose_panorama_cv(
        views, res.cameras, float(res.warped_image_scale), ws, jcfg)
    got, mask = cc.compose_panorama_cv(
        views, cams, float(res.warped_image_scale), ws, cfg, device="cpu")
    assert got.dtype == np.uint8 and mask.dtype == bool
    assert got.shape == want.shape and got.shape[1] > 600
    d = np.abs(got.astype(int) - want.astype(int))
    assert np.median(d) <= 1 and (d <= 4).mean() >= 0.999, \
        (np.median(d), (d <= 4).mean())
    assert (mask != wmask).mean() <= 5e-3
    # the reference's own gates (tests/test_stitcher.py:47-59)
    assert mask.mean() > 0.5 and got[mask].mean() > 30


def test_compose_needs_cuda_by_default(scene, monkeypatch):
    views, res, cams, ws = scene
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cc.compose_panorama_cv(views, cams, float(res.warped_image_scale),
                               ws, StitchConfig())
