"""Port slice 4b against the JAX package on the CPU: color, filters and
features (`stitchingvideo_tpu_torch/ops/{color,filters,features}.py`,
`register/pipeline.py` compute_features).

Same inputs, made from a seed with numpy, through both packages. The
detector path is exact: FAST masks, Harris responses, keypoint slots (the
top-k order, ties included), responses, descriptors. The port rounds the
shift-and-accumulate filters and the Harris algebra as XLA's CPU backend
contracts them (`ops/fma.py`). Stated tolerances: orientations within 1e-6
rad (XLA's and PyTorch's atan2 differ in the last bits; the binary
descriptors they rotate come out equal), 1e-4 rad on the per-image path,
whose gray is not rounded to integers (measured 6.5e-5); the float ('grad') descriptors
within 1e-6 (summation order of the histograms); the depthwise
convolutions of `filters.py` within 1e-6 of the output's largest magnitude
(convolution summation order; measured at most 1.2e-7); the pyramid, whose
levels come from a resize that both packages sum in their own order, at
least 99% of keypoint slots equal and at least 99.9% of descriptor bits on
the shared ones.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stitchingvideo_tpu.config import StitchConfig as JStitchConfig
from stitchingvideo_tpu.ops import color as jcolor
from stitchingvideo_tpu.ops import features as jfeat
from stitchingvideo_tpu.ops import filters as jfilt
from stitchingvideo_tpu.register import pipeline as jpipe
from stitchingvideo_tpu.utils import synthetic as jsyn
from stitchingvideo_tpu_torch import StitchConfig
from stitchingvideo_tpu_torch.ops import color, features, filters
from stitchingvideo_tpu_torch.register import pipeline


def _gray_views(n=2, wh=(320, 240), seed=3, jitter=False):
    """Gray views of a synthetic scene as the batched path makes them
    (host rounding to integers); `jitter` adds sub-level noise, so that the
    filters see non-integer input."""
    views = jsyn.make_scene(n=n, img_wh=wh, seed=seed, overlap_frac=0.45)[0]
    a = np.stack(views).astype(np.float32)
    g = np.clip(np.round(a[..., 0] * 0.299 + a[..., 1] * 0.587
                         + a[..., 2] * 0.114), 0, 255).astype(np.float32)
    if jitter:
        g = g + np.random.default_rng(0).uniform(-0.5, 0.5, g.shape) \
            .astype(np.float32)
    return g


def test_constants_are_the_references():
    np.testing.assert_array_equal(features._FAST_OFFSETS, jfeat._FAST_OFFSETS)
    np.testing.assert_array_equal(features._ARC9_RUNS, jfeat._ARC9_RUNS)
    np.testing.assert_array_equal(features.brief_pattern(),
                                  jfeat.brief_pattern())
    np.testing.assert_array_equal(features._PATTERN, jfeat._PATTERN)
    for a, b in zip(features._grad_pattern(), jfeat._grad_pattern()):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(features._WX, jfeat._WX)
    np.testing.assert_array_equal(features._WY, jfeat._WY)
    np.testing.assert_array_equal(filters.gaussian_kernel(7, 2.0),
                                  jfilt.gaussian_kernel(7, 2.0))
    np.testing.assert_array_equal(filters.gaussian_kernel(5, -1),
                                  jfilt.gaussian_kernel(5, -1))


def test_color_matches():
    img = np.random.default_rng(0).integers(0, 256, (37, 45, 3)) \
        .astype(np.uint8)
    for jf, pf in ((jcolor.rgb_to_gray, color.rgb_to_gray),
                   (jcolor.bgr_to_gray, color.bgr_to_gray)):
        np.testing.assert_array_equal(pf(torch.from_numpy(img)).numpy(),
                                      np.asarray(jf(jnp.asarray(img))))


K5 = np.array([1, 2, 3, 2, 1.0]) / 9
K5B = np.array([1, 4, 6, 4, 1.0]) / 16
FILTERS = {
    "gaussian": lambda m, x: m.gaussian_blur(x),
    "sobel_x": lambda m, x: m.sobel(x, 1, 0),
    "sobel_y": lambda m, x: m.sobel(x, 0, 1),
    "box": lambda m, x: m.box_filter(x, 5),
    "box_sum": lambda m, x: m.box_filter(x, 3, normalize=False),
    "reflect_3ch": lambda m, x: m.sep_filter2d(
        m_stack(m, x), K5, K5B, "reflect"),
    "edge": lambda m, x: m.sep_filter2d(x, np.ones(3) / 3, np.ones(7) / 7,
                                        "edge"),
    "constant": lambda m, x: m.sep_filter2d(x, np.ones(3) / 3,
                                            np.ones(7) / 7, "constant"),
}


def m_stack(m, x):
    lib = jnp if m is jfilt else torch
    return lib.stack([x, x * 2, -x], -1)


@pytest.mark.parametrize("name", FILTERS)
def test_filter_matches(name):
    x = np.random.default_rng(1).normal(size=(37, 45)).astype(np.float32)
    want = np.asarray(FILTERS[name](jfilt, jnp.asarray(x)))
    got = FILTERS[name](filters, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-6 * float(np.abs(want).max()))


def test_morphology_matches():
    """dilate and erode: float, bool and uint8 [H, W, C] masks, equal."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(37, 45)).astype(np.float32)
    m = rng.random((20, 30)) > 0.8
    m3 = (rng.random((20, 30, 2)) * 255).astype(np.uint8)
    for a in (x, m, m3):
        for jf, pf in ((lambda t: jfilt.dilate(t, 5, 2),
                        lambda t: filters.dilate(t, 5, 2)),
                       (lambda t: jfilt.dilate(t, 3),
                        lambda t: filters.dilate(t, 3)),
                       (lambda t: jfilt.erode(t, 3),
                        lambda t: filters.erode(t, 3))):
            want = np.asarray(jf(jnp.asarray(a)))
            got = pf(torch.from_numpy(a)).numpy()
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("jitter", [False, True])
def test_fast_and_harris_are_exact(jitter):
    g = _gray_views(jitter=jitter)
    want = np.asarray(jax.jit(jax.vmap(
        lambda x: jfeat.fast_score_map(x, 20.0)))(jnp.asarray(g)))
    got = features.fast_score_map(torch.from_numpy(g), 20.0).numpy()
    np.testing.assert_array_equal(got > 0, want > 0)      # the corner mask
    np.testing.assert_array_equal(got, want)
    want = np.asarray(jax.jit(jfeat.harris_score_map)(jnp.asarray(g[0])))
    np.testing.assert_array_equal(
        features.harris_score_map(torch.from_numpy(g[0])).numpy(), want)


KINDS = {"orb": ("fast", "brief", 20.0), "harris_brief": ("harris", "brief", 1.0),
         "grad": ("harris", "grad", 1.0)}


@pytest.mark.parametrize("kind", KINDS)
def test_detect_and_describe_matches(kind):
    """The batched detector over a 2-camera stack with a bucket extent:
    keypoint slots, validity and responses equal; binary descriptors equal;
    orientations within 1e-6, float descriptors within 1e-6."""
    det, desc_kind, thr = KINDS[kind]
    g = _gray_views(wh=(300, 230))
    gp = np.stack([jpipe._pad_to_bucket(x) for x in g])
    assert gp.shape[1:] == (256, 320)
    run = jax.jit(jax.vmap(lambda x: jfeat.detect_and_describe(
        x, thr, 256, 24, (3, 1), det, desc_kind,
        extent=jnp.asarray([230, 300]))))
    want = {k: np.asarray(v) for k, v in run(jnp.asarray(gp)).items()}
    got = {k: v.numpy() for k, v in features.detect_and_describe(
        torch.from_numpy(gp), thr, 256, 24, (3, 1), det, desc_kind,
        extent=(230, 300)).items()}
    assert want["valid"].sum() > 200
    for k in ("xy", "valid", "response"):
        np.testing.assert_array_equal(got[k], want[k])
    np.testing.assert_allclose(got["angle"], want["angle"], rtol=0, atol=1e-6)
    if desc_kind == "grad":
        assert got["desc"].dtype == np.float32
        np.testing.assert_allclose(got["desc"], want["desc"], rtol=0,
                                   atol=1e-6)
    else:
        np.testing.assert_array_equal(got["desc"], want["desc"])
    # keypoints stay inside the true extent minus the border
    xy = got["xy"][got["valid"]]
    assert xy[:, 0].max() < 300 - 24 and xy[:, 1].max() < 230 - 24


def test_pyramid_matches():
    g = _gray_views(n=1)[0]
    want = {k: np.asarray(v) for k, v in jfeat.detect_and_describe_pyramid(
        jnp.asarray(g), 20.0, 300, 24, (3, 1), 3, 1.5).items()}
    got = {k: v.numpy() for k, v in features.detect_and_describe_pyramid(
        torch.from_numpy(g), 20.0, 300, 24, (3, 1), 3, 1.5).items()}
    assert got["xy"].shape == (300, 2) and got["desc"].shape == (300, 256)
    same = (got["xy"] == want["xy"]).all(-1) & (got["valid"] == want["valid"])
    assert same.mean() >= 0.99, same.mean()
    shared = same & want["valid"]
    assert (got["desc"][shared] == want["desc"][shared]).mean() >= 0.999
    # the level images: the same antialiased linear resize
    want = np.asarray(jax.image.resize(jnp.asarray(g), (160, 213), "linear"))
    got = features.resize_linear(torch.from_numpy(g), (160, 213)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def _cfg(cls, **feat):
    cfg = cls()
    return cfg.replace(features=dataclasses.replace(
        cfg.features, max_keypoints=256, **feat))


@pytest.mark.parametrize("path", ["batched", "gray", "per_image", "pyramid"])
def test_compute_features_matches(path):
    """compute_features on images of no multiple of 32 (bucket padding and
    the extent mask): the batched pass over a same-size rig (RGB, and gray
    [H, W] images), the per-image path of a mixed-size rig, and the pyramid
    (num_levels 3, per image, unpadded)."""
    views = jsyn.make_scene(n=2, img_wh=(300, 230), seed=5,
                            overlap_frac=0.45)[0]
    feat = {}
    if path == "per_image":
        views = [views[0], views[1][:200, :290]]
    elif path == "gray":
        views = [v[..., 1].copy() for v in views]
    elif path == "pyramid":
        feat = dict(num_levels=3)
    want = jpipe.compute_features(views, _cfg(JStitchConfig, **feat))
    got = pipeline.compute_features(views, _cfg(StitchConfig, **feat),
                                    device="cpu")
    for w, g in zip(want, got):
        assert g["img_wh"] == w["img_wh"]
        assert ("_dev" in g) == (path in ("batched", "gray"))
        gd, wd = np.asarray(jpipe_desc(g)), np.asarray(jpipe_desc(w))
        if path == "pyramid":       # the pyramid's stated tolerance
            same = (g["xy"] == np.asarray(w["xy"])).all(-1)
            assert same.mean() >= 0.99
            assert (gd[same] == wd[same]).mean() >= 0.999
            continue
        for k in ("xy", "valid", "response"):
            np.testing.assert_array_equal(g[k], np.asarray(w[k]))
        # per image the gray is not rounded to integers, so the centroid
        # sums round in each package's order: angles within 1e-4
        np.testing.assert_allclose(g["angle"], np.asarray(w["angle"]),
                                   rtol=0, atol=1e-4 if path == "per_image"
                                   else 1e-6)
        np.testing.assert_array_equal(gd, wd)


def jpipe_desc(f):
    """A feature dict's descriptors (its batch row after a batched pass),
    in either package."""
    if "desc" in f:
        return f["desc"]
    bd, i = f["_dev"]
    return bd["desc"][i]


def test_compute_features_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.compute_features([np.zeros((64, 64, 3), np.uint8)] * 2,
                                  StitchConfig())
