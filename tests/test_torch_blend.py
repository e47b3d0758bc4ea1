"""The port's pyramids and blenders against the JAX package's, on the CPU
(`stitchingvideo_tpu_torch/ops/pyramid.py`, `ops/pyramid_int.py`,
`blend/feather.py`, `blend/multiband.py`, `blend/multiband_cv.py`).

Stated tolerances:
  - the CV_16S pyramids, the Laplacian build and collapse, and
    `MultiBandBlenderCV` (the port's one `feed_dev` against the JAX
    package's blender fed through its `feed` and its `feed_dev`): bit for bit,
    against the JAX package and against cv2 (`pyrDown`/`pyrUp` on odd and
    even shapes with negative values, `detail_MultiBandBlender`);
  - the float pyramids (depthwise convolutions, summed in another order
    than XLA's): within 1e-4 on 0..255 data (measured 4.6e-5);
  - feather weights: equal; feather blend and multiband_blend with bands > 0
    (float32 sums in camera order, XLA's in its own): within 1e-4 (measured
    3.1e-5 and 6.1e-5), masks equal; multiband_blend with bands = 0: equal.
"""
import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stitchingvideo_tpu.blend import feather as jfeather
from stitchingvideo_tpu.blend import multiband as jmultiband
from stitchingvideo_tpu.blend.multiband_cv import \
    MultiBandBlenderCV as JMultiBandBlenderCV
from stitchingvideo_tpu.ops import pyramid as jpyr
from stitchingvideo_tpu.ops import pyramid_int as jpi
from stitchingvideo_tpu_torch.blend import feather, multiband
from stitchingvideo_tpu_torch.blend.multiband_cv import MultiBandBlenderCV
from stitchingvideo_tpu_torch.ops import pyramid, pyramid_int

FLOAT_TOL = 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# the JAX package's functions as one program each (its tests run them
# jitted inside the blender; eager, every primitive compiles on its own)
J_DOWN, J_UP = jax.jit(jpi.pyr_down_i16), jax.jit(jpi.pyr_up_i16)


@pytest.mark.parametrize("shape", [(64, 96), (254, 66), (63, 95), (33, 17),
                                   (7, 9), (1, 5), (31, 45, 3)])
def test_pyramid_int_bit_exact(shape):
    """pyr_down_i16 / pyr_up_i16 against the JAX package and cv2 on
    int16 data with negative values, odd and even sizes."""
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-3000, 3000, shape).astype(np.int16)
    down = pyramid_int.pyr_down_i16(_t(x)).numpy()
    up = pyramid_int.pyr_up_i16(_t(x)).numpy()
    assert down.dtype == up.dtype == np.int32
    np.testing.assert_array_equal(down, np.asarray(J_DOWN(jnp.asarray(x))))
    np.testing.assert_array_equal(up, np.asarray(J_UP(jnp.asarray(x))))
    np.testing.assert_array_equal(down, cv2.pyrDown(x).astype(np.int32))
    np.testing.assert_array_equal(up, cv2.pyrUp(x).astype(np.int32))


def test_laplace_pyr_i16_bit_exact():
    rng = np.random.default_rng(1)
    x = rng.integers(-300, 300, (96, 128, 3)).astype(np.int16)
    w = rng.integers(0, 257, (96, 128)).astype(np.int16)
    got = pyramid_int.create_laplace_pyr_i16(_t(x), 4)
    want, restored, wpyr = jax.jit(lambda a, b: (
        jpi.create_laplace_pyr_i16(a, 4),
        jpi.restore_laplace_i16(jpi.create_laplace_pyr_i16(a, 4)),
        jpi.weight_pyr_i16(b, 4)))(jnp.asarray(x), jnp.asarray(w))
    assert len(got) == len(want) == 5
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    np.testing.assert_array_equal(
        pyramid_int.restore_laplace_i16(got).numpy(), np.asarray(restored))
    np.testing.assert_array_equal(pyramid_int.restore_laplace_i16(got)
                                  .numpy(), x)
    for g, j in zip(pyramid_int.weight_pyr_i16(_t(w), 4), wpyr):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


@pytest.mark.parametrize("fn", ["pyr_down", "pyr_up", "laplacian"])
@pytest.mark.parametrize("channels", [0, 3])
def test_float_pyramid_matches(fn, channels):
    rng = np.random.default_rng(2)
    shape = (64, 96) + ((channels,) if channels else ())
    x = rng.uniform(0, 255, shape).astype(np.float32)
    if fn == "laplacian":
        got = pyramid.laplacian_pyramid(_t(x), 3)
        got += [pyramid.collapse_laplacian(got),
                pyramid.gaussian_pyramid(_t(x), 3)[-1]]
        want = jax.jit(lambda a: jpyr.laplacian_pyramid(a, 3) + [
            jpyr.collapse_laplacian(jpyr.laplacian_pyramid(a, 3)),
            jpyr.gaussian_pyramid(a, 3)[-1]])(jnp.asarray(x))
    else:
        got = [getattr(pyramid, fn)(_t(x))]
        want = [jax.jit(getattr(jpyr, fn))(jnp.asarray(x))]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=FLOAT_TOL)


def _canvas(seed, n=3, h=64, w=80):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 255, (n, h, w, 3)).astype(np.float32)
    masks = np.zeros((n, h, w), bool)
    for i in range(n):                  # overlapping vertical strips
        masks[i, 4:h - 4, i * w // (n + 1):(i + 2) * w // (n + 1) + 6] = True
    masks[1, 20:30, 10:20] = True       # a detached patch
    return imgs, masks


def test_feather_matches():
    imgs, masks = _canvas(3)
    for sharpness in (0.02, 0.3):
        w = feather.feather_weights(_t(masks), sharpness)
        jw = jfeather.feather_weights(jnp.asarray(masks), sharpness)
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    pano, mask = feather.feather_blend(_t(imgs), w)
    jpano, jmask = jfeather.feather_blend(jnp.asarray(imgs), jw)
    np.testing.assert_allclose(pano.numpy(), np.asarray(jpano), rtol=0,
                               atol=FLOAT_TOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    assert mask.numpy().mean() > 0.5


@pytest.mark.parametrize("bands", [0, 3])
def test_multiband_blend_matches(bands):
    imgs, masks = _canvas(4)
    pano, mask = multiband.multiband_blend(_t(imgs), _t(masks), bands)
    jpano, jmask = jmultiband.multiband_blend(jnp.asarray(imgs),
                                              jnp.asarray(masks), bands)
    assert pano.shape == (64, 80, 3) and pano.dtype == torch.float32
    if bands == 0:
        np.testing.assert_array_equal(pano.numpy(), np.asarray(jpano))
    np.testing.assert_allclose(pano.numpy(), np.asarray(jpano), rtol=0,
                               atol=FLOAT_TOL)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))


def _blender_inputs():
    """tests/test_parity_cv.py's two-image case: corners above and left of
    the origin and a mask of partial weights."""
    rng = np.random.default_rng(5)
    H, W = 200, 300
    img1 = cv2.GaussianBlur(rng.integers(0, 256, (H, W, 3)).astype(np.uint8),
                            (7, 7), 2)
    img2 = cv2.GaussianBlur(rng.integers(0, 256, (H, W, 3)).astype(np.uint8),
                            (7, 7), 2)
    m1 = np.zeros((H, W), np.uint8)
    m1[10:190, 5:200] = 255
    m2 = np.zeros((H, W), np.uint8)
    m2[20:180, 150:295] = 255
    m2[100:110, 150:160] = 97
    corners = [(-7, 3), (123, -11)]
    roi = cv2.detail.resultRoi(corners=corners, sizes=[(W, H), (W, H)])
    return [(img1.astype(np.int16), m1, corners[0]),
            (img2.astype(np.int16), m2, corners[1])], roi


@pytest.mark.parametrize("feed", ["feed", "feed_dev"])
def test_multiband_blender_cv_bit_exact(feed):
    """The port's feed_dev against the JAX package's blender fed through
    `feed` (host arrays) and `feed_dev` (device arrays), and cv2's."""
    inputs, roi = _blender_inputs()
    mb = MultiBandBlenderCV(5, device="cpu")
    jmb = JMultiBandBlenderCV(5)
    cvb = cv2.detail_MultiBandBlender(0, 5, cv2.CV_16S)
    for b in (mb, jmb, cvb):
        b.prepare(roi)
    assert (mb.num_bands, mb.roi) == (jmb.num_bands, jmb.roi)
    for img, m, tl in inputs:
        assert mb._sub_roi(tl, *img.shape[:2])[0] == \
            jmb._sub_roi(tl, *img.shape[:2])[0]
        np.testing.assert_array_equal(
            np.asarray(mb._sub_roi(tl, *img.shape[:2])[1]),
            jmb._sub_roi(tl, *img.shape[:2])[1])
        mb.feed_dev(_t(img), _t(m), tl)
        if feed == "feed":
            jmb.feed(img, m, tl)
        else:
            jmb.feed_dev(jnp.asarray(img), jnp.asarray(m), tl)
        cvb.feed(img, m, tl)
    for g, j in zip(mb.dst_laplace + mb.dst_weights,
                    jmb.dst_laplace + jmb.dst_weights):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))
    pano, mask = mb.blend()
    jpano, jmask = jmb.blend()
    res, res_mask = cvb.blend(None, None)
    assert pano.dtype == np.int32 and pano.shape == (roi[3], roi[2], 3)
    np.testing.assert_array_equal(pano, jpano)
    np.testing.assert_array_equal(mask, jmask)
    np.testing.assert_array_equal(pano, res.astype(np.int32))
    np.testing.assert_array_equal(mask, res_mask.astype(bool))


def test_blender_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MultiBandBlenderCV(5)
