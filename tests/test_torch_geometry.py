"""Port slice 4a against the JAX package on the CPU: rotations, the 15
projections, remap and the synthetic scene (`stitchingvideo_tpu_torch/
geometry/`, `ops/remap.py`, `utils/synthetic.py`).

Same inputs, made from a seed with numpy, through both packages. Stated
tolerances: the Rodrigues maps within 1e-6 (float32 round-off of the
norm, arccos and sin); camera maps and projections within 1e-6 of the
output's largest magnitude (XLA's and PyTorch's 3x3 products and
transcendental functions differ in the last bits; measured at most
3.5e-7);
remap exact (the port rounds the tap sum as XLA contracts it), except
the constant border's float fill term, within 1e-6 (one rounding), and the
rendered views within one uint8 step on at most 0.01% of values (the
projection's last bits move a texture coordinate across a rounding point).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from stitchingvideo_tpu.geometry import projections as jproj
from stitchingvideo_tpu.geometry import rotation as jrot
from stitchingvideo_tpu.ops import remap as jremap
from stitchingvideo_tpu.utils import synthetic as jsyn
from stitchingvideo_tpu_torch.geometry import projections as proj
from stitchingvideo_tpu_torch.geometry import rotation as rot
from stitchingvideo_tpu_torch.ops import remap as remap_mod
from stitchingvideo_tpu_torch.utils import synthetic as syn


def _rvecs():
    """Rotation vectors: generic, tiny, zero, and within 1e-3 of pi."""
    rng = np.random.default_rng(0)
    generic = rng.normal(0, 1.0, (16, 3))
    axes = rng.normal(size=(6, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    near_pi = axes * (math.pi - np.array([0, 1e-5, 1e-4, 3e-4, 6e-4, 9e-4]))[:, None]
    tiny = rng.normal(0, 1e-9, (3, 3))
    return np.concatenate([generic, near_pi, tiny, np.zeros((1, 3))]) \
        .astype(np.float32)


def test_rodrigues_to_matrix_matches():
    rv = _rvecs()
    want = np.asarray(jrot.rodrigues_to_matrix(jnp.asarray(rv)))
    got = rot.rodrigues_to_matrix(torch.from_numpy(rv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_matrix_to_rodrigues_matches():
    """Including the near-pi branch and the small-angle branch."""
    R = Rotation.from_rotvec(_rvecs().astype(np.float64)).as_matrix() \
        .astype(np.float32)
    want = np.asarray(jrot.matrix_to_rodrigues(jnp.asarray(R)))
    got = rot.matrix_to_rodrigues(torch.from_numpy(R)).numpy()
    # near pi the axis sign is set by the largest component: equal, not
    # just equivalent
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def _close(got: torch.Tensor, want, rel: float = 1e-6) -> None:
    """|got - want| <= rel * max |want| (float32 round-off, stated above)."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=rel * float(np.abs(want).max()))


def _camera():
    K = np.array([[800, 0, 640], [0, 820, 360], [0, 0, 1]], np.float32)
    R = Rotation.from_euler("yx", [-0.22, 0.1]).as_matrix().astype(np.float32)
    return K, R


def test_camera_maps_match():
    K, R = _camera()
    for a, b in zip(jproj.camera_maps(K, R),
                    proj.camera_maps(torch.from_numpy(K), torch.from_numpy(R))):
        _close(b, a)


@pytest.mark.parametrize("kind", proj.PROJECTION_KINDS)
def test_projection_matches(kind):
    """Forward and backward maps of each kind, batched over two cameras."""
    assert proj.PROJECTION_KINDS == jproj.PROJECTION_KINDS
    K, R = _camera()
    Ks = np.stack([K, K])
    Rs = np.stack([R, Rotation.from_euler("y", 0.5).as_matrix()
                   .astype(np.float32)])
    rng = np.random.default_rng(7)
    pts = rng.uniform([100, 100], [1180, 620], (2, 64, 2)).astype(np.float32)
    jr, jk = jproj.camera_maps(Ks, Rs)
    r_kinv, k_rinv = proj.camera_maps(torch.from_numpy(Ks),
                                      torch.from_numpy(Rs))
    want = jproj.map_forward(kind, 800.0, jr[:, None], pts[..., 0],
                             pts[..., 1])
    got = proj.map_forward(kind, 800.0, r_kinv[:, None],
                           torch.from_numpy(pts[..., 0]),
                           torch.from_numpy(pts[..., 1]))
    for a, b in zip(want, got):
        _close(b, a)
    u, v = (np.asarray(a) for a in want)
    want = jproj.map_backward(kind, 800.0, jk[:, None], u, v)
    got = proj.map_backward(kind, 800.0, k_rinv[:, None],
                            torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    for a, b in zip(want[:2], got[:2]):
        _close(b, a)
    assert proj.uv_range(kind) == jproj.uv_range(kind)


def test_plane_with_translation_matches():
    K, R = _camera()
    jr, jk = jproj.camera_maps(K, R)
    r_kinv, k_rinv = proj.camera_maps(torch.from_numpy(K), torch.from_numpy(R))
    t = (0.1, -0.2, 0.3)
    x = np.linspace(100, 1100, 32, dtype=np.float32)
    y = np.linspace(50, 650, 32, dtype=np.float32)
    want = jproj.map_forward("plane", 700.0, jr, x, y, t)
    got = proj.map_forward("plane", 700.0, r_kinv, torch.from_numpy(x),
                           torch.from_numpy(y), t)
    for a, b in zip(want, got):
        _close(b, a)
    u, v = (np.asarray(a) for a in want)
    want = jproj.map_backward("plane", 700.0, jk, u, v, t)
    got = proj.map_backward("plane", 700.0, k_rinv, torch.from_numpy(u),
                            torch.from_numpy(v), t)
    for a, b in zip(want, got):
        _close(b, a)


@pytest.mark.parametrize("border", ["constant", "replicate", "reflect",
                                    "reflect101", "wrap"])
@pytest.mark.parametrize("interp", ["nearest", "linear"])
def test_remap_matches(interp, border):
    """uint8 and float32 images, [H, W] and [H, W, C], maps reaching 5 px
    past every edge: equal."""
    rng = np.random.default_rng(3)
    xm = rng.uniform(-5, 55, (30, 31)).astype(np.float32)
    ym = rng.uniform(-5, 45, (30, 31)).astype(np.float32)
    for img in (rng.integers(0, 256, (40, 50, 3)).astype(np.uint8),
                rng.normal(size=(40, 50)).astype(np.float32),
                rng.normal(size=(40, 50, 3)).astype(np.float32)):
        want = np.asarray(jremap.remap(jnp.asarray(img), jnp.asarray(xm),
                                       jnp.asarray(ym), interp=interp,
                                       border=border, cval=7.0))
        got = remap_mod.remap(torch.from_numpy(img), torch.from_numpy(xm),
                              torch.from_numpy(ym), interp=interp,
                              border=border, cval=7.0).numpy()
        assert got.dtype == want.dtype
        if img.dtype == np.float32 and interp == "linear" \
                and border == "constant":
            # XLA contracts the fill term (1 - wsum) * cval + acc into an
            # FMA for some shapes and not for others: one rounding apart
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


def test_synthetic_scene_matches():
    """The texture and the rig are the same arrays; the rendered views are
    within one step on at most 0.01% of values."""
    views, K, Rs, f, tex = jsyn.make_scene(n=3, img_wh=(320, 240), seed=3)
    pviews, pK, pRs, pf, ptex = syn.make_scene(n=3, img_wh=(320, 240),
                                               seed=3, device="cpu")
    np.testing.assert_array_equal(ptex, tex)
    np.testing.assert_array_equal(pK, K)
    np.testing.assert_array_equal(pRs, Rs)
    assert pf == f
    for a, b in zip(views, pviews):
        d = np.abs(a.astype(np.int16) - b)
        assert d.max() <= 1 and (d > 0).mean() <= 1e-4, ((d > 0).mean(),
                                                        d.max())
    jit = jsyn.yaw_cameras(5, 90.0, (1033, 581), 0.2, jitter=0.01, seed=4)
    pit = syn.yaw_cameras(5, 90.0, (1033, 581), 0.2, jitter=0.01, seed=4)
    for a, b in zip(jit, pit):
        np.testing.assert_array_equal(b, a)


def test_render_views_needs_cuda_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    K, Rs, _f = syn.yaw_cameras(2, img_wh=(64, 48))
    with pytest.raises(RuntimeError, match="CUDA"):
        syn.render_views(np.zeros((32, 64, 3), np.uint8), K, Rs, (64, 48))
