"""Port slice 4b against the JAX package on the CPU: matching, homography
and RANSAC (`stitchingvideo_tpu_torch/ops/{matching,homography,ransac}.py`).

Same inputs, made from a seed with numpy, through both packages. Given the
same descriptors, matching is exact: Hamming distances, the 2-NN search
(dense and chunked), and match_pair's src, dst, dist and valid. Given the
same points and the same uniforms, RANSAC draws the same samples. Stated
tolerances: L2 distances of the float descriptors within 1e-5 (products
summed in another order, then a square root; measured 1.9e-6), their
matches' src, dst and valid equal on this data;
homographies compared as H / H[2,2] within 1e-4 relative to their largest
entry (the 8x8 solves and the eigh differ in the last bits, and the
eigenvector's sign is free); transfer errors within 1e-5 relative; RANSAC
inlier sets equal except for points within 1e-3 px^2 of the threshold,
inlier counts within 2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stitchingvideo_tpu.ops import features as jfeat
from stitchingvideo_tpu.ops import homography as jhom
from stitchingvideo_tpu.ops import matching as jmatch
from stitchingvideo_tpu.ops import ransac as jransac
from stitchingvideo_tpu.utils import synthetic as jsyn
from stitchingvideo_tpu_torch.ops import homography as hom
from stitchingvideo_tpu_torch.ops import matching
from stitchingvideo_tpu_torch.ops import ransac


def _descriptors(kind="brief", n=2, kp=256):
    """Features of an overlapping synthetic pair from the JAX detector:
    (desc [n, K, D], valid [n, K], xy [n, K, 2]) as numpy."""
    views = jsyn.make_scene(n=n, img_wh=(320, 240), seed=3,
                            overlap_frac=0.45)[0]
    a = np.stack(views).astype(np.float32)
    g = np.clip(np.round(a[..., 0] * 0.299 + a[..., 1] * 0.587
                         + a[..., 2] * 0.114), 0, 255).astype(np.float32)
    det = "fast" if kind == "brief" else "harris"
    f = jax.jit(jax.vmap(lambda x: jfeat.detect_and_describe(
        x, 20.0 if det == "fast" else 1.0, kp, 24, (3, 1), det, kind)))(
        jnp.asarray(g))
    return tuple(np.array(f[k]) for k in ("desc", "valid", "xy"))


@pytest.fixture(scope="module")
def brief():
    return _descriptors("brief")


@pytest.fixture(scope="module")
def grad():
    return _descriptors("grad")


def _t(*a):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in a)


def test_hamming_matrix_is_exact(brief):
    d, v, _ = brief
    v = v.copy()
    v[0, ::7] = False                       # invalid rows and columns
    want = np.asarray(jmatch.hamming_matrix(*(jnp.asarray(x) for x in
                                              (d[0], d[1], v[0], v[1]))))
    got = matching.hamming_matrix(*_t(d[0], d[1], v[0], v[1])).numpy()
    np.testing.assert_array_equal(got, want)


def test_l2_matrix_matches(grad):
    d, v, _ = grad
    want = np.asarray(jmatch.l2_matrix(*(jnp.asarray(x) for x in
                                         (d[0], d[1], v[0], v[1]))))
    got = matching.l2_matrix(*_t(d[0], d[1], v[0], v[1])).numpy()
    ok = want < 1e8
    np.testing.assert_array_equal(got >= 1e8, ~ok)
    np.testing.assert_allclose(got[ok], want[ok], rtol=0, atol=1e-5)


def test_two_nn_dense_and_chunked_are_the_references(brief):
    """Chunks of 64 columns (ties at chunk edges included): the port's
    dense and chunked searches equal the JAX package's; the two agree on
    every distance below the invalid-entry penalty and its neighbour
    (above the penalty both only say "no match")."""
    d, v, _ = brief
    v = v.copy()
    v[1, ::5] = False
    J = [jnp.asarray(x) for x in (d[0], v[0], d[1], v[1])]
    dense = [x.numpy() for x in matching._two_nn(matching.hamming_matrix(
        *_t(d[0], d[1], v[0], v[1])))]
    jdense = [np.asarray(x) for x in jmatch._two_nn(
        jmatch.hamming_matrix(J[0], J[2], J[1], J[3]))]
    chunked = [x.numpy() for x in matching._two_nn_chunked(
        *_t(d[0], v[0], d[1], v[1]), chunk=64)]
    jchunked = [np.asarray(x) for x in jmatch._two_nn_chunked(*J, chunk=64)]
    for a, b in zip(dense, jdense):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(chunked, jchunked):
        np.testing.assert_array_equal(a, b)
    real = dense[0] < 1e9
    assert real.sum() > 100
    np.testing.assert_array_equal(chunked[0][real], dense[0][real])
    np.testing.assert_array_equal(chunked[2][real], dense[2][real])
    real = dense[1] < 1e9
    np.testing.assert_array_equal(chunked[1][real], dense[1][real])


@pytest.mark.parametrize("kind", ["brief", "grad"])
def test_match_pair_is_exact(kind, brief, grad):
    """src, dst, dist and valid equal; the pair axis batches (pairs (0,1)
    and (1,0) in one call give each pair's own result)."""
    d, v, _ = brief if kind == "brief" else grad
    for mm in (128, 32):
        want = [np.asarray(x) for x in jmatch.match_pair(
            *(jnp.asarray(x) for x in (d[0], v[0], d[1], v[1])),
            0.3, mm)]
        got = matching.match_pair(*_t(d[0], v[0], d[1], v[1]), 0.3, mm)
        assert want[3].sum() > 10
        for a, w in zip(got, want):
            if kind == "grad" and a.dtype == torch.float32:
                np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=1e-5)
            else:
                np.testing.assert_array_equal(a.numpy(), w)
        batch = matching.match_pair(*_t(d, v, d[::-1], v[::-1]), 0.3, mm)
        for a, b in zip(got, batch):
            assert torch.equal(b[0], a)


def test_match_pair_chunked_path_is_the_dense_one(brief, monkeypatch):
    """Above CHUNKED_ABOVE the search streams chunks: the same result."""
    d, v, _ = brief
    want = [np.asarray(x) for x in jmatch.match_pair(
        *(jnp.asarray(x) for x in (d[0], v[0], d[1], v[1])), 0.3, 128)]
    monkeypatch.setattr(matching, "CHUNKED_ABOVE", 64 * 64)
    monkeypatch.setattr(matching, "NN_CHUNK", 48)
    got = matching.match_pair(*_t(d[0], v[0], d[1], v[1]), 0.3, 128)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), w)
    r = matching._rank(*(torch.from_numpy(x) for x in (
        np.where(want[3], want[2], np.inf).astype(np.float32), want[3])),
        chunk=40)
    np.testing.assert_array_equal(r.numpy()[want[3]],
                                  np.arange(int(want[3].sum())))


def test_match_pair_refuses_past_the_envelope():
    d = torch.zeros((matching.MAX_KEYPOINTS + 1, 8), dtype=torch.uint8)
    v = torch.zeros(d.shape[0], dtype=torch.bool)
    with pytest.raises(ValueError, match="MAX_KEYPOINTS"):
        matching.match_pair(d, v, d[:4], v[:4])


def _rel(H):
    H = np.asarray(H, np.float64)
    return H / H[..., 2:3, 2:3]


def _assert_h_close(got, want, tol=1e-4):
    g, w = _rel(got), _rel(want)
    scale = np.abs(w).max(axis=(-1, -2), keepdims=True)
    assert (np.abs(g - w) / scale).max() <= tol, (np.abs(g - w) / scale).max()


def _points(seed=0, m=64, outliers=0.3):
    """Correspondences of a known homography with noise and outliers."""
    rng = np.random.default_rng(seed)
    H = np.array([[0.9, 0.05, 40.0], [-0.03, 1.1, -12.0], [1e-4, -2e-4, 1.0]])
    p1 = rng.uniform(-150, 150, (m, 2))
    q = np.concatenate([p1, np.ones((m, 1))], 1) @ H.T
    p2 = q[:, :2] / q[:, 2:3] + rng.normal(0, 0.5, (m, 2))
    bad = rng.random(m) < outliers
    p2[bad] = rng.uniform(-150, 150, (int(bad.sum()), 2))
    valid = np.ones(m, bool)
    valid[-5:] = False
    return p1.astype(np.float32), p2.astype(np.float32), valid


def test_homography_solvers_match():
    p1, p2, valid = _points(outliers=0.0)
    w = valid.astype(np.float32)
    J = [jnp.asarray(x) for x in (p1, p2, w)]
    T = _t(p1, p2, w)
    _assert_h_close(hom.dlt_homography(*T).numpy(),
                    jhom.dlt_homography(*J))
    _assert_h_close(hom.weighted_refit_8pt(*T).numpy(),
                    jhom.weighted_refit_8pt(*J))
    # batched 4-point solves, degenerate (repeated-point) samples included
    rng = np.random.default_rng(1)
    idx = np.stack([rng.choice(59, 4, replace=False) for _ in range(40)])
    idx[:3, 1] = idx[:3, 0]               # degenerate: a repeated point
    want = np.asarray(jax.vmap(jhom.perspective_4pt)(jnp.asarray(p1[idx]),
                                                     jnp.asarray(p2[idx])))
    got = hom.perspective_4pt(*_t(p1[idx], p2[idx])).numpy()
    assert got.shape == (40, 3, 3)        # the degenerate ones do not raise
    _assert_h_close(got[3:], want[3:])
    H = jhom.dlt_homography(*J)
    np.testing.assert_allclose(
        hom.transfer_error2(torch.from_numpy(np.asarray(H)), *_t(p1, p2))
        .numpy(), np.asarray(jhom.transfer_error2(H, J[0], J[1])),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ransac_with_the_same_draws_matches(seed):
    """The JAX package's draws, handed to the port: the same hypotheses."""
    p1, p2, valid = _points(seed)
    key = jax.random.PRNGKey(seed)
    want = jransac.ransac_homography(key, jnp.asarray(p1), jnp.asarray(p2),
                                     jnp.asarray(valid), 3.0, 64)
    u = np.asarray(jax.random.uniform(key, (64, 4)))
    got = ransac.ransac_homography(*_t(u, p1, p2, valid), 3.0)
    assert bool(got["ok"]) == bool(want["ok"]) is True
    _assert_h_close(got["H"].numpy(), want["H"])
    inl, winl = got["inliers"].numpy(), np.asarray(want["inliers"])
    err = np.asarray(jhom.transfer_error2(want["H"], jnp.asarray(p1),
                                          jnp.asarray(p2)))
    assert np.all((inl == winl) | (np.abs(err - 9.0) < 1e-3))
    assert abs(int(got["num_inliers"]) - int(want["num_inliers"])) <= 2
    # batched over pairs: each pair's own result
    b = ransac.ransac_homography(*_t(np.stack([u, u[::-1]]),
                                     np.stack([p1, p1]), np.stack([p2, p2]),
                                     np.stack([valid, valid])), 3.0)
    assert torch.equal(b["inliers"][0], got["inliers"])
    _assert_h_close(b["H"][0].numpy(), got["H"].numpy(), tol=1e-6)


def test_ransac_uniforms_come_from_the_cpu_generator():
    u = ransac.ransac_uniforms(5, 3, 64, "cpu")
    assert u.shape == (3, 64, 4) and u.dtype == torch.float32
    gen = torch.Generator().manual_seed(5)
    assert torch.equal(u, torch.rand((3, 64, 4), generator=gen))
    assert not torch.equal(u, ransac.ransac_uniforms(6, 3, 64, "cpu"))

