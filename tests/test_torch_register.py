"""Port slice 4c against the JAX package on the CPU: the match graph,
autocalibration, rotations, bundle adjustment, wave correction, and the
whole slice `register_images` (`stitchingvideo_tpu_torch/register/`,
`geometry/autocalib.py`).

Same inputs, made from a seed with numpy, through both packages. The
numpy modules (graph, autocalib, estimator, wave) are copies: equal.
Stated tolerances: bundle adjustment from identical inputs, focals within
1e-4 relative and rotations within 1e-3 (largest entry of R - R'); with
a free principal point, which trades off against the rotations, the
edges' homographies K_j R_j R_i^T K_i^-1 within 1e-4 of their largest
entry and the principal point within 0.01 px; frozen parameters exactly
frozen; the whole slice on a
3-camera scene, with the JAX package's RANSAC draws handed to the port:
the same kept cameras, focals within 1e-3 relative, relative rotations
within 0.05 degrees, per-pair inlier counts within 2, match counts equal.

Run as a script, the module prints the JAX package's own result on
chip_smoke.py's registration scene (the reference the card's gates are
held to), on the CPU:

    JAX_PLATFORMS=cpu python -m tests.test_torch_register [--seed 0]
"""
import argparse
import dataclasses
import json
import math
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from stitchingvideo_tpu.config import StitchConfig as JStitchConfig
from stitchingvideo_tpu.geometry import autocalib as jcalib
from stitchingvideo_tpu.register import bundle as jbundle
from stitchingvideo_tpu.register import estimator as jest
from stitchingvideo_tpu.register import graph as jgraph
from stitchingvideo_tpu.register import pipeline as jpipe
from stitchingvideo_tpu.register import wave as jwave
from stitchingvideo_tpu.utils import synthetic as jsyn
from stitchingvideo_tpu_torch import StitchConfig, register_images
from stitchingvideo_tpu_torch.geometry import autocalib
from stitchingvideo_tpu_torch.register import bundle, estimator, graph
from stitchingvideo_tpu_torch.register import pipeline, wave
from tests.test_register import _ba_synthetic_scene


def _random_graph(seed, n=7):
    rng = np.random.default_rng(seed)
    pairs = [(i, j) for i in range(n) for j in range(i + 1, n)
             if rng.random() < 0.5]
    return {p: float(rng.integers(0, 40)) / 10 for p in pairs}


@pytest.mark.parametrize("seed", range(4))
def test_graph_is_the_references(seed):
    conf = _random_graph(seed)
    assert graph.biggest_component(7, conf, 1.0) == \
        jgraph.biggest_component(7, conf, 1.0)
    tree, center = graph.max_spanning_tree(7, conf)
    assert (tree, center) == jgraph.max_spanning_tree(7, conf)
    assert graph.bfs_order(7, tree, center) == \
        jgraph.bfs_order(7, tree, center)
    names = [f"img{i}.jpg" for i in range(7)]
    stats = {p: (20, int(c * 5), c) for p, c in conf.items()}
    assert graph.matches_graph_dot(names, stats, 1.0) == \
        jgraph.matches_graph_dot(names, stats, 1.0)


def _homographies(seed=0, n=5):
    rng = np.random.default_rng(seed)
    K = np.array([[800.0, 2.0, 320.0], [0, 790.0, 240.0], [0, 0, 1.0]])
    Kc = np.diag([700.0, 700.0, 1.0])
    Hs, Hc = [], []
    for _ in range(n):
        R = Rotation.from_euler("xyz", rng.uniform(-0.3, 0.3, 3)).as_matrix()
        Hs.append(K @ R @ np.linalg.inv(K))
        Hc.append(Kc @ R @ np.linalg.inv(Kc))
    return Hs, Hc


def test_autocalib_is_the_references():
    Hs, Hc = _homographies()
    for H in Hs + Hc + [np.eye(3)]:
        assert autocalib.focals_from_homography(H) == \
            jcalib.focals_from_homography(H)
    pairs = [(0, 1, H, 30) for H in Hc] + [(1, 2, None, 0)]
    sizes = [(640, 480)] * 3
    assert autocalib.estimate_focal(sizes, pairs) == \
        jcalib.estimate_focal(sizes, pairs)
    assert autocalib.estimate_focal(sizes, []) == \
        jcalib.estimate_focal(sizes, [])
    np.testing.assert_array_equal(autocalib.calibrate_rotating_camera(Hs),
                                  jcalib.calibrate_rotating_camera(Hs))
    assert autocalib.calibrate_rotating_camera([]) is None


def test_estimator_and_wave_are_the_references():
    f = 500.0
    K = np.diag([f, f, 1.0])
    yaws = np.radians([-30.0, 0.0, 25.0, 55.0])
    Rs = [Rotation.from_euler("yx", [y, 0.02 * k]).as_matrix()
          for k, y in enumerate(yaws)]
    info = {}
    for i, j in ((0, 1), (1, 2), (2, 3), (0, 2)):
        H = K @ Rs[j].T @ Rs[i] @ np.linalg.inv(K)
        info[(i, j)] = (H / H[2, 2], 40 - i - j)
    sizes = [(640, 480)] * 4
    for a, b in zip(estimator.estimate_rotations(sizes, info),
                    jest.estimate_rotations(sizes, info)):
        np.testing.assert_array_equal(a, b)
    R = np.stack(Rs).astype(np.float32)
    for kind in ("horiz", "vert"):
        np.testing.assert_array_equal(wave.wave_correct(R, kind),
                                      jwave.wave_correct(R, kind))


BA_CASES = {
    "ray": ("ray", {}),
    "reproj_focal": ("reproj", dict(refine_focal=True)),
    "reproj_ppx": ("reproj", dict(refine_focal=True, refine_ppx=True)),
    "reproj_all": ("reproj", dict(refine_focal=True, refine_ppx=True,
                                  refine_ppy=True, refine_aspect=True)),
}


@pytest.mark.parametrize("case", BA_CASES)
def test_bundle_adjust_matches(case):
    """`_ba_synthetic_scene` from identical inputs. The ray model takes the
    scene without principal-point offset or aspect (its own model) and the
    rotations as ray rotations (R^T of the reprojection model's)."""
    kind, flags = BA_CASES[case]
    if kind == "ray":
        Rs, ei, ej, p1, p2, w = _ba_synthetic_scene(ppx=0.0, ppy=0.0,
                                                    aspect=1.0)
        Rs = Rs.transpose(0, 2, 1)
    else:
        Rs, ei, ej, p1, p2, w = _ba_synthetic_scene()
    f0 = np.full(3, 480.0, np.float32)
    R0 = np.ascontiguousarray(Rs.astype(np.float32))
    want = [np.asarray(x) for x in jbundle.bundle_adjust(
        *(jnp.asarray(x) for x in (f0, R0, ei, ej, p1, p2, w)),
        kind=kind, iters=30, **flags)]
    got = [x.numpy() for x in bundle.bundle_adjust(
        *(torch.from_numpy(x) for x in (f0, R0, ei.astype(np.int64),
                                        ej.astype(np.int64), p1, p2, w)),
        kind=kind, iters=30, **flags)]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    free = [flags.get("refine_ppx", False), flags.get("refine_ppy", False)]
    if any(free):
        # a free principal point trades off against the rotations (the
        # gauge ambiguity the reference's LM shares): hold the edges'
        # homographies, which the data fixes
        for e in range(len(ei)):
            Hg, Hw = (_edge_h(r, ei[e], ej[e]) for r in (got, want))
            assert np.abs(Hg - Hw).max() <= 1e-4 * np.abs(Hw).max()
    else:
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-3)
    for c in range(2):
        if free[c]:
            np.testing.assert_allclose(got[2][:, c], want[2][:, c], rtol=0,
                                       atol=0.01)
        else:
            assert np.all(got[2][:, c] == 0.0) and np.all(want[2][:, c] == 0)
    if flags.get("refine_aspect", False):
        np.testing.assert_allclose(got[2][:, 2], want[2][:, 2], rtol=1e-4)
    else:
        assert np.all(got[2][:, 2] == 1.0)
    assert float(got[3]) <= max(2.0 * float(want[3]), 1e-3)


def _edge_h(result, i, j):
    """K_j R_j R_i^T K_i^-1 of a bundle result, divided by its [2,2]."""
    f, R, ppa = (np.asarray(x, np.float64) for x in result[:3])

    def K(k):
        return np.array([[f[k], 0, ppa[k, 0]],
                         [0, f[k] * ppa[k, 2], ppa[k, 1]], [0, 0, 1]])

    H = K(j) @ R[j] @ R[i].T @ np.linalg.inv(K(i))
    return H / H[2, 2]


def _slice_cfg(cls):
    cfg = cls()
    return cfg.replace(
        features=dataclasses.replace(cfg.features, max_keypoints=256),
        match=dataclasses.replace(cfg.match, max_matches=128,
                                  ransac_iters=64),
        register=dataclasses.replace(cfg.register, ba_iters=10))


def _jax_draws(monkeypatch, seed, iters, running):
    """Hand the port the JAX package's RANSAC uniforms: per pair from
    split(PRNGKey(seed), P) on the batched pass, or from the running split
    of the per-pair path, one draw per pair that reaches RANSAC."""
    def draws(s, n_pairs, it, device):
        assert (s, it) == (seed, iters)
        key = jax.random.PRNGKey(seed)
        if running:
            keys = []
            for _ in range(n_pairs):
                key, sub = jax.random.split(key)
                keys.append(sub)
        else:
            keys = jax.random.split(key, n_pairs)
        return torch.from_numpy(np.stack([
            np.asarray(jax.random.uniform(k, (it, 4))) for k in keys])) \
            .to(device)
    monkeypatch.setattr(pipeline, "ransac_uniforms", draws)


def _angle_deg(Ra, Rb) -> float:
    """Angle of Ra Rb^T, in float64."""
    d = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    s = np.linalg.norm(d - d.T) / (2 * math.sqrt(2))
    c = (np.trace(d) - 1) / 2
    return math.degrees(math.atan2(s, c))


def _scene(path):
    views = jsyn.make_scene(n=3, img_wh=(320, 240), fov_deg=55,
                            overlap_frac=0.4, seed=2)[0]
    if path == "per_pair":                  # mixed sizes: the per-pair path
        views = [views[0], views[1][:232, :310], views[2]]
    return views


@pytest.mark.parametrize("path", ["batched", "per_pair"])
def test_register_images_matches(path, monkeypatch):
    views = _scene(path)
    want = jpipe.register_images(views, _slice_cfg(JStitchConfig), seed=0)
    _jax_draws(monkeypatch, 0, 64, running=path == "per_pair")
    got = register_images(views, _slice_cfg(StitchConfig), seed=0,
                          device="cpu")
    assert isinstance(got, pipeline.RegistrationResult)
    assert got.indices == want.indices == [0, 1, 2]
    np.testing.assert_allclose(got.cameras.focal.numpy(),
                               np.asarray(want.cameras.focal), rtol=1e-3)
    assert got.warped_image_scale == pytest.approx(
        want.warped_image_scale, rel=1e-3)
    Rg, Rw = got.cameras.R.numpy(), np.asarray(want.cameras.R)
    for a in range(3):
        for b in range(a + 1, 3):
            assert _angle_deg(Rg[a] @ Rg[b].T, Rw[a] @ Rw[b].T) < 0.05
    for k in ("ppx", "ppy", "aspect"):
        np.testing.assert_allclose(getattr(got.cameras, k).numpy(),
                                   np.asarray(getattr(want.cameras, k)),
                                   rtol=1e-4, atol=0.01)
    assert got.pair_stats.keys() == want.pair_stats.keys()
    for p, (nm, ni, _c) in want.pair_stats.items():
        assert got.pair_stats[p][0] == nm
        assert abs(got.pair_stats[p][1] - ni) <= 2


def test_stages_from_the_references_features(monkeypatch):
    """features_from_numpy takes the JAX package's features across: from
    identical descriptors the matching is the reference's (match counts,
    homographies within 1e-4, inliers within 2) and so are the cameras."""
    views = _scene("batched")
    cfg = _slice_cfg(JStitchConfig)
    jf = jpipe.compute_features(views, cfg)
    jpairs = jpipe.match_all_pairs(jf, cfg, seed=3)
    want = jpipe.estimate_cameras(jf, jpairs, cfg)
    host = [{"xy": f["xy"], "valid": f["valid"], "response": f["response"],
             "angle": f["angle"], "img_wh": f["img_wh"],
             "desc": np.asarray(f["_dev"][0]["desc"][f["_dev"][1]])}
            for f in jf]
    feats = pipeline.features_from_numpy(host, device="cpu")
    assert all("_dev" in f for f in feats)
    _jax_draws(monkeypatch, 3, 64, running=False)
    pairs = pipeline.match_all_pairs(feats, _slice_cfg(StitchConfig), seed=3,
                                     device="cpu")
    for g, w in zip(pairs, jpairs):
        assert (g.src, g.dst, g.num_matches) == (w.src, w.dst, w.num_matches)
        assert abs(g.num_inliers - w.num_inliers) <= 2
        assert (g.H is None) == (w.H is None)
        if w.H is not None:
            Hg, Hw = g.H / g.H[2, 2], w.H / w.H[2, 2]
            assert np.abs(Hg - Hw).max() <= 1e-4 * np.abs(Hw).max()
        np.testing.assert_array_equal(g.pts1, w.pts1)
        np.testing.assert_array_equal(g.pts2, w.pts2)
    got = pipeline.estimate_cameras(feats, pairs, _slice_cfg(StitchConfig),
                                    device="cpu")
    assert got.indices == want.indices
    np.testing.assert_allclose(got.cameras.focal.numpy(),
                               np.asarray(want.cameras.focal), rtol=1e-3)


def test_estimate_cameras_refuses_a_bad_mask():
    views = _scene("batched")
    cfg = _slice_cfg(StitchConfig)
    bad = cfg.replace(register=dataclasses.replace(cfg.register,
                                                   ba_refine_mask="xxx"))
    with pytest.raises(ValueError, match="ba_refine_mask"):
        register_images(views, bad, device="cpu")


@pytest.mark.parametrize("entry", ["register_images", "match_all_pairs",
                                   "estimate_cameras", "features_from_numpy"])
def test_entry_points_need_cuda_by_default(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = StitchConfig()
    call = {"register_images": lambda: register_images([], cfg),
            "match_all_pairs": lambda: pipeline.match_all_pairs([], cfg),
            "estimate_cameras": lambda: pipeline.estimate_cameras([], [], cfg),
            "features_from_numpy": lambda: pipeline.features_from_numpy([])}
    with pytest.raises(RuntimeError, match="CUDA"):
        call[entry]()


def jax_result_on_the_chip_scene(seed: int = 0) -> dict:
    """The JAX package's register_images on chip_smoke.py's scene (5
    cameras in a 360-degree ring at the work scale of a 1080p frame,
    rendered by the port on the CPU as chip_smoke.py renders it on the
    card), with its stage times on this CPU."""
    from chip_smoke import registration_scene, rotation_errors_deg
    views, _K, Rs, f = registration_scene(seed, "cpu")
    cfg = JStitchConfig()
    t = [time.perf_counter()]
    feats = jpipe.compute_features(views, cfg)
    t.append(time.perf_counter())
    pairs = jpipe.match_all_pairs(feats, cfg, seed)
    t.append(time.perf_counter())
    reg = jpipe.estimate_cameras(feats, pairs, cfg)
    t.append(time.perf_counter())
    focal = [float(x) for x in reg.cameras.focal]
    return {
        "views": [list(v.shape) for v in views], "kept": reg.indices,
        "focal_true": f, "focals": focal,
        "focal_rel_err": [abs(x - f) / f for x in focal],
        "rotation_err_deg": rotation_errors_deg(np.asarray(reg.cameras.R),
                                                Rs[reg.indices]),
        "keypoints": [int(x["valid"].sum()) for x in feats],
        "pairs": {f"{i}-{j}": [nm, ni] for (i, j), (nm, ni, _c)
                  in reg.pair_stats.items()},
        "cpu_stage_s": [t[1] - t[0], t[2] - t[1], t[3] - t[2]]}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    print(json.dumps(jax_result_on_the_chip_scene(ap.parse_args().seed)))
