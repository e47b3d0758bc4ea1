"""The port's CLI, sinks and calibration tool against the JAX package's and
against the port's own API.

`_build_cfg` is held field by field against the JAX package's on the flag
sets of `tests/test_cli.py`; the sinks are copies of that file's sink
tests; `main([..., '--device', 'cpu'])` runs end to end on a small rendered
scene and each panorama or file it writes is compared with what the port's
`VideoStitcher` or `Stitcher.stitch` gives on the same frames (those are held
against the JAX package by the other test_torch_* files); a saved
registration loads in the JAX package; the calibration equals the JAX
package's on the same rendered boards.
"""
import argparse
import dataclasses
import glob
import os
import sys
import types

import imageio.v3 as iio
import numpy as np
import pytest
import torch

from stitchingvideo_tpu import cli as jcli
from stitchingvideo_tpu_torch import cli
from stitchingvideo_tpu_torch import Stitcher, UndistortConfig, VideoStitcher
from stitchingvideo_tpu_torch.utils import synthetic, timing
from stitchingvideo_tpu_torch.video import sink as sm
from stitchingvideo_tpu_torch.video import sources
from stitchingvideo_tpu_torch.video.sources import ReplaySource

SCENE = ["--warp", "cylindrical", "--seam", "voronoi", "--expos_comp", "no",
         "--blend", "no", "--conf_thresh", "0.6"]
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several workers on the machine's cores, and a
    registration or a composite here is many small torch ops: with one team
    of intra-op threads a worker, every op waits for threads the other
    workers hold, so this file runs torch on one (as test_torch_stream.py
    does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("scene")
    views, *_ = synthetic.make_scene(n=3, img_wh=(384, 288), fov_deg=55,
                                     overlap_frac=0.4, seed=9, device="cpu")
    paths = []
    for i, v in enumerate(views):
        p = d / f"cam{i}.png"
        iio.imwrite(p, v)
        paths.append(str(p))
    return views, paths


def _args(flags):
    """The port's parser of the common flags, as `main` builds it."""
    p = argparse.ArgumentParser()
    cli._add_common(p)
    return p.parse_args(flags)


def _video_stitcher(flags) -> VideoStitcher:
    """What `video` builds from the same flags, through the API."""
    cfg = cli._build_cfg(_args(flags))
    return VideoStitcher(cfg, device="cpu")


def _read_video(path):
    import cv2
    cap = cv2.VideoCapture(str(path))
    out = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        out.append(f)
    cap.release()
    return out


def _encoded(panos, path):
    """The panoramas through the port's VideoFileSink, decoded again."""
    s = sm.VideoFileSink(str(path))
    for i, p in enumerate(panos):
        s.write(p, i)
    s.close()
    return _read_video(path)


# -- the configuration ---------------------------------------------------------

FLAG_SETS = {
    "defaults": [],
    "scene": SCENE,
    "stitch_feather": ["--warp", "cylindrical", "--seam", "voronoi",
                       "--expos_comp", "no", "--blend", "feather",
                       "--conf_thresh", "0.6"],
    "preview": ["--blend", "feather", "--preview", "--try_gpu", "no"],
    "undistort": ["--undistort"],
    "undistort_params": ["--undistort", "--undistort_params",
                         "100,101,50,51,-0.1,0.01,0.001,0.002"],
    "grad": ["--features", "grad"],
    "grad_match_conf": ["--features", "grad", "--match_conf", "0.7"],
    "harris_brief": ["--features", "harris_brief"],
    "wave_no": ["--wave_correct", "no"],
    "scales_ba": ["--work_megapix", "0.3", "--seam_megapix", "0.05",
                  "--compose_megapix", "0.4", "--ba", "reproj",
                  "--ba_refine_mask", "x_x_x", "--blend_strength", "3",
                  "--seam", "dp_colorgrad", "--expos_comp", "gain",
                  "--wave_correct", "vert", "--warp", "mercator"],
}


@pytest.mark.parametrize("flags", list(FLAG_SETS.values()),
                         ids=list(FLAG_SETS))
def test_build_cfg_matches_the_jax_package(flags):
    jp = argparse.ArgumentParser()
    jcli._add_common(jp)
    got = cli._build_cfg(_args(flags))
    want = jcli._build_cfg(jp.parse_args(flags))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_build_cfg_refuses_short_undistort_params():
    for build, add in ((cli._build_cfg, cli._add_common),
                       (jcli._build_cfg, jcli._add_common)):
        p = argparse.ArgumentParser()
        add(p)
        with pytest.raises(SystemExit, match="8 comma-separated"):
            build(p.parse_args(["--undistort", "--undistort_params", "1,2"]))


# -- the sinks (tests/test_cli.py:161-223) ----------------------------------

def test_display_sink_key_callback(monkeypatch):
    """DisplaySink forwards keypresses (the reference's 'a'-key on-demand
    re-registration, 64-bit driver :768) and make_sink wires on_key
    through. cv2's GUI is faked so the test runs headless."""
    shown, keys = [], [ord("a"), -1, ord("q")]
    fake = types.SimpleNamespace(
        imshow=lambda title, img: shown.append((title, img.shape)),
        waitKey=lambda ms: keys.pop(0),
        destroyWindow=lambda title: None,
        cvtColor=lambda img, code: img,
        COLOR_RGB2BGR=4,
    )
    monkeypatch.setitem(sys.modules, "cv2", fake)
    pressed = []
    s = sm.make_sink(None, display=True, on_key=pressed.append)
    frame = np.zeros((8, 8, 3), np.uint8)
    for i in range(3):
        s.write(frame, i)
    s.close()
    assert s.frames_written == 3
    assert len(shown) == 3
    assert pressed == [ord("a"), ord("q")]  # -1 (no key) filtered out


def test_sink_routing_and_edges(tmp_path):
    """make_sink routes by extension; VideoFileSink rejects a mid-stream
    frame-size change; StillSink keeps only the first frame; TeeSink fans
    out and counts once."""
    f1 = np.full((32, 48, 3), 10, np.uint8)
    f2 = np.full((32, 48, 3), 200, np.uint8)

    s = sm.make_sink(str(tmp_path / "frames_dir"))
    assert isinstance(s, sm.FrameDirSink)
    s.write(f1, 0)
    s.write(f2, 1)
    s.close()
    assert sorted(p.name for p in (tmp_path / "frames_dir").iterdir()) == \
        ["frame_000000.jpg", "frame_000001.jpg"]

    still = sm.make_sink(str(tmp_path / "one.png"))
    assert isinstance(still, sm.StillSink)
    still.write(f1, 0)
    still.write(f2, 1)
    still.close()
    assert still.frames_written == 1
    np.testing.assert_array_equal(iio.imread(tmp_path / "one.png"), f1)

    vid = sm.make_sink(str(tmp_path / "out.avi"))
    assert isinstance(vid, sm.VideoFileSink)
    vid.write(f1, 0)
    with pytest.raises(ValueError, match="frame size changed"):
        vid.write(np.zeros((16, 48, 3), np.uint8), 1)
    vid.close()

    tee = sm.TeeSink(sm.StillSink(str(tmp_path / "t.png")),
                     sm.FrameDirSink(str(tmp_path / "t_dir")))
    tee.write(f1, 0)
    tee.write(f2, 1)
    tee.close()
    assert tee.frames_written == 2
    assert sm.make_sink("") is None and sm.make_sink(None) is None


# -- end to end on the CPU ------------------------------------------------------

def test_cli_video_replay(scene_files, tmp_path, capsys):
    """`video --mode replay` writes every panorama; each equals the API's
    composite() of the same jittered frame set, after a registration on
    the first."""
    views, paths = scene_files
    out = tmp_path / "frames"
    rc = cli.main(["video", *paths, "--mode", "replay", "--frames", "3",
                   *SCENE, *CPU, "--output", str(out)])
    assert rc == 0
    assert "frames: 3," in capsys.readouterr().out
    src = ReplaySource(views, jitter=2)
    sets = [src.read() for _ in range(3)]
    vs = _video_stitcher(SCENE)
    vs.register(sets[0])
    for i, s in enumerate(sets):
        want = tmp_path / f"want{i}.jpg"
        iio.imwrite(want, vs.composite(s))
        np.testing.assert_array_equal(
            iio.imread(out / f"frame_{i:06d}.jpg"), iio.imread(want))


@pytest.fixture(scope="module")
def lossless_clips(scene_files, tmp_path_factory):
    """Each camera's view repeated in a losslessly coded (FFV1) .avi: a
    decode producer publishes exactly the view."""
    cv2 = pytest.importorskip("cv2")
    views, _ = scene_files
    d = tmp_path_factory.mktemp("clips")
    vids = []
    for i, v in enumerate(views):
        vp = str(d / f"cam{i}.avi")
        w = cv2.VideoWriter(vp, cv2.VideoWriter_fourcc(*"FFV1"), 15.0,
                            (v.shape[1], v.shape[0]))
        assert w.isOpened()
        for _ in range(10):
            w.write(cv2.cvtColor(v, cv2.COLOR_RGB2BGR))
        w.release()
        vids.append(vp)
    return vids


def _spy_producers(monkeypatch):
    """Record the producers and ring names `video --mode shm` spawns."""
    spawned = []
    real = sources.spawn_video_producer

    def spawn(name, uri, **kw):
        p = real(name, uri, **kw)
        spawned.append((name, p))
        return p

    monkeypatch.setattr(sources, "spawn_video_producer", spawn)
    return spawned


def _ring_files():
    return set(glob.glob(f"/dev/shm/svt_cli_{os.getpid()}_*"))


def test_cli_video_shm_mode(scene_files, lossless_clips, tmp_path,
                            monkeypatch):
    """The reference's RT scenario from the CLI: decode producers spawned
    by the CLI feed the shared-memory rings; every panorama equals the
    API's composite() of the views; no producer and no ring outlive it."""
    views, _ = scene_files
    spawned = _spy_producers(monkeypatch)
    out = tmp_path / "frames"
    rc = cli.main(["video", *lossless_clips, "--mode", "shm", "--frames",
                   "2", *SCENE, *CPU, "--output", str(out)])
    assert rc == 0
    assert len(spawned) == 3
    assert all(p.poll() is not None for _, p in spawned)
    assert not _ring_files()
    vs = _video_stitcher(SCENE)
    vs.register(list(views))
    want = tmp_path / "want.jpg"
    iio.imwrite(want, vs.composite(list(views)))
    got = sorted(out.iterdir())
    assert [p.name for p in got] == ["frame_000000.jpg", "frame_000001.jpg"]
    for p in got:
        np.testing.assert_array_equal(iio.imread(p), iio.imread(want))


def test_cli_video_mp4_and_registration_persistence(scene_files, tmp_path):
    """`video --output out.mp4` writes every panorama (each the API's,
    through the same encoder); the saved registration loads in the JAX
    package with every integer LUT field equal; a second run restarts from
    it with no registration from frames."""
    pytest.importorskip("cv2")
    from stitchingvideo_tpu.config import StitchConfig as JStitchConfig
    from stitchingvideo_tpu.video.runtime import \
        VideoStitcher as JVideoStitcher
    views, paths = scene_files
    out, regp = tmp_path / "pano.mp4", tmp_path / "reg.npz"
    rc = cli.main(["video", *paths, "--mode", "replay", "--frames", "4",
                   *SCENE, *CPU, "--output", str(out),
                   "--save_registration", str(regp)])
    assert rc == 0 and regp.exists()
    src = ReplaySource(views, jitter=2)
    sets = [src.read() for _ in range(4)]
    vs = _video_stitcher(SCENE)
    vs.register(sets[0])
    want = _encoded([vs.composite(s) for s in sets], tmp_path / "want.mp4")
    got = _read_video(out)
    assert len(got) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)

    # the JAX package reads the file
    jcfg = JStitchConfig()
    jvs = JVideoStitcher(jcfg.replace(video=dataclasses.replace(
        jcfg.video, kernel="gather")))
    jvs.load_registration(str(regp))
    loaded = _video_stitcher(SCENE)
    loaded.load_registration(str(regp))
    np.testing.assert_array_equal(np.asarray(jvs._lut.cam_idx),
                                  loaded._lut.cam_idx.numpy())
    assert jvs._frame_hw == loaded._frame_hw == vs._frame_hw
    np.testing.assert_array_equal(vs._lut.cam_idx, loaded._lut.cam_idx)

    # restart from the checkpoint: no registration from frames
    timing.GLOBAL_TRACER.spans.clear()
    out2 = tmp_path / "pano2.mp4"
    rc = cli.main(["video", *paths, "--mode", "replay", "--frames", "2",
                   *SCENE, *CPU, "--output", str(out2),
                   "--load_registration", str(regp)])
    assert rc == 0
    assert "find_features" not in timing.GLOBAL_TRACER.spans
    src = ReplaySource(views, jitter=2)
    want2 = _encoded([loaded.composite(src.read()) for _ in range(2)],
                     tmp_path / "want2.mp4")
    got2 = _read_video(out2)
    assert len(got2) == 2
    for g, w in zip(got2, want2):
        np.testing.assert_array_equal(g, w)


def test_cli_stitch(scene_files, tmp_path):
    """`stitch` writes what `Stitcher.stitch` gives, and the match graph."""
    views, paths = scene_files
    flags = ["--warp", "cylindrical", "--seam", "voronoi", "--expos_comp",
             "no", "--blend", "feather", "--conf_thresh", "0.6"]
    out, graph = tmp_path / "pano.png", tmp_path / "graph.dot"
    rc = cli.main(["stitch", *paths, *flags, *CPU, "--save_graph",
                   str(graph), "--output", str(out)])
    assert rc == 0
    pano, _mask = Stitcher(cli._build_cfg(_args(flags)),
                           device="cpu").stitch(list(views))
    np.testing.assert_array_equal(iio.imread(out), pano)
    dot = graph.read_text()
    assert dot.startswith("graph matches_graph{") and "Nm=" in dot


def test_cli_canvas_shards_raises_and_cleans_up(lossless_clips, tmp_path,
                                                monkeypatch):
    """A start with --canvas_shards 2 that fails after the producers came
    up (a --load_registration file that is not there) raises, and none of
    the producers and none of their rings is left."""
    spawned = _spy_producers(monkeypatch)
    with pytest.raises(FileNotFoundError):
        cli.main(["video", *lossless_clips, "--mode", "shm", "--frames",
                  "2", *SCENE, *CPU, "--output", "", "--canvas_shards", "2",
                  "--load_registration", str(tmp_path / "missing.npz")])
    assert len(spawned) == 3
    assert all(p.poll() is not None for _, p in spawned)
    assert not _ring_files()


def test_cli_canvas_shards_equal_single(scene_files, tmp_path, monkeypatch):
    """`video --canvas_shards 2 --device cpu` writes, frame for frame, what
    `--canvas_shards 1` writes; on CUDA with too few cards it raises before
    it spawns a producer."""
    _views, paths = scene_files
    outs = []
    for n in (1, 2):
        out = tmp_path / f"shards{n}"
        rc = cli.main(["video", *paths, "--mode", "replay", "--frames", "2",
                       *SCENE, *CPU, "--output", str(out),
                       "--canvas_shards", str(n)])
        assert rc == 0
        outs.append(sorted(out.iterdir()))
    assert [p.name for p in outs[1]] == ["frame_000000.jpg",
                                         "frame_000001.jpg"]
    for a, b in zip(*outs):
        np.testing.assert_array_equal(iio.imread(a), iio.imread(b))

    def no_spawn(*a, **kw):
        raise AssertionError("a producer was spawned")

    monkeypatch.setattr(sources, "spawn_video_producer", no_spawn)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="need 2 devices, have 1"):
        cli.main(["video", "a.avi", "b.avi", "--mode", "shm", "--output", "",
                  "--canvas_shards", "2"])


@pytest.mark.parametrize("argv", [
    ["stitch", "a.png", "b.png"],
    ["video", "a.png", "b.png", "--mode", "replay"],
    ["video", "a.avi", "b.avi", "--mode", "shm"],
], ids=["stitch", "video_replay", "video_shm"])
def test_cli_without_a_card_raises(argv, monkeypatch):
    """With no card and no --device cpu the CLI raises before it reads an
    input or spawns a producer: it never runs on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    def no_spawn(*a, **kw):
        raise AssertionError("a producer was spawned")

    monkeypatch.setattr(sources, "spawn_video_producer", no_spawn)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv + ["--output", ""])


# -- the calibration tool -------------------------------------------------------

@pytest.fixture
def cv2_one_thread():
    """cv2's threaded reductions vary a solve in its last bits from call to
    call; on one thread two calls on the same views agree bit for bit."""
    cv2 = pytest.importorskip("cv2")
    n = cv2.getNumThreads()
    cv2.setNumThreads(1)
    yield cv2
    cv2.setNumThreads(n)


def test_calibrate_matches_the_jax_package(tmp_path, cv2_one_thread):
    cv2 = cv2_one_thread
    from stitchingvideo_tpu.tools import calibrate as jcal
    from stitchingvideo_tpu_torch.tools import calibrate as cal
    from test_calibrate import _render_board
    K = np.array([[600.0, 0, 320], [0, 600.0, 240], [0, 0, 1]], np.float64)
    dist = np.array([-0.15, 0.05, 0.001, -0.001, 0.0])
    views = []
    for k in range(6):
        rvec = np.array([0.25 * np.sin(k), 0.25 * np.cos(k),
                         0.1 * np.sin(2 * k)])
        tvec = np.array([-120 + 12 * k, -90 + 6 * k, 420 + 18 * k],
                        np.float64)
        views.append(_render_board(K, dist, rvec, tvec))
    got = cal.calibrate_chessboard(views, board_size=(9, 6), square_size=30)
    assert got == jcal.calibrate_chessboard(views, board_size=(9, 6),
                                            square_size=30)
    assert got["n_used"] >= 5
    assert got["fx"] == pytest.approx(600.0, rel=0.05)

    paths = []
    for i, v in enumerate(views):
        paths.append(str(tmp_path / f"board{i}.png"))
        cv2.imwrite(paths[-1], v)
    out = str(tmp_path / "calib.json")
    assert cal.main([*paths, "--board", "9x6", "--square_size", "30",
                     "--output", out]) == 0
    und = cal.load_undistort_config(out)
    assert und.enabled
    assert dataclasses.asdict(und) == \
        dataclasses.asdict(jcal.load_undistort_config(out))
    assert und.fx == pytest.approx(got["fx"])
    assert isinstance(und, UndistortConfig)
