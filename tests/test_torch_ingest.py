"""The port's ingest against the JAX package's: the shared-memory ring and
its chaos cases, both packages on one ring, the file and video sources, the
decode producer and the live-stream reconnect.

Copies of the JAX package's tests of the same code (`tests/test_video.py`,
`tests/test_chaos.py`, `tests/test_rtsp_reconnect.py`) run against the
port's modules, with two changes: every producer process imports the
port's `ShmRing`, and the dead-camera case drains the dead camera's ring
before it counts the degraded reads, so a frame the producer published
between the first read and its death cannot reset the stale budget (the
JAX package's copy races with its producer there). The ring library is
built once a module, before any producer spawns; ring names carry a uuid
and every ring is unlinked in a `finally`.
"""
import os
import subprocess
import sys
import time
import uuid

import numpy as np
import pytest
import torch

from stitchingvideo_tpu.video import sharemem as jshm
from stitchingvideo_tpu.video import sources as jsources
from stitchingvideo_tpu_torch.native import build as native_build
from stitchingvideo_tpu_torch.video import sources
from stitchingvideo_tpu_torch.video.sharemem import ShmRing
from stitchingvideo_tpu_torch.video.sources import (SharedMemorySource,
                                                    producer_env)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 256, 512        # ~0.4 MB frames: long memcpy windows for real races


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


@pytest.fixture(scope="module", autouse=True)
def ring_library():
    """Build the ring library once, before any producer process starts."""
    return native_build.load_sharemem()


def test_ring_library_builds_into_build_dir_and_a_failed_build_raises(
        tmp_path):
    so = native_build.library_path(native_build.SHAREMEM_SOURCE,
                                   native_build.SHAREMEM_LIBS)
    assert so.exists() and so.parent.name == "_build"
    assert so.name.startswith("sharemem-")
    bad = tmp_path / "sharemem.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_build.build(bad, native_build.SHAREMEM_LIBS)


def _name(tag: str) -> str:
    return f"/svt_port_{tag}_{uuid.uuid4().hex[:8]}"


def _spawn(code: str, **kw) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", code], env=producer_env(),
                            cwd=ROOT, **kw)


def _hammer_producer(name: str, frames: int = 10 ** 9) -> subprocess.Popen:
    """Publish self-checking frames (every byte == seq % 251) as fast as
    possible, through the port's ShmRing."""
    return _spawn(
        "import numpy as np;"
        "from stitchingvideo_tpu_torch.video.sharemem import ShmRing;"
        f"r = ShmRing.create({name!r}, {W}, {H}, 3, 4);"
        f"buf = np.empty(({H}, {W}, 3), np.uint8);"
        f"[ (buf.fill(i % 251), r.publish(buf, i)) for i in range({frames}) ]")


def _assert_untorn(frame: np.ndarray) -> int:
    v = int(frame.flat[0])
    assert (frame == v).all(), \
        f"TORN FRAME: first byte {v}, {np.unique(frame)[:8]}"
    return v


def _wait_ring(name: str, proc=None, deadline_s: float = 90.0) -> ShmRing:
    """Wait for a producer's ring to appear. The deadline is generous (a
    producer is a fresh interpreter importing torch; under the suite's
    workers that takes many seconds), but a producer that died is reported
    at once."""
    t0 = time.monotonic()
    while True:
        try:
            return ShmRing.open(name)
        except OSError:
            if proc is not None and proc.poll() is not None:
                err = proc.stderr.read()[-800:] if proc.stderr else ""
                raise RuntimeError(f"producer for {name} exited "
                                   f"rc={proc.returncode} before creating "
                                   f"its ring {err}")
            if time.monotonic() - t0 > deadline_s:
                raise
            time.sleep(0.05)


def _unlink(names) -> None:
    for n in names:
        try:
            ShmRing.open(n).close(unlink=True)
        except OSError:
            pass


def _stop(procs) -> None:
    for p in procs:
        if p is not None:
            p.kill()
            p.wait()


# -- the ring (tests/test_video.py:162-223) ----------------------------------

def test_shm_ring_roundtrip():
    name = _name("rt")
    prod = ShmRing.create(name, 64, 48, 3, slots=4)
    try:
        cons = ShmRing.open(name)
        assert cons.shape == (48, 64, 3)
        rng = np.random.default_rng(0)
        f0 = rng.integers(0, 255, (48, 64, 3), np.uint8)
        prod.publish(f0, seq=0)
        np.testing.assert_array_equal(cons.consume(timeout_s=1.0), f0)
        # timeout path (no new frame): returns None, does not hang
        t0 = time.time()
        assert cons.consume(timeout_s=0.2) is None
        assert time.time() - t0 < 1.0
        # newest-wins: publish 3, the consumer sees the latest
        for s in range(1, 4):
            f = rng.integers(0, 255, (48, 64, 3), np.uint8)
            prod.publish(f, seq=s)
        np.testing.assert_array_equal(cons.consume(timeout_s=1.0), f)
        with pytest.raises(ValueError, match="frame shape"):
            prod.publish(np.zeros((48, 63, 3), np.uint8))
        cons.close(False)
    finally:
        prod.close(unlink=True)
    with pytest.raises(OSError, match="producer not up"):
        ShmRing.open(name)


def test_shm_cross_process():
    """A producer in a subprocess (the GetFromRtsp model) publishes through
    the port's ring; the consumer here reads its frames."""
    name = _name("xproc")
    p = _spawn(
        "import numpy as np, time;"
        "from stitchingvideo_tpu_torch.video.sharemem import ShmRing;"
        f"r = ShmRing.create({name!r}, 32, 24, 3, 4);"
        "f = np.full((24, 32, 3), 7, np.uint8);"
        "[r.publish((f + i).astype(np.uint8), i) for i in range(20)];"
        "time.sleep(30)", stderr=subprocess.PIPE, text=True)
    cons = None
    try:
        cons = _wait_ring(name, p)
        got = cons.consume(timeout_s=3.0)
        assert got is not None and got.shape == (24, 32, 3)
        assert (got == got.flat[0]).all() and 7 <= got.flat[0] < 27
    finally:
        _stop([p])
        if cons is not None:
            cons.close(unlink=True)


def test_replay_producer_publishes_the_image(tmp_path):
    """spawn_replay_producer's process republishes one image file."""
    import imageio.v3 as iio
    img = np.random.default_rng(2).integers(0, 256, (24, 40, 3), np.uint8)
    path = str(tmp_path / "cam.png")
    iio.imwrite(path, img)
    name = _name("replay")
    p = sources.spawn_replay_producer(name, path, fps=100.0)
    ring = None
    try:
        ring = _wait_ring(name, p)
        for _ in range(3):            # a newer frame each time, the image
            np.testing.assert_array_equal(ring.consume(timeout_s=5.0), img)
    finally:
        _stop([p])
        if ring is not None:
            ring.close(unlink=True)


def test_producer_env_hides_the_card():
    """A producer never takes a CUDA context; the JAX package's variables
    are left as they are."""
    env = producer_env()
    assert env["CUDA_VISIBLE_DEVICES"] == ""
    assert env.get("JAX_PLATFORMS") == os.environ.get("JAX_PLATFORMS")
    assert {k: v for k, v in env.items() if k != "CUDA_VISIBLE_DEVICES"} \
        == {k: v for k, v in os.environ.items()
            if k != "CUDA_VISIBLE_DEVICES"}


# -- chaos (tests/test_chaos.py, the cases that are not slow) ----------------

def test_kill_producer_mid_publish_no_hang_no_torn_frame():
    """SIGKILL a full-speed producer at a random moment; the consumer never
    sees a torn frame and returns None within its timeout, over several
    kill rounds."""
    rng = np.random.default_rng(7)
    for _trial in range(3):
        name = _name("kill")
        p = _hammer_producer(name)
        ring = None
        try:
            ring = _wait_ring(name, p)
            t_kill = time.monotonic() + float(rng.uniform(0.1, 0.4))
            consumed, killed = 0, False
            t_end = time.monotonic() + 15.0
            while time.monotonic() < t_end:
                if not killed and time.monotonic() >= t_kill:
                    p.kill()          # SIGKILL: maybe mid-memcpy
                    killed = True
                f = ring.consume(timeout_s=1.0)
                if f is None:
                    assert killed, "consume timed out with a live producer"
                    break             # dead producer detected, no hang
                _assert_untorn(f)
                consumed += 1
            else:
                pytest.fail("consumer never detected the dead producer")
            assert consumed > 0, "no frames consumed before the kill"
        finally:
            _stop([p])
            if ring is not None:
                ring.close(unlink=True)


def test_consumer_stall_past_ring_wrap():
    """A consumer that sleeps while the producer wraps the 4-slot ring wakes
    to the newest frame, untorn."""
    name = _name("wrap")
    ring = ShmRing.create(name, W, H, 3, slots=4)
    try:
        buf = np.empty((H, W, 3), np.uint8)
        for i in range(23):           # 23 frames through 4 slots
            buf.fill(i % 251)
            ring.publish(buf, i)
        consumer = ShmRing.open(name)
        f = consumer.consume(timeout_s=1.0)
        assert f is not None
        assert _assert_untorn(f) == 22 % 251     # newest, not an old slot
        consumer.close()
    finally:
        ring.close(unlink=True)


def test_torn_read_retry_under_wrap_pressure():
    """The consumer hammers a 4-slot ring while the producer overwrites at
    full speed: every frame returned is consistent (the seqlock's retry
    path runs for real)."""
    name = _name("race")
    p = _hammer_producer(name)
    ring = None
    try:
        ring = _wait_ring(name, p)
        got = 0
        t_end = time.monotonic() + 3.0
        while time.monotonic() < t_end:
            f = ring.consume(timeout_s=1.0)
            assert f is not None, "live producer timed out"
            _assert_untorn(f)
            got += 1
        assert got > 20, f"only {got} frames consumed under pressure"
    finally:
        _stop([p])
        if ring is not None:
            ring.close(unlink=True)


def test_producer_restart_consumer_reattaches():
    """The producer dies; a replacement recreates the ring under the same
    name, and a consumer whose reads time out re-opens it and resumes."""
    name = _name("restart")
    p1 = _hammer_producer(name)
    ring, p2 = None, None
    try:
        ring = _wait_ring(name, p1)
        assert ring.consume(timeout_s=5.0) is not None
        p1.kill()
        p1.wait()
        t0 = time.monotonic()         # drain: None after a bounded wait
        while ring.consume(timeout_s=0.5) is not None:
            assert time.monotonic() - t0 < 10.0
        ring.close(unlink=False)
        ring = None
        p2 = _hammer_producer(name)   # recreates the shm name
        time.sleep(0.5)
        ring = _wait_ring(name, p2)
        f = ring.consume(timeout_s=5.0)
        assert f is not None, "consumer did not recover after restart"
        _assert_untorn(f)
    finally:
        _stop([p1, p2])
        if ring is not None:
            ring.close(unlink=True)


def test_consumer_survives_a_producer_killed_mid_broadcast():
    """A producer SIGKILLed at a random moment while a consumer waits: the
    consumer's read still ends at its timeout. Tiny frames keep the
    producer inside its broadcast a large share of the time; a consumer
    that waited on the ring's mutex or condition variable blocked for ever
    after about one kill in five (the JAX package's library). The producer
    drives the port's library through ctypes alone, so it starts in
    milliseconds."""
    import threading
    so = native_build.library_path(native_build.SHAREMEM_SOURCE,
                                   native_build.SHAREMEM_LIBS)
    code = (
        "import ctypes, sys\n"
        f"lib = ctypes.CDLL({str(so)!r})\n"
        "lib.shm_ring_create.restype = ctypes.c_void_p\n"
        "lib.shm_ring_publish.argtypes = [ctypes.c_void_p, ctypes.c_char_p,"
        " ctypes.c_int64, ctypes.c_int64]\n"
        "h = lib.shm_ring_create(sys.argv[1].encode(), 4, 4, 3, 4)\n"
        "i = 0\n"
        "while True:\n"
        "    lib.shm_ring_publish(h, bytes(48), 48, i)\n"
        "    i += 1\n")
    rng = np.random.default_rng(3)
    for trial in range(30):
        name = _name("bcast")
        p = subprocess.Popen([sys.executable, "-S", "-c", code, name])
        ring = None
        try:
            ring = _wait_ring(name, p)
            done = threading.Event()

            def drain():
                while ring.consume(timeout_s=0.05) is not None:
                    pass
                done.set()

            threading.Thread(target=drain, daemon=True).start()
            time.sleep(float(rng.uniform(0.005, 0.03)))
            p.kill()
            p.wait()
            assert done.wait(10.0), f"consumer blocked after kill {trial}"
        finally:
            _stop([p])
            if ring is not None and done.is_set():
                ring.close(unlink=True)


def test_dead_camera_degrades_then_stops():
    """One dead camera keeps the rig streaming on its last good frame for
    exactly `stale_reads` reads, then the source reports end of stream.
    Deterministic: the dead camera's ring is drained before the count, so
    no frame published before the kill is read as fresh."""
    names = [_name(f"deg{k}") for k in range(2)]
    procs = [_hammer_producer(n) for n in names]
    src = None
    try:
        for n, pr in zip(names, procs):
            _wait_ring(n, pr).close()
        src = SharedMemorySource(names, timeout_s=0.5, stale_reads=3)
        first = src.read()
        assert first is not None and len(first) == 2
        procs[1].kill()               # camera 1 dies mid-stream
        procs[1].wait()
        t0 = time.monotonic()         # drain what it published before
        while src.rings[1].consume(timeout_s=0.5) is not None:
            assert time.monotonic() - t0 < 10.0
        last_good = first[1].copy()
        served = 0
        while True:
            frames = src.read()
            if frames is None:
                break
            _assert_untorn(frames[0])
            np.testing.assert_array_equal(frames[1], last_good)
            served += 1
            assert served <= 3, "stale budget not enforced"
        assert served == 3, f"expected 3 degraded reads, got {served}"
    finally:
        _stop(procs)
        if src is not None:
            src.close(unlink=True)


# -- both packages on one ring ------------------------------------------------

@pytest.mark.parametrize("writer", ["jax_package", "port"])
def test_both_packages_share_a_ring(writer):
    """The ring's layout is the interface between the two packages'
    processes: frame sets that one package publishes are read byte for
    byte by the other's SharedMemorySource."""
    create, reader = ((jshm.ShmRing.create, SharedMemorySource)
                      if writer == "jax_package" else
                      (ShmRing.create, jsources.SharedMemorySource))
    names = [_name(f"both{k}") for k in range(3)]
    rng = np.random.default_rng(5)
    rings, src = [], None
    try:
        rings = [create(n, 96, 64, 3, 4) for n in names]
        src = reader(names, timeout_s=1.0)
        for seq in range(6):          # past the 4-slot wrap
            sets = rng.integers(0, 256, (3, 64, 96, 3), np.uint8)
            for r, f in zip(rings, sets):
                r.publish(f, seq)
            got = src.read()
            assert len(got) == 3
            for g, f in zip(got, sets):
                assert g.dtype == np.uint8 and g.shape == f.shape
                np.testing.assert_array_equal(g, f)
        assert src.read() is None     # nothing new: a bounded wait
    finally:
        if src is not None:
            src.close()
        for r in rings:
            r.close(unlink=True)


# -- the file and video sources ----------------------------------------------

@pytest.fixture(scope="module")
def camera_clips(tmp_path_factory):
    """Three cameras of 4 distinct frames each, as JPEG directories and as
    MJPG .avi files."""
    cv2 = pytest.importorskip("cv2")
    import imageio.v3 as iio
    d = tmp_path_factory.mktemp("clips")
    rng = np.random.default_rng(11)
    dirs, vids = [], []
    for c in range(3):
        cd = d / f"cam{c}"
        cd.mkdir()
        vp = str(d / f"cam{c}.avi")
        w = cv2.VideoWriter(vp, cv2.VideoWriter_fourcc(*"MJPG"), 10.0,
                            (80, 48))
        assert w.isOpened()
        for i in range(4):
            f = np.clip(rng.normal(120, 50, (48, 80, 3)), 0,
                        255).astype(np.uint8)
            iio.imwrite(cd / f"{i:03d}.jpg", f)
            w.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
        w.release()
        dirs.append(str(cd))
        vids.append(vp)
    return dirs, vids


def _drain(src, n: int):
    out = []
    for _ in range(n):
        fs = src.read()
        out.append(fs)
        if fs is None:
            break
    src.close()
    return out


@pytest.mark.parametrize("kind", ["dirs", "dirs_loop", "videos"])
def test_file_sources_read_what_the_jax_package_reads(camera_clips, kind):
    dirs, vids = camera_clips
    make = {
        "dirs": lambda m: m.DirectorySource(dirs),
        "dirs_loop": lambda m: m.DirectorySource(dirs, loop=True),
        "videos": lambda m: m.VideoFileSource(vids),
    }[kind]
    n = 10 if kind == "dirs_loop" else 6
    got, want = _drain(make(sources), n), _drain(make(jsources), n)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert len(g) == 3
        for a, b in zip(g, w):
            assert a.shape == (48, 80, 3)
            np.testing.assert_array_equal(a, b)
    # 4 frames a camera: the end of stream, unless looping
    assert (got[-1] is None) == (kind != "dirs_loop")


def test_directory_source_refuses_an_empty_camera(tmp_path):
    pytest.importorskip("imageio")
    (tmp_path / "a").mkdir()
    with pytest.raises(ValueError, match="empty camera directory"):
        sources.DirectorySource([str(tmp_path / "a")])


# -- the decode producer (tests/test_video.py:385-446) -----------------------

def test_video_decode_producer_pipeline(tmp_path):
    """The full ingest-to-composite chain with real video decode: one
    producer process a camera (cv2.VideoCapture decoding an .avi, the
    GetFromRtsp contract) -> ShmRing -> SharedMemorySource ->
    VideoStitcher.run. Each clip repeats its camera's view, losslessly
    coded (FFV1), so every frame a ring delivers is that view and every
    panorama equals composite() of the views."""
    cv2 = pytest.importorskip("cv2")
    import dataclasses

    from stitchingvideo_tpu_torch import StitchConfig, VideoStitcher
    from stitchingvideo_tpu_torch.utils import synthetic
    views, *_ = synthetic.make_scene(n=3, img_wh=(384, 288), fov_deg=55,
                                     overlap_frac=0.4, seed=7, device="cpu")
    names, procs = [], []
    src = None
    try:
        for c, v in enumerate(views):
            path = str(tmp_path / f"cam{c}.avi")
            w = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"FFV1"), 20.0,
                                (v.shape[1], v.shape[0]))
            assert w.isOpened()
            for _ in range(20):
                w.write(cv2.cvtColor(v, cv2.COLOR_RGB2BGR))
            w.release()
            names.append(_name(f"vdec{c}"))
            procs.append(sources.spawn_video_producer(names[-1], path,
                                                      fps=20.0, loop=True))
        for n, p in zip(names, procs):
            _wait_ring(n, p).close()
        src = SharedMemorySource(names, timeout_s=10.0)

        cfg = StitchConfig()
        cfg = cfg.replace(
            compose=dataclasses.replace(
                cfg.compose, warp_type="cylindrical", blend_type="no",
                seam_find="voronoi", expos_comp="no"),
            video=dataclasses.replace(cfg.video, reregister_seconds=3600.0))
        vs = VideoStitcher(cfg, device="cpu")
        outs, seen = [], []

        def on_frame(pano, i):
            outs.append(pano)
            seen.append(vs._latest_frames)

        stats = vs.run(src, on_frame=on_frame, max_frames=3)
        assert stats.frames == 3 and len(outs) == 3
        for frames in seen:            # what the rings delivered
            for f, v in zip(frames, views):
                np.testing.assert_array_equal(f, v)
        want = vs.composite(list(views))
        assert want.std() > 5          # real (decoded) content
        for o in outs:
            np.testing.assert_array_equal(o, want)
    finally:
        _stop(procs)
        if src is not None:
            src.close()
        _unlink(names)


# -- a live stream that drops (tests/test_rtsp_reconnect.py) -----------------

def _spawn_decode_producer(url: str, name: str, reconnect: int,
                           wait_s: float = 0.1) -> subprocess.Popen:
    return subprocess.Popen(
        [sys.executable, "-m", "stitchingvideo_tpu_torch.video.producer",
         url, name, "--reconnect", str(reconnect), "--reconnect-wait",
         str(wait_s)], env=producer_env(), cwd=ROOT, stderr=subprocess.PIPE,
        text=True)


def test_producer_reconnects_after_midstream_drop():
    """Phase-1 frames (gray 40), the server drops the TCP connection, the
    producer reconnects, phase-2 frames (gray 200). The consumer rides the
    gap on its stale-frame budget and sees both phases, untorn."""
    pytest.importorskip("cv2")
    from test_rtsp_reconnect import MjpegFaultServer
    srv = MjpegFaultServer(values=[40, 200], drop_after=[8, 0])
    name = _name("rc")
    p = _spawn_decode_producer(srv.url, name, reconnect=20)
    src = None
    try:
        _wait_ring(name, p).close()
        src = SharedMemorySource([name], timeout_s=1.0, stale_reads=60)
        saw_phase1 = saw_phase2 = False
        t_end = time.monotonic() + 60.0
        while time.monotonic() < t_end:
            frames = src.read()
            assert frames is not None, \
                "consumer gave up before the producer reconnected"
            m = float(frames[0].mean())
            if abs(m - 40) < 15:      # JPEG of a flat frame: within ~2
                saw_phase1 = True
            elif abs(m - 200) < 15:
                saw_phase2 = True
                break
            else:
                pytest.fail(f"unexpected frame mean {m} (torn/mixed?)")
        assert saw_phase1, "never saw a pre-drop frame"
        assert saw_phase2, "producer did not reconnect after the drop"
        assert srv.connections >= 2, "server never saw a reconnect"
    finally:
        _stop([p])
        if src is not None:
            src.close(unlink=True)
        srv.close()


def test_reconnect_budget_exhausted_exits_cleanly():
    """When the stream dies for good, the producer exits after its
    reconnect budget, and the consumer's reads stay bounded."""
    pytest.importorskip("cv2")
    from test_rtsp_reconnect import MjpegFaultServer
    srv = MjpegFaultServer(values=[90], drop_after=[5], max_connections=1)
    name = _name("dead")
    p = _spawn_decode_producer(srv.url, name, reconnect=2, wait_s=0.05)
    ring = None
    try:
        ring = _wait_ring(name, p)
        got = 0
        t_end = time.monotonic() + 30.0
        while time.monotonic() < t_end:
            if ring.consume(timeout_s=1.0) is None:
                break
            got += 1
        assert got > 0, "no frames before the permanent drop"
        # both re-open attempts are refused: the producer must exit
        p.wait(timeout=30.0)
    finally:
        _stop([p])
        if ring is not None:
            ring.close(unlink=True)
        srv.close()
