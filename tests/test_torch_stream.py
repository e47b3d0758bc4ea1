"""Frames in flight: the port's StreamingComposer and run(pipeline_depth > 1)
against the port's serial composite() and the JAX package's composer.

On one saved registration (tests/test_torch_runtime.py's), six distinct
frame sets go through the composer at depths 1, 2 and 3 in the seam-select,
feather and multiband modes and through the full blend: the outputs equal
the serial `composite()` of the same frame set bit for bit, in submit
order, and each is compared only after the last submit, so a delivered
array that still aliased a ring slot would show. Against the JAX package's
StreamingComposer (CPU, interpret mode) the seam-select output is bit-exact
and feather, multiband and the full blend keep ROADMAP.md section 3's
tolerances (`tests/test_torch_runtime.py:_assert_same`: feather and the full
blend <= 1 step on <= 0.01% of values; multiband median 0, <= 1 step on
<= 1%, none above 2)."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from stitchingvideo_tpu.config import StitchConfig as JStitchConfig
from stitchingvideo_tpu.video.runtime import VideoStitcher as JVideoStitcher
from stitchingvideo_tpu.video.stream import \
    StreamingComposer as JStreamingComposer
from stitchingvideo_tpu_torch import StitchConfig, VideoStitcher
from stitchingvideo_tpu_torch.video import runtime as runtime_mod
from stitchingvideo_tpu_torch.video.sources import ReplaySource
from stitchingvideo_tpu_torch.video.stream import StreamingComposer

from tests.test_torch_runtime import (_Frames, _assert_same, _cfg, _frames,
                                      _save, _scene, _slow_cfgs)

SETS = 6
MODES = ("lut", "feather", "multiband", "blend")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The suite runs several workers on the machine's cores, and a frame
    set here is hundreds of small torch ops: with one team of intra-op
    threads a worker, every op waits for threads the other workers hold
    (measured tens of times slower), so this file runs torch on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("reg")
    return {"full": _save(d, "reg.npz"),
            "second": _save(d, "second.npz", seed=9)}


@functools.lru_cache(maxsize=None)
def _sets():
    return tuple(_frames(40 + k) for k in range(SETS))


def _blend_stitcher(cls, cfg_cls, path):
    """A stitcher of `cls` that serves the full blend: a registration
    installed in 'lut' mode, then the mode switched to 'feather' (as
    tests/test_video.py:271-274 switches)."""
    v = cls(_cfg(cfg_cls), **({} if cls is JVideoStitcher
                              else {"device": "cpu"}))
    v.load_registration(path)
    v.cfg = v.cfg.replace(video=dataclasses.replace(v.cfg.video,
                                                    compose_mode="feather"))
    assert v._ftlut is None
    return v


@functools.lru_cache(maxsize=None)
def _port(path, mode):
    """The port's VideoStitcher serving `mode` on the saved registration;
    'blend' is the full blend."""
    if mode == "blend":
        return _blend_stitcher(VideoStitcher, StitchConfig, path)
    vs = VideoStitcher(_cfg(compose_mode=mode), device="cpu")
    vs.load_registration(path)
    state = {"lut": vs._tlut, "feather": vs._ftlut, "multiband": vs._mbtlut}
    assert state[mode] is not None
    return vs


def _reference(path, mode):
    """The JAX package's VideoStitcher serving `mode` on the same file."""
    if mode == "blend":
        return _blend_stitcher(JVideoStitcher, JStitchConfig, path)
    jvs = JVideoStitcher(_cfg(JStitchConfig, compose_mode=mode))
    jvs.load_registration(path)
    return jvs


@functools.lru_cache(maxsize=None)
def _serial(path, mode):
    vs = _port(path, mode)
    want = [vs.composite(f) for f in _sets()]
    for a, b in zip(want, want[1:]):
        assert not np.array_equal(a, b)
    return want


@functools.lru_cache(maxsize=None)
def _streamed(path, mode, depth):
    """The port's composer at `depth` over `_sets()`: (deliveries, its
    out_times)."""
    sc = StreamingComposer(_port(path, mode), depth=depth)
    return _stream(sc, _sets()), tuple(sc.out_times)


def _stream(sc, sets):
    """Submit every frame set, then flush; check the fill and the counts
    (tests/test_video.py:533-558) and return the deliveries in order."""
    got = []
    for k, f in enumerate(sets):
        out = sc.submit(f)
        assert (out is None) == (k < sc.depth - 1)
        if out is not None:
            got.append(out)
        assert len(sc) == min(k + 1, sc.depth - 1)
    assert len(got) == len(sets) - (sc.depth - 1)
    got += sc.flush()
    assert len(sc) == 0 and len(got) == len(sets)
    assert sc.flush() == []
    return got


@pytest.mark.parametrize("depth", (1, 2, 3))
@pytest.mark.parametrize("mode", MODES)
def test_composer_equals_serial_composite(saved, mode, depth):
    want = _serial(saved["full"], mode)
    got, out_times = _streamed(saved["full"], mode, depth)
    assert len(out_times) == SETS and list(out_times) == sorted(out_times)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (96, 1040, 3)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("mode", MODES)
def test_composer_matches_the_reference_composer(saved, mode):
    ref = _stream(JStreamingComposer(_reference(saved["full"], mode), depth=3),
                  _sets())
    got, _ = _streamed(saved["full"], mode, 3)
    for g, r in zip(got, ref):
        _assert_same("feather" if mode == "blend" else mode, g, r)


@pytest.mark.parametrize("mode", ["lut", "feather"])
def test_device_reduce_skips_the_postprocess(saved, mode, monkeypatch):
    """A device_reduce output is fetched in place of the panorama, distinct
    for distinct inputs, and the mode's postprocess (_fit_frame, which
    feather output takes) is not applied to it."""
    vs = _port(saved["full"], mode)
    want = [int(p[::7, ::11].astype(np.int64).sum())
            for p in _serial(saved["full"], mode)]
    fitted = []
    fit = vs._fit_frame
    monkeypatch.setattr(vs, "_fit_frame",
                        lambda p: fitted.append(p.shape) or fit(p))
    sc = StreamingComposer(
        vs, depth=2,
        device_reduce=lambda o: o[::7, ::11].to(torch.int64).sum())
    got = [int(o) for o in _stream(sc, _sets())]
    assert got == want and len(set(got)) == SETS
    assert fitted == []


@pytest.mark.parametrize("mode", ["lut", "multiband"])
def test_in_flight_frames_finish_on_their_state(saved, mode):
    """A registration loaded while two frame sets are in flight: those two
    come out as the old state's composite(), the later ones as the new
    state's."""
    sets = _sets()
    vs = VideoStitcher(_cfg(compose_mode=mode), device="cpu")
    vs.load_registration(saved["full"])
    old = [vs.composite(f) for f in sets[:2]]
    ref = VideoStitcher(_cfg(compose_mode=mode), device="cpu")
    ref.load_registration(saved["full"])
    ref.load_registration(saved["second"])
    new = [ref.composite(f) for f in sets[2:]]
    assert not np.array_equal(vs.composite(sets[2]), new[0])
    sc = StreamingComposer(vs, depth=3)
    assert sc.submit(sets[0]) is None and sc.submit(sets[1]) is None
    vs.load_registration(saved["second"])
    got = [sc.submit(f) for f in sets[2:]] + sc.flush()
    assert len(got) == SETS and vs.registrations == 2
    for g, w in zip(got, old + new):
        np.testing.assert_array_equal(g, w)


class _Replay:
    """The frame sets of `_sets()`, in order, then the end of the stream."""

    def __init__(self):
        self.i = 0

    def read(self):
        if self.i >= SETS:
            return None
        self.i += 1
        return _sets()[self.i - 1]


@pytest.mark.parametrize("mode", ["lut", "feather"])
def test_run_pipelined_delivers_every_frame_in_order(saved, mode,
                                                     monkeypatch):
    """run(pipeline_depth=3), and cfg.video.pipeline_depth=2 by default,
    deliver every frame set once, in order, bit-identical to
    pipeline_depth=1 (tests/test_video.py:586-611)."""
    depths = []

    class Recording(StreamingComposer):
        def __init__(self, stitcher, depth=3, device_reduce=None):
            depths.append(depth)
            super().__init__(stitcher, depth, device_reduce)

    monkeypatch.setattr(runtime_mod, "StreamingComposer", Recording)

    def collect(depth, **video):
        vs = VideoStitcher(_cfg(compose_mode=mode, **video), device="cpu")
        vs.load_registration(saved["full"])
        got = []
        src = _Replay()
        stats = vs.run(src, on_frame=lambda p, i: got.append((i, p)),
                       pipeline_depth=depth)
        assert stats.frames == SETS and src.i == SETS
        assert [i for i, _ in got] == list(range(SETS))
        return [p for _, p in got]

    serial = collect(1)
    assert depths == []
    for got in (collect(3), collect(None, pipeline_depth=2)):
        for g, w in zip(got, serial):
            np.testing.assert_array_equal(g, w)
    assert depths == [3, 2]
    with pytest.raises(ValueError, match="depth"):
        StreamingComposer(_port(saved["full"], mode), depth=0)


def test_run_pipelined_reregisters_and_delivers_every_frame():
    """run(pipeline_depth=3) with force_reregister() mid-stream: every frame
    set once, in order, the output shape frozen; then numbered frame sets
    each come out as their own serial composite()."""
    vs = VideoStitcher(_slow_cfgs()[1], device="cpu")
    got = []

    def on_frame(pano, i):
        got.append((i, pano.shape))
        if i == 3:
            vs.force_reregister()

    stats = vs.run(ReplaySource(_scene(), max_frames=14), on_frame=on_frame,
                   pipeline_depth=3)
    assert [i for i, _ in got] == list(range(14))
    assert len({s for _, s in got}) == 1 and got[0][1][:2] == vs._out_shape
    assert vs.registrations == 2 and stats.frames == 14
    src = _Frames(6)
    seen = []
    vs.run(src, on_frame=lambda p, i: seen.append((i, p)), pipeline_depth=3)
    assert [i for i, _ in seen] == list(range(6)) and src.i == 6
    for i, pano in seen:
        np.testing.assert_array_equal(pano, vs.composite(_Frames.set(i)))
