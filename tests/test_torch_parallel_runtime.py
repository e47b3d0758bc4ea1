"""The port's VideoStitcher over canvas bands against its single-device
self and against the JAX package's VideoStitcher with the same
`canvas_shards` (Pallas kernels in interpret mode over the virtual CPU
devices of tests/conftest.py), on one saved registration
(tests/test_torch_runtime.py's).

In `lut` mode (`kernel='auto'`, the sharded mat2 kernel, and `'mat'`) and in
`feather` mode the sharded panorama equals the single-device one bit for
bit; in `multiband` mode it is held to the reference's gate of its own
sharded path, median 0 and >= 99.9% within 2 (tests/test_parallel.py:
451-454). Against the JAX package, ROADMAP.md section 3's tolerances for
`composite` (`tests/test_torch_runtime.py:_assert_same`). Also: the
sharded micro-batch equals the per-frame path, `run(pipeline_depth=4)`
equals serial `composite()`, the kernel pins follow the reference's rule,
and a failed sharded build raises with the previous state live."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from stitchingvideo_tpu.config import StitchConfig as JStitchConfig
from stitchingvideo_tpu.video.runtime import VideoStitcher as JVideoStitcher
from stitchingvideo_tpu_torch import Registration, StitchConfig, VideoStitcher
from stitchingvideo_tpu_torch.ops.composite_mat import frames_to_planar_i8
from stitchingvideo_tpu_torch.parallel.compose_multiband import \
    ShardedMultiband
from stitchingvideo_tpu_torch.parallel.mesh import Banded, make_mesh

from tests.test_torch_composite import torch_lut
from tests.test_torch_registration import FRAME_HW, make_registration_dict
from tests.test_torch_runtime import _assert_same, _frames, _save

MODES = {"auto": dict(), "mat": dict(kernel="mat"),
         "feather": dict(compose_mode="feather"),
         "multiband": dict(compose_mode="multiband")}
# the sharded state the reference's stitcher holds: (attribute, kind)
SHARDED = {"auto": ("_tlut", "mat2_sharded"), "mat": ("_tlut", "mat_sharded"),
           "feather": ("_ftlut", "fmat_sharded"),
           "multiband": ("_mbtlut_sharded", None)}
# the port's: (attribute, kind of a state cut into canvas bands)
PORT_SHARDED = {"auto": ("_tlut", "mat2"), "mat": ("_tlut", "mat"),
                "feather": ("_ftlut", "fmat"), "multiband": ("_mbtlut", None)}
BANDS = (2, 4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops a frame set: one intra-op thread a worker under
    the suite's six workers (as tests/test_torch_stream.py does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    return _save(tmp_path_factory.mktemp("reg"), "reg.npz")


def _cfg(cls=StitchConfig, shards=1, **video):
    cfg = cls()
    cfg = cfg.replace(video=dataclasses.replace(cfg.video, **video))
    return cfg.replace(parallel=dataclasses.replace(cfg.parallel,
                                                    canvas_shards=shards))


def _sharded_kind(vs, mode):
    attr, kind = SHARDED[mode]
    state = getattr(vs, attr)
    if state is None:
        return None
    return "mb" if kind is None else state[0]


def _port_sharded(vs, mode) -> bool:
    """Whether the port's stitcher holds its mode's state cut into bands."""
    attr, kind = PORT_SHARDED[mode]
    state = getattr(vs, attr)
    if kind is None:
        return isinstance(state[0], ShardedMultiband)
    return state[0] == kind and isinstance(state[1], Banded)


@functools.lru_cache(maxsize=None)
def _port(path, mode, n):
    vs = VideoStitcher(_cfg(shards=n, **MODES[mode]), device="cpu")
    vs.load_registration(path)
    if n > 1:
        assert vs._mesh.shape == {"camera": 1, "canvas": n}
        assert _port_sharded(vs, mode)
    return vs


def _reference(path, mode, n):
    jvs = JVideoStitcher(_cfg(JStitchConfig, shards=n, **MODES[mode]))
    jvs.load_registration(path)
    assert _sharded_kind(jvs, mode) == (SHARDED[mode][1] or "mb")
    return jvs


def assert_multiband_gate(got, want):
    """The reference's gate of its sharded multiband against its single
    device: median 0 and >= 99.9% of values within 2."""
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert np.median(d) == 0 and (d <= 2).mean() >= 0.999, \
        (np.median(d), float((d <= 2).mean()), int(d.max()))


@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("mode", MODES)
def test_sharded_composite(saved, mode, n):
    frames = _frames(50)
    got = _port(saved, mode, n).composite(frames)
    single = _port(saved, mode, 1).composite(frames)
    assert got.shape == single.shape == (96, 1040, 3)
    if mode == "multiband":
        assert_multiband_gate(got, single)
    else:
        np.testing.assert_array_equal(got, single)
    ref = _reference(saved, mode, n).composite(frames)
    _assert_same("mat" if mode == "auto" else mode, got, ref)


@pytest.mark.parametrize("mode", ["auto", "mat", "feather"])
def test_sharded_microbatch_is_per_frame(saved, mode):
    """The micro-batch on a sharded state (one batched launch a band) gives,
    per frame set, the sharded single-frame path and the single-device
    micro-batch."""
    vs = _port(saved, mode, 2)
    batch = np.stack([np.stack(_frames(s)) for s in (51, 52, 53)])
    planar = frames_to_planar_i8(torch.from_numpy(batch))
    got = vs.composite_microbatch(planar)
    assert got.shape == (3, 3, 96, 1040)
    for b in range(3):
        np.testing.assert_array_equal(got[b].permute(1, 2, 0).numpy(),
                                      vs.composite(list(batch[b])))
    assert torch.equal(got, _port(saved, mode, 1).composite_microbatch(planar))


class _Replay:
    def __init__(self, sets):
        self.sets, self.i = sets, 0

    def read(self):
        if self.i >= len(self.sets):
            return None
        self.i += 1
        return self.sets[self.i - 1]


@pytest.mark.parametrize("mode", ["auto", "multiband"])
def test_sharded_run_pipelined(saved, mode):
    """run(pipeline_depth=4) on a sharded stitcher delivers every frame set
    once, in order, equal to the serial composite()."""
    vs = _port(saved, mode, 2)
    sets = [_frames(60 + k) for k in range(6)]
    got = []
    vs.run(_Replay(sets), on_frame=lambda p, i: got.append((i, p)),
           pipeline_depth=4)
    assert [i for i, _ in got] == list(range(6))
    for (_i, pano), f in zip(got, sets):
        np.testing.assert_array_equal(pano, vs.composite(f))


def test_kernel_pins_with_a_mesh(saved):
    """The reference's rule: 'tiled' shards the mat kernel, 'gather' stays
    on one device; and an explicit mesh that lists the CPU twice."""
    vs = VideoStitcher(_cfg(shards=2, kernel="tiled"), device="cpu")
    vs.load_registration(saved)
    assert _port_sharded(vs, "mat")
    frames = _frames(54)
    np.testing.assert_array_equal(
        vs.composite(frames), _port(saved, "mat", 2).composite(frames))
    vs = VideoStitcher(_cfg(shards=2, kernel="gather"), device="cpu")
    vs.load_registration(saved)
    assert vs._tlut is None
    mesh = make_mesh(canvas=2, devices=["cpu", "cpu"])
    vs = VideoStitcher(_cfg(), mesh=mesh)
    assert vs.device == torch.device("cpu") and vs._mesh is mesh
    vs.load_registration(saved)
    assert _port_sharded(vs, "auto")
    np.testing.assert_array_equal(vs.composite(frames),
                                  _port(saved, "auto", 1).composite(frames))


@pytest.mark.parametrize("mode", ["auto", "multiband"])
def test_failed_sharded_build_raises_and_keeps_the_state(saved, mode):
    """A sharded state that cannot be built (frames smaller than the source
    window) raises, and the previous state stays live (the reference
    demotes to single-device or to its full blend instead: ROADMAP.md
    section 3)."""
    vs = VideoStitcher(_cfg(shards=2, **MODES[mode]), device="cpu")
    vs.load_registration(saved)
    frames = _frames(55)
    before = vs.composite(frames)
    d = make_registration_dict()
    reg = Registration.from_state_dict(d, device="cpu")
    with pytest.raises(ValueError, match="window"):
        vs.install_lut(torch_lut(_reference_lut(d)), (64, 256), reg=reg)
    assert vs.registrations == 1 and vs._frame_hw == FRAME_HW
    np.testing.assert_array_equal(vs.composite(frames), before)


def _reference_lut(d):
    from stitchingvideo_tpu.models.registration import Registration as JReg
    from stitchingvideo_tpu.video import lut as jlut_mod
    return jlut_mod.build_lut(JReg.from_state_dict(d))


def test_mat_with_fallback_tiles_raises_on_a_mesh(saved):
    """As on one device, the sharded mat kernel refuses a LUT with fallback
    tiles and the previous state stays live."""
    import jax.numpy as jnp
    jl = _reference_lut(make_registration_dict())
    cam = np.array(jl.cam_idx)
    cam[40:44, 500:510], cam[40:44, 510:520] = 0, 2    # a 3-camera tile
    vs = VideoStitcher(_cfg(shards=2, kernel="mat"), device="cpu")
    vs.install_lut(torch_lut(jl), FRAME_HW)
    with pytest.raises(ValueError, match="fallback tiles.*'mat2'"):
        vs.install_lut(torch_lut(jl.replace(cam_idx=jnp.asarray(cam))),
                       FRAME_HW)
    assert _port_sharded(vs, "mat") and vs.registrations == 1
