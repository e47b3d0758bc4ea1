"""The port's VideoStitcher against the JAX package's, on one saved
registration: the same frames give the same panorama, bit for bit."""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stitchingvideo_tpu.models.registration import Registration as JReg
from stitchingvideo_tpu.ops.pallas.composite_mat import \
    frames_to_planar_i8 as j_frames_to_planar_i8
from stitchingvideo_tpu.video import lut as jlut_mod
from stitchingvideo_tpu.video.runtime import VideoStitcher as JVideoStitcher
from stitchingvideo_tpu_torch import StitchConfig, VideoStitcher
from stitchingvideo_tpu_torch.ops.composite_mat import frames_to_planar_i8
from stitchingvideo_tpu_torch.video.lut import build_lut, composite_frame_u8

from tests.test_torch_composite import torch_lut
from tests.test_torch_registration import FRAME_HW, make_registration_dict


def _save(tmp_path, name, **kw):
    """What the JAX package's save_registration writes."""
    d = JReg.from_state_dict(make_registration_dict(**kw)).state_dict()
    d["frame_hw"] = np.asarray(FRAME_HW, np.int32)
    path = tmp_path / name
    with open(path, "wb") as f:
        np.savez_compressed(f, **d)
    return str(path)


def _frames(seed, n=3):
    rng = np.random.default_rng(seed)
    return list(rng.integers(0, 256, (n,) + FRAME_HW + (3,), dtype=np.uint8))


@functools.lru_cache(maxsize=None)
def _pair(path):
    jvs = JVideoStitcher()
    jvs.load_registration(path)
    assert jvs._tlut is not None and jvs._tlut[0] == "mat2"
    vs = VideoStitcher(device="cpu")
    vs.load_registration(path)
    return jvs, vs


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    d = tmp_path_factory.mktemp("reg")
    return {"full": _save(d, "reg.npz"),
            "subset": _save(d, "subset.npz", src_indices=(0, 2, 3))}


def test_composite_bit_exact(saved):
    jvs, vs = _pair(saved["full"])
    frames = _frames(1)
    ref = jvs.composite(frames)
    got = vs.composite(frames)
    assert got.dtype == np.uint8 and got.shape == ref.shape
    assert got.shape[:2] == vs._out_shape == (96, 1040)
    np.testing.assert_array_equal(got, ref)
    assert vs.registrations == 1
    # composite_planar: the device-tensor entry point, planar output
    planar = vs.composite_planar(torch.from_numpy(np.stack(frames)))
    np.testing.assert_array_equal(planar.permute(1, 2, 0).numpy(), ref)


def test_composite_microbatch_bit_exact(saved):
    jvs, vs = _pair(saved["full"])
    batch = np.stack([np.stack(_frames(s)) for s in (2, 3, 4)])  # [B,N,H,W,3]
    jplanar = jnp.stack([j_frames_to_planar_i8(jnp.asarray(b)) for b in batch])
    ref = np.asarray(jvs.composite_microbatch(jplanar))
    got = vs.composite_microbatch(frames_to_planar_i8(torch.from_numpy(batch)))
    assert got.shape == ref.shape == (3, 3, 96, 1040)
    np.testing.assert_array_equal(got.numpy(), ref)
    for b in range(3):
        np.testing.assert_array_equal(
            got[b].permute(1, 2, 0).numpy(), vs.composite(list(batch[b])))


def test_src_indices_selection(saved):
    """A registration that kept rig cameras (0, 2, 3) of 4 selects them
    from the full rig, as the reference does."""
    jvs, vs = _pair(saved["subset"])
    rig = _frames(5, n=4)
    ref = jvs.composite(rig)
    got = vs.composite(rig)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, vs.composite([rig[0], rig[2], rig[3]]))
    with pytest.raises(ValueError):
        vs.composite(rig[:2])


def test_second_install_keeps_frozen_shape(saved):
    """A larger LUT installed later is cropped to the first one's shape, in
    the port as in the reference."""
    jvs = JVideoStitcher()
    jvs.load_registration(saved["full"])
    vs = VideoStitcher(device="cpu")
    vs.load_registration(saved["full"])
    jreg = JReg.from_state_dict(make_registration_dict(seed=9))
    jbig = jlut_mod.build_lut(jreg)                    # uncropped: 128 x 1088
    assert jbig.cam_idx.shape != vs._out_shape
    jvs.install_lut(jbig, FRAME_HW)
    vs.install_lut(torch_lut(jbig), FRAME_HW)
    assert vs.registrations == 2
    assert vs._lut.shape == vs._out_shape == (96, 1040)
    frames = _frames(6)
    got = vs.composite(frames)
    assert got.shape[:2] == (96, 1040)
    np.testing.assert_array_equal(got, jvs.composite(frames))
    # a LUT whose mat2 state cannot be built (frames smaller than the
    # reference's source window) raises, and the previous state stays live
    with pytest.raises(ValueError, match="window"):
        vs.install_lut(torch_lut(jbig), (64, 256))
    assert vs.registrations == 2 and vs._frame_hw == FRAME_HW
    np.testing.assert_array_equal(vs.composite(frames), got)


def test_gather_kernel_is_the_plain_oracle(saved):
    cfg = StitchConfig()
    cfg = cfg.replace(video=dataclasses.replace(cfg.video, kernel="gather"))
    vs = VideoStitcher(cfg, device="cpu")
    vs.load_registration(saved["full"])
    assert vs._tlut is None
    frames = _frames(7)
    got = vs.composite(frames)
    lut = build_lut(vs._reg, crop=vs._crop_slices(
        vs._reg.canvas_wh[::-1], vs._reg.extent_wh))
    want = composite_frame_u8(torch.from_numpy(np.stack(frames)), lut)
    np.testing.assert_array_equal(got, want.numpy())
    with pytest.raises(RuntimeError):
        vs.composite_microbatch(frames_to_planar_i8(
            torch.from_numpy(np.stack(frames)))[None])


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        VideoStitcher()


def _cfg(**video):
    cfg = StitchConfig()
    return cfg.replace(video=dataclasses.replace(cfg.video, **video))


@pytest.mark.parametrize("cfg", [
    _cfg(kernel="tiled"), _cfg(kernel="mat"), _cfg(compose_mode="feather"),
    _cfg(compose_mode="multiband"),
    StitchConfig().replace(parallel=dataclasses.replace(
        StitchConfig().parallel, canvas_shards=2)),
], ids=["tiled", "mat", "feather", "multiband", "canvas_shards"])
def test_unported_options_raise(cfg):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        VideoStitcher(cfg, device="cpu")


def test_registration_is_a_later_slice():
    vs = VideoStitcher(device="cpu")
    with pytest.raises(NotImplementedError, match="slice 2"):
        vs.register(_frames(8))
    with pytest.raises(NotImplementedError, match="slice 2"):
        vs.run(None)
    with pytest.raises(RuntimeError, match="not registered"):
        vs.composite(_frames(8))
