"""The port's VideoStitcher against the JAX package's, on one saved
registration: the same frames give the same panorama, bit for bit, in the
seam-select mode with each of its kernels (mat2, mat, tiled) and in the
feather mode; in the multiband mode within a stated tolerance."""
import dataclasses
import functools
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stitchingvideo_tpu.config import StitchConfig as JStitchConfig
from stitchingvideo_tpu.models.registration import Registration as JReg
from stitchingvideo_tpu.ops.pallas.composite_mat import \
    frames_to_planar_i8 as j_frames_to_planar_i8
from stitchingvideo_tpu.video import lut as jlut_mod
from stitchingvideo_tpu.video.runtime import VideoStitcher as JVideoStitcher
from stitchingvideo_tpu_torch import Registration, StitchConfig, VideoStitcher
from stitchingvideo_tpu_torch.blend.multiband_video import (
    multiband_video_frame, multiband_video_frames_batched)
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


def _cfg(cls=StitchConfig, **video):
    cfg = cls()
    return cfg.replace(video=dataclasses.replace(cfg.video, **video))


@pytest.mark.parametrize("mode", ["lut", "feather", "multiband"])
def test_unported_options_raise(mode):
    """Canvas sharding is not ported, in any mode."""
    cfg = _cfg(compose_mode=mode)
    cfg = cfg.replace(parallel=dataclasses.replace(cfg.parallel,
                                                   canvas_shards=2))
    with pytest.raises(NotImplementedError, match="ROADMAP.*item 22"):
        VideoStitcher(cfg, device="cpu")


@pytest.mark.parametrize("video", [dict(kernel="mat3"),
                                   dict(compose_mode="blend")])
def test_unknown_options_raise(video):
    with pytest.raises(ValueError, match="unknown"):
        VideoStitcher(_cfg(**video), device="cpu")


# -- the other kernels and the feather mode ---------------------------------

MODES = {"mat": dict(kernel="mat"), "tiled": dict(kernel="tiled"),
         "feather": dict(compose_mode="feather"),
         "multiband": dict(compose_mode="multiband")}
# the state each side must hold: (attribute, kind); the multiband state is
# (MultibandVideoState, crop_yx) on both sides
STATE = {"mat": ("_tlut", "mat"), "tiled": ("_tlut", "tiled"),
         "feather": ("_ftlut", "fmat"), "multiband": ("_mbtlut", "mb")}


def _assert_same(mode, got, ref):
    """mat and tiled: bit for bit. feather: XLA's CPU backend does not keep
    the kernel's float tail `slot_val * gw + 128 * (gw0 + gw1)` rounded step
    by step (composite_feather.py:413-426), so where the tail lands on a
    rounding tie the reference can be one uint8 step away: measured 1 value
    of 299,520 here; the bound is <= 1 step on <= 0.01% of values.
    multiband: the warp stage is bit-exact and the bfloat16 pyramids round
    where the reference's do, but the float32 sums of the mask pyramid, the
    canvas collapse and the last multiply-add are taken in another order, so
    a value on a rounding tie can come out one step away: the bound is
    median 0, <= 1 step on <= 1% of values, none above 2 (measured in
    tests/test_torch_multiband.py: 2 values of 599,040 one step away)."""
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    if mode == "multiband":
        assert np.median(diff) == 0 and diff.max() <= 2, diff.max()
        assert (diff > 0).mean() <= 0.01 and (diff > 1).sum() == 0, \
            ((diff > 0).mean(), (diff > 1).sum())
        return
    if mode != "feather":
        np.testing.assert_array_equal(got, ref)
        return
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, \
        (diff.max(), (diff > 0).mean())


def _kind(vs, mode):
    attr, _ = STATE[mode]
    state = getattr(vs, attr)
    if state is None:
        return None
    return "mb" if mode == "multiband" else state[0]


@functools.lru_cache(maxsize=None)
def _mode_pair(path, mode):
    """(JAX VideoStitcher, port VideoStitcher) in one mode, on one saved
    registration; both must hold the mode's kernel state, not a demotion."""
    jvs = JVideoStitcher(_cfg(JStitchConfig, **MODES[mode]))
    jvs.load_registration(path)
    assert _kind(jvs, mode) == STATE[mode][1]
    vs = VideoStitcher(_cfg(**MODES[mode]), device="cpu")
    vs.load_registration(path)
    assert _kind(vs, mode) == STATE[mode][1]
    return jvs, vs


@pytest.mark.parametrize("mode", MODES)
def test_modes_composite_bit_exact(saved, mode):
    jvs, vs = _mode_pair(saved["full"], mode)
    frames = _frames(11)
    ref = jvs.composite(frames)
    got = vs.composite(frames)
    assert got.dtype == np.uint8 and got.shape == ref.shape == (96, 1040, 3)
    _assert_same(mode, got, ref)
    # the device-tensor entry point of the mode, planar output
    batch = torch.from_numpy(np.stack(frames))
    if mode == "feather":
        planar = vs.composite_feather_planar(batch)
    elif mode == "multiband":
        st, crop_yx = vs._mbtlut
        planar = multiband_video_frame(frames_to_planar_i8(batch), st,
                                       crop_yx=crop_yx)
    else:
        planar = vs.composite_planar(batch)
    np.testing.assert_array_equal(planar.permute(1, 2, 0).numpy(), got)


@pytest.mark.parametrize("mode", ["mat", "feather"])
def test_modes_microbatch_bit_exact(saved, mode):
    jvs, vs = _mode_pair(saved["full"], mode)
    batch = np.stack([np.stack(_frames(s)) for s in (12, 13)])
    jplanar = jnp.stack([j_frames_to_planar_i8(jnp.asarray(b)) for b in batch])
    ref = np.asarray(jvs.composite_microbatch(jplanar))
    got = vs.composite_microbatch(frames_to_planar_i8(torch.from_numpy(batch)))
    assert got.shape == ref.shape == (2, 3, 96, 1040)
    _assert_same(mode, got.numpy(), ref)
    for b in range(2):
        np.testing.assert_array_equal(
            got[b].permute(1, 2, 0).numpy(), vs.composite(list(batch[b])))


def test_tiled_has_no_microbatch(saved):
    """As in the reference, the on-the-fly kernel serves single frame sets."""
    jvs, vs = _mode_pair(saved["full"], "tiled")
    planar = frames_to_planar_i8(torch.from_numpy(np.stack(_frames(14))))[None]
    with pytest.raises(RuntimeError):
        vs.composite_microbatch(planar)
    with pytest.raises(RuntimeError):
        jvs.composite_microbatch(jnp.asarray(planar.numpy()))


@pytest.mark.parametrize("mode", MODES)
def test_modes_src_indices_selection(saved, mode):
    jvs, vs = _mode_pair(saved["subset"], mode)
    rig = _frames(15, n=4)
    got = vs.composite(rig)
    _assert_same(mode, got, jvs.composite(rig))
    np.testing.assert_array_equal(got, vs.composite([rig[0], rig[2], rig[3]]))
    with pytest.raises(ValueError):
        vs.composite(rig[:2])


@pytest.mark.parametrize("mode", MODES)
def test_modes_second_install_keeps_frozen_shape(saved, mode):
    """A second, larger registration is fitted to the first one's output
    shape, kernel state included, in the port as in the reference."""
    jvs = JVideoStitcher(_cfg(JStitchConfig, **MODES[mode]))
    jvs.load_registration(saved["full"])
    vs = VideoStitcher(_cfg(**MODES[mode]), device="cpu")
    vs.load_registration(saved["full"])
    d = make_registration_dict(seed=9)
    jreg = JReg.from_state_dict(d)
    jbig = jlut_mod.build_lut(jreg)                    # uncropped: 128 x 1088
    jvs.install_lut(jbig, FRAME_HW, reg=jreg)
    vs.install_lut(torch_lut(jbig), FRAME_HW,
                   reg=Registration.from_state_dict(d, device="cpu"))
    assert vs.registrations == 2 and vs._out_shape == (96, 1040)
    assert _kind(jvs, mode) == _kind(vs, mode) == STATE[mode][1]
    frames = _frames(16)
    got = vs.composite(frames)
    assert got.shape[:2] == (96, 1040)
    _assert_same(mode, got, jvs.composite(frames))
    # a state that cannot be built raises, and the previous one stays live
    with pytest.raises(ValueError, match="window"):
        vs.install_lut(torch_lut(jbig), (64, 256),
                       reg=Registration.from_state_dict(d, device="cpu"))
    assert vs.registrations == 2 and vs._frame_hw == FRAME_HW
    np.testing.assert_array_equal(vs.composite(frames), got)


@pytest.mark.parametrize("kernel", ["mat", "tiled"])
def test_fallback_tiles_demote_to_the_gather(saved, kernel):
    """Neither kernel has a fallback path. On a LUT with fallback tiles the
    reference quietly demotes to its plain gather; the port refuses the
    install instead, names the kernels that take such a LUT, and keeps the
    previous state live."""
    d = make_registration_dict()
    jlut = jlut_mod.build_lut(JReg.from_state_dict(d))
    cam = np.array(jlut.cam_idx)
    cam[40:44, 500:510], cam[40:44, 510:520] = 0, 2    # a 3-camera tile
    jbad = jlut.replace(cam_idx=jnp.asarray(cam))
    jvs = JVideoStitcher(_cfg(JStitchConfig, kernel=kernel))
    jvs.install_lut(jbad, FRAME_HW)
    assert jvs._tlut is None
    vs = VideoStitcher(_cfg(kernel=kernel), device="cpu")
    vs.install_lut(torch_lut(jlut), FRAME_HW)
    frames = _frames(17)
    before = vs.composite(frames)
    with pytest.raises(ValueError, match="fallback tiles.*'mat2'.*'gather'"):
        vs.install_lut(torch_lut(jbad), FRAME_HW)
    assert vs.registrations == 1 and vs._tlut[0] == kernel
    np.testing.assert_array_equal(vs.composite(frames), before)
    # a fresh stitcher that was refused holds no state at all
    vs = VideoStitcher(_cfg(kernel=kernel), device="cpu")
    with pytest.raises(ValueError, match="fallback tiles"):
        vs.install_lut(torch_lut(jbad), FRAME_HW)
    with pytest.raises(RuntimeError, match="not registered"):
        vs.composite(frames)
    # the kernels the message names take the same LUT: 'gather' composes it
    # as the reference's gather does, to the tolerance test_torch_lut.py
    # states for the plain gather (XLA's CPU backend contracts multiply-adds:
    # <= 1 step on <= 0.01% of values; measured 1 of 417,792 here); 'mat2'
    # (7-bit weights) within the reference's own gate against that gather
    # (tests/test_pallas_mat2.py: median <= 1, 99.9% within 4 steps)
    ref = jvs.composite(frames)
    vs = VideoStitcher(_cfg(kernel="gather"), device="cpu")
    vs.install_lut(torch_lut(jbad), FRAME_HW)
    diff = np.abs(vs.composite(frames).astype(np.int16) - ref)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    vs = VideoStitcher(_cfg(kernel="mat2"), device="cpu")
    vs.install_lut(torch_lut(jbad), FRAME_HW)
    diff = np.abs(vs.composite(frames).astype(np.int16) - ref)
    assert np.median(diff) <= 1 and (diff <= 4).mean() > 0.999


def test_multiband_batches_outside_the_stitcher(saved):
    """As in the reference, `composite_microbatch` refuses the multiband
    mode, and `multiband_video_frames_batched` on the stitcher's state is
    the batched entry point: per frame set what `composite` gives."""
    jvs, vs = _mode_pair(saved["full"], "multiband")
    assert vs._tlut is None and jvs._tlut is None    # no seam-select state
    batch = np.stack([np.stack(_frames(s)) for s in (19, 20)])
    planar = frames_to_planar_i8(torch.from_numpy(batch))
    with pytest.raises(RuntimeError, match="multiband"):
        vs.composite_microbatch(planar)
    with pytest.raises(RuntimeError, match="multiband"):
        jvs.composite_microbatch(jnp.asarray(planar.numpy()))
    st, crop_yx = vs._mbtlut
    got = multiband_video_frames_batched(planar, st, crop_yx=crop_yx)
    assert got.shape == (2, 3, 96, 1040)
    for b in range(2):
        np.testing.assert_array_equal(
            got[b].permute(1, 2, 0).numpy(), vs.composite(list(batch[b])))
    # the public rebuild swaps in an equal state and the path stays live
    assert vs.build_multiband_state(FRAME_HW) is True
    assert vs._mbtlut[0] is not st
    np.testing.assert_array_equal(vs.composite(list(batch[0])),
                                  got[0].permute(1, 2, 0).numpy())


def test_multiband_second_load_rebuilds_the_state(saved):
    """A second `load_registration` rebuilds the cached state with the
    registration it came from, the output shape stays frozen and the path
    stays live (the reference's re-registration test, without `register`)."""
    vs = VideoStitcher(_cfg(compose_mode="multiband"), device="cpu")
    vs.load_registration(saved["full"])
    st, reg = vs._mbtlut[0], vs._mbtlut_reg
    frames = _frames(21)
    first = vs.composite(frames)
    assert first.shape == (96, 1040, 3) and (first.sum(-1) > 0).mean() > 0.9
    vs.load_registration(saved["full"])
    assert vs.registrations == 2 and vs._out_shape == (96, 1040)
    assert vs._mbtlut[0] is not st and vs._mbtlut_reg is not reg
    assert vs._mbtlut_reg is vs._reg
    np.testing.assert_array_equal(vs.composite(frames), first)


def test_multiband_needs_a_registration():
    """Multiband with no registration has no cached state; the full blend
    the reference falls back to is not ported, so the hot path raises."""
    vs = VideoStitcher(_cfg(compose_mode="multiband"), device="cpu")
    assert vs.build_multiband_state(FRAME_HW) is False
    lut = build_lut(Registration.from_state_dict(make_registration_dict(),
                                                 device="cpu"))
    vs.install_lut(lut, FRAME_HW)
    assert vs._tlut is None and vs._mbtlut is None
    with pytest.raises(RuntimeError, match="multiband.*item 19"):
        vs.composite(_frames(18))


def test_feather_needs_a_registration(saved):
    """Feather with no registration has no kernel state; the full blend it
    would fall back to is not ported, so the hot path raises."""
    vs = VideoStitcher(_cfg(compose_mode="feather"), device="cpu")
    lut = build_lut(Registration.from_state_dict(make_registration_dict(),
                                                 device="cpu"))
    vs.install_lut(lut, FRAME_HW)
    assert vs._tlut is None and vs._ftlut is None
    batch = torch.from_numpy(np.stack(_frames(18)))
    for call in (lambda: vs.composite(_frames(18)),
                 lambda: vs.composite_feather_planar(batch),
                 lambda: vs.composite_microbatch(
                     frames_to_planar_i8(batch)[None])):
        with pytest.raises(RuntimeError, match="feather"):
            call()


def test_registration_is_a_later_slice():
    vs = VideoStitcher(device="cpu")
    with pytest.raises(NotImplementedError, match="items 13-15"):
        vs.register(_frames(8))
    with pytest.raises(NotImplementedError, match="item 15"):
        vs.run(None)
    with pytest.raises(RuntimeError, match="not registered"):
        vs.composite(_frames(8))


@pytest.mark.parametrize("mode", ["feather", "multiband"])
def test_composite_is_served_during_a_state_build(saved, mode, monkeypatch):
    """A feather or multiband state builds outside the lock that
    composite() takes: while a new build waits, composite() on another
    thread returns the previous state's output; released, the new state is
    live."""
    cfg = _cfg(**MODES[mode])
    vs = VideoStitcher(cfg, device="cpu")
    vs.load_registration(saved["full"])
    frames = _frames(21)
    before = vs.composite(frames)
    reg = Registration.from_state_dict(make_registration_dict(seed=9),
                                       device="cpu")
    lut = build_lut(reg)
    ref = VideoStitcher(cfg, device="cpu")      # the same two installs
    ref.load_registration(saved["full"])
    ref.install_lut(lut, FRAME_HW, reg=reg)
    want = ref.composite(frames)
    assert not np.array_equal(want, before)

    started, release = threading.Event(), threading.Event()
    name = "_build_feather" if mode == "feather" else "_build_multiband"
    build = getattr(VideoStitcher, name)

    def waiting_build(self, *args):
        started.set()
        assert release.wait(60)
        return build(self, *args)

    monkeypatch.setattr(VideoStitcher, name, waiting_build)
    errors, served = [], []

    def install():
        try:
            vs.install_lut(lut, FRAME_HW, reg=reg)
        except Exception as e:          # surfaced by the assert below
            errors.append(e)

    installer = threading.Thread(target=install)
    installer.start()
    try:
        assert started.wait(30)
        reader = threading.Thread(
            target=lambda: served.append(vs.composite(frames)))
        reader.start()
        reader.join(timeout=30)
        assert not reader.is_alive(), "composite() waited for the build"
        np.testing.assert_array_equal(served[0], before)
    finally:
        release.set()
        installer.join(timeout=60)
    assert not installer.is_alive() and not errors, errors
    assert vs.registrations == 2
    assert (vs._ftlut_reg if mode == "feather" else vs._mbtlut_reg) is reg
    np.testing.assert_array_equal(vs.composite(frames), want)
