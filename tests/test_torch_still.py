"""The port's still path and the runtime's full blend against the JAX
package's, on the CPU (`stitchingvideo_tpu_torch/models/stitcher.py`
`stitch`, `compose_panorama`, `_remap_gain_batch`, `_blend_on_canvas`;
`video/runtime.py` `_composite_blend`).

Stated tolerances (each the reference's own kernel gate, median <= 1 and
>= 99.9% of values within 4, unless said):
  - `Stitcher.stitch` from the frames (tests/test_torch_stitcher.py's
    3 x 384x288 scene, the JAX package's RANSAC draws handed to the port,
    focals 2.3e-5 apart): the same kept cameras and panorama shape, masks
    apart on <= 0.5% of pixels; measured with `faithful=True` max 2 steps
    on 0.29% of values, masks equal; with `faithful=False` max 9 steps,
    99.991% within 4, masks equal;
  - `compose_panorama` from identical cameras, blend multiband / feather /
    no: masks equal (measured max 1 step on <= 1.9e-5 of values);
  - `VideoStitcher.composite` through the full blend on a saved
    registration, feather and multiband: within one step on <= 0.01% of
    values, the output shape of the mode's kernel state (measured: feather
    equal, multiband 2 values one step away); against the port's own
    kernel state, the reference's gates (tests/test_pallas_feather.py,
    tests/test_multiband_video.py): median <= 1 and > 99% within 4
    (feather) or 6 (multiband).
"""
import dataclasses

import numpy as np
import pytest

from stitchingvideo_tpu.config import StitchConfig as JStitchConfig
from stitchingvideo_tpu.models import stitcher as jst
from stitchingvideo_tpu.video.runtime import VideoStitcher as JVideoStitcher
from stitchingvideo_tpu_torch import Registration, VideoStitcher
from stitchingvideo_tpu_torch.models import stitcher
from stitchingvideo_tpu_torch.video.lut import build_lut

from tests.test_torch_register import _jax_draws
from tests.test_torch_registration import FRAME_HW, make_registration_dict
from tests.test_torch_runtime import _cfg, _frames, _save
from tests.test_torch_stitcher import (_cfgs, _given_cameras, _reference,
                                       _views)


def _gate(got, want, mask=None, wmask=None, mask_share=0.0):
    assert got.dtype == np.uint8 and got.shape == want.shape
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert np.median(d) <= 1 and (d <= 4).mean() >= 0.999, \
        (np.median(d), (d <= 4).mean(), d.max())
    if mask is not None:
        assert mask.dtype == bool
        assert (mask != wmask).mean() <= mask_share
        # the reference's own gates (tests/test_stitcher.py:47-59)
        assert mask.mean() > 0.5 and got[mask].mean() > 30


@pytest.mark.parametrize("faithful", [True, False])
def test_stitch_matches_the_reference(faithful, monkeypatch):
    jcfg, cfg = _cfgs(faithful=faithful)
    views = _views()
    _jax_draws(monkeypatch, 0, 64, running=False)
    jstitch = jst.Stitcher(jcfg)
    want, wmask = jstitch.stitch(views)
    st = stitcher.Stitcher(cfg, device="cpu")
    got, mask = st.stitch(views)
    assert st.component() == jstitch.component() == [0, 1, 2]
    assert st.work_scale() == jstitch.work_scale()
    assert got.shape[1] > 600
    _gate(got, want, mask, wmask, mask_share=5e-3)


@pytest.fixture(scope="module")
def registrations():
    """Both stitchers' registrations of the scene from the JAX package's
    cameras: ((JAX reg, result, scale), (port reg, result, scale))."""
    jres = _reference()[1]
    with pytest.MonkeyPatch.context() as mp:
        _given_cameras(mp, jres)
        jcfg, cfg = _cfgs()
        want = jst.Stitcher(jcfg).estimate_transform(_views())
        got = stitcher.Stitcher(cfg, device="cpu").estimate_transform(
            _views())
    return want, got


@pytest.mark.parametrize("blend", ["multiband", "feather", "no"])
def test_compose_panorama_matches(registrations, blend):
    jcfg, cfg = _cfgs(blend_type=blend)
    (jreg, jres, jscale), (reg, res, scale) = registrations
    want, wmask = jst.Stitcher(jcfg).compose_panorama(_views(), jreg, jres,
                                                      jscale)
    got, mask = stitcher.Stitcher(cfg, device="cpu").compose_panorama(
        _views(), reg, res, scale)
    CW, CH = reg.canvas_wh
    assert got.shape == (CH, CW, 3)
    _gate(got, want, mask, wmask)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    return _save(tmp_path_factory.mktemp("reg"), "reg.npz")


def _switched(vs, mode):
    """The stitcher in compose_mode `mode` with the registration it holds
    and no state built for the mode."""
    vs.cfg = vs.cfg.replace(video=dataclasses.replace(vs.cfg.video,
                                                      compose_mode=mode))
    return vs


@pytest.mark.parametrize("mode", ["feather", "multiband"])
def test_full_blend_matches_the_reference(saved, mode):
    """A registration installed in 'lut' mode, then the mode switched (the
    reference's tests/test_video.py:271-274 switch, the other way): no
    state is built for it, so composite() serves the full blend."""
    jvs = JVideoStitcher(_cfg(JStitchConfig))
    jvs.load_registration(saved)
    vs = VideoStitcher(_cfg(), device="cpu")
    vs.load_registration(saved)
    _switched(jvs, mode)
    _switched(vs, mode)
    assert vs._ftlut is None and vs._mbtlut is None
    frames = _frames(31)
    want = jvs.composite(frames)
    got = vs.composite(frames)
    assert got.shape == want.shape == (96, 1040, 3)
    d = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert d.max() <= 1 and (d > 0).mean() <= 1e-4, (d.max(), (d > 0).mean())
    np.testing.assert_array_equal(vs._composite_blend(frames, mode), got)
    # the mode's kernel state on the same registration: same shape, within
    # the reference's gates of the full blend
    hot = VideoStitcher(_cfg(compose_mode=mode), device="cpu")
    hot.load_registration(saved)
    pano_hot = hot.composite(frames)
    assert pano_hot.shape == got.shape
    cov = (got.sum(-1) > 0) & (pano_hot.sum(-1) > 0)
    d = np.abs(pano_hot.astype(np.int16) - got.astype(np.int16))[cov]
    within = 4 if mode == "feather" else 6
    assert np.median(d) <= 1 and (d <= within).mean() > 0.99


@pytest.mark.parametrize("mode", ["feather", "multiband"])
def test_a_failed_state_build_raises(saved, mode, monkeypatch):
    """A feather or multiband state build that fails raises and leaves the
    previous state live; with no previous registration nothing is
    installed, and composite() raises rather than serving the full blend."""
    name = "_build_feather" if mode == "feather" else "_build_multiband"
    vs = VideoStitcher(_cfg(compose_mode=mode), device="cpu")
    vs.load_registration(saved)
    frames = _frames(32)
    before = vs.composite(frames)
    state = (vs._ftlut, vs._mbtlut)

    def failing(*args):
        raise MemoryError("state build failed")

    monkeypatch.setattr(VideoStitcher, name, failing)
    reg = Registration.from_state_dict(make_registration_dict(seed=9),
                                       device="cpu")
    with pytest.raises(MemoryError):
        vs.install_lut(build_lut(reg), FRAME_HW, reg=reg)
    assert (vs._ftlut, vs._mbtlut) == state and vs.registrations == 1
    np.testing.assert_array_equal(vs.composite(frames), before)
    fresh = VideoStitcher(_cfg(compose_mode=mode), device="cpu")
    with pytest.raises(MemoryError):
        fresh.load_registration(saved)
    assert fresh._reg is None and fresh.registrations == 0
    with pytest.raises(RuntimeError, match="not registered"):
        fresh.composite(frames)
