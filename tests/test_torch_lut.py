"""The port's composite LUT build and its exact gather oracle against the
JAX package, bit for bit."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stitchingvideo_tpu.models.registration import Registration as JReg
from stitchingvideo_tpu.video import lut as jlut_mod
from stitchingvideo_tpu_torch.models.registration import Registration
from stitchingvideo_tpu_torch.video.lut import (build_lut, composite_frame,
                                                composite_frame_u8)

from tests.test_torch_composite import make_state, torch_lut
from tests.test_torch_registration import FRAME_HW, make_registration_dict

CROP = (11, 107, 10, 1050)     # the runtime's margins for this registration


@pytest.mark.parametrize("crop", (None, CROP))
def test_build_lut_bit_exact(crop):
    d = make_registration_dict(seed=3)
    ref = jlut_mod.build_lut(JReg.from_state_dict(d), crop=crop)
    got = build_lut(Registration.from_state_dict(d, device="cpu"), crop=crop)
    for k in ("cam_idx", "src_x", "src_y", "gain"):
        r = np.asarray(getattr(ref, k))
        g = getattr(got, k).numpy()
        assert g.dtype == r.dtype, k
        np.testing.assert_array_equal(g, r, err_msg=k)
    # all three cameras own pixels
    assert {0, 1, 2} <= set(np.unique(got.cam_idx.numpy()))


def test_build_lut_first_owner_wins():
    d = make_registration_dict(seed=4)
    lut = build_lut(Registration.from_state_dict(d, device="cpu"))
    # canvas columns 330..365 are owned by cameras 0 and 1: camera 0 wins
    cam = lut.cam_idx.numpy()[20:100, 335:360]
    assert (cam == 0).all()


def _gather_cases():
    d = make_registration_dict(seed=5)
    reg_lut = jlut_mod.build_lut(JReg.from_state_dict(d), crop=CROP)
    rng = np.random.default_rng(11)
    frames = rng.integers(0, 256, (3,) + FRAME_HW + (3,), dtype=np.uint8)
    yield frames, reg_lut
    frames, lut = make_state("poisoned")
    yield frames, lut


@pytest.mark.parametrize("case", (0, 1))
def test_composite_frame_matches(case):
    """The plain gather rounds every product and sum on its own; XLA's CPU
    backend contracts some of the reference's multiply-adds into FMAs, so
    ~20% of the float values differ in the last bits (rtol 1e-6) and, after
    rounding to u8, a value can land one step away: at most 1 step, on at
    most 0.01% of the values."""
    frames, jl = list(_gather_cases())[case]
    ref = np.asarray(jlut_mod.composite_frame(jnp.asarray(frames), jl))
    ref_u8 = np.asarray(jlut_mod.composite_frame_u8(jnp.asarray(frames), jl))
    ft = torch.from_numpy(frames)
    tl = torch_lut(jl)
    got = composite_frame(ft, tl).numpy()
    got_u8 = composite_frame_u8(ft, tl).numpy()
    assert got_u8.dtype == np.uint8 and got_u8.shape == ref_u8.shape
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)
    diff = np.abs(got_u8.astype(np.int32) - ref_u8)
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-4, (diff > 0).mean()
    # uncovered pixels are exactly 0 on both sides
    unc = np.asarray(jl.cam_idx) < 0
    assert (got[unc] == 0).all() and (ref[unc] == 0).all()
