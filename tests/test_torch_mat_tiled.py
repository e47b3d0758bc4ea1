"""The port's `mat` and `tiled` seam-select kernels (their plain versions, on
the CPU) against the JAX package's Pallas kernels in interpret mode, bit for
bit, on the reference's own fixture; and `remap_tiled`.

Both port kernels gather four taps a pixel. These tests show that the `mat`
weights are the non-zeros of the reference's band-local hat matrices, and
that the `tiled` arithmetic (x-hats rounded to bfloat16, y-hats float32)
reproduces the reference's matmul, value for value."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stitchingvideo_tpu.ops.pallas import composite as jcomp
from stitchingvideo_tpu.ops.pallas import composite_mat as jmat
from stitchingvideo_tpu.ops.pallas.remap import remap_tiled as j_remap_tiled
from stitchingvideo_tpu_torch.ops import composite as tcomp
from stitchingvideo_tpu_torch.ops import composite_mat as tmat
from stitchingvideo_tpu_torch.ops import composite_mat2 as tmat2
from stitchingvideo_tpu_torch.ops.remap_tiled import remap_tiled
from stitchingvideo_tpu_torch.video.lut import composite_frame_u8

from tests.test_torch_composite import (FRAME_HW, _tile_major, make_state,
                                        torch_lut)

# the fixture's states with no fallback tile; "poisoned" has some
CLEAN = ("rot005", "rot04", "edge")


@functools.lru_cache(maxsize=None)
def port_mat(name: str):
    return tmat.build_mat_lut(torch_lut(make_state(name)[1]), FRAME_HW)


@functools.lru_cache(maxsize=None)
def port_tiled(name: str):
    return tcomp.build_tiled_lut(torch_lut(make_state(name)[1]), FRAME_HW)


def _planar(frames):
    return tmat.frames_to_planar_i8(torch.from_numpy(frames))


@pytest.mark.parametrize("name", CLEAN)
def test_mat_weights_are_the_hat_matrix_nonzeros(name):
    """On every covered pixel the port's global taps and integer weights are
    the non-zeros of the reference's vx/vy (`_mat_chunk`), mapped back
    through the pixel's slot's window origin and band offset; so the
    band-local clip of `_materialize` never engaged."""
    _frames, lut = make_state(name)
    jml = jmat.build_mat_lut(lut, FRAME_HW)
    assert int(jml.n_fallback) == 0
    tl = jcomp.build_tiled_lut(lut, FRAME_HW)
    T = jml.n_tiles
    cam = np.asarray(tl.cidx)[:, 0]
    m = cam >= 0
    ml = port_mat(name)
    f = {k: _tile_major(v.numpy(), tl.grid_hw, tl.pano_hw,
                        -1 if k == "cam" else 0)
         for k, v in ml.fields().items()}
    np.testing.assert_array_equal(f["cam"], cam)
    tcam = np.asarray(jml.tile_cam).reshape(-1, 2)[:T]
    org = np.asarray(jml.tile_org).reshape(-1, 4)[:T]
    band = np.asarray(jml.tile_band).reshape(-1, 2)[:T]
    is_a = cam == tcam[:, 0:1]
    x_org = np.where(is_a, org[:, 1:2] + band[:, 0:1],
                     org[:, 3:4] + band[:, 1:2])
    y_org = np.where(is_a, org[:, 0:1], org[:, 2:3])
    last = 0
    for w, lo, size, vm in (
            ("a", f["x0"] - x_org, jcomp.VXW,
             np.asarray(jml.vx).reshape(-1, jcomp.VXW, jcomp.P)[:T]),
            ("ay", f["y0"] - y_org, jcomp.WIN_H,
             np.asarray(jml.vy).reshape(-1, jcomp.WIN_H, jcomp.P)[:T])):
        wt = f[w]
        assert ((lo >= 0) & (lo < size))[m].all()

        def at(i):
            return np.take_along_axis(
                vm, np.clip(i, 0, size - 1)[:, None, :], axis=1)[:, 0]

        np.testing.assert_array_equal(at(lo)[m], wt[m])
        nxt = m & (lo + 1 < size)
        np.testing.assert_array_equal(at(lo + 1)[nxt], 127 - wt[nxt])
        np.testing.assert_array_equal(vm.sum(axis=1, dtype=np.int32)[m], 127)
        assert (wt[m & ~nxt] == 127).all()
        last += int((m & ~nxt).sum())
    if name == "edge":
        assert last > 0      # taps on a window's last row/column occur
    # gc and the covered pixels' fields are the mat2 state's too
    m2 = tmat2.build_mat2_lut(torch_lut(lut), FRAME_HW)
    kern = ml.tap_cw >= 0
    assert torch.equal(kern, m2.tap_cw >= 0) and torch.equal(ml.gc, m2.gc)
    for k, v in ml.fields().items():
        assert torch.equal(v[kern], m2.fields()[k][kern]), k


@pytest.mark.parametrize("name", CLEAN)
def test_composite_mat_planar_bit_exact(name):
    frames, lut = make_state(name)
    jml = jmat.build_mat_lut(lut, FRAME_HW)
    ref = np.asarray(jmat.composite_mat(jnp.asarray(frames), jml,
                                        interpret=True))
    ml = port_mat(name)
    got = tmat.composite_mat(torch.from_numpy(frames), ml)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    # on a LUT without fallback tiles mat and mat2 are the same function
    m2 = tmat2.build_mat2_lut(torch_lut(lut), FRAME_HW)
    assert torch.equal(got, tmat2.composite_mat2_planar(_planar(frames), m2))


def test_composite_mat_batched_is_the_single_frame_kernel():
    """B=3 distinct frame sets: the batched entry point gives, per frame
    set, the single-frame output (the reference maps the single-frame kernel
    over the batch, `video/runtime.py:663-671`)."""
    frames, _lut = make_state("rot04")
    batch = np.stack([frames, frames[:, ::-1], np.roll(frames, 7, axis=2)])
    planar = _planar(batch)
    ml = port_mat("rot04")
    got = tmat.composite_mat_planar_batched(planar, ml)
    assert got.shape == (3, 3, 64, 1024)
    for b in range(3):
        assert torch.equal(got[b], tmat.composite_mat_planar(planar[b], ml))


@pytest.mark.parametrize("name", CLEAN)
def test_composite_tiled_bit_exact(name):
    frames, lut = make_state(name)
    jtl = jcomp.build_tiled_lut(lut, FRAME_HW)
    ref = np.asarray(jcomp.composite_tiled(jnp.asarray(frames), jtl,
                                           interpret=True))
    got = tcomp.composite_tiled(torch.from_numpy(frames), port_tiled(name))
    assert got.dtype == torch.uint8 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("kernel", ("mat", "tiled"))
def test_kernels_vs_gather_oracle(kernel):
    """The reference's own tolerances against the exact gather
    (tests/test_pallas_composite.py:47-58 for tiled: median <= 1, mean < 1,
    99.9% within 3; tests/test_pallas_mat2.py:24-27 for the int8 weights:
    median <= 1, 99.9% within 4); uncovered pixels are exactly 0."""
    frames, lut = make_state("rot005")
    ft = torch.from_numpy(frames)
    tl = torch_lut(lut)
    ref = composite_frame_u8(ft, tl).numpy().astype(np.int32)
    if kernel == "mat":
        out = tmat.composite_mat(ft, port_mat("rot005")).permute(1, 2, 0)
        within = 4
    else:
        out = tcomp.composite_tiled(ft, port_tiled("rot005"))
        within = 3
    diff = np.abs(out.numpy().astype(np.int32) - ref)
    assert np.median(diff) <= 1 and diff.mean() < 1.0
    assert (diff <= within).mean() > 0.999
    assert (out.numpy()[tl.cam_idx.numpy() < 0] == 0).all()


def test_fallback_tiles_are_refused():
    """Neither kernel has a fallback path (`video/runtime.py:400-402`): the
    build succeeds, as the reference's does, and the composite raises."""
    frames, lut = make_state("poisoned")
    ml = port_mat("poisoned")
    tl = port_tiled("poisoned")
    assert ml.n_fallback == tl.n_fallback > 0
    with pytest.raises(ValueError, match="fallback"):
        tmat.composite_mat_planar(_planar(frames), ml)
    with pytest.raises(ValueError, match="fallback"):
        tmat.composite_mat_planar_batched(_planar(frames)[None], ml)
    with pytest.raises(ValueError, match="fallback"):
        tcomp.composite_tiled(torch.from_numpy(frames), tl)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    frames, _lut = make_state("rot005")
    planar = _planar(frames)
    ml, tl = port_mat("rot005"), port_tiled("rot005")
    u8 = torch.from_numpy(frames).permute(0, 3, 1, 2).contiguous()
    for bad in (planar[:, :, :64], planar[:2], planar.to(torch.int16),
                planar.to("meta")):
        with pytest.raises(ValueError):
            tmat.composite_mat_planar(bad, ml)
    for bad in (u8[:, :, :64], u8[:2], u8.to(torch.int8), u8.to("meta"),
                u8.transpose(2, 3)):
        with pytest.raises(ValueError):
            tcomp.composite_tiled_planar(bad, tl)


def _smooth_map(H, W, ph, pw):
    yy, xx = np.meshgrid(np.arange(ph, dtype=np.float32),
                         np.arange(pw, dtype=np.float32), indexing="ij")
    xmap = 3.0 + xx * (W - 2.0) / pw + 0.03 * yy        # runs past W - 1
    ymap = -2.0 + yy * (H + 1.0) / ph + 0.01 * xx       # starts above 0
    return xmap.astype(np.float32), ymap.astype(np.float32)


def test_remap_tiled_bit_exact():
    """One image through a smooth map with out-of-source pixels and a valid
    mask: the port equals the reference's kernel, and equals its own
    composite_tiled on the one-camera LUT it stands for."""
    rng = np.random.default_rng(5)
    H, W = FRAME_HW
    image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    xmap, ymap = _smooth_map(H, W, 72, 600)
    valid = rng.random(xmap.shape) > 0.05
    ref = j_remap_tiled(jnp.asarray(image), jnp.asarray(xmap),
                        jnp.asarray(ymap), jnp.asarray(valid), interpret=True)
    got = remap_tiled(torch.from_numpy(image), torch.from_numpy(xmap),
                      torch.from_numpy(ymap), torch.from_numpy(valid))
    assert ref is not None and got is not None
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    outside = (xmap > W - 1) | (ymap < 0) | ~valid
    assert outside.any() and (got.numpy()[outside] == 0).all()


@pytest.mark.parametrize("case", ("scrambled", "small"))
def test_remap_tiled_returns_none(case):
    """A map no tile can hold (its pixels scatter over the whole image), or
    an image smaller than the source window, gives None in both packages."""
    rng = np.random.default_rng(6)
    H, W = FRAME_HW if case == "scrambled" else (64, 256)
    image = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    xmap = rng.uniform(0, W - 1, (16, 256)).astype(np.float32)
    ymap = rng.uniform(0, H - 1, (16, 256)).astype(np.float32)
    assert j_remap_tiled(jnp.asarray(image), jnp.asarray(xmap),
                         jnp.asarray(ymap), interpret=True) is None
    assert remap_tiled(torch.from_numpy(image), torch.from_numpy(xmap),
                       torch.from_numpy(ymap)) is None
