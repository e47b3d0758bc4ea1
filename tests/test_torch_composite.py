"""The port's tile build, mat2 state and mat2 composite against the JAX
package (Pallas kernels in interpret mode on the CPU), bit for bit.

The port's kernel is a direct 4-tap gather with per-pixel integer weights;
these tests show that on the reference's own fixture those weights are the
non-zeros of the reference's hat matrices, and that the composite it gives,
single and micro-batched, fallback tiles included, is the reference's."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stitchingvideo_tpu.ops.pallas import composite as jcomp
from stitchingvideo_tpu.ops.pallas import composite_mat2 as jmat2
from stitchingvideo_tpu.ops.pallas.composite_mat import \
    frames_to_planar_i8 as j_frames_to_planar_i8
from stitchingvideo_tpu.video.lut import CompositeLUT as JLUT
from stitchingvideo_tpu.video.lut import composite_frame_u8 as j_gather_u8
from stitchingvideo_tpu_torch.ops import composite_mat2 as tmat2
from stitchingvideo_tpu_torch.ops.composite import build_tiled_lut
from stitchingvideo_tpu_torch.ops.composite_mat import frames_to_planar_i8
from stitchingvideo_tpu_torch.video.lut import CompositeLUT, composite_frame_u8

from tests.test_pallas_composite import _make_state

FRAME_HW = (128, 512)
STATES = ("rot005", "rot04", "easy", "poisoned", "edge")


@functools.lru_cache(maxsize=None)
def make_state(name: str):
    """(frames [N,H,W,3] u8 numpy, JAX CompositeLUT) from a numpy seed."""
    rng = np.random.default_rng(STATES.index(name))
    kw = {"rot005": {}, "rot04": dict(rot=0.4), "easy": dict(ph=512),
          "poisoned": {}, "edge": {}}[name]
    frames, lut = _make_state(rng, **kw)
    cam = np.array(lut.cam_idx)
    sx, sy = np.array(lut.src_x), np.array(lut.src_y)
    if name == "poisoned":
        # 3-camera tiles (test_pallas_mat2.py): the fallback overlay is live
        cam[4:6, 200:210] = 1
        cam[4:6, 210:220] = 2
        cam[40:44, 980:990] = 0
        cam[40:44, 990:1000] = 1
    if name == "edge":
        # taps on the frame's last column and row, and integer coordinates:
        # fx == 0 must give a == 127 with a zero-weight tap past the frame
        fh, fw = FRAME_HW
        sx[sx > fw - 12] = fw - 1.0
        sy[-1, :] = fh - 1.0
        sx[:, ::7] = np.floor(sx[:, ::7])
        sy[::3, :] = np.floor(sy[::3, :])
        # coordinates in (0, 1) whose f32 weight 127 * (1 - fx) is exactly
        # 30.5 / 48.5: round half to EVEN gives 30 / 48
        sx[sx < 12] = np.float32(0.7598425149917603)
        sy[sy < 9] = np.float32(0.6181102395057678)
    lut = JLUT(cam_idx=jnp.asarray(cam), src_x=jnp.asarray(sx),
               src_y=jnp.asarray(sy), gain=lut.gain)
    return np.array(frames), lut


def torch_lut(jlut) -> CompositeLUT:
    return CompositeLUT(*(torch.from_numpy(np.array(getattr(jlut, k)))
                          for k in ("cam_idx", "src_x", "src_y", "gain")))


@functools.lru_cache(maxsize=None)
def jax_mat2(name: str):
    """The reference's mat2 LUT and its single-frame composite [3, Hp, Wp]."""
    frames, lut = make_state(name)
    ml = jmat2.build_mat2_lut(lut, FRAME_HW)
    out = jmat2.composite_mat2_planar(
        j_frames_to_planar_i8(jnp.asarray(frames)), ml, interpret=True)
    return ml, np.asarray(out)


@functools.lru_cache(maxsize=None)
def port_mat2(name: str):
    frames, lut = make_state(name)
    return tmat2.build_mat2_lut(torch_lut(lut), FRAME_HW)


@pytest.mark.parametrize("name", STATES)
def test_build_tiled_lut_bit_exact(name):
    _frames, lut = make_state(name)
    ref = jcomp.build_tiled_lut(lut, FRAME_HW)
    got = build_tiled_lut(torch_lut(lut), FRAME_HW)
    for k in ("tile_cam", "tile_org", "tile_band", "fallback"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    for k in ("sx", "sy", "gain", "cidx"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k))[:, 0], k)
    assert got.n_fallback == int(ref.n_fallback)
    assert (got.grid_hw, got.pano_hw, got.frame_hw) == \
        (ref.grid_hw, ref.pano_hw, ref.frame_hw)
    assert (got.n_fallback > 0) == (name == "poisoned")


def _tile_major(a, grid_hw, pano_hw, fill):
    """[Hp*Wp] panorama row-major -> [T, P] tile-major, padded with fill."""
    nty, ntx = grid_hw
    Hp, Wp = pano_hw
    full = np.full((nty * jcomp.TILE_H, ntx * jcomp.TILE_W), fill, a.dtype)
    full[:Hp, :Wp] = a.reshape(Hp, Wp)
    return full.reshape(nty, jcomp.TILE_H, ntx, jcomp.TILE_W) \
        .transpose(0, 2, 1, 3).reshape(nty * ntx, jcomp.P)


def assert_hat_matrix_nonzeros(ml, tl, f, name=""):
    """On every covered pixel of a non-fallback tile in the reference's two
    classes (`ml`, built over the reference's TiledLUT `tl`), the port's
    global taps and integer weights (`f`: tile-major unpacked fields) are the
    non-zeros of the reference's vx/vy (`_mat_chunk_h`), mapped back through
    tile_org/tile_band and the class's window origin, including the
    last-row/column rule. Returns (pixels checked, of them on a window's last
    row or column)."""
    fallback = np.asarray(tl.fallback)
    cidx = np.asarray(tl.cidx)[:, 0]
    T = cidx.shape[0]
    G = jmat2.GROUP
    checked = last_row_or_col = 0
    for cl, win_h in ((ml.easy, jmat2.WIN_HE), (ml.hard, jmat2.WIN_HH)):
        M = cl.vx.shape[0] * G                 # tiles of the class
        if M == 0:
            continue
        t = (np.asarray(cl.gid)[:, None] * G + np.arange(G)).reshape(-1)
        tt = np.minimum(t, T - 1)
        cam = cidx[tt]
        m = (t < T)[:, None] & ~fallback[tt][:, None] & (cam >= 0)
        np.testing.assert_array_equal(f["cam"][tt][m], cam[m])
        tcam = np.asarray(cl.tile_cam).reshape(M, 2)
        org = np.asarray(cl.tile_org).reshape(M, 4)
        band = np.asarray(cl.tile_band).reshape(M, 2)
        is_a = cam == tcam[:, 0:1]
        # window-local tap origins of each axis, per the pixel's slot
        x_org = np.where(is_a, org[:, 1:2] + band[:, 0:1],
                         org[:, 3:4] + band[:, 1:2])
        y_org = np.where(is_a, org[:, 0:1], org[:, 2:3])
        for w, lo, size, vm in (
                ("a", f["x0"][tt] - x_org, jcomp.VXW,
                 np.asarray(cl.vx).reshape(M, jcomp.VXW, jcomp.P)),
                ("ay", f["y0"][tt] - y_org, win_h,
                 np.asarray(cl.vy).reshape(M, win_h, jcomp.P))):
            wt = f[w][tt]
            assert ((lo >= 0) & (lo < size))[m].all(), name

            def at(i):
                return np.take_along_axis(
                    vm, np.clip(i, 0, size - 1)[:, None, :], axis=1)[:, 0]

            np.testing.assert_array_equal(at(lo)[m], wt[m])
            nxt = m & (lo + 1 < size)
            np.testing.assert_array_equal(at(lo + 1)[nxt], 127 - wt[nxt])
            # no other non-zero in the column
            np.testing.assert_array_equal(
                vm.sum(axis=1, dtype=np.int32)[m], 127)
            # the window's last row/column takes the whole weight
            last = m & ~nxt
            assert (wt[last] == 127).all()
            last_row_or_col += int(last.sum())
        checked += int(m.sum())
    return checked, last_row_or_col


def tile_major_fields(port_ml, tl) -> dict:
    """A port mat2 state's unpacked per-pixel fields, tile-major like `tl`."""
    return {k: _tile_major(v.numpy(), tl.grid_hw, tl.pano_hw,
                           -1 if k == "cam" else 0)
            for k, v in port_ml.fields().items()}


@pytest.mark.parametrize("name", STATES)
def test_weights_are_the_hat_matrix_nonzeros(name):
    """On every covered pixel of a non-fallback tile, the port's global taps
    and integer weights are the non-zeros of the reference's vx/vy
    (`_mat_chunk_h`), mapped back through tile_org/tile_band and the class's
    window origin — in both classes, including the last-row/column rule."""
    ml, _ = jax_mat2(name)
    _frames, lut = make_state(name)
    tl = jcomp.build_tiled_lut(lut, FRAME_HW)
    f = tile_major_fields(port_mat2(name), tl)
    checked, last_row_or_col = assert_hat_matrix_nonzeros(ml, tl, f, name)
    assert checked > 0
    if name == "easy":
        assert ml.tg_easy > 0
    if name == "edge":
        assert last_row_or_col > 0
        kern = f["cam"] >= 0
        at_edge = kern & (f["x0"] == FRAME_HW[1] - 1)
        assert at_edge.any() and (f["a"][at_edge] == 127).all()
        assert ((f["a"] == 30) & kern & (f["x0"] == 0)).any()
        assert ((f["ay"] == 48) & kern & (f["y0"] == 0)).any()


@pytest.mark.parametrize("name", STATES)
def test_composite_mat2_planar_bit_exact(name):
    frames, _lut = make_state(name)
    _ml, ref = jax_mat2(name)
    got = tmat2.composite_mat2_planar(
        frames_to_planar_i8(torch.from_numpy(frames)), port_mat2(name))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)


def test_composite_mat2_batched_bit_exact():
    """B=3 distinct frame sets with fallback tiles: the port's batched
    composite equals the reference's batched kernel and its own per-frame
    output, bit for bit."""
    frames, lut = make_state("poisoned")
    batch = np.stack([frames, frames[:, ::-1], np.roll(frames, 7, axis=2)])
    jml, _ = jax_mat2("poisoned")
    jplanar = jnp.stack([j_frames_to_planar_i8(jnp.asarray(b)) for b in batch])
    ref = np.asarray(jmat2.composite_mat2_planar_batched(jplanar, jml,
                                                         interpret=True))
    planar = frames_to_planar_i8(torch.from_numpy(batch))
    assert planar.shape == (3, 3, 3) + FRAME_HW
    ml = port_mat2("poisoned")
    got = tmat2.composite_mat2_planar_batched(planar, ml)
    np.testing.assert_array_equal(got.numpy(), ref)
    for b in range(3):
        np.testing.assert_array_equal(
            got[b].numpy(), tmat2.composite_mat2_planar(planar[b], ml).numpy())


def test_fallback_tiles_bit_exact():
    """Fallback tiles take the exact float gather: bit-exact against the
    reference's gather oracle and its mat2 overlay."""
    frames, lut = make_state("poisoned")
    ml = port_mat2("poisoned")
    assert ml.n_fallback > 0 and ml.fb_pix.numel() > 0
    gather = np.asarray(j_gather_u8(jnp.asarray(frames), lut))
    _jml, jout = jax_mat2("poisoned")
    got = tmat2.composite_mat2_planar(
        frames_to_planar_i8(torch.from_numpy(frames)), ml).numpy()
    pix = ml.fb_pix.numpy()
    flat = got.reshape(3, -1)[:, pix]
    np.testing.assert_array_equal(flat, gather.reshape(-1, 3)[pix].T)
    np.testing.assert_array_equal(flat, jout.reshape(3, -1)[:, pix])


@pytest.mark.parametrize("name", ("rot005", "poisoned"))
def test_composite_mat2_vs_gather_oracle(name):
    """The reference's own tolerance of mat2 against the exact gather
    (test_pallas_mat2.py): median <= 1, >= 99.9% within 4; the port's plain
    gather oracle is the same function."""
    frames, lut = make_state(name)
    tl = torch_lut(lut)
    ft = torch.from_numpy(frames)
    ref = composite_frame_u8(ft, tl).numpy().astype(np.int32)
    out = tmat2.composite_mat2_planar(frames_to_planar_i8(ft),
                                      port_mat2(name))
    diff = np.abs(out.permute(1, 2, 0).numpy().astype(np.int32) - ref)
    assert np.median(diff) <= 1
    assert diff.mean() < 1.2, diff.mean()
    assert (diff <= 4).mean() > 0.999
    # uncovered pixels are exactly 0
    assert (out.permute(1, 2, 0).numpy()[tl.cam_idx.numpy() < 0] == 0).all()


def test_shift_planar_bn_bit_exact():
    rng = np.random.default_rng(7)
    x = rng.integers(-128, 128, (2, 3, 3, 16, 256), dtype=np.int8)
    ref = np.asarray(jmat2._shift_planar_bn_xla(jnp.asarray(x)))
    got = tmat2.shift_planar_bn(torch.from_numpy(x))
    assert got.shape == (tmat2.N_SHIFTS, 3, 2, 3, 16, 256)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_cuda_only_paths_refuse_other_devices():
    """A wrapper takes the plain version only for a CPU tensor; it refuses
    what its kernel does not take instead of converting it."""
    frames, _lut = make_state("rot005")
    ml = port_mat2("rot005")
    planar = frames_to_planar_i8(torch.from_numpy(frames))
    with pytest.raises(ValueError):
        tmat2.composite_mat2_planar(planar[:, :, :64], ml)
    with pytest.raises(ValueError):
        tmat2.composite_mat2_planar(planar[:2], ml)
    with pytest.raises(ValueError):
        tmat2.composite_mat2_planar(planar.to(torch.int16), ml)
    with pytest.raises(ValueError):
        tmat2.composite_mat2_planar(planar.to("meta"), ml)
