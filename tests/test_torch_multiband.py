"""The multiband video mode of the port against the JAX package (Pallas
kernels in interpret mode on the CPU): geometry and cached state, the warp
stage bit for bit, and the blended panorama within a stated tolerance."""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stitchingvideo_tpu.blend import multiband as jmulti
from stitchingvideo_tpu.blend import multiband_video as jmb
from stitchingvideo_tpu.models.registration import Registration as JReg
from stitchingvideo_tpu.ops.pallas import composite as jcomp
from stitchingvideo_tpu.ops.pallas import composite_mat2 as jmat2
from stitchingvideo_tpu.ops.pallas.composite_mat import \
    frames_to_planar_i8 as j_frames_to_planar_i8
from stitchingvideo_tpu.video.lut import CompositeLUT as JLUT
from stitchingvideo_tpu_torch import Registration
from stitchingvideo_tpu_torch.blend import multiband as tmulti
from stitchingvideo_tpu_torch.blend import multiband_video as tmb
from stitchingvideo_tpu_torch.ops import composite as tcomp
from stitchingvideo_tpu_torch.ops import composite_mat2 as tmat2
from stitchingvideo_tpu_torch.ops.composite_mat import frames_to_planar_i8

from tests.test_torch_composite import (assert_hat_matrix_nonzeros,
                                        tile_major_fields, torch_lut)
from tests.test_torch_registration import FRAME_HW, make_registration_dict

CROP = (12, 108, 10, 1050)


def registration_dict(kind: str) -> dict:
    """The shared 3-camera registration; 'curved' bends camera 1's map so
    that some window tiles overflow their source window (fallback tiles)."""
    d = make_registration_dict()
    if kind == "curved":
        cols = np.arange(200, dtype=np.float32)
        d["xmaps"][1][40:56, 100:300] = 60.0 + 2.2 * cols
    return d


@functools.lru_cache(maxsize=None)
def states(kind: str, pad_pieces_to: int = 0):
    """(reference state, port state, crop_yx) of one registration."""
    d = registration_dict(kind)
    jst, jcrop = jmb.build_multiband_state(
        JReg.from_state_dict(d), FRAME_HW, crop=CROP,
        pad_pieces_to=pad_pieces_to)
    st, crop = tmb.build_multiband_state(
        Registration.from_state_dict(d, device="cpu"), FRAME_HW, crop=CROP,
        pad_pieces_to=pad_pieces_to)
    assert crop == tuple(jcrop) == (12, 10)
    return jst, st, crop


def frame_sets(seed: int, B: int, smooth_last: bool = False) -> np.ndarray:
    """[B, 3, H, W, 3] uint8: random frame sets; the last one smooth
    (a gradient plus low noise), where blending, not noise, sets the value."""
    rng = np.random.default_rng(seed)
    out = rng.integers(0, 256, (B, 3) + FRAME_HW + (3,), dtype=np.uint8)
    if smooth_last:
        yy, xx = np.mgrid[:FRAME_HW[0], :FRAME_HW[1]]
        base = 90 + 60 * np.sin(xx / 70.0) + 40 * np.cos(yy / 23.0)
        offset = 25 * np.arange(3)[:, None, None, None]
        cams = base[None, :, :, None] + offset \
            + rng.uniform(-3, 3, (3,) + FRAME_HW + (3,))
        out[-1] = np.clip(cams, 0, 255).astype(np.uint8)
    return out


def both_planar(batch: np.ndarray):
    return (jnp.stack([j_frames_to_planar_i8(jnp.asarray(b)) for b in batch]),
            frames_to_planar_i8(torch.from_numpy(batch)))


def test_column_pieces():
    """The cases of the reference's own test, and equal to its function."""
    W = 4000
    m = np.zeros((4, W), bool)
    m[:, 0:100] = True
    m[:, 1500:1650] = True
    m[:, 3200:3300] = True          # three clusters, gaps > SPLIT_GAP
    m2 = np.zeros((4, W), bool)
    m2[:, 0:100] = True
    m2[:, 150:300] = True           # a narrow gap merges
    m3 = np.zeros((4, W), bool)
    m3[:, 10:20] = True
    m3[:, 20 + tmb.SPLIT_GAP:500] = True     # a gap of exactly SPLIT_GAP
    assert (tmb.SPLIT_GAP, tmb.MARGIN) == (jmb.SPLIT_GAP, jmb.MARGIN)
    assert tmb._column_pieces(m) == [(0, 100), (1500, 1650), (3200, 3300)]
    assert tmb._column_pieces(m2) == [(0, 300)]
    assert tmb._column_pieces(np.zeros((4, W), bool)) == []
    for mask in (m, m2, m3):
        assert tmb._column_pieces(mask) == jmb._column_pieces(mask)


@pytest.mark.parametrize("strength", (1.0, 5.0, 20.0))
def test_band_rules(strength):
    assert tmulti.WEIGHT_EPS == jmulti.WEIGHT_EPS
    for h in (1, 37, 128, 1080, 1600):
        for w in (1, 200, 1088, 7232):
            bands = tmulti.num_bands_for(float(h * w), strength)
            assert bands == jmulti.num_bands_for(float(h * w), strength)
            assert tmulti.pad_for_bands(h, w, bands) == \
                jmulti.pad_for_bands(h, w, bands)


def test_concat_tiled_luts_fields_equal():
    rng = np.random.default_rng(3)
    jluts, luts = [], []
    for _ in range(3):
        cam = np.where(rng.uniform(size=(64, 256)) < 0.7, 0, -1) \
            .astype(np.int32)
        cam[:16] = -1
        sx = rng.uniform(20, 300, (64, 256)).astype(np.float32)
        sy = rng.uniform(5, 100, (64, 256)).astype(np.float32)
        g = rng.uniform(0.9, 1.1, (64, 256)).astype(np.float32)
        jl = JLUT(*(jnp.asarray(a) for a in (cam, sx, sy, g)))
        jluts.append(jcomp.build_tiled_lut(jl, FRAME_HW))
        luts.append(tcomp.build_tiled_lut(torch_lut(jl), FRAME_HW))
    ref = jcomp.concat_tiled_luts(jluts, (2, 0, 2))
    got = tcomp.concat_tiled_luts(luts, (2, 0, 2))
    for k in ("tile_cam", "tile_org", "tile_band", "fallback"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k)), err_msg=k)
    for k in ("sx", "sy", "gain", "cidx"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(ref, k))[:, 0], k)
    assert got.cidx.dtype == torch.int32
    assert set(np.unique(got.cidx.numpy())) == {-1, 0, 2}
    assert got.n_fallback == int(ref.n_fallback) and got.n_cams == 3
    assert (got.grid_hw, got.pano_hw, got.frame_hw) == \
        (ref.grid_hw, ref.pano_hw, ref.frame_hw)
    with pytest.raises(ValueError):
        tcomp.concat_tiled_luts(
            [luts[0], tcomp.build_tiled_lut(torch_lut(JLUT(*(
                jnp.zeros((8, 128), t) for t in
                (jnp.int32, jnp.float32, jnp.float32, jnp.float32)))),
                FRAME_HW)], (0, 1))


@pytest.mark.parametrize("kind,pad", (("plain", 0), ("plain", 2),
                                      ("curved", 0)))
def test_build_multiband_state_equal(kind, pad):
    """Geometry and integer fields equal, the binary mask equal; the mask
    pyramid and the reciprocals are float32 sums taken in another order:
    gm within 1e-6 absolute (values <= 1; measured 6e-8), recip within 1e-5
    relative (measured 4e-6 absolute on values up to 1e5, where the weight
    sum is ~0)."""
    jst, st, _ = states(kind, pad)
    for k in ("piece_cam", "piece_ax", "canvas_hw", "buf_hw", "out_hw",
              "bands", "pad_w"):
        assert getattr(st, k) == getattr(jst, k), k
    assert st.bands == 4 and st.canvas_hw == (128, 1088)
    assert len(st.piece_cam) == (4 if pad else 3)
    assert st.m0.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        st.m0.float().numpy(), np.asarray(jst.m0.astype(jnp.float32)))
    if pad:
        # the dummy piece: camera 0 at origin 0, empty mask, nothing covered
        assert (st.piece_cam[-1], st.piece_ax[-1]) == (0, 0)
        assert float(st.m0[-1].float().abs().sum()) == 0.0
        win = st.buf_hw[0] * st.buf_hw[1]
        assert bool((st.warp_lut.tap_cw[-win:] == tmat2.UNCOVERED).all())
    assert len(st.gm) == len(st.recip) == st.bands + 1
    for lvl in range(st.bands + 1):
        assert st.gm[lvl].dtype == st.recip[lvl].dtype == torch.float32
        np.testing.assert_allclose(st.gm[lvl].numpy(),
                                   np.asarray(jst.gm[lvl]), rtol=0, atol=1e-6)
        np.testing.assert_allclose(st.recip[lvl].numpy(),
                                   np.asarray(jst.recip[lvl]), rtol=1e-5)
    # seam masks that overlap (canvas columns 300..365) count twice
    assert float(st.recip[0].min()) == pytest.approx(0.5, abs=1e-4)
    assert (st.warp_lut.n_fallback > 0) == (kind == "curved")
    # .to() carries every tensor
    moved = st.to("cpu")
    assert moved.piece_ax == st.piece_ax and \
        torch.equal(moved.warp_lut.tap_cw, st.warp_lut.tap_cw)


@pytest.mark.parametrize("kind", ("plain", "curved"))
def test_warp_state_is_the_hat_matrix_nonzeros(kind):
    """The port's warp state, as per-pixel taps, equals the non-zeros of the
    reference's vx/vy on the tile groups the reference launches; every pixel
    of a group the reference skips is uncovered in the port's state."""
    jst, st, _ = states(kind)
    d = registration_dict(kind)
    # the reference's window LUTs again, as its build makes them
    jtl = _reference_window_lut(d, jst)
    ml = jst.warp_lut
    f = tile_major_fields(st.warp_lut, jtl)
    checked, _ = assert_hat_matrix_nonzeros(ml, jtl, f, kind)
    assert checked > 0
    G = jmat2.GROUP
    T = np.asarray(jtl.cidx).shape[0]
    Tg = -(-T // G)
    launched = np.zeros(Tg + 1, bool)
    for cl in (ml.easy, ml.hard):
        launched[np.minimum(np.asarray(cl.gid), Tg)] = True
    skipped = ~launched[:Tg]
    assert skipped.any() and launched[:Tg].any()
    tiles = np.repeat(skipped, G)[:T]
    assert (f["cam"][tiles] == -1).all()
    assert not np.asarray(jtl.fallback)[tiles].any()
    # fallback flags agree tile by tile
    nty, ntx = jtl.grid_hw
    port_fb = (st.warp_lut.tap_cw.numpy() == tmat2.FALLBACK) \
        .reshape(nty, jcomp.TILE_H, ntx, jcomp.TILE_W).transpose(0, 2, 1, 3) \
        .reshape(T, jcomp.P)
    np.testing.assert_array_equal(
        port_fb, np.repeat(np.asarray(jtl.fallback)[:, None], jcomp.P, 1))


def _reference_window_lut(d: dict, jst):
    """The concatenated window TiledLUT of the reference's build, rebuilt
    from the port-independent pieces of its state (the reference keeps only
    the materialized form)."""
    reg = JReg.from_state_dict(d)
    CHb, Wb = jst.buf_hw
    CHp, CWp = jst.canvas_hw
    seam = np.asarray(reg.seam_masks) & np.asarray(reg.valid)
    luts = []
    for cam, ax in zip(jst.piece_cam, jst.piece_ax):
        cx, cy = (int(v) for v in np.asarray(reg.corners)[cam])
        (x0r, x1r), = jmb._column_pieces(seam[cam])
        Hr = seam.shape[1]
        ry0, ry1 = max(0, -cy), min(Hr, CHp - cy)
        rc0 = max(x0r, ax - cx)
        rc1 = min(x1r, ax + Wb - cx, CWp - cx)
        wy, wx = cy + ry0, cx + rc0 - ax
        win = (slice(wy, wy + ry1 - ry0), slice(wx, wx + rc1 - rc0))
        roi = (cam, slice(ry0, ry1), slice(rc0, rc1))
        cam_idx = np.full((CHb, Wb), -1, np.int32)
        cam_idx[win] = np.where(seam[roi], 0, -1)
        sx, sy = np.zeros((2, CHb, Wb), np.float32)
        gg = np.ones((CHb, Wb), np.float32)
        sx[win] = np.asarray(reg.xmaps)[roi]
        sy[win] = np.asarray(reg.ymaps)[roi]
        gg[win] = np.asarray(reg.gain_maps)[roi]
        luts.append(jcomp.build_tiled_lut(
            JLUT(*(jnp.asarray(a) for a in (cam_idx, sx, sy, gg))), FRAME_HW))
    return jcomp.concat_tiled_luts(luts, jst.piece_cam)


def test_pieces_single_bit_exact():
    """`composite_mat2_planar_pieces` against the reference's single-frame
    kernel; uncovered pixels are exactly 0 and the values are whole."""
    jst, st, _ = states("plain")
    Nv = len(st.piece_cam)
    jplanar, planar = both_planar(frame_sets(21, 1))
    ref = np.asarray(jmat2.composite_mat2_planar_pieces(
        jplanar[0], jst.warp_lut, Nv, interpret=True).astype(jnp.float32))
    got = tmat2.composite_mat2_planar_pieces(planar[0], st.warp_lut, Nv)
    assert got.dtype == torch.bfloat16
    assert got.shape == ref.shape == (Nv, 3) + st.buf_hw
    got = got.float().numpy()
    np.testing.assert_array_equal(got, ref)
    assert (got == np.round(got)).all() and got.min() == 0 and got.max() <= 255
    uncovered = (st.warp_lut.tap_cw.numpy() == tmat2.UNCOVERED) \
        .reshape(Nv, 1, *st.buf_hw)
    assert uncovered.mean() > 0.3
    assert (got[np.broadcast_to(uncovered, got.shape)] == 0).all()
    # the folded seam mask: nothing outside m0
    assert (got[np.broadcast_to(st.m0.float().numpy()[:, None] == 0,
                                got.shape)] == 0).all()


@pytest.mark.parametrize("kind", ("plain", "curved"))
def test_pieces_batched_bit_exact(kind):
    """B=3 through `composite_mat2_planar_pieces_batched` against the
    reference's batched kernel, fallback tiles included ('curved'), and per
    frame set against the port's single-frame entry point."""
    jst, st, _ = states(kind)
    Nv = len(st.piece_cam)
    jplanar, planar = both_planar(frame_sets(22, 3))
    ref = np.asarray(jmat2.composite_mat2_planar_pieces_batched(
        jplanar, jst.warp_lut, Nv, interpret=True).astype(jnp.float32))
    got = tmat2.composite_mat2_planar_pieces_batched(planar, st.warp_lut, Nv)
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    np.testing.assert_array_equal(got.float().numpy(), ref)
    for b in range(3):
        assert torch.equal(got[b], tmat2.composite_mat2_planar_pieces(
            planar[b], st.warp_lut, Nv))
    if kind == "curved":
        # the same tiles take the exact float gather on both sides
        jfb = np.asarray(jst.warp_lut.fb_tid)[np.asarray(
            jst.warp_lut.fb_valid)]
        assert st.warp_lut.n_fallback == len(jfb) > 0
        fb = st.warp_lut.fb_pix.numpy()
        assert got.float().numpy().transpose(0, 2, 1, 3, 4) \
            .reshape(3, 3, -1)[:, :, fb].max() > 0


def test_pieces_refuse_what_they_do_not_take():
    _, st, _ = states("plain")
    _, planar = both_planar(frame_sets(23, 1))
    with pytest.raises(ValueError, match="pieces"):
        tmat2.composite_mat2_planar_pieces(planar[0], st.warp_lut, 5)
    with pytest.raises(ValueError):
        tmat2.composite_mat2_planar_pieces(planar[0, :2], st.warp_lut, 3)
    with pytest.raises(ValueError):
        tmat2.composite_mat2_planar_pieces(planar[0].to("meta"), st.warp_lut,
                                           3)


def assert_panorama_close(got: np.ndarray, ref: np.ndarray) -> None:
    """The blended uint8 panorama against the reference's. The warp stage is
    bit-exact and the bfloat16 pyramids round at the same points, but the
    float32 sums of the mask pyramid, the canvas collapse and the last
    multiply-add are taken in another order (XLA's CPU backend also
    contracts multiply-adds), so a value that lands on a rounding tie can
    come out one step away, and one bfloat16 step of a normalised level
    (up to 1.0 on 128..255) can move a few pixels around it. Bound: median
    0, at most 1 step on at most 1% of values, none above 2. Measured on
    the inputs of `test_multiband_frames_batched_matches`: 2 values of
    599,040 one step away, both in the random frame set."""
    assert got.shape == ref.shape and got.dtype == ref.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert np.median(diff) == 0 and diff.max() <= 2, diff.max()
    assert (diff > 0).mean() <= 0.01 and (diff > 1).sum() == 0, \
        ((diff > 0).mean(), (diff > 1).sum())


def test_multiband_frames_batched_matches():
    """The slice as a whole: B=2 (one random frame set, one smooth) through
    `multiband_video_frames_batched`, and batched == single per frame set."""
    jst, st, crop = states("plain")
    jplanar, planar = both_planar(frame_sets(24, 2, smooth_last=True))
    ref = np.asarray(jmb.multiband_video_frames_batched(
        jplanar, jst, crop_yx=crop, interpret=True))
    stages = []
    got = tmb.multiband_video_frames_batched(planar, st, crop_yx=crop,
                                             on_stage=stages.append)
    assert stages == ["warp", "pyramids", "canvas", "level0"]
    assert got.shape == (2, 3, 96, 1040) and got.dtype == torch.uint8
    assert_panorama_close(got.numpy(), ref)
    assert (got.numpy() > 0).mean() > 0.9
    for b in range(2):
        assert torch.equal(got[b], tmb.multiband_video_frame(planar[b], st,
                                                             crop_yx=crop))
    # the chain fed by the plain warp is the chain fed by the entry point
    x = tmat2.composite_mat2_pieces_plain(planar, st.warp_lut, 3)
    assert torch.equal(tmb.multiband_blend_windows(x, st, crop), got)
    with pytest.raises(ValueError, match="windows"):
        tmb.multiband_blend_windows(x.float(), st, crop)
    with pytest.raises(ValueError, match="windows"):
        tmb.multiband_blend_windows(x[:, :2], st, crop)
