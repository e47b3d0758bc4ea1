"""The port's feather hot loop against the JAX package: the L1 distance
transform, the blend LUT of a registration, the dual-slot kernel state, and
the feather composite (the kernel's plain version on the CPU against the
Pallas kernel in interpret mode), with and without fallback tiles.

Each JAX kernel result is computed once in a module-scoped fixture: the
first interpret-mode call of a shape compiles for seconds."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stitchingvideo_tpu.models.registration import Registration as JReg
from stitchingvideo_tpu.ops.distance import distance_transform_l1 as j_dt
from stitchingvideo_tpu.ops.pallas import composite as jcomp
from stitchingvideo_tpu.ops.pallas import composite_feather as jfe
from stitchingvideo_tpu.ops.pallas.composite_mat import \
    frames_to_planar_i8 as j_frames_to_planar_i8
from stitchingvideo_tpu.ops.pallas.composite_mat2 import GROUP
from stitchingvideo_tpu_torch import Registration
from stitchingvideo_tpu_torch.ops import composite_feather as tfe
from stitchingvideo_tpu_torch.ops.composite_mat import frames_to_planar_i8
from stitchingvideo_tpu_torch.ops.distance import distance_transform_l1

from tests.test_pallas_feather import _synthetic_blend_lut
from tests.test_torch_composite import _tile_major
from tests.test_torch_registration import make_registration_dict

FRAME_HW = (128, 512)
TRIPLE_COLS = (130, 131, 700)
FIXTURES = {"clean": (), "fallback": TRIPLE_COLS}


def blend_to_numpy(jb) -> dict:
    return {k: np.array(getattr(jb, k)) for k in tfe._FIELDS}


def torch_blend(jb) -> tfe.BlendLUT:
    return tfe.BlendLUT(**{k: torch.from_numpy(v)
                           for k, v in blend_to_numpy(jb).items()})


@pytest.fixture(scope="module", params=list(FIXTURES))
def case(request):
    """tests/test_pallas_feather.py's synthetic blend LUT (side-by-side
    cameras with ramped overlap bands; in "fallback", columns that name a
    third camera), the reference's state and composite, and the port's."""
    rng = np.random.default_rng(len(request.param))
    frames, jb = _synthetic_blend_lut(rng, triple_cols=FIXTURES[request.param])
    jml = jfe.build_feather_mat(jb, FRAME_HW)
    ref = np.asarray(jfe.composite_feather_planar(
        j_frames_to_planar_i8(jnp.asarray(frames)), jml, interpret=True))
    oracle = np.asarray(jfe.composite_blend_gather(jnp.asarray(frames), jb))
    tb = torch_blend(jb)
    ml = tfe.build_feather_mat(tb, FRAME_HW)
    got = tfe.composite_feather_planar(
        frames_to_planar_i8(torch.from_numpy(frames)), ml)
    return dict(name=request.param, frames=frames, jb=jb, jml=jml, ref=ref,
                oracle=oracle, tb=tb, ml=ml, got=got)


@pytest.mark.parametrize("kind", ("random", "sparse_holes", "all_true",
                                  "all_false"))
def test_distance_transform_l1_bit_equal(kind):
    rng = np.random.default_rng(0)
    mask = {"random": rng.random((37, 53)) > 0.2,
            "sparse_holes": rng.random((64, 200)) > 0.002,
            "all_true": np.ones((9, 11), bool),
            "all_false": np.zeros((5, 6), bool)}[kind]
    ref = np.asarray(j_dt(jnp.asarray(mask)))
    got = distance_transform_l1(torch.from_numpy(mask))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    # leading dimensions are a batch
    both = distance_transform_l1(torch.from_numpy(np.stack([mask, ~mask])))
    np.testing.assert_array_equal(both[0].numpy(), ref)
    np.testing.assert_array_equal(both[1].numpy(),
                                  np.asarray(j_dt(jnp.asarray(~mask))))


@pytest.mark.parametrize("seed", (0, 9))
def test_build_blend_lut_every_field_equal(seed):
    d = make_registration_dict(seed=seed)
    jb = jfe.build_blend_lut(JReg.from_state_dict(d), 0.02)
    tb = tfe.build_blend_lut(Registration.from_state_dict(d, device="cpu"),
                             0.02)
    assert tb.shape == tuple(jb.shape) == (128, 1088)
    for k, want in blend_to_numpy(jb).items():
        got = getattr(tb, k).numpy()
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=k)
    # both slots are live somewhere: the doubly owned band of the fixture
    assert ((tb.cam_a >= 0) & (tb.cam_b >= 0)).any()
    cropped = tb.crop(10, 100, 20, 1000)
    jc = jb.crop(10, 100, 20, 1000)
    np.testing.assert_array_equal(cropped.gw_b.numpy(), np.asarray(jc.gw_b))
    assert cropped.cam_a.is_contiguous()


def test_build_feather_mat_integer_fields_equal(case):
    jml, ml = case["jml"], case["ml"]
    T = jml.n_tiles
    for k, n in (("tile_cam", 2), ("tile_org", 4), ("tile_band", 2)):
        np.testing.assert_array_equal(getattr(ml, k).numpy(),
                                      np.asarray(getattr(jml, k))[:T * n], k)
    assert ml.n_fallback == int(jml.n_fallback)
    assert (ml.n_fallback > 0) == (case["name"] == "fallback")
    assert (ml.grid_hw, ml.pano_hw, ml.frame_hw) == \
        (jml.grid_hw, jml.pano_hw, jml.frame_hw)
    # the same tiles are fallback tiles (the reference pads its list to a
    # bucket and flags the real ones)
    ref_fb = np.sort(np.asarray(jml.fb_tid)[np.asarray(jml.fb_valid)])
    np.testing.assert_array_equal(np.nonzero(ml.fallback.numpy())[0], ref_fb)
    # and their pixels carry the reference's float fields
    if ml.n_fallback:
        order = np.argsort(np.asarray(jml.fb_tid)[np.asarray(jml.fb_valid)])
        Hp, Wp = ml.pano_hw
        for k in ("fb_cam", "fb_sx", "fb_sy", "fb_gw"):
            want = np.asarray(getattr(jml, k))[np.asarray(jml.fb_valid)][order]
            got = np.full((ml.fallback.numel(), 2, jcomp.P), -7,
                          want.dtype)
            full = np.full((2, Hp * Wp), -7, want.dtype)
            full[:, ml.fb_pix.numpy()] = getattr(ml, k).numpy().T
            for s in range(2):
                got[:, s] = _tile_major(full[s], ml.grid_hw, ml.pano_hw, -7)
            np.testing.assert_array_equal(got[ref_fb], want, err_msg=k)


def test_feather_weights_are_the_hat_matrix_nonzeros(case):
    """For both slots, on every live pixel of a tile that is not a fallback
    tile, the port's global taps and integer weights are the non-zeros of
    the reference's slot-interleaved vx/vy (`_mat_chunk_h`), mapped back
    through the slot's window origin and band offset; the float weights are
    the reference's gws."""
    jml, ml = case["jml"], case["ml"]
    T = jml.n_tiles
    Tp = np.asarray(jml.gws).shape[0] * GROUP
    org = np.asarray(jml.tile_org).reshape(-1, 4)[:T]
    band = np.asarray(jml.tile_band).reshape(-1, 2)[:T]
    tcam = np.asarray(jml.tile_cam).reshape(-1, 2)[:T]
    vx = np.asarray(jml.vx).reshape(Tp, 2, jcomp.VXW, jcomp.P)[:T]
    vy = np.asarray(jml.vy).reshape(Tp, 2, jcomp.WIN_H, jcomp.P)[:T]
    gws = np.asarray(jml.gws).reshape(-1, 2, GROUP, jcomp.P) \
        .transpose(0, 2, 1, 3).reshape(Tp, 2, jcomp.P)[:T]
    keep = ~ml.fallback.numpy()[:, None]
    checked = 0
    for s in range(2):
        f = {k: _tile_major(v.numpy(), ml.grid_hw, ml.pano_hw,
                            -1 if k == "cam" else 0)
             for k, v in ml.fields(s).items()}
        gw = _tile_major(ml.gw[s].numpy(), ml.grid_hw, ml.pano_hw, 0)
        np.testing.assert_array_equal(gw[keep[:, 0]], gws[:, s][keep[:, 0]])
        m = keep & (gw > 0)
        # a slot is live exactly where its weight is positive
        np.testing.assert_array_equal((f["cam"] >= 0)[keep[:, 0]],
                                      (gw > 0)[keep[:, 0]])
        np.testing.assert_array_equal(
            f["cam"][m], np.broadcast_to(tcam[:, s:s + 1], m.shape)[m])
        for w, lo, size, vm in (
                ("a", f["x0"] - (org[:, 2 * s + 1] + band[:, s])[:, None],
                 jcomp.VXW, vx[:, s]),
                ("ay", f["y0"] - org[:, 2 * s][:, None], jcomp.WIN_H,
                 vy[:, s])):
            wt = f[w]
            assert ((lo >= 0) & (lo < size))[m].all()

            def at(i):
                return np.take_along_axis(
                    vm, np.clip(i, 0, size - 1)[:, None, :], axis=1)[:, 0]

            np.testing.assert_array_equal(at(lo)[m], wt[m])
            nxt = m & (lo + 1 < size)
            np.testing.assert_array_equal(at(lo + 1)[nxt], 127 - wt[nxt])
            np.testing.assert_array_equal(
                vm.sum(axis=1, dtype=np.int32)[m], 127)
            assert (wt[m & ~nxt] == 127).all()
        checked += int(m.sum())
    assert checked > 0
    # both slots live on one pixel somewhere (the ramped overlap bands)
    assert ((ml.tap_cw[0] >= 0) & (ml.tap_cw[1] >= 0)).any()


def test_composite_feather_planar_bit_exact(case):
    """The whole panorama, fallback tiles included, equals the reference's
    kernel + overlay bit for bit on this fixture."""
    got = case["got"]
    assert got.dtype == torch.uint8 and got.shape == case["ref"].shape
    np.testing.assert_array_equal(got.numpy(), case["ref"])


def test_composite_feather_vs_blend_gather_oracle(case):
    """The reference's gates against the exact dual gather
    (tests/test_pallas_feather.py:64-89): median 0, max <= 3, and the
    fallback columns within 1."""
    tb, frames = case["tb"], case["frames"]
    oracle = tfe.composite_blend_gather(torch.from_numpy(frames), tb)
    assert oracle.shape == (64, 768, 3) and oracle.dtype == torch.float32
    # XLA's CPU backend contracts some of the oracle's multiply-adds into
    # FMAs; the port rounds each step (measured here: <= 4.6e-5 apart)
    np.testing.assert_allclose(oracle.numpy(), case["oracle"], rtol=0,
                               atol=1e-4)
    ref_u8 = torch.round(oracle).clamp(0, 255).to(torch.uint8).numpy()
    out = case["got"].permute(1, 2, 0).numpy()
    d = np.abs(out.astype(np.int16) - ref_u8.astype(np.int16))
    assert np.median(d) == 0 and d.max() <= 3, (np.median(d), d.max())
    for c in FIXTURES[case["name"]]:
        assert d[:, c].max() <= 1


def test_feather_batched_is_the_single_frame_kernel(case):
    frames, ml = case["frames"], case["ml"]
    batch = np.stack([frames, frames[:, ::-1], np.roll(frames, 7, axis=2)])
    planar = frames_to_planar_i8(torch.from_numpy(batch))
    got = tfe.composite_feather_planar_batched(planar, ml)
    assert got.shape == (3, 3, 64, 768)
    assert torch.equal(got[0], case["got"])
    for b in (1, 2):
        assert torch.equal(got[b],
                           tfe.composite_feather_planar(planar[b], ml))


def test_feather_refuses_what_the_kernel_does_not_take(case):
    ml = case["ml"]
    planar = frames_to_planar_i8(torch.from_numpy(case["frames"]))
    for bad in (planar[:, :, :64], planar[:2], planar.to(torch.int16),
                planar.to("meta")):
        with pytest.raises(ValueError):
            tfe.composite_feather_planar(bad, ml)
    with pytest.raises(ValueError, match="window"):
        tfe.build_feather_mat(case["tb"], (64, 256))
