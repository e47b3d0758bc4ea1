"""The port's multi-device layer (`stitchingvideo_tpu_torch/parallel/`)
against the JAX package's (`stitchingvideo_tpu/parallel/`, Pallas kernels
in interpret mode over the virtual CPU devices of tests/conftest.py), at 2
and 4 canvas bands.

The port's meshes list the CPU device once a band, so its sharded paths run
each band's plain kernel version in turn. Held bit for bit: the row padding
of the LUT and of the blend LUT, the sharded seam-select (mat2, on the
reference's banding cases: fallback tiles, a fallback tile at a band's first
tile, fallback tiles in every band's first and last tile row, an easy/hard
class mix, non-monotonic hard group ids), mat and feather compose, each
against the port's single-device kernel and the reference's sharded
function. The gather and the gain statistics within the tolerances of the
plain gather (tests/test_torch_lut.py) and the reference's own rtol. The
multiband piece groups: against the port's single-device chain, median 0
and >= 99.9% within 2 (the reference's own gate,
tests/test_parallel.py:451-454); against the reference's sharded function,
ROADMAP.md section 3's multiband tolerance. Also the counterpart of
`__graft_entry__.dryrun_multichip`, and `local_camera_slice`,
`global_camera_batch` and the gain statistics across two gloo processes
(the counterpart of tests/multihost_worker.py).

Each JAX result is computed once per module: the first interpret-mode call
of a shape compiles for seconds."""
import functools
import os
import socket
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from stitchingvideo_tpu_torch.blend import multiband_video as tmb
from stitchingvideo_tpu_torch.ops import composite_feather as tfe
from stitchingvideo_tpu_torch.ops import composite_mat as tmat
from stitchingvideo_tpu_torch.ops import composite_mat2 as tmat2
from stitchingvideo_tpu_torch.ops.composite import build_tiled_lut
from stitchingvideo_tpu_torch.ops.composite_mat import frames_to_planar_i8
from stitchingvideo_tpu_torch.parallel import compose as tpc
from stitchingvideo_tpu_torch.parallel import compose_feather as tpf
from stitchingvideo_tpu_torch.parallel import compose_mat as tpm
from stitchingvideo_tpu_torch.parallel import compose_mat2 as tpm2
from stitchingvideo_tpu_torch.parallel import compose_multiband as tpmb
from stitchingvideo_tpu_torch.parallel.mesh import make_mesh, run_banded
from stitchingvideo_tpu_torch.video import lut as tlut_mod


@functools.lru_cache(maxsize=None)
def J():
    """The JAX package and the fixtures of its tests, imported on first use
    rather than with this file: the two-process workers import this file
    and must not import jax."""
    import jax
    import jax.numpy as jnp

    from stitchingvideo_tpu.ops.pallas import composite as jcomp
    from stitchingvideo_tpu.ops.pallas import composite_feather as jfe
    from stitchingvideo_tpu.ops.pallas import composite_mat as jmat
    from stitchingvideo_tpu.ops.pallas import composite_mat2 as jmat2
    from stitchingvideo_tpu.parallel import compose as jpc
    from stitchingvideo_tpu.parallel import compose_feather as jpf
    from stitchingvideo_tpu.parallel import compose_mat as jpm
    from stitchingvideo_tpu.parallel import compose_mat2 as jpm2
    from stitchingvideo_tpu.parallel import compose_multiband as jpmb
    from stitchingvideo_tpu.parallel.mesh import make_mesh as j_make_mesh
    from stitchingvideo_tpu.video import lut as jlut
    from tests.test_pallas_composite import _make_state
    from tests.test_pallas_feather import _synthetic_blend_lut
    from tests.test_torch_composite import torch_lut
    from tests.test_torch_feather import torch_blend
    from tests.test_torch_multiband import (assert_panorama_close,
                                            both_planar, frame_sets, states)
    return types.SimpleNamespace(**locals())


FRAME_HW = (128, 512)
BANDS = (2, 4)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small torch ops a test: one intra-op thread a worker under the
    suite's six workers (as tests/test_torch_stream.py does)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def mesh_of(n: int):
    """The port's n-band mesh on the CPU and the reference's on the first n
    virtual devices."""
    j = J()
    return make_mesh(canvas=n, devices=[CPU] * n), j.j_make_mesh(canvas=n)


def _poisoned(lut, cells):
    """`lut` with a 3-camera stripe in each (row slice, column slice)."""
    j = J()
    cam = np.array(lut.cam_idx)
    for rows, cols in cells:
        cam[rows, cols] = np.arange(cols.stop - cols.start)[None, :] % 3
    return j.jlut.CompositeLUT(cam_idx=j.jnp.asarray(cam), src_x=lut.src_x,
                               src_y=lut.src_y, gain=lut.gain)


@functools.lru_cache(maxsize=None)
def mat2_case(name: str):
    """(frames, the reference's MatLUT2 of a banding case, the port's
    per-pixel state of the same LUT)."""
    j = J()
    rng = np.random.default_rng(1234 + len(name))
    frames, lut = j._make_state(rng)
    if name == "fallback":          # tests/test_parallel.py _fallback_lut
        lut = _poisoned(lut, [(slice(8, 16), slice(128, 256)),
                              (slice(48, 56), slice(640, 768))])
    elif name == "band_tile0":      # a fallback tile at global tile 0
        lut = _poisoned(lut, [(slice(0, 8), slice(0, 128))])
    elif name == "band_edges":
        # a fallback tile in every tile row: the first and last tile row of
        # each band at 2 and at 4 bands (8 tile rows)
        lut = _poisoned(lut, [(slice(8 * r, 8 * r + 8),
                               slice(128 * r, 128 * r + 128))
                              for r in range(8)])
    tl = j.jcomp.build_tiled_lut(lut, FRAME_HW)
    if name == "easy_hard":
        n_easy, _n_fb = (int(x) for x in j.jmat2._class_counts(tl))
        jml = j.jmat2._materialize2_jit(tl, min(4, n_easy), 0)
        assert jml.easy.gid.shape[0] > 0 and jml.hard.gid.shape[0] > 0
    elif name == "nonmonotonic":
        jml = j.jmat2._pack_classes(
            tl, j.jnp.asarray([0, 1, 3, 4], j.jnp.int32),
            j.jnp.asarray([6, 7, 2, 5], j.jnp.int32), None, 0, scratch=False)
    else:
        jml = j.jmat2._materialize2(tl, FRAME_HW)
    assert (int(jml.n_fallback) > 0) == (name in ("fallback", "band_tile0",
                                                  "band_edges"))
    ml = tmat2._per_pixel2(build_tiled_lut(j.torch_lut(lut), FRAME_HW))
    return np.array(frames), jml, ml


@functools.lru_cache(maxsize=None)
def jax_sharded_mat2(name: str, n: int) -> np.ndarray:
    j = J()
    frames, jml, _ml = mat2_case(name)
    jm = j.j_make_mesh(canvas=n)
    sm = j.jpm2.shard_mat2_lut(jml, jm)
    fn = j.jpm2.sharded_composite_mat2_fn(jm, sm, interpret=True)
    return np.asarray(fn(j.jmat.frames_to_planar_i8(j.jnp.asarray(frames)),
                         sm))


def assert_mat2_reference(got: torch.Tensor, ref: np.ndarray, ml) -> None:
    """A mat2 panorama [3, Hp, Wp] against the reference's: bit for bit on
    every pixel outside the fallback tiles. On the fallback tiles' exact
    float gather XLA's CPU backend contracts multiply-adds into FMAs, as in
    the plain gather (tests/test_torch_lut.py), so a value on a rounding
    tie can land one step away: <= 1 step on <= 0.01% of values (measured:
    1 value of 196,608, 171.49998 in the port, 171.5 in the reference, on
    the "band_tile0" case at 1 band as at 2 and 4)."""
    got = got.numpy()
    ref = ref[:, :got.shape[1]]
    diff = np.abs(got.astype(np.int16) - ref).reshape(3, -1)
    off = np.ones(diff.shape[1], bool)
    off[ml.fb_pix.numpy()] = False
    assert diff[:, off].max() == 0
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4, diff.max()


def _planar(frames: np.ndarray) -> torch.Tensor:
    return frames_to_planar_i8(torch.from_numpy(frames))


# -- padding -----------------------------------------------------------------

@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("hw", [(64, 1024), (96, 1040), (61, 300)])
def test_pad_lut_rows_for_shards_bit_exact(n, hw):
    j = J()
    rng = np.random.default_rng(hw[0] + n)
    H, W = hw
    jl = j.jlut.CompositeLUT(
        cam_idx=j.jnp.asarray(rng.integers(-1, 3, hw).astype(np.int32)),
        src_x=j.jnp.asarray(rng.uniform(0, 500, hw).astype(np.float32)),
        src_y=j.jnp.asarray(rng.uniform(0, 100, hw).astype(np.float32)),
        gain=j.jnp.asarray(rng.uniform(0.5, 2, hw).astype(np.float32)))
    ref = j.jlut.pad_lut_rows_for_shards(jl, n)
    got = tlut_mod.pad_lut_rows_for_shards(j.torch_lut(jl), n)
    for k in ("cam_idx", "src_x", "src_y", "gain"):
        a, b = getattr(got, k).numpy(), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    assert got.shape[0] % (8 * n) == 0 and got.shape[0] >= H


@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("hp", [64, 61])
def test_pad_blend_rows_for_shards_bit_exact(n, hp):
    j = J()
    _frames, jb = j._synthetic_blend_lut(np.random.default_rng(n), Hp=hp,
                                         triple_cols=(130,))
    ref = j.jpf.pad_blend_rows_for_shards(jb, n)
    got = tpf.pad_blend_rows_for_shards(j.torch_blend(jb), n)
    for k in tfe._FIELDS:
        a, b = getattr(got, k).numpy(), np.asarray(getattr(ref, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


# -- the gather and the gain statistics --------------------------------------

@pytest.mark.parametrize("n", BANDS)
def test_sharded_gather(n):
    """Column bands of the plain gather == the whole gather, and against
    the reference's sharded gather within the plain gather's tolerance
    (tests/test_torch_lut.py: <= 1 step on <= 0.01% of values)."""
    j = J()
    mesh, jm = mesh_of(n)
    frames, lut = j._make_state(np.random.default_rng(7))
    frames = np.array(frames)
    tl = j.torch_lut(lut)
    luts = tpc.shard_lut(tl, mesh)
    assert [l.shape[1] for l in luts] == [1024 // n] * n
    got = tpc.sharded_composite_fn(mesh)(torch.from_numpy(frames), luts)
    want = tlut_mod.composite_frame_u8(torch.from_numpy(frames), tl)
    assert torch.equal(got, want)
    ref = np.asarray(j.jpc.sharded_composite_fn(jm)(
        j.jnp.asarray(frames), j.jpc.shard_lut(lut, jm)))
    diff = np.abs(got.numpy().astype(np.int16) - ref)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4


@pytest.mark.parametrize("n", BANDS)
def test_gain_stats_sharded(n):
    """Against the dense products and the reference, with its rtol
    (tests/test_parallel.py:936-943)."""
    j = J()
    mesh, jm = mesh_of(n)
    rng = np.random.default_rng(0)
    lum = rng.uniform(0, 255, (4, 1024)).astype(np.float32)
    mask = (rng.uniform(size=(4, 1024)) > 0.4).astype(np.float32)
    Nm, Im = tpc.gain_stats_sharded(mesh, torch.from_numpy(lum),
                                    torch.from_numpy(mask))
    np.testing.assert_allclose(Nm.numpy(), mask @ mask.T, rtol=1e-5)
    np.testing.assert_allclose(Im.numpy(), (lum * mask) @ mask.T, rtol=1e-4)
    jN, jI = j.jpc.gain_stats_sharded(jm, j.jnp.asarray(lum),
                                      j.jnp.asarray(mask))
    np.testing.assert_allclose(Nm.numpy(), np.asarray(jN), rtol=1e-5)
    np.testing.assert_allclose(Im.numpy(), np.asarray(jI), rtol=1e-4)


# -- mat2, mat and feather over row bands ------------------------------------

# each case against the reference's sharded kernel at one band count (an
# interpret-mode compile a call; tests/test_torch_parallel_runtime.py holds
# the sharded seam-select against the reference's at 2 and 4 bands)
MAT2_CASES = {"fallback": 2, "band_tile0": 4, "band_edges": 4, "easy_hard": 2,
              "nonmonotonic": 4}


@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("name", MAT2_CASES)
def test_sharded_mat2(name, n):
    """Each band composes its rows, fallback tiles included, bit for bit as
    the single-device kernel, single and batched; at the band count
    MAT2_CASES names, as the reference's sharded kernel does
    (`assert_mat2_reference`)."""
    frames, _jml, ml = mat2_case(name)
    mesh, _jm = mesh_of(n)
    sm = tpm2.shard_mat2_lut(ml, mesh, ml.pano_hw[0])
    assert sum(b.n_fallback for b in sm.bands) == ml.n_fallback
    if name == "band_edges":
        rows_of = [b.fb_pix // 1024 for b in sm.bands]
        h = 64 // n
        assert all(int(r.min()) < 8 and int(r.max()) >= h - 8
                   for r in rows_of)
    for b, band in zip(sm.bands, sm.rows):
        assert b.pano_hw == (band[1] - band[0], 1024)
        assert b.stage_table is not None
    planar = _planar(frames)
    want = tmat2.composite_mat2_planar(planar, ml)
    got = run_banded(tmat2.composite_mat2_planar, planar, sm)
    assert torch.equal(got, want)
    if MAT2_CASES[name] == n:
        assert_mat2_reference(got, jax_sharded_mat2(name, n), ml)
    batch = torch.stack([planar, planar.flip(0)])
    got_b = run_banded(tmat2.composite_mat2_planar_batched, batch, sm)
    assert torch.equal(got_b[0], got)
    assert torch.equal(got_b[1], tmat2.composite_mat2_planar(batch[1], ml))


def test_mat2_reference_difference_is_the_single_device_one():
    """The difference that `assert_mat2_reference` admits is the port's
    single-device one, not the banding's: on "band_tile0" the port's and
    the reference's single-device mat2 differ on exactly one value, one
    step, on a fallback pixel (a rounding tie under XLA's FMA contraction),
    and the sharded outputs differ from each other by the same array. A
    change to the fallback arithmetic on either side shows here."""
    j = J()
    frames, jml, ml = mat2_case("band_tile0")
    got = tmat2.composite_mat2_planar(_planar(frames), ml).numpy()
    one = np.asarray(j.jmat2.composite_mat2_planar(
        j.jmat.frames_to_planar_i8(j.jnp.asarray(frames)), jml,
        interpret=True))
    d1 = got.astype(np.int16) - one
    assert np.count_nonzero(d1) == 1 and np.abs(d1).max() == 1
    at = np.flatnonzero(d1.reshape(3, -1).any(axis=0))
    assert np.isin(at, ml.fb_pix.numpy()).all()
    sharded = jax_sharded_mat2("band_tile0", MAT2_CASES["band_tile0"])
    np.testing.assert_array_equal(
        got.astype(np.int16) - sharded[:, :got.shape[1]], d1)


def test_band_bounds_refuse_unpadded_rows():
    mesh, _jm = mesh_of(4)
    _frames, _jml, ml = mat2_case("fallback")
    mesh3 = make_mesh(canvas=3, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="pad the LUT rows"):
        tpm2.shard_mat2_lut(ml, mesh3, ml.pano_hw[0])
    with pytest.raises(ValueError, match="need 5 devices, have 4"):
        make_mesh(canvas=5, devices=[CPU] * 4)
    assert mesh.shape == {"camera": 1, "canvas": 4}


@pytest.mark.parametrize("n", BANDS)
def test_sharded_mat(n):
    """Bands of the single-class kernel == the single-device kernel, single
    and batched (tests/test_torch_parallel_runtime.py holds it against the
    reference's sharded kernel through the stitcher)."""
    j = J()
    frames, lut = j._make_state(np.random.default_rng(3))
    frames = np.array(frames)
    ml = tmat._per_pixel(build_tiled_lut(j.torch_lut(lut), FRAME_HW))
    assert ml.n_fallback == 0
    mesh, _jm = mesh_of(n)
    sm = tpm.shard_mat_lut(ml, mesh, ml.pano_hw[0])
    planar = _planar(frames)
    got = run_banded(tmat.composite_mat_planar, planar, sm)
    assert torch.equal(got, tmat.composite_mat_planar(
        planar, tmat.with_staging_table(ml)))
    got_b = run_banded(tmat.composite_mat_planar_batched,
                       torch.stack([planar, planar.flip(0)]), sm)
    assert torch.equal(got_b[0], got)
    assert torch.equal(got_b[1], run_banded(tmat.composite_mat_planar,
                                            planar.flip(0), sm))


# the band count at which the feather and multiband cases are held against
# the reference's sharded function (tests/test_torch_parallel_runtime.py
# holds both modes against the reference's at 2 and 4 bands)
JAX_BANDS = 4


@functools.lru_cache(maxsize=None)
def feather_case(n: int):
    """(frames, blend LUT) of tests/test_parallel.py's feather fixture, and
    the port's per-pixel state of it padded for n bands."""
    j = J()
    frames, jb = j._synthetic_blend_lut(np.random.default_rng(5),
                                        triple_cols=(130, 131, 700))
    ml = tfe._per_pixel_feather(
        tpf.pad_blend_rows_for_shards(j.torch_blend(jb), n), FRAME_HW)
    return frames, jb, ml


def jax_sharded_feather(n: int) -> np.ndarray:
    j = J()
    frames, jb, _ml = feather_case(n)
    jm = j.j_make_mesh(canvas=n)
    jml = j.jfe.build_feather_mat(j.jpf.pad_blend_rows_for_shards(jb, n),
                                  FRAME_HW)
    assert int(jml.n_fallback) > 0
    sf = j.jpf.shard_feather_lut(jml, jm)
    fn = j.jpf.sharded_composite_feather_fn(jm, sf, interpret=True)
    return np.asarray(fn(j.jmat.frames_to_planar_i8(j.jnp.asarray(frames)),
                         sf))


@pytest.mark.parametrize("n", BANDS)
def test_sharded_feather(n):
    """Bands of the feather kernel, fallback tiles included, == the
    single-device kernel, single and batched, and the reference's sharded
    kernel bit for bit."""
    frames, _jb, ml = feather_case(n)
    mesh, _jm = mesh_of(n)
    sf = tpf.shard_feather_lut(ml, mesh, ml.pano_hw[0])
    assert sum(b.n_fallback for b in sf.bands) == ml.n_fallback > 0
    assert [b.grid_hw[0] for b in sf.bands] == [ml.grid_hw[0] // n] * n
    planar = _planar(frames)
    got = run_banded(tfe.composite_feather_planar, planar, sf)
    assert torch.equal(got, tfe.composite_feather_planar(
        planar, tfe.with_feather_staging(ml)))
    if n == JAX_BANDS:
        np.testing.assert_array_equal(got.numpy(), jax_sharded_feather(n))
    got_b = run_banded(tfe.composite_feather_planar_batched,
                       torch.stack([planar, planar.flip(0)]), sf)
    assert torch.equal(got_b[0], got)
    assert torch.equal(got_b[1], run_banded(tfe.composite_feather_planar,
                                            planar.flip(0), sf))


# -- multiband over piece groups ---------------------------------------------

def jax_sharded_multiband(kind: str, n: int, seed: int) -> np.ndarray:
    j = J()
    jst, _st, crop = j.states(kind, n)
    jm = j.j_make_mesh(canvas=n)
    smb = j.jpmb.shard_multiband_state(jst, jm)
    fn = j.jpmb.sharded_multiband_fn(jm, smb, crop_yx=crop, interpret=True)
    jplanar, _planar_t = j.both_planar(j.frame_sets(seed, 1,
                                                    smooth_last=True))
    return np.asarray(fn(jplanar[0], smb))


@pytest.mark.parametrize("n", BANDS)
@pytest.mark.parametrize("kind", ("plain", "curved"))
def test_sharded_multiband(kind, n):
    """Piece groups summed on the first device: against the port's
    single-device chain (the reference's gate of its own sharded path) and,
    on the registration whose window tiles take the fallback branch,
    against the reference's sharded function."""
    j = J()
    _jst, st, crop = j.states(kind, n)
    mesh, _jm = mesh_of(n)
    smb = tpmb.shard_multiband_state(st, mesh)
    assert smb.pd * n == len(st.piece_cam)
    _jp, planar = j.both_planar(j.frame_sets(31, 1, smooth_last=True))
    got = tpmb.multiband_sharded_frame(planar[0], smb, crop)
    want = tmb.multiband_video_frame(planar[0], j.states(kind)[1], crop)
    d = np.abs(got.numpy().astype(np.int16) - want.numpy())
    assert np.median(d) == 0 and (d <= 2).mean() >= 0.999, d.max()
    if kind == "curved" and n == JAX_BANDS:
        j.assert_panorama_close(got.numpy(),
                                jax_sharded_multiband(kind, n, 31))
    with pytest.raises(ValueError, match="pad_pieces_to"):
        tpmb.shard_multiband_state(st, make_mesh(canvas=n + 1,
                                                 devices=[CPU] * (n + 1)))


def test_multiband_shard_is_rows_of_the_warp_state():
    """A piece group's warp state is the rows of its windows: its warp
    equals those windows of the whole stack's."""
    j = J()
    _jst, st, _crop = j.states("curved", 2)
    mesh, _jm = mesh_of(2)
    smb = tpmb.shard_multiband_state(st, mesh)
    _jp, planar = j.both_planar(j.frame_sets(32, 1))
    whole = tmat2.composite_mat2_planar_pieces(planar[0], st.warp_lut,
                                               len(st.piece_cam))
    assert st.warp_lut.n_fallback > 0
    for b in range(2):
        part = tmat2.composite_mat2_planar_pieces(planar[0], smb.warp[b],
                                                  smb.pd)
        assert torch.equal(part, whole[b * smb.pd:(b + 1) * smb.pd])


# -- the dry run and multi-host ingest ---------------------------------------

@pytest.mark.parametrize("n", (2, 8))
def test_dryrun_multichip(n):
    """`__graft_entry__.dryrun_multichip`'s step on the port: the column-
    sharded gather of the tiny rig and the gain statistics over the canvas
    strips, one real step each on an n-band mesh."""
    j = J()
    from __graft_entry__ import _tiny_lut_and_frames
    frames, lut = _tiny_lut_and_frames(n_cams=4, ph=96, pw=64 * n)
    mesh = make_mesh(canvas=n, devices=[CPU] * n)
    tl = j.torch_lut(lut)
    f = torch.from_numpy(np.asarray(frames))
    out = tpc.sharded_composite_fn(mesh)(f, tpc.shard_lut(tl, mesh))
    assert out.shape == (96, 64 * n, 3)
    assert torch.equal(out, tlut_mod.composite_frame_u8(f, tl))
    mask = (tl.cam_idx.reshape(-1)[None] == torch.arange(4)[:, None]).float()
    lum = out.float().mean(-1).reshape(1, -1).expand(4, -1)
    Nm, Im = tpc.gain_stats_sharded(mesh, lum, mask)
    assert torch.equal(Nm, torch.diag(mask.sum(1)))
    assert torch.allclose(torch.diag(Im), (lum * mask).sum(1))


def multihost_worker(rank: int, world: int, port: int) -> None:
    """One process of the two-process test: joins a gloo group on
    localhost, takes its cameras by `local_camera_slice`, assembles the
    global batch and reduces gain statistics over every process's pixels."""
    import torch.distributed as dist
    from stitchingvideo_tpu_torch.parallel.compose import gain_stats_sharded
    from stitchingvideo_tpu_torch.parallel.ingest import (global_camera_batch,
                                                          local_camera_slice)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        n_cams = 8
        rng = np.random.default_rng(0)        # the same set in every process
        frames = rng.integers(0, 255, (n_cams, 16, 24, 3), np.uint8)
        sl = local_camera_slice(n_cams)
        assert (sl.start, sl.stop) == (rank * 4, rank * 4 + 4), sl
        got = global_camera_batch(torch.from_numpy(frames[sl]))
        assert torch.equal(got, torch.from_numpy(frames))
        means = got.float().mean(dim=(1, 2, 3))
        np.testing.assert_allclose(
            means.numpy(), frames.astype(np.float32).mean(axis=(1, 2, 3)),
            rtol=1e-6)
        # each process holds half of the canvas pixels, in 4 local bands
        lum = rng.uniform(0, 255, (4, 512)).astype(np.float32)
        mask = (rng.uniform(size=(4, 512)) > 0.4).astype(np.float32)
        half = slice(rank * 256, rank * 256 + 256)
        mesh = make_mesh(canvas=4, camera=2, devices=["cpu"] * 8)
        Nm, Im = gain_stats_sharded(mesh, torch.from_numpy(lum[:, half]),
                                    torch.from_numpy(mask[:, half]))
        np.testing.assert_allclose(Nm.numpy(), mask @ mask.T, rtol=1e-5)
        np.testing.assert_allclose(Im.numpy(), (lum * mask) @ mask.T,
                                   rtol=1e-4)
        print(f"multihost worker {rank}/{world} OK", flush=True)
    finally:
        dist.destroy_process_group()


def test_multihost_two_process_gloo():
    """Two processes in a gloo group on localhost: the camera slices cover
    the rig once, the global batch is the whole rig in both, and the gain
    statistics sum both processes' pixels (tests/multihost_worker.py's
    checks). The workers import no jax."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys\n"
            "from tests.test_torch_parallel import multihost_worker\n"
            "multihost_worker(int(sys.argv[1]), 2, int(sys.argv[2]))\n"
            "assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'stitchingvideo_tpu')], 'jax imported'\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(port)], cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {r} failed:\n{out[-3000:]}"
        assert f"multihost worker {r}/2 OK" in out


def test_ingest_without_a_process_group():
    """With no process group both helpers are the single-process identity
    (the reference's degenerate case)."""
    j = J()
    from stitchingvideo_tpu_torch.parallel.ingest import (global_camera_batch,
                                                          local_camera_slice)
    assert local_camera_slice(8) == slice(0, 8)
    f = torch.arange(24, dtype=torch.uint8).reshape(2, 3, 4, 1)
    assert global_camera_batch(f) is f
    assert j.jax.process_count() == 1
