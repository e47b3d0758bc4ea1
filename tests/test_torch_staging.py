"""The staging table of the staged kernels (`ops/staging.py`): mat2, the
single-class kernel (mat), the multiband warp stage (pieces, over its window
stack) and feather, on the reference's fixtures.

The kernels gather their taps from source boxes staged into shared memory
(`csrc/staging.cuh`); their speed, not their function, depends on the table.
These tests hold what the kernels rely on: every tap of a staged block's
kernel pixels lies in its block's box for its camera, every box starts on a
16-column boundary and has a whole number of 16-byte copies a row, the
blocks that do not fit are exactly the ones flagged for the direct gather,
the table changes nothing else in the state, and a numpy model of the
staged gather (boxes copied one after the other, taps read at the kernels'
offsets, the separable integer sum, the store into the panorama or into the
bfloat16 windows) gives the plain version bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

from stitchingvideo_tpu_torch import Registration
from stitchingvideo_tpu_torch.blend import multiband_video as tmb
from stitchingvideo_tpu_torch.ops import composite_feather as tfe
from stitchingvideo_tpu_torch.ops import composite_mat as tmat
from stitchingvideo_tpu_torch.ops import composite_mat2 as tmat2
from stitchingvideo_tpu_torch.ops import staging as stg
from stitchingvideo_tpu_torch.ops.composite_mat import frames_to_planar_i8
from stitchingvideo_tpu_torch.video.lut import CompositeLUT

from tests.test_pallas_composite import _make_state
from tests.test_pallas_feather import _synthetic_blend_lut
from tests.test_torch_composite import (FRAME_HW, STATES, make_state,
                                        port_mat2, torch_lut)
from tests.test_torch_feather import FIXTURES, torch_blend
from tests.test_torch_mat_tiled import CLEAN, port_mat
from tests.test_torch_multiband import CROP, registration_dict
from tests.test_torch_multiband import states as multiband_states

INV = np.float32(1.0 / 16129.0)


def feather_state(name: str):
    """(frames, FeatherMatLUT) of tests/test_pallas_feather.py's fixture."""
    rng = np.random.default_rng(len(name))
    frames, jb = _synthetic_blend_lut(rng, triple_cols=FIXTURES[name])
    return np.asarray(frames), tfe.build_feather_mat(torch_blend(jb), FRAME_HW)


def kernel_taps(ml):
    """(pixel, cam, x0, y0) of every kernel tap set of a state."""
    fields = [ml.fields(s) for s in range(2)] if hasattr(ml, "gw") else \
        [ml.fields()]
    out = []
    for f in fields:
        kern = torch.nonzero(f["cam"] >= 0).reshape(-1)
        out.append((kern, f["cam"][kern], f["x0"][kern], f["y0"][kern]))
    return out


def block_of(pix, pano_hw):
    _, nbx = stg.grid_of(pano_hw)
    Wp = pano_hw[1]
    return (pix // Wp // stg.BLOCK_H) * nbx + (pix % Wp) // stg.BLOCK_W


def states():
    return [("mat2", n) for n in STATES] + [("mat", n) for n in CLEAN] + \
        [("pieces", k) for k in ("plain", "curved")] + \
        [("feather", n) for n in FIXTURES]


def get_state(kind, name):
    """The state of a staged kernel: mat2's and mat's on the reference's
    composite fixtures (mat's without fallback tiles), the multiband warp
    stage's over the window stack of tests/test_torch_multiband.py's
    registrations, feather's on its blend fixtures."""
    if kind == "mat2":
        return port_mat2(name)
    if kind == "mat":
        return port_mat(name)
    if kind == "pieces":
        return multiband_states(name)[1].warp_lut
    return feather_state(name)[1]


@pytest.mark.parametrize("kind,name", states())
def test_boxes_hold_every_tap(kind, name):
    """Every tap of every kernel pixel of a staged block, its second taps
    clamped to the frame, lies in the box of its block for its camera; boxes
    start on a 16-column boundary, hold whole 16-byte copies a row and lie
    inside the frame."""
    ml = get_state(kind, name)
    fh, fw = ml.frame_hw
    t = stg.unpack_table(ml.stage_table)
    nb = int(np.prod(stg.grid_of(ml.pano_hw)))
    assert ml.stage_table.shape == (nb, stg.SLOTS, 4)
    assert ml.stage_table.dtype == torch.int32
    staged = t["cam"][:, 0] != stg.DIRECT
    used = t["cam"] >= 0
    assert bool((t["col0"][used] % 16 == 0).all())
    assert bool((t["cols"][used] % 16 == 0).all())
    assert bool((t["cols"][used] > 0).all() and (t["rows"][used] > 0).all())
    assert bool((t["col0"] + t["cols"] <= fw)[used].all())
    assert bool((t["row0"][used] >= 0).all())
    assert bool((t["row0"] + t["rows"] <= fh)[used].all())
    # slots in ascending camera order, slot 1 only after slot 0
    later = used[:, 0] & (t["cam"][:, 1] > t["cam"][:, 0])
    assert bool((~used[:, 1] | later).all())
    boxes = (t["rows"] * t["cols"] * used).sum(1)
    assert ml.stage_bytes == int(boxes[staged].max()) // 16 * 16 + 16
    checked = 0
    for pix, cam, x0, y0 in kernel_taps(ml):
        b = block_of(pix.long(), ml.pano_hw)
        on = staged[b]
        b, cam, x0, y0 = b[on], cam[on].long(), x0[on].long(), y0[on].long()
        slot = (t["cam"][b] == cam[:, None]).long()
        assert bool((slot.sum(1) == 1).all()), "a camera without a slot"
        s = slot.argmax(1)
        row0, rows = t["row0"][b, s], t["rows"][b, s]
        col0, cols = t["col0"][b, s], t["cols"][b, s]
        for x in (x0, (x0 + 1).clamp(max=fw - 1)):
            assert bool(((x >= col0) & (x < col0 + cols)).all())
        for y in (y0, (y0 + 1).clamp(max=fh - 1)):
            assert bool(((y >= row0) & (y < row0 + rows)).all())
        checked += int(b.numel())
    assert checked > 0
    assert ml.n_direct == int((~staged).sum())


def three_cameras_and_a_tall_box():
    """The fixture map with, in its first block, a tile row of each of three
    cameras (8x128 tiles of one camera each, so no fallback tile), and
    frames of 256 rows that a block further right samples at 6 rows a
    panorama row (a box of ~190 rows, over the budget; its tiles fit their
    source windows)."""
    fh, fw = 256, 512
    frames, lut = _make_state(np.random.default_rng(3), fh=fh, fw=fw)
    cam = np.array(lut.cam_idx)
    sx, sy = np.array(lut.src_x), np.array(lut.src_y)
    cam[8:16, :128] = 2
    cam[16:24, :128] = 1
    xx, yy = np.meshgrid(np.arange(256, dtype=np.float32),
                         np.arange(32, dtype=np.float32))
    sx[:32, 256:512] = 20 + 1.5 * xx
    sy[:32, 256:512] = 4 + 6 * yy
    cam[:32, 256:512] = 0
    lut = CompositeLUT(*(torch.from_numpy(np.ascontiguousarray(a)) for a in
                         (cam, sx, sy, np.array(lut.gain))))
    return np.asarray(frames), lut, (fh, fw)


def test_direct_blocks_are_the_ones_that_do_not_fit(monkeypatch):
    """A block whose kernel pixels tap three cameras, and blocks whose boxes
    exceed the budget, take the direct gather; every other block is staged.
    With a budget under every box, every block with a kernel pixel is
    direct; frames whose rows do not start on 16-byte boundaries stage
    nothing."""
    _frames, lut, frame_hw = three_cameras_and_a_tall_box()
    ml = tmat2.build_mat2_lut(lut, frame_hw)
    assert ml.n_fallback == 0
    t = stg.unpack_table(ml.stage_table)
    nb = t["cam"].shape[0]
    (pix, cam, x0, y0), = kernel_taps(ml)
    blk = block_of(pix.long(), ml.pano_hw)
    n_cams = torch.zeros((nb, 8), dtype=torch.bool)
    n_cams[blk, cam.long()] = True
    n_cams = n_cams.sum(1)
    direct = t["cam"][:, 0] == stg.DIRECT
    assert bool(direct[0]) and int(n_cams[0]) == 3
    # recount each block's boxes from its taps, the way the kernels need them
    fh, fw = frame_hw
    over = torch.zeros(nb, dtype=torch.bool)
    for b in range(nb):
        m = blk == b
        total = 0
        for c in cam[m].unique():
            mc = m & (cam == c)
            xs, ys = x0[mc].long(), y0[mc].long()
            col0 = int(xs.min()) // 16 * 16
            cols = -(-(int((xs + 1).clamp(max=fw - 1).max()) + 1 - col0)
                     // 16) * 16
            rows = int((ys + 1).clamp(max=fh - 1).max()) - int(ys.min()) + 1
            total += rows * cols
        over[b] = total > stg.STAGE_BUDGET
    assert int(over.sum()) > 0
    np.testing.assert_array_equal(direct.numpy(),
                                  ((n_cams > stg.SLOTS) | over).numpy())
    assert ml.n_direct == int(direct.sum())
    # the tall box is the tall sampling's, its block no fallback tile
    assert bool(over[256 // stg.BLOCK_W])        # first block row, x = 256
    # a budget under every box: every block with a kernel pixel is direct
    taps = kernel_taps(ml)
    with monkeypatch.context() as m:
        m.setattr(stg, "STAGE_BUDGET", 16)
        table, stage_bytes, n_direct = stg.staging_table(
            taps, ml.pano_hw, frame_hw)
    assert n_direct == int((n_cams > 0).sum()) and stage_bytes == 16
    # rows that do not start on 16-byte boundaries: no block is staged
    table, _, n_direct = stg.staging_table(taps, ml.pano_hw, (fh, fw - 8))
    assert n_direct == int((n_cams > 0).sum())


def window_stack_tlut():
    """The TiledLUT of the window stack that `build_multiband_state` builds
    for tests/test_torch_multiband.py's 'curved' registration (fallback
    tiles included), as it hands it to `materialize2_used`."""
    seen = []

    def capture(tlut):
        seen.append(tlut)
        return tmat2.materialize2_used(tlut)
    mp = pytest.MonkeyPatch()
    mp.setattr(tmb, "materialize2_used", capture)
    try:
        tmb.build_multiband_state(
            Registration.from_state_dict(registration_dict("curved"),
                                         device="cpu"), FRAME_HW, crop=CROP)
    finally:
        mp.undo()
    return seen[0]


def test_window_stack_state_has_no_table():
    """`materialize2_used` (the pieces kernel's state) builds the staging
    table of its kernel pixels' taps over the window stack's own panorama
    (the windows stacked along rows), and is otherwise the per-pixel state,
    which has no table; the staged kernels refuse a state without one."""
    tlut = window_stack_tlut()
    full, bare = tmat2.materialize2_used(tlut), tmat2._per_pixel2(tlut)
    assert full.pano_hw == tlut.pano_hw and full.n_fallback > 0
    table, stage_bytes, n_direct = stg.staging_table(
        kernel_taps(full), full.pano_hw, full.frame_hw)
    assert torch.equal(full.stage_table, table)
    assert (full.stage_bytes, full.n_direct) == (stage_bytes, n_direct)
    assert table.shape[0] == int(np.prod(stg.grid_of(tlut.pano_hw)))
    assert bool((table[:, 0, 0] >= 0).any())          # staged blocks
    assert bare.stage_table is None and (bare.stage_bytes, bare.n_direct) \
        == (0, 0)
    for f in dataclasses.fields(full):
        if f.name in ("stage_table", "stage_bytes", "n_direct"):
            continue
        a, b = getattr(full, f.name), getattr(bare, f.name)
        assert torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b
    frames, _lut = make_state("poisoned")
    planar = frames_to_planar_i8(torch.from_numpy(np.asarray(frames)))[None]
    with pytest.raises(ValueError, match="no staging table"):
        tmat2.check_staged(planar, (bare.tap_xy, bare.tap_cw, bare.gc), None)


@pytest.mark.parametrize("name", CLEAN)
def test_mat_table_is_mat2s_on_a_clean_lut(name):
    """Without fallback tiles mat's kernel pixels tap what mat2's tap: the
    two states have the same staging table."""
    ml, ml2 = port_mat(name), port_mat2(name)
    assert ml.n_fallback == 0 and ml.stage_table is not None
    assert torch.equal(ml.stage_table, ml2.stage_table)
    assert (ml.stage_bytes, ml.n_direct) == (ml2.stage_bytes, ml2.n_direct)


@pytest.mark.parametrize("kind", ("mat2", "mat", "feather"))
def test_state_fields_unchanged_by_the_table(kind, monkeypatch):
    """The staging table is new state beside the old: every other field of
    the state is what the build gives without it."""
    if kind in ("mat2", "mat"):
        _frames, lut = make_state("poisoned" if kind == "mat2" else "rot04")
        build_lut = tmat2.build_mat2_lut if kind == "mat2" else \
            tmat.build_mat_lut

        def build():
            return build_lut(torch_lut(lut), FRAME_HW)
        module = tmat2
    else:
        rng = np.random.default_rng(len("fallback"))
        _frames, jb = _synthetic_blend_lut(
            rng, triple_cols=FIXTURES["fallback"])

        def build():
            return tfe.build_feather_mat(torch_blend(jb), FRAME_HW)
        module = tfe
    full = build()
    monkeypatch.setattr(module, "staging_table", lambda *a, **k: (
        torch.zeros((0, stg.SLOTS, 4), dtype=torch.int32), 16, 0))
    bare = build()
    for f in dataclasses.fields(full):
        if f.name in ("stage_table", "stage_bytes", "n_direct"):
            continue
        a, b = getattr(full, f.name), getattr(bare, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def staged_sums(planar, ml, tap_xy, tap_cw, b, c):
    """The kernels' integer sums S of one plane (frame set b, channel c), on
    the kernel pixels of staged blocks, as the kernels form them: each
    staged block's boxes copied one after the other into a stage (16 bytes
    past them), the taps read at the kernels' offsets (the tap right of a
    tap is the next byte), S = ay * h0 + (127 - ay) * h1 with h = a * v0 +
    (127 - a) * v1 a row. Returns (pixels, S)."""
    fh, fw = ml.frame_hw
    t = {k: v.numpy() for k, v in stg.unpack_table(ml.stage_table).items()}
    cw, xy = tap_cw.numpy().astype(np.int64), tap_xy.numpy().astype(np.int64)
    kern = np.nonzero(cw >= 0)[0]
    blk = block_of(torch.from_numpy(kern), ml.pano_hw).numpy()
    pixels, sums = [], []
    for bi in np.unique(blk):
        if t["cam"][bi, 0] == stg.DIRECT:
            continue
        stage, base = [], {}
        for s in range(stg.SLOTS):
            cam = t["cam"][bi, s]
            if cam < 0:
                continue
            r0, c0 = t["row0"][bi, s], t["col0"][bi, s]
            base[cam] = sum(len(x) for x in stage)
            box = planar[b, cam, c, r0:r0 + t["rows"][bi, s],
                         c0:c0 + t["cols"][bi, s]]
            stage.append(box.reshape(-1))
        pad = np.full(16, 99, np.int8)
        st = np.concatenate(stage + [pad]).astype(np.int64)
        p = kern[blk == bi]
        cam, x0, y0 = cw[p] >> 16, xy[p] & 0xFFFF, xy[p] >> 16
        a, ay = (cw[p] >> 8) & 0xFF, cw[p] & 0xFF
        s = (cam[:, None] == t["cam"][bi][None]).argmax(1)
        cols = t["cols"][bi][s]
        o00 = np.array([base[k] for k in cam]) + (y0 - t["row0"][bi][s]) \
            * cols + x0 - t["col0"][bi][s]
        o10 = o00 + (np.minimum(y0 + 1, fh - 1) - y0) * cols
        h0 = a * st[o00] + (127 - a) * st[o00 + 1]
        h1 = a * st[o10] + (127 - a) * st[o10 + 1]
        assert np.abs(np.concatenate([h0, h1])).max() <= 16256   # int16
        pixels.append(p)
        sums.append(ay * h0 + (127 - ay) * h1)
    return np.concatenate(pixels), np.concatenate(sums)


def u8(v):
    return np.clip(np.rint(v), 0, 255).astype(np.uint8)


def model_planes(planar, ml):
    """The staged kernels' uint8 results of every plane, modelled: on the
    kernel pixels of staged blocks (f32(S) * f32(1/16129) + 128) * gc, each
    step rounded, then rounded half to even and clamped; 0 on the other
    pixels of staged blocks and of blocks without a kernel pixel, which
    stage nothing. Returns ([B, 3, Hp*Wp] uint8, [Hp*Wp] bool: the pixels
    modelled, neither fallback pixels nor pixels of direct blocks)."""
    B = planar.shape[0]
    npix = ml.tap_cw.numel()
    gc = ml.gc.numpy()
    direct = (ml.stage_table[:, 0, 0] == stg.DIRECT).numpy()
    on = ~direct[block_of(torch.arange(npix), ml.pano_hw).numpy()] \
        & (ml.tap_cw.numpy() != tmat2.FALLBACK)
    out = np.zeros((B, 3, npix), np.uint8)
    for b in range(B):
        for c in range(3):
            p, s = staged_sums(planar.numpy(), ml, ml.tap_xy, ml.tap_cw, b, c)
            v = s.astype(np.float32) * INV
            out[b, c, p] = u8((v + np.float32(128)) * gc[p])
    return out, on


def window_store(planes, on, pieces, Hb, Wb):
    """The pieces kernel's store of modelled planes [B, 3, pieces*Hb*Wb]: a
    stack pixel p of row y goes to window y // Hb, at p + 2 * (y // Hb) *
    win of its plane (b, c) at (b * pieces * 3 + c) * win, as bfloat16.
    Returns ([B, pieces, 3, Hb, Wb] bfloat16, the same-shaped mask of the
    modelled values)."""
    B = planes.shape[0]
    win = Hb * Wb
    p = np.nonzero(on)[0]
    at = p + 2 * (p // Wb // Hb) * win
    out = torch.zeros(B * pieces * 3 * win, dtype=torch.bfloat16)
    mask = torch.zeros(B * pieces * 3 * win, dtype=torch.bool)
    for b in range(B):
        for c in range(3):
            i = torch.from_numpy((b * pieces * 3 + c) * win + at)
            out[i] = torch.from_numpy(planes[b, c, p]).to(torch.bfloat16)
            mask[i] = True
    shape = (B, pieces, 3, Hb, Wb)
    return out.reshape(shape), mask.reshape(shape)


# mat2's and mat's fixtures, the multiband window stacks, and mat2's
# 64-row 'poisoned' fixture as a stack of 8 windows of 8 rows (blocks span
# four windows; fallback tiles)
MODELLED = [pytest.param("mat2", n, id=n) for n in ("rot04", "poisoned",
                                                    "edge")] + \
    [("mat", n) for n in CLEAN] + \
    [("pieces", k) for k in ("plain", "curved")] + [("pieces8", "poisoned")]


@pytest.mark.parametrize("kind,name", MODELLED)
def test_staged_gather_model_is_the_plain_mat2(kind, name):
    """The staged gather of mat2, mat and the pieces kernel, modelled in
    numpy with the kernel's float tail, equals the plain version on every
    pixel it models; for the pieces kernel the model stores into the
    bfloat16 window layout and is held against
    `composite_mat2_pieces_plain` bit for bit."""
    if kind == "pieces":
        rng = np.random.default_rng(7)
        ml = multiband_states(name)[1].warp_lut
        pieces = len(multiband_states(name)[1].piece_cam)
        batch = rng.integers(0, 256, (2, 3) + ml.frame_hw + (3,), np.uint8)
    else:
        frames, _lut = make_state(name)
        ml = port_mat(name) if kind == "mat" else port_mat2(name)
        pieces = 8 if kind == "pieces8" else 0
        batch = np.stack([frames, np.roll(frames, 5, axis=2)])
    planar = frames_to_planar_i8(torch.from_numpy(batch))
    planes, on = model_planes(planar, ml)
    kern = ml.tap_cw.numpy() >= 0
    assert on[kern].mean() > 0.5
    if not pieces:
        plain = tmat.composite_mat_plain if kind == "mat" else \
            tmat2.composite_mat2_plain
        want = plain(planar, ml).reshape(2, 3, -1).numpy()
        np.testing.assert_array_equal(planes[:, :, on], want[:, :, on])
        return
    Hb, Wb = ml.pano_hw[0] // pieces, ml.pano_hw[1]
    assert (Hb % stg.BLOCK_H != 0) == (kind == "pieces8")
    got, mask = window_store(planes, on, pieces, Hb, Wb)
    want = tmat2.composite_mat2_pieces_plain(planar, ml, pieces)
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got[mask], want[mask])
    assert bool((want[mask] > 0).any())
    assert (ml.n_fallback > 0) == (name in ("curved", "poisoned"))


@pytest.mark.parametrize("name", list(FIXTURES))
def test_staged_gather_model_is_the_plain_feather(name):
    """Feather's staged gather, modelled in numpy with the kernel's order
    (acc = 0 + v0 * gw0, then + v1 * gw1, then + 128 * (gw0 + gw1)), equals
    the plain version on every pixel whose live slots are all staged."""
    frames, ml = feather_state(name)
    planar = frames_to_planar_i8(torch.from_numpy(frames))[None]
    want = tfe.composite_feather_plain(planar, ml).reshape(3, -1).numpy()
    npix = ml.tap_cw.shape[1]
    gw = ml.gw.numpy()
    restore = np.float32(128) * (gw[0] + gw[1])
    live = ml.tap_cw.numpy() >= 0
    for c in range(3):
        acc = np.zeros(npix, np.float32)
        staged = np.zeros(npix, bool)
        for s in range(2):
            p, S = staged_sums(planar.numpy(), ml, ml.tap_xy[s],
                               ml.tap_cw[s], 0, c)
            acc[p] = acc[p] + (S.astype(np.float32) * INV) * gw[s][p]
            staged[p] = True
        ok = live.any(0) & staged
        got = u8(acc + restore)
        np.testing.assert_array_equal(got[ok], want[c, ok])
    assert ok.sum() > 0.5 * live.any(0).sum()
    assert (live.all(0) & ok).any()              # two-slot pixels


def test_library_name_hashes_included_headers(tmp_path):
    """A kernel library is named by a hash of its source and of the headers
    the source includes from its directory, headers of headers too: editing
    a header renames the library, so the card never runs stale code."""
    from stitchingvideo_tpu_torch.ops import _cuda
    (tmp_path / "k.cu").write_text('#include "a.cuh"\nint k;\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    lib = _cuda.KernelLibrary("k", [])
    lib.source = tmp_path / "k.cu"
    assert _cuda.local_includes(lib.source) == [
        tmp_path / "k.cu", tmp_path / "a.cuh", tmp_path / "b.cuh"]
    before = lib.path
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert lib.path != before and lib.path.parent == _cuda.BUILD_DIR
    # the port's staged kernels include the shared header
    for stem in ("composite_mat2", "composite_feather"):
        assert _cuda.CSRC / "staging.cuh" in _cuda.local_includes(
            _cuda.CSRC / f"{stem}.cu")
