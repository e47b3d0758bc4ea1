"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. They import neither JAX
nor the JAX package (the plain versions are held against the JAX package by
the other test_torch_* files), so on a machine with a card and no JAX they
run without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import multiband_registration
from stitchingvideo_tpu_torch import (Registration, StitchConfig,
                                      VideoStitcher)
from stitchingvideo_tpu_torch.blend import multiband_video as mb
from stitchingvideo_tpu_torch.ops import composite as tiled
from stitchingvideo_tpu_torch.ops import composite_feather as fe
from stitchingvideo_tpu_torch.ops import composite_mat as mat
from stitchingvideo_tpu_torch.ops import composite_mat2 as m2
from stitchingvideo_tpu_torch.ops import staging
from stitchingvideo_tpu_torch.ops import window_probe as wp
from stitchingvideo_tpu_torch.ops.composite_mat import frames_to_planar_i8
from stitchingvideo_tpu_torch.ops.remap_tiled import remap_tiled
from stitchingvideo_tpu_torch.video.lut import CompositeLUT, composite_frame_u8

pytestmark = pytest.mark.cuda

FRAME_HW = (128, 512)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _state(kind: str, seed: int = 0, n_cams=3, ph=64, pw=1024):
    """tests/test_pallas_composite.py's fixture map, in numpy, with the
    poisoned 3-camera tiles and the frame-edge taps of test_torch_composite."""
    fh, fw = FRAME_HW
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (n_cams, fh, fw, 3), np.uint8)
    xx, yy = np.meshgrid(np.arange(pw, dtype=np.float32),
                         np.arange(ph, dtype=np.float32))
    seg = pw // n_cams
    cam = np.clip(xx.astype(np.int32) // seg, 0, n_cams - 1)
    lx = xx - cam * seg
    rot = 0.4 if kind == "rot04" else 0.05
    sx = (8 + lx * (fw - 16) / seg + rot * yy).astype(np.float32)
    sy = (8 + yy * (fh - 16) / ph - rot * lx * 0.2).astype(np.float32)
    valid = (sx > 1) & (sx < fw - 2) & (sy > 1) & (sy < fh - 2)
    cam = np.where(valid, cam, -1).astype(np.int32)
    if kind == "poisoned":
        cam[4:6, 200:210] = 1
        cam[4:6, 210:220] = 2
        cam[40:44, 980:990] = 0
        cam[40:44, 990:1000] = 1
    if kind == "edge":
        sx[sx > fw - 12] = fw - 1.0
        sy[-1, :] = fh - 1.0
        sx[:, ::7] = np.floor(sx[:, ::7])
        sy[::3, :] = np.floor(sy[::3, :])
        # coordinates in (0, 1) whose f32 weight 127 * (1 - fx) is exactly
        # 30.5 / 48.5: round half to EVEN gives 30 / 48
        sx[sx < 12] = np.float32(0.7598425149917603)
        sy[sy < 9] = np.float32(0.6181102395057678)
    gain = (1.0 + 0.1 * np.sin(xx / 31.0)).astype(np.float32)
    lut = CompositeLUT(*(torch.from_numpy(a) for a in (cam, sx, sy, gain)))
    return torch.from_numpy(frames), lut


@pytest.mark.parametrize("kind", ("rot005", "rot04", "poisoned", "edge"))
def test_composite_mat2_kernel_matches_plain(dev, kind):
    frames, lut = _state(kind)
    lut = lut.to(dev)
    ml = m2.build_mat2_lut(lut, FRAME_HW)
    planar = frames_to_planar_i8(frames.to(dev))
    before = m2.MAT2_SINGLE.launches
    got = m2.composite_mat2_planar(planar, ml)
    torch.cuda.synchronize()
    assert m2.MAT2_SINGLE.launches == before + 1
    want = m2.composite_mat2_plain(planar[None], ml)[0]
    assert torch.equal(got, want)
    # and the plain version on the card is the plain version on the CPU
    ml_cpu = m2.build_mat2_lut(lut.to("cpu"), FRAME_HW)
    assert torch.equal(want.cpu(),
                       m2.composite_mat2_plain(planar.cpu()[None], ml_cpu)[0])
    ref = composite_frame_u8(frames.to(dev), lut).permute(2, 0, 1)
    diff = (got.int() - ref.int()).abs().float()
    assert diff.median() <= 1 and (diff <= 4).float().mean() > 0.999


def test_batched_kernel_matches_single(dev):
    frames, lut = _state("poisoned")
    ml = m2.build_mat2_lut(lut.to(dev), FRAME_HW)
    batch = torch.stack([frames, frames.flip(1), frames.roll(7, 2)]).to(dev)
    planar = frames_to_planar_i8(batch)
    got = m2.composite_mat2_planar_batched(planar, ml)
    assert got.shape == (3, 3, 64, 1024)
    assert torch.equal(got, m2.composite_mat2_plain(planar, ml))
    for b in range(3):
        assert torch.equal(got[b], m2.composite_mat2_planar(planar[b], ml))


@pytest.mark.parametrize("shape", ((2, 3, 3, 16, 256), (3, 5, 3, 24, 132),
                                   (1, 1, 3, 8, 96)))
def test_shift_planar_bn_kernel_matches_plain(dev, shape):
    gen = torch.Generator(device=dev).manual_seed(3)
    x = torch.randint(-128, 128, shape, dtype=torch.int8, device=dev,
                      generator=gen)
    got = m2.shift_planar_bn(x)
    assert torch.equal(got, m2.shift_planar_bn_plain(x))


def test_kernels_refuse_what_they_do_not_take(dev):
    x = torch.zeros((1, 1, 3, 8, 130), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        m2.shift_planar_bn(x)                       # W % 4 != 0
    frames, lut = _state("rot005")
    ml = m2.build_mat2_lut(lut.to(dev), FRAME_HW)
    planar = frames_to_planar_i8(frames.to(dev))
    with pytest.raises(ValueError):
        m2.composite_mat2_planar(planar.cpu(), ml)   # LUT on another device


# panorama sizes that are no multiple of the 8x128 tile; "rot04" leaves an
# uncovered region (coordinates outside the frame)
ODD = dict(ph=61, pw=1000)


@pytest.mark.parametrize("kind", ("rot005", "rot04", "edge"))
def test_composite_mat_kernel_matches_plain(dev, kind):
    frames, lut = _state(kind, **ODD)
    lut = lut.to(dev)
    ml = mat.build_mat_lut(lut, FRAME_HW)
    assert ml.n_fallback == 0
    assert bool((ml.tap_cw < 0).any()) == (kind == "rot04")
    batch = torch.stack([frames, frames.flip(1), frames.roll(7, 2)]).to(dev)
    planar = frames_to_planar_i8(batch)
    before = mat.MAT_SINGLE.launches, mat.MAT_BATCHED.launches
    got1 = mat.composite_mat_planar(planar[0], ml)
    got3 = mat.composite_mat_planar_batched(planar, ml)
    torch.cuda.synchronize()
    assert (mat.MAT_SINGLE.launches, mat.MAT_BATCHED.launches) == \
        (before[0] + 1, before[1] + 1)
    assert got3.shape == (3, 3, 61, 1000)
    assert torch.equal(got3, mat.composite_mat_plain(planar, ml))
    assert torch.equal(got1, got3[0])
    # without fallback tiles mat is mat2
    ml2 = m2.build_mat2_lut(lut, FRAME_HW)
    assert torch.equal(got3, m2.composite_mat2_planar_batched(planar, ml2))


@pytest.mark.parametrize("kind", ("rot005", "rot04", "edge"))
def test_composite_tiled_kernel_matches_plain(dev, kind):
    frames, lut = _state(kind, **ODD)
    lut = lut.to(dev)
    tl = tiled.build_tiled_lut(lut, FRAME_HW)
    assert tl.n_fallback == 0
    before = tiled.TILED.launches
    got = tiled.composite_tiled(frames.to(dev), tl)
    torch.cuda.synchronize()
    assert tiled.TILED.launches == before + 1
    assert got.shape == (61, 1000, 3)
    planar = frames.to(dev).permute(0, 3, 1, 2).contiguous()
    want = tiled.composite_tiled_plain(planar, tl)
    assert torch.equal(got, want)
    tl_cpu = tiled.build_tiled_lut(lut.to("cpu"), FRAME_HW)
    assert torch.equal(want.cpu(),
                       tiled.composite_tiled_plain(planar.cpu(), tl_cpu))
    ref = composite_frame_u8(frames.to(dev), lut)
    diff = (got.int() - ref.int()).abs().float()
    assert diff.median() <= 1 and (diff <= 3).float().mean() > 0.999
    assert bool((got[lut.cam_idx < 0] == 0).all())


def test_remap_tiled_on_the_card(dev):
    frames, lut = _state("rot005", **ODD)
    own = (lut.cam_idx == 1).to(dev)
    minus = torch.full((), -1.0, device=dev)
    got = remap_tiled(frames[1].to(dev), torch.where(own, lut.src_x.to(dev),
                                                     minus),
                      torch.where(own, lut.src_y.to(dev), minus))
    want = remap_tiled(frames[1], torch.where(own.cpu(), lut.src_x, -1.0),
                       torch.where(own.cpu(), lut.src_y, -1.0))
    assert got is not None and torch.equal(got.cpu(), want)
    gen = torch.Generator().manual_seed(1)
    scrambled = torch.rand((16, 256), generator=gen) * 100
    assert remap_tiled(frames[1].to(dev), scrambled.to(dev) * 5,
                       scrambled.to(dev)) is None


def _blend_state(triple_cols=(), N=3, Hp=61, Wp=700, seed=0,
                 frame_hw=FRAME_HW):
    """tests/test_pallas_feather.py's synthetic blend LUT, in numpy: side-
    by-side cameras with ramped overlap bands; `triple_cols` name a third
    camera (fallback tiles); the last columns are uncovered."""
    fh, fw = frame_hw
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 255, (N, fh, fw, 3), np.uint8)
    xx, yy = np.meshgrid(np.arange(Wp, dtype=np.float32),
                         np.arange(Hp, dtype=np.float32))
    seg = Wp // N
    camA = np.clip((xx / seg).astype(np.int32), 0, N - 1)
    bpos = (xx - camA * seg) / seg
    ov = 0.25
    wA = np.ones((Hp, Wp), np.float32)
    camB = np.full((Hp, Wp), -1, np.int32)
    wB = np.zeros((Hp, Wp), np.float32)
    right = (bpos > 1 - ov) & (camA < N - 1)
    wA[right] = ((1 - bpos[right]) / ov) * 0.5 + 0.5
    camB[right] = camA[right] + 1
    wB[right] = 1 - wA[right]
    for c in triple_cols:
        camB[:, c] = (camA[:, c] + 2) % N
        wB[:, c] = 0.3
        wA[:, c] = 0.7
    camA[:, -9:] = -1
    wA[:, -9:] = 0.0
    sxA = 8 + (xx - np.maximum(camA, 0) * seg) * (fw - 16) / seg * 0.6
    syA = 8 + yy * (fh - 16) / Hp * 0.8
    sxB = np.where(camB >= 0, 10 + (xx % seg) * 0.1, 0.0)
    gA = 1.0 + 0.1 * np.sin(xx / 31)
    f32 = np.float32
    blut = fe.BlendLUT(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (
        camA, sxA.astype(f32), syA.astype(f32), (wA * gA).astype(f32),
        camB, sxB.astype(f32), syA.astype(f32), (wB * gA).astype(f32))))
    return torch.from_numpy(frames), blut


@pytest.mark.parametrize("triple_cols", ((), (130, 131, 600)),
                         ids=("clean", "fallback"))
def test_composite_feather_kernel_matches_plain(dev, triple_cols):
    frames, blut = _blend_state(triple_cols)
    ml = fe.build_feather_mat(blut.to(dev), FRAME_HW)
    assert (ml.n_fallback > 0) == bool(triple_cols)
    live = ml.tap_cw >= 0
    assert bool((live[0] & live[1]).any())           # two-slot pixels
    assert bool((~live[0] & ~live[1] & (ml.tap_cw[0] == -1)).any())
    batch = torch.stack([frames, frames.flip(1), frames.roll(7, 2)]).to(dev)
    planar = frames_to_planar_i8(batch)
    before = fe.FEATHER_SINGLE.launches, fe.FEATHER_BATCHED.launches
    got1 = fe.composite_feather_planar(planar[0], ml)
    got3 = fe.composite_feather_planar_batched(planar, ml)
    torch.cuda.synchronize()
    assert (fe.FEATHER_SINGLE.launches, fe.FEATHER_BATCHED.launches) == \
        (before[0] + 1, before[1] + 1)
    assert got3.shape == (3, 3, 61, 700)
    assert torch.equal(got3, fe.composite_feather_plain(planar, ml))
    assert torch.equal(got1, got3[0])
    # the plain version on the card is the plain version on the CPU
    ml_cpu = fe.build_feather_mat(blut, FRAME_HW)
    assert torch.equal(got3.cpu(),
                       fe.composite_feather_plain(planar.cpu(), ml_cpu))
    oracle = torch.round(fe.composite_blend_gather(frames.to(dev),
                                                   blut.to(dev)))
    diff = (got1.permute(1, 2, 0).int() - oracle.clamp(0, 255).int()).abs()
    assert diff.float().median() == 0 and int(diff.max()) <= 3
    if triple_cols:
        assert int(diff[:, list(triple_cols)].max()) <= 1


def test_new_kernels_refuse_what_they_do_not_take(dev):
    frames, lut = _state("poisoned")
    lut = lut.to(dev)
    planar = frames_to_planar_i8(frames.to(dev))
    with pytest.raises(ValueError, match="fallback"):
        mat.composite_mat_planar(planar, mat.build_mat_lut(lut, FRAME_HW))
    with pytest.raises(ValueError, match="fallback"):
        tiled.composite_tiled(frames.to(dev),
                              tiled.build_tiled_lut(lut, FRAME_HW))
    # the runtime refuses such a LUT at install: nothing on the card gives
    # way to a plain version
    for kernel in ("mat", "tiled"):
        cfg = StitchConfig()
        vs = VideoStitcher(cfg.replace(
            video=dataclasses.replace(cfg.video, kernel=kernel)))
        with pytest.raises(ValueError, match="fallback tiles"):
            vs.install_lut(lut, FRAME_HW)
        assert vs._lut is None and vs.registrations == 0
    frames, blut = _blend_state()
    ml = fe.build_feather_mat(blut.to(dev), FRAME_HW)
    with pytest.raises(ValueError):
        fe.composite_feather_planar(frames_to_planar_i8(frames), ml)


# -- the multiband warp stage and the window-copy probe ----------------------

def _multiband_state(dev, curved: bool):
    """A reduced 5-camera registration (chip_smoke.py's rig at 128x512
    frames, 4 bands); 'curved' widens its curvature patch so that whole
    window tiles overflow their source window (fallback tiles)."""
    d = multiband_registration(0, FRAME_HW, step=200, width=260,
                               canvas_h=128, f_src=150.0)
    d.pop("frame_hw")
    if curved:
        cols = np.arange(40, 240, dtype=np.float32)
        d["xmaps"][2][56:80, 40:240] = 30.0 + 2.2 * (cols - 40)
        d["valid"][2][56:80, 40:240] = True
        d["seam_masks"][2][56:80, 40:240] = True
    reg = Registration.from_state_dict(d, device=dev)
    return mb.build_multiband_state(reg, FRAME_HW, crop=(12, 116, 10, 1050))


@pytest.mark.parametrize("curved", (False, True), ids=("plain", "curved"))
def test_pieces_kernel_matches_plain(dev, curved):
    st, _ = _multiband_state(dev, curved)
    ml, Nv = st.warp_lut, len(st.piece_cam)
    assert (ml.n_fallback > 0) == curved
    gen = torch.Generator(device=dev).manual_seed(5)
    planar = torch.randint(-128, 128, (3, 5, 3) + FRAME_HW, dtype=torch.int8,
                           device=dev, generator=gen)
    before = m2.PIECES_SINGLE.launches, m2.PIECES_BATCHED.launches
    got1 = m2.composite_mat2_planar_pieces(planar[0], ml, Nv)
    got3 = m2.composite_mat2_planar_pieces_batched(planar, ml, Nv)
    torch.cuda.synchronize()
    assert (m2.PIECES_SINGLE.launches, m2.PIECES_BATCHED.launches) == \
        (before[0] + 1, before[1] + 1)
    assert got3.dtype == torch.bfloat16
    assert got3.shape == (3, Nv, 3) + st.buf_hw
    want = m2.composite_mat2_pieces_plain(planar, ml, Nv)
    assert torch.equal(got3, want) and torch.equal(got1, got3[0])
    # the plain version on the card is the plain version on the CPU
    assert torch.equal(want.cpu(), m2.composite_mat2_pieces_plain(
        planar.cpu(), ml.to("cpu"), Nv))
    uncovered = (ml.tap_cw == m2.UNCOVERED).reshape(Nv, 1, *st.buf_hw)
    assert bool((got1[uncovered.expand_as(got1)] == 0).all())
    with pytest.raises(ValueError):
        m2.composite_mat2_planar_pieces(planar[0].cpu(), ml, Nv)


def test_multiband_on_the_card(dev):
    """The multiband panorama on the card against the same code on the CPU
    (the tolerance of tests/test_torch_multiband.py: median 0, <= 1 step on
    <= 1% of values, none above 2), batched == single bit for bit, and the
    stitcher goes through the warp kernel."""
    st, crop = _multiband_state(dev, curved=True)
    st_cpu = st.to("cpu")
    gen = torch.Generator(device=dev).manual_seed(6)
    planar = torch.randint(-128, 128, (2, 5, 3) + FRAME_HW, dtype=torch.int8,
                           device=dev, generator=gen)
    before = m2.PIECES_BATCHED.launches
    got = mb.multiband_video_frames_batched(planar, st, crop)
    assert m2.PIECES_BATCHED.launches == before + 1
    assert got.shape == (2, 3, 104, 1040) and got.dtype == torch.uint8
    for b in range(2):
        assert torch.equal(got[b], mb.multiband_video_frame(planar[b], st,
                                                            crop))
    want = mb.multiband_video_frames_batched(planar.cpu(), st_cpu, crop)
    diff = (got.cpu().int() - want.int()).abs()
    assert float(diff.float().median()) == 0 and int(diff.max()) <= 2
    assert float((diff > 0).float().mean()) <= 0.01
    assert int((diff > 1).sum()) == 0
    # through the stitcher: the default device is the card
    cfg = StitchConfig()
    vs = VideoStitcher(cfg.replace(
        video=dataclasses.replace(cfg.video, compose_mode="multiband")))
    d = multiband_registration(0, FRAME_HW, step=200, width=260,
                               canvas_h=128, f_src=150.0)
    d.pop("frame_hw")
    reg = Registration.from_state_dict(d)
    from stitchingvideo_tpu_torch.video.lut import build_lut
    vs.install_lut(build_lut(reg), FRAME_HW, reg=reg)
    assert vs._mbtlut is not None and vs._tlut is None
    frames = list(np.random.default_rng(7).integers(
        0, 256, (5,) + FRAME_HW + (3,), dtype=np.uint8))
    before = m2.PIECES_BATCHED.launches
    pano = vs.composite(frames)
    assert m2.PIECES_BATCHED.launches == before + 1
    # the uncropped LUT froze the output at the canvas; the multiband state
    # carries the runtime's crop margins and sits in its top-left corner
    assert pano.dtype == np.uint8 and pano.shape == (128, 1088, 3)
    assert (pano[:104, :1040] > 0).mean() > 0.9


@pytest.mark.parametrize("align", (128, 32, 16, 8, 4))
@pytest.mark.parametrize("hw", ((1088, 1920), (40, 304)), ids=str)
def test_window_probe_kernel_matches_plain(dev, align, hw):
    H, W = hw
    rng = np.random.default_rng(align)
    frame = torch.from_numpy(rng.integers(-128, 128, (3, H, W),
                                          dtype=np.int8)).to(dev)
    n = 300
    oy = rng.integers(0, H - wp.WIN_H + 1, n)
    ox = rng.integers(0, (W - wp.WIN_W) // align + 1, n) * align
    org = torch.from_numpy(np.stack([oy, ox], 1).astype(np.int32)).to(dev)
    before = wp.WINDOW_PROBE.launches
    got = wp.window_probe(frame, org, align)
    torch.cuda.synchronize()
    assert wp.WINDOW_PROBE.launches == before + 1
    assert got.shape == (n, 2, 128) and got.dtype == torch.float32
    assert torch.equal(got, wp.window_probe_plain(frame, org))
    assert torch.equal(got.cpu(), wp.window_probe(frame.cpu(), org.cpu()))


def test_window_probe_refuses_what_it_does_not_take(dev):
    frame = torch.zeros((3, 64, 512), dtype=torch.int8, device=dev)
    org = torch.tensor([[0, 0], [40, 0], [0, 260], [0, 130], [8, 128]],
                       dtype=torch.int32, device=dev)
    got = wp.window_probe(frame, org, 128)
    # rows past the frame, columns past the frame, an origin off its
    # alignment: NaN; the windows inside the frame are summed
    assert got.isnan().reshape(5, -1).all(dim=1).tolist() == \
        [False, True, True, True, False]
    with pytest.raises(ValueError):
        wp.window_probe(frame, org, 2)                  # no copy that narrow
    with pytest.raises(ValueError):
        wp.window_probe(frame, org.cpu(), 128)          # another device
    with pytest.raises(ValueError):
        wp.window_probe(frame[:, :, :500], org, 128)    # not contiguous
    with pytest.raises(ValueError):
        wp.window_probe(frame.to(torch.uint8), org, 128)


# -- the staged mat2 and feather kernels --------------------------------------

def _direct_lut():
    """`_state`'s map at 256-row frames on a 192x2048 panorama (boxes within
    the staging budget) with, in the first block, a tile row of each of
    three cameras (8x128 tiles of one camera each, no fallback tile), and
    blocks right of x = 256 that sample 6 frame rows a panorama row (boxes
    over the budget; their tiles fit their windows): both take the kernel's
    direct gather, every other block is staged."""
    fh, fw = 256, 512
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 255, (3, fh, fw, 3), np.uint8)
    ph, pw = 192, 2048
    xx, yy = np.meshgrid(np.arange(pw, dtype=np.float32),
                         np.arange(ph, dtype=np.float32))
    seg = pw // 3
    cam = np.clip(xx.astype(np.int32) // seg, 0, 2)
    lx = xx - cam * seg
    sx = (8 + lx * (fw - 16) / seg + 0.05 * yy).astype(np.float32)
    sy = (8 + yy * (fh - 16) / ph - 0.01 * lx).astype(np.float32)
    cam[8:16, :128] = 2
    cam[16:24, :128] = 1
    sx[:32, 256:512] = 20 + 1.5 * xx[:32, :256]
    sy[:32, 256:512] = 4 + 6 * yy[:32, :256]
    cam[:32, 256:512] = 0
    valid = (sx > 1) & (sx < fw - 2) & (sy > 1) & (sy < fh - 2)
    cam = np.where(valid, cam, -1).astype(np.int32)
    gain = (1.0 + 0.1 * np.sin(xx / 31.0)).astype(np.float32)
    lut = CompositeLUT(*(torch.from_numpy(a) for a in (cam, sx, sy, gain)))
    return torch.from_numpy(frames), lut, (fh, fw)


def _mat2_case(kind, dev):
    """(frames [N, H, W, 3], MatLUT2 on the card, frame_hw) of a staged
    kernel case, its panorama tall enough that its boxes fit the staging
    budget: 'poisoned' has fallback tiles; 'odd' a 122x1000 panorama (no
    multiple of the 32x32 block), 'ragged' a 122x998 one (rows of no
    multiple of 4 pixels: no 16-byte state loads, byte stores);
    'ragged_fallback' the poisoned map at 122x998, a fallback tile at its
    ragged right edge; 'direct' blocks of the direct gather."""
    if kind == "direct":
        frames, lut, frame_hw = _direct_lut()
    else:
        shape = {"poisoned": dict(ph=128), "odd": dict(ph=122, pw=1000),
                 "ragged": dict(ph=122, pw=998),
                 "ragged_fallback": dict(ph=122, pw=998)}[kind]
        frames, lut = _state("rot04" if kind in ("odd", "ragged")
                             else "poisoned", **shape)
        frame_hw = FRAME_HW
    return frames, m2.build_mat2_lut(lut.to(dev), frame_hw), frame_hw


def _fallback_at_ragged_edge(ml) -> bool:
    """Whether a fallback-tile pixel lies in the last block column of a
    panorama whose rows are no multiple of 4 pixels."""
    Wp = ml.pano_hw[1]
    return Wp % 4 != 0 and bool(
        ((ml.fb_pix % Wp) >= Wp // 32 * 32).any())


@pytest.mark.parametrize("B", (1, 3, 32))
@pytest.mark.parametrize("kind", ("poisoned", "odd", "ragged",
                                  "ragged_fallback", "direct"))
def test_staged_mat2_kernel_matches_plain(dev, kind, B):
    frames, ml, frame_hw = _mat2_case(kind, dev)
    assert (ml.n_fallback > 0) == (kind in ("poisoned", "ragged_fallback"))
    assert _fallback_at_ragged_edge(ml) == (kind == "ragged_fallback")
    assert (ml.n_direct > 0) == (kind == "direct")
    assert bool((ml.stage_table[:, 0, 0] >= 0).any())
    gen = torch.Generator(device=dev).manual_seed(B)
    planar = torch.randint(-128, 128, (B, 3, 3) + frame_hw, dtype=torch.int8,
                           device=dev, generator=gen)
    planar[0] = frames_to_planar_i8(frames.to(dev))
    before = m2.MAT2_BATCHED.launches
    got = m2.composite_mat2_planar_batched(planar, ml)
    torch.cuda.synchronize()
    assert m2.MAT2_BATCHED.launches == before + 1
    assert torch.equal(got, m2.composite_mat2_plain(planar, ml))
    assert torch.equal(m2.composite_mat2_planar(planar[B - 1], ml),
                       got[B - 1])


def _feather_direct():
    """A blend LUT on 256-row frames and a 192x1536 panorama (boxes within
    the staging budget) whose first block has tiles of three cameras (rows
    8-15 of camera 2 alone, rows 16-23 of camera 1 alone: no fallback tile)
    and whose blocks in x = 256..511 sample 6 frame rows a panorama row
    (boxes over the budget; their tiles fit their windows)."""
    frames, blut = _blend_state(Hp=192, Wp=1536, frame_hw=(256, 512))
    for rows, c in ((slice(8, 16), 2), (slice(16, 24), 1)):
        blut.cam_a[rows, :128] = c
        blut.cam_b[rows, :128] = -1
        blut.gw_b[rows, :128] = 0.0
    yy = torch.arange(32, dtype=torch.float32)[:, None]
    blut.sy_a[:32, 256:512] = 4 + 6 * yy
    blut.sy_b[:32, 256:512] = 4 + 6 * yy
    return frames, blut, (256, 512)


def _feather_ragged_fallback():
    """`_blend_state` on a 122x698 panorama (rows of no multiple of 4
    pixels) whose top-right tile gets second slots of cameras 1 and 0 beside
    camera 2's first slots: a fallback tile at the ragged right edge."""
    frames, blut = _blend_state(Hp=122, Wp=698)
    for cols, c in ((slice(670, 680), 1), (slice(680, 689), 0)):
        blut.cam_b[:8, cols] = c
        blut.sx_b[:8, cols] = 10.0
        blut.gw_b[:8, cols] = 0.3
    return frames, blut


@pytest.mark.parametrize("B", (1, 3, 32))
@pytest.mark.parametrize("kind", ("fallback", "ragged_fallback", "direct"))
def test_staged_feather_kernel_matches_plain(dev, kind, B):
    if kind == "direct":
        frames, blut, frame_hw = _feather_direct()
    elif kind == "fallback":
        (frames, blut), frame_hw = _blend_state((130, 131, 600),
                                                Hp=122), FRAME_HW
    else:
        (frames, blut), frame_hw = _feather_ragged_fallback(), FRAME_HW
    ml = fe.build_feather_mat(blut.to(dev), frame_hw)
    assert (ml.n_fallback > 0) == (kind != "direct")
    assert _fallback_at_ragged_edge(ml) == (kind == "ragged_fallback")
    assert (ml.n_direct > 0) == (kind == "direct")
    assert bool((ml.stage_table[:, 0, 0] >= 0).any())
    live = ml.tap_cw >= 0
    assert bool((live[0] & live[1]).any())
    gen = torch.Generator(device=dev).manual_seed(B)
    planar = torch.randint(-128, 128, (B, 3, 3) + frame_hw, dtype=torch.int8,
                           device=dev, generator=gen)
    planar[0] = frames_to_planar_i8(frames.to(dev))
    before = fe.FEATHER_BATCHED.launches
    got = fe.composite_feather_planar_batched(planar, ml)
    torch.cuda.synchronize()
    assert fe.FEATHER_BATCHED.launches == before + 1
    assert torch.equal(got, fe.composite_feather_plain(planar, ml))
    assert torch.equal(fe.composite_feather_planar(planar[B - 1], ml),
                       got[B - 1])


def _misaligned(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of `t` one element past a 16-byte boundary."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def _awkward(planar: torch.Tensor):
    """The frames one byte past a 16-byte boundary, and as a view that is
    not contiguous."""
    return {"misaligned": _misaligned(planar),
            "strided": planar.transpose(-2, -1).contiguous()
                             .transpose(-2, -1)}


@pytest.mark.parametrize("kernel", ("mat2", "mat", "pieces", "feather"))
def test_staged_kernels_take_misaligned_inputs(dev, kernel):
    """Frames that are not contiguous or not 16-byte aligned give what
    their aligned copy gives (the wrapper copies them before the launch);
    a frame set past the int32 offsets still raises."""
    if kernel == "pieces":
        st, _ = _multiband_state(dev, curved=True)
        ml, pieces = st.warp_lut, len(st.piece_cam)
        frame_hw, n = FRAME_HW, ml.n_cams
        run = lambda x: m2.composite_mat2_planar_pieces_batched(x, ml,
                                                                pieces)
        state = (ml.tap_xy, ml.tap_cw, ml.gc)
    elif kernel == "feather":
        _, blut = _blend_state()
        ml = fe.build_feather_mat(blut.to(dev), FRAME_HW)
        frame_hw, n = FRAME_HW, 3
        run = lambda x: fe.composite_feather_planar_batched(x, ml)
        state = (ml.tap_xy, ml.tap_cw, ml.gw)
    else:
        _, ml, frame_hw = _mat2_case("odd", dev)
        if kernel == "mat":
            _, lut = _state("rot04", ph=122, pw=1000)
            ml = mat.build_mat_lut(lut.to(dev), FRAME_HW)
        n = 3
        run = (lambda x: mat.composite_mat_planar_batched(x, ml)) \
            if kernel == "mat" \
            else (lambda x: m2.composite_mat2_planar_batched(x, ml))
        state = (ml.tap_xy, ml.tap_cw, ml.gc)
    gen = torch.Generator(device=dev).manual_seed(5)
    planar = torch.randint(-128, 128, (3, n, 3) + tuple(frame_hw),
                           dtype=torch.int8, device=dev, generator=gen)
    want = run(planar)
    for name, bad in _awkward(planar).items():
        assert torch.equal(bad, planar), name
        assert torch.equal(run(bad), want), name
    big = torch.zeros((), dtype=torch.int8, device=dev).expand(
        1, n, 3, 32768, 32768)                      # no memory behind it
    with pytest.raises(ValueError, match="int32"):
        m2.check_staged(big, state, ml.stage_table)


# -- the staged single-class (mat) and multiband warp (pieces) kernels --------

def _mat_case(kind, dev, monkeypatch):
    """(frames, MatLUT on the card, frame_hw) of a staged K5 case: 'odd' a
    122x1000 panorama (no multiple of the 32x32 block), 'ragged' 122x998
    (rows of no multiple of 4 pixels: byte stores), 'edge' taps on the
    frame's last row and column, 'direct' `_direct_lut`'s blocks of a third
    camera and over-budget boxes, 'budget' the odd panorama with the
    staging budget cut to 1,024 bytes, so that its larger boxes go direct."""
    if kind == "direct":
        frames, lut, frame_hw = _direct_lut()
    else:
        shape = dict(ph=122, pw=998 if kind == "ragged" else 1000)
        frames, lut = _state("edge" if kind == "edge" else "rot04", **shape)
        frame_hw = FRAME_HW
    if kind == "budget":
        monkeypatch.setattr(staging, "STAGE_BUDGET", 1024)
    return frames, mat.build_mat_lut(lut.to(dev), frame_hw), frame_hw


@pytest.mark.parametrize("B", (1, 3, 32))
@pytest.mark.parametrize("kind", ("odd", "ragged", "edge", "direct",
                                  "budget"))
def test_staged_mat_kernel_matches_plain(dev, kind, B, monkeypatch):
    frames, ml, frame_hw = _mat_case(kind, dev, monkeypatch)
    assert ml.n_fallback == 0 and ml.stage_table is not None
    assert (ml.n_direct > 0) == (kind in ("direct", "budget"))
    assert bool((ml.stage_table[:, 0, 0] >= 0).any())
    assert (ml.pano_hw[1] % 4 != 0) == (kind == "ragged")
    gen = torch.Generator(device=dev).manual_seed(B)
    planar = torch.randint(-128, 128, (B, 3, 3) + frame_hw, dtype=torch.int8,
                           device=dev, generator=gen)
    planar[0] = frames_to_planar_i8(frames.to(dev))
    before = mat.MAT_BATCHED.launches
    got = mat.composite_mat_planar_batched(planar, ml)
    torch.cuda.synchronize()
    assert mat.MAT_BATCHED.launches == before + 1
    assert torch.equal(got, mat.composite_mat_plain(planar, ml))
    assert torch.equal(mat.composite_mat_planar(planar[B - 1], ml),
                       got[B - 1])


def _pieces_case(kind, dev, monkeypatch):
    """(MatLUT2 of a window stack on the card, pieces, frame_hw) of a staged
    pieces case: 'windows' the reduced multiband registration with its
    curvature patch (5 windows of 128 rows; fallback tiles, and direct
    blocks where the patch's boxes exceed the staging budget); 'ragged' the
    poisoned map at 122x998 as a stack of 2 windows of 61 rows (a window
    height of no multiple of 32, so blocks span two windows; rows of no
    multiple of 4 pixels; a fallback tile at the ragged edge); 'budget' the
    registration without the patch (no fallback tile) with the staging
    budget cut to 1,024 bytes, so that its larger boxes go direct."""
    if kind == "ragged":
        _, lut = _state("poisoned", ph=122, pw=998)
        ml = m2.materialize2_used(tiled.build_tiled_lut(lut.to(dev),
                                                        FRAME_HW))
        return ml, 2, FRAME_HW
    if kind == "budget":
        monkeypatch.setattr(staging, "STAGE_BUDGET", 1024)
    st, _ = _multiband_state(dev, curved=kind == "windows")
    return st.warp_lut, len(st.piece_cam), FRAME_HW


@pytest.mark.parametrize("B", (1, 3, 8))
@pytest.mark.parametrize("kind", ("windows", "ragged", "budget"))
def test_staged_pieces_kernel_matches_plain(dev, kind, B, monkeypatch):
    ml, pieces, frame_hw = _pieces_case(kind, dev, monkeypatch)
    Hb, Wb = ml.pano_hw[0] // pieces, ml.pano_hw[1]
    assert (ml.n_fallback > 0) == (kind != "budget")
    assert ml.stage_table is not None
    assert (ml.n_direct > 0) == (kind != "ragged")
    assert bool((ml.stage_table[:, 0, 0] >= 0).any())
    assert (Hb % 32 != 0) == (kind == "ragged")
    assert _fallback_at_ragged_edge(ml) == (kind == "ragged")
    gen = torch.Generator(device=dev).manual_seed(B)
    planar = torch.randint(-128, 128, (B, ml.n_cams, 3) + frame_hw,
                           dtype=torch.int8, device=dev, generator=gen)
    before = m2.PIECES_BATCHED.launches
    got = m2.composite_mat2_planar_pieces_batched(planar, ml, pieces)
    torch.cuda.synchronize()
    assert m2.PIECES_BATCHED.launches == before + 1
    assert got.shape == (B, pieces, 3, Hb, Wb) and got.dtype == torch.bfloat16
    want = m2.composite_mat2_pieces_plain(planar, ml, pieces)
    assert torch.equal(got, want)
    if ml.n_fallback:
        # the fallback tiles' exact values, not the staged path's zeros
        fb = got.transpose(1, 2).reshape(B, 3, -1)[:, :, ml.fb_pix]
        assert float(fb.float().max()) > 0
    assert torch.equal(m2.composite_mat2_planar_pieces(planar[B - 1], ml,
                                                       pieces), got[B - 1])


def test_staged_mat_and_pieces_refuse_what_they_do_not_take(dev):
    """A state without a staging table, or with a misaligned one, raises
    on the card; nothing falls back to the plain version."""
    frames, lut = _state("rot04", ph=122, pw=1000)
    ml = mat.build_mat_lut(lut.to(dev), FRAME_HW)
    planar = frames_to_planar_i8(frames.to(dev))
    with pytest.raises(ValueError, match="no staging table"):
        mat.composite_mat_planar(planar, dataclasses.replace(
            ml, stage_table=None))
    with pytest.raises(ValueError):
        mat.composite_mat_planar(planar, dataclasses.replace(
            ml, stage_table=_misaligned(ml.stage_table)))
    st, _ = _multiband_state(dev, curved=True)
    wl, pieces = st.warp_lut, len(st.piece_cam)
    planar = torch.zeros((5, 3) + FRAME_HW, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="no staging table"):
        m2.composite_mat2_planar_pieces(planar, dataclasses.replace(
            wl, stage_table=None), pieces)


# -- registration (plain PyTorch on the card): the card against the CPU ------

def _views(n=2, wh=(320, 240)):
    from stitchingvideo_tpu_torch.utils import synthetic as syn
    K, Rs, _f = syn.yaw_cameras(n, 55.0, wh, 0.45)
    tex = syn.panorama_texture(np.random.default_rng(3))
    return syn.render_views(tex, K, Rs, wh, device="cpu")


def test_ransac_uniforms_are_the_same_on_the_card(dev):
    from stitchingvideo_tpu_torch.ops import ransac
    u = ransac.ransac_uniforms(5, 3, 64, dev)
    assert u.device.type == "cuda"
    assert torch.equal(u.cpu(), ransac.ransac_uniforms(5, 3, 64, "cpu"))


def test_features_on_the_card_are_the_cpus(dev):
    """The detector's keypoints and responses are equal (FAST, Harris and
    the top-k use IEEE arithmetic and a stable sort); orientations within
    1e-5 (the card's atan2), descriptor bits at least 99.9% equal."""
    from stitchingvideo_tpu_torch.ops import features
    v = np.stack(_views()).astype(np.float32)
    g = torch.from_numpy(np.round(v[..., 0] * 0.299 + v[..., 1] * 0.587
                                  + v[..., 2] * 0.114).astype(np.float32))
    cpu = features.detect_and_describe(g, 20.0, 256, extent=(240, 320))
    card = features.detect_and_describe(g.to(dev), 20.0, 256,
                                        extent=(240, 320))
    for k in ("xy", "valid", "response"):
        assert torch.equal(card[k].cpu(), cpu[k]), k
    assert float((card["angle"].cpu() - cpu["angle"]).abs().max()) <= 1e-5
    assert float((card["desc"].cpu() == cpu["desc"]).float().mean()) >= 0.999


def test_matching_and_ransac_on_the_card_are_the_cpus(dev):
    """From the same descriptors and draws: matches equal, homographies
    within 1e-4 relative, inlier counts within 2."""
    from stitchingvideo_tpu_torch.ops import features, matching, ransac
    v = np.stack(_views()).astype(np.float32)
    g = torch.from_numpy(np.round(v[..., 0] * 0.299 + v[..., 1] * 0.587
                                  + v[..., 2] * 0.114).astype(np.float32))
    f = features.detect_and_describe(g, 20.0, 256)
    out = {}
    for d in ("cpu", dev):
        src, dst, dist, valid = matching.match_pair(
            f["desc"][0].to(d), f["valid"][0].to(d), f["desc"][1].to(d),
            f["valid"][1].to(d), 0.3, 128)
        p1 = f["xy"][0].to(d)[src] - 160.0
        p2 = f["xy"][1].to(d)[dst] - 120.0
        r = ransac.ransac_homography(ransac.ransac_uniforms(0, 1, 64, d)[0],
                                     p1, p2, valid, 3.0)
        out[str(d)] = [t.cpu() for t in (src, dst, dist, valid)] + [r]
    a, b = out["cpu"], out[str(dev)]
    for x, y in zip(a[:4], b[:4]):
        assert torch.equal(x, y)
    assert int(a[3].sum()) > 10 and bool(b[4]["ok"])
    Ha, Hb = a[4]["H"].double(), b[4]["H"].cpu().double()
    Ha, Hb = Ha / Ha[2, 2], Hb / Hb[2, 2]
    assert float((Ha - Hb).abs().max()) <= 1e-4 * float(Ha.abs().max())
    assert abs(int(a[4]["num_inliers"]) - int(b[4]["num_inliers"])) <= 2


def test_register_images_runs_on_the_card(dev):
    """The whole slice on the card, by default (no device argument)."""
    from stitchingvideo_tpu_torch import register_images
    cfg = StitchConfig()
    cfg = cfg.replace(features=dataclasses.replace(cfg.features,
                                                   max_keypoints=256),
                      match=dataclasses.replace(cfg.match, max_matches=128,
                                                ransac_iters=64),
                      register=dataclasses.replace(cfg.register, ba_iters=10))
    reg = register_images(_views(3), cfg)
    assert reg.cameras.focal.device.type == "cuda"
    assert reg.indices == [0, 1, 2]
    assert bool(torch.isfinite(reg.cameras.R).all())
