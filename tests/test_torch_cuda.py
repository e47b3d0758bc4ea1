"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need a CUDA card and skip without one. They import neither JAX
nor the JAX package (the plain versions are held against the JAX package by
the other test_torch_* files), so on a machine with a card and no JAX they
run without the suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""
import numpy as np
import pytest
import torch

from stitchingvideo_tpu_torch.ops import composite_mat2 as m2
from stitchingvideo_tpu_torch.ops.composite_mat import frames_to_planar_i8
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
    with pytest.raises(ValueError):
        m2.composite_mat2_planar(planar.transpose(2, 3).contiguous()
                                 .transpose(2, 3), ml)   # not contiguous
