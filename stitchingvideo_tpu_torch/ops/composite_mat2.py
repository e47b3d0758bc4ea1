"""Seam-select composite ("mat2"): the build of its per-pixel state, and the
compose of one frame set or a micro-batch through the CUDA kernel.

Port of `stitchingvideo_tpu/ops/pallas/composite_mat2.py`. On the TPU every
8x128 tile turns its bilinear gather into int8 matmuls against hat matrices
(`vx`, `vy`) over a 32- or 80-row source window, sorted into easy and hard
classes with sticky buckets and fed five band-shifted frame copies. None of
that carries over: the matmuls' answer does not depend on the windows. On
every covered pixel of a tile that is not a fallback tile, the window clip of
`_mat_chunk_h` never engages (an overflowing window is what marks a fallback
tile) and the window offsets are integers subtracted exactly, so the hat
matrices' two non-zeros per axis are, in global frame coordinates:

    x0 = floor(sx),  a = round_half_even(127 * (1 - (sx - x0)))

with weight `a` on tap x0 and `127 - a` on tap x0 + 1 (the same for y; a tap
on the window's last row/column, `fx == 0`, gets 127). The port stores these
per pixel, row-major on the panorama (12 bytes a pixel), and its kernel
gathers the four taps directly (`csrc/composite_mat2.cu`). Pixels of
fallback tiles keep the reference's exact float gather (`_fallback_values`),
in the same kernel on the card and in `_overlay_fallback` on the CPU.

`tests/test_torch_composite.py` holds all of this bit-exact against the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from . import _cuda
from .composite import (BAND_STEP, P, TILE_H, TILE_W, VXW, WIN_W, TiledLUT,
                        build_tiled_lut)

WEIGHT = 127                              # int8 weight scale of one axis
UNCOVERED, FALLBACK = -1, -2              # tap_cw of pixels off the int path
INV = np.float32(1.0 / (127.0 * 127.0))   # the reference's f32(1/16129)
N_SHIFTS = (WIN_W - VXW) // BAND_STEP + 1  # band offsets 0..128 step 32

# launch counters of the hot loop's two entry points (one CUDA kernel) and of
# the band-shift copy
MAT2_SINGLE = _cuda.CudaKernel("composite_mat2_planar", _cuda.COMPOSITE_MAT2)
MAT2_BATCHED = _cuda.CudaKernel("composite_mat2_planar_batched",
                                _cuda.COMPOSITE_MAT2)
SHIFT_BN = _cuda.CudaKernel("shift_planar_bn", _cuda.SHIFT_PLANAR_BN)


@dataclasses.dataclass
class MatLUT2:
    """Per-pixel state of the mat2 composite, row-major on the panorama.

    tap_xy:  [Hp*Wp] int32  y0 << 16 | x0, the top-left tap in the frame;
                            for a fallback-tile pixel, its index into fb_*
    tap_cw:  [Hp*Wp] int32  cam << 16 | a << 8 | ay; UNCOVERED (-1), or
                            FALLBACK (-2) for a pixel of a fallback tile
    gc:      [Hp*Wp] f32    gain * covered
    fb_pix:  [F] int64      panorama pixels of the fallback tiles, in order
    fb_cam:  [F] int32      their camera (-1 = uncovered)
    fb_sx, fb_sy, fb_gain: [F] f32 their clipped source coords and gain
    n_fallback: fallback tiles;  n_cams: highest camera index + 1
    """
    tap_xy: torch.Tensor
    tap_cw: torch.Tensor
    gc: torch.Tensor
    fb_pix: torch.Tensor
    fb_cam: torch.Tensor
    fb_sx: torch.Tensor
    fb_sy: torch.Tensor
    fb_gain: torch.Tensor
    n_fallback: int
    n_cams: int
    pano_hw: Tuple[int, int]
    frame_hw: Tuple[int, int]

    @property
    def device(self) -> torch.device:
        return self.tap_cw.device

    def fields(self) -> dict:
        """Unpacked per-pixel fields: cam (-1 where not a kernel pixel), x0,
        y0, a, ay, all [Hp*Wp] int32."""
        cw, xy = self.tap_cw, self.tap_xy
        kern = cw >= 0
        return dict(cam=torch.where(kern, cw >> 16, -1),
                    x0=xy & 0xFFFF, y0=xy >> 16,
                    a=(cw >> 8) & 0xFF, ay=cw & 0xFF)


def _taps(s: torch.Tensor):
    """Integer tap origin and first-tap weight of one axis (`_mat_chunk_h`)."""
    s0 = torch.floor(s)
    w = torch.round(WEIGHT * (1.0 - (s - s0))).to(torch.int32)
    return s0.to(torch.int32), w


def build_mat2_lut(lut, frame_hw: Tuple[int, int]) -> MatLUT2:
    """From a CompositeLUT, on the LUT's device."""
    return _materialize2(build_tiled_lut(lut, frame_hw))


def _materialize2(tlut: TiledLUT) -> MatLUT2:
    fh, fw = tlut.frame_hw
    if fh >= 1 << 15 or fw >= 1 << 16:
        raise ValueError(f"frames {tlut.frame_hw} too large for the packed "
                         "16-bit tap coordinates")
    nty, ntx = tlut.grid_hw
    Hp, Wp = tlut.pano_hw
    T = nty * ntx

    def untile(a):
        return a.reshape(nty, ntx, TILE_H, TILE_W).permute(0, 2, 1, 3) \
                .reshape(nty * TILE_H, ntx * TILE_W)[:Hp, :Wp].reshape(-1)

    cam = untile(tlut.cidx)
    sx, sy, gain = untile(tlut.sx), untile(tlut.sy), untile(tlut.gain)
    fb = untile(tlut.fallback[:, None].expand(T, P))
    covered = cam >= 0
    x0, a = _taps(sx)
    y0, ay = _taps(sy)
    tap_cw = torch.where(covered, (cam << 16) | (a << 8) | ay, UNCOVERED)
    tap_cw = torch.where(fb, FALLBACK, tap_cw)
    fb_index = (torch.cumsum(fb, 0, dtype=torch.int32) - 1)
    tap_xy = torch.where(fb, fb_index, (y0 << 16) | x0)
    fb_pix = torch.nonzero(fb).reshape(-1)
    return MatLUT2(
        tap_xy=tap_xy.contiguous(), tap_cw=tap_cw.contiguous(),
        gc=(gain * covered.to(torch.float32)).contiguous(),
        fb_pix=fb_pix, fb_cam=cam[fb_pix], fb_sx=sx[fb_pix],
        fb_sy=sy[fb_pix], fb_gain=gain[fb_pix],
        n_fallback=tlut.n_fallback,
        n_cams=int(cam.max()) + 1 if cam.numel() else 0,
        pano_hw=(Hp, Wp), frame_hw=(fh, fw))


def bilinear_taps(sx, sy, H: int, W: int):
    """Clamped bilinear tap indices + fractional weights: the gather
    reference's edge rules (video/lut.composite_frame)."""
    x0f = torch.floor(sx)
    y0f = torch.floor(sy)
    fx = sx - x0f
    fy = sy - y0f
    x0 = x0f.to(torch.int32).clamp(0, W - 1).long()
    y0 = y0f.to(torch.int32).clamp(0, H - 1).long()
    return x0, y0, (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1), fx, fy


def _overlay_fallback(out: torch.Tensor, planar_b: torch.Tensor,
                      ml: MatLUT2) -> None:
    """Write the exact bilinear gather of the fallback tiles into
    out [B, 3, Hp*Wp] u8, in place: `_fallback_values` with its order of
    operations (values + 128 gathered as f32, weights summed left to right,
    times gain, 0 where uncovered), then rounded half to even and clamped.
    The plain version's; the kernel does the same per pixel."""
    if ml.fb_pix.numel() == 0:
        return
    B, N, _, H, W = planar_b.shape
    flat = planar_b.reshape(B, -1)
    cam = ml.fb_cam.clamp(min=0).long()
    x0, y0, x1, y1, fx, fy = bilinear_taps(ml.fb_sx, ml.fb_sy, H, W)

    def chan(c):
        base = cam * (3 * H * W) + c * (H * W)

        def g(yi, xi):
            return flat[:, base + yi * W + xi].to(torch.float32) + 128.0

        return ((1 - fx) * (1 - fy) * g(y0, x0) + fx * (1 - fy) * g(y0, x1)
                + (1 - fx) * fy * g(y1, x0) + fx * fy * g(y1, x1))

    vals = torch.stack([chan(c) for c in range(3)], dim=1) * ml.fb_gain
    vals = torch.where(ml.fb_cam >= 0, vals, torch.zeros((), device=vals.device))
    out[:, :, ml.fb_pix] = torch.round(vals).clamp(0, 255).to(torch.uint8)


def composite_mat2_plain(planar_b_i8: torch.Tensor,
                         ml: MatLUT2) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the integer gather, then the
    fallback tiles' float gather): [B, N, 3, H, W] int8 (value-128) ->
    [B, 3, Hp, Wp] uint8. The CPU path, and the version the kernel is held
    against on the card."""
    _check(planar_b_i8, ml)
    B, N, _, H, W = planar_b_i8.shape
    Hp, Wp = ml.pano_hw
    dev = planar_b_i8.device
    out = torch.zeros((B, 3, Hp * Wp), dtype=torch.uint8, device=dev)
    f = ml.fields()
    sel = torch.nonzero(f["cam"] >= 0).reshape(-1)
    cam, x0, y0, a, ay = (f[k][sel].long() for k in
                          ("cam", "x0", "y0", "a", "ay"))
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    w00, w01 = (a * ay).int(), ((WEIGHT - a) * ay).int()
    w10, w11 = (a * (WEIGHT - ay)).int(), ((WEIGHT - a) * (WEIGHT - ay)).int()
    gc = ml.gc[sel]
    inv = torch.tensor(INV, dtype=torch.float32, device=dev)
    flat = planar_b_i8.reshape(B, -1)
    for c in range(3):
        base = (cam * 3 + c) * (H * W)

        def tap(yi, xi):
            return flat[:, base + yi * W + xi].to(torch.int32)

        s = (w00 * tap(y0, x0) + w01 * tap(y0, x1) + w10 * tap(y1, x0)
             + w11 * tap(y1, x1))
        v = s.to(torch.float32) * inv
        out[:, c, sel] = torch.round((v + 128.0) * gc).clamp(0, 255) \
            .to(torch.uint8)
    _overlay_fallback(out, planar_b_i8, ml)
    return out.reshape(B, 3, Hp, Wp)


def _check(planar_b: torch.Tensor, ml: MatLUT2) -> None:
    if planar_b.dtype != torch.int8 or planar_b.dim() != 5 \
            or planar_b.shape[2] != 3:
        raise ValueError("expected [B, N, 3, H, W] int8 frames, got "
                         f"{tuple(planar_b.shape)} {planar_b.dtype}")
    B, N, _, H, W = planar_b.shape
    if (H, W) != tuple(ml.frame_hw):
        raise ValueError(f"frames are {(H, W)}, the LUT was built for "
                         f"{tuple(ml.frame_hw)}")
    if N < ml.n_cams:
        raise ValueError(f"the LUT addresses {ml.n_cams} cameras, got {N}")
    if planar_b.device != ml.device:
        raise ValueError(f"frames on {planar_b.device}, LUT on {ml.device}")
    if not planar_b.is_contiguous():
        raise ValueError("frames must be contiguous")


def _composite(planar_b: torch.Tensor, ml: MatLUT2,
               kernel: _cuda.CudaKernel) -> torch.Tensor:
    if planar_b.device.type == "cpu":
        return composite_mat2_plain(planar_b, ml)
    if planar_b.device.type != "cuda":
        raise ValueError(f"no kernel for device {planar_b.device}")
    _check(planar_b, ml)
    B, N, _, H, W = planar_b.shape
    Hp, Wp = ml.pano_hw
    out = torch.empty((B, 3, Hp * Wp), dtype=torch.uint8,
                      device=planar_b.device)
    kernel.launch(*(t.data_ptr() for t in (
                      planar_b, ml.tap_xy, ml.tap_cw, ml.gc, ml.fb_cam,
                      ml.fb_sx, ml.fb_sy, ml.fb_gain, out)),
                  B, N, H, W, Hp * Wp,
                  torch.cuda.current_stream(planar_b.device).cuda_stream)
    return out.reshape(B, 3, Hp, Wp)


def composite_mat2_planar(planar_i8: torch.Tensor,
                          ml: MatLUT2) -> torch.Tensor:
    """One frame set: [N, 3, H, W] int8 (value-128) -> [3, Hp, Wp] uint8.
    On a CUDA tensor it launches the kernel (B = 1); on a CPU tensor it runs
    the plain version."""
    return _composite(planar_i8[None], ml, MAT2_SINGLE)[0]


def composite_mat2_planar_batched(planar_b_i8: torch.Tensor,
                                  ml: MatLUT2) -> torch.Tensor:
    """Micro-batch: [B, N, 3, H, W] int8 -> [B, 3, Hp, Wp] uint8, per frame
    set bit-identical to `composite_mat2_planar`. One launch for the whole
    batch: the LUT is read once for B frame sets."""
    return _composite(planar_b_i8, ml, MAT2_BATCHED)


def shift_planar_bn_plain(planar_b_i8: torch.Tensor) -> torch.Tensor:
    """Plain version of `shift_planar_bn` (the reference's
    `_shift_planar_bn_xla`)."""
    tb = planar_b_i8.transpose(0, 1)                  # [N, B, 3, H, W]
    W = tb.shape[-1]
    out = torch.zeros((N_SHIFTS,) + tuple(tb.shape), dtype=tb.dtype,
                      device=tb.device)
    for k in range(N_SHIFTS):
        s = k * BAND_STEP
        if s < W:
            out[k, ..., :W - s] = tb[..., s:]
    return out


def shift_planar_bn(planar_b_i8: torch.Tensor) -> torch.Tensor:
    """[B, N, 3, H, W] int8 -> [5, N, B, 3, H, W]: copy k shifted left by
    32*k columns with a zero tail, the batch inside the camera axis (the
    layout the TPU's batched and feather kernels read). On a CUDA tensor it
    launches the copy kernel; on a CPU tensor it runs the plain version."""
    if planar_b_i8.device.type == "cpu":
        return shift_planar_bn_plain(planar_b_i8)
    if planar_b_i8.device.type != "cuda":
        raise ValueError(f"no kernel for device {planar_b_i8.device}")
    if planar_b_i8.dim() != 5 or planar_b_i8.dtype != torch.int8 \
            or not planar_b_i8.is_contiguous():
        raise ValueError("expected contiguous [B, N, C, H, W] int8, got "
                         f"{tuple(planar_b_i8.shape)} {planar_b_i8.dtype}")
    B, N, C, H, W = planar_b_i8.shape
    if W % 4:
        raise ValueError(f"the copy kernel moves 4-byte words: W={W} % 4 != 0")
    out = torch.empty((N_SHIFTS, N, B, C, H, W), dtype=torch.int8,
                      device=planar_b_i8.device)
    SHIFT_BN.launch(planar_b_i8.data_ptr(), out.data_ptr(), B, N, C * H, W,
                    torch.cuda.current_stream(planar_b_i8.device).cuda_stream)
    return out
