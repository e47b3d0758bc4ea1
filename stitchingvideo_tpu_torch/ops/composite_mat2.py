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
(`csrc/composite_mat2.cu`) gathers the four taps from source boxes that each
block of 32x32 pixels stages into shared memory, as the state's staging
table (`ops/staging.py`) sets out. Pixels of fallback tiles keep the
reference's exact float gather (`_fallback_values`), in the same kernel on
the card and in `_overlay_fallback` on the CPU.

`tests/test_torch_composite.py` holds all of this bit-exact against the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from . import _cuda
from .composite import (BAND_STEP, P, VXW, WIN_W, TiledLUT, build_tiled_lut,
                        untile)
from .staging import staging_table

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
# the multiband warp stage's two entry points (one CUDA kernel, bf16 windows)
PIECES_SINGLE = _cuda.CudaKernel("composite_mat2_planar_pieces",
                                 _cuda.COMPOSITE_MAT2_PIECES)
PIECES_BATCHED = _cuda.CudaKernel("composite_mat2_planar_pieces_batched",
                                  _cuda.COMPOSITE_MAT2_PIECES)


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
    stage_table: [blocks, 2, 4] int32  the staged kernel's staging table
                            (`ops/staging.py`), None on a state built
                            without it (the staged wrappers refuse one);
                            the plain versions do not read it
    stage_bytes: shared memory of one stage;  n_direct: direct-gather blocks
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
    stage_table: Optional[torch.Tensor] = None
    stage_bytes: int = 0
    n_direct: int = 0

    @property
    def device(self) -> torch.device:
        return self.tap_cw.device

    def fields(self) -> dict:
        return unpack_taps(self.tap_xy, self.tap_cw)

    def to(self, device) -> "MatLUT2":
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if isinstance(getattr(self, f.name), torch.Tensor)})


def pack_taps(cam, x0, a, y0, ay):
    """(tap_xy, tap_cw) int32 words of a tap origin, its camera and its two
    first-tap weights."""
    return (y0 << 16) | x0, (cam << 16) | (a << 8) | ay


def unpack_taps(tap_xy: torch.Tensor, tap_cw: torch.Tensor) -> dict:
    """Unpacked per-pixel fields: cam (-1 where not a kernel pixel), x0, y0,
    a, ay, all int32."""
    kern = tap_cw >= 0
    return dict(cam=torch.where(kern, tap_cw >> 16, -1),
                x0=tap_xy & 0xFFFF, y0=tap_xy >> 16,
                a=(tap_cw >> 8) & 0xFF, ay=tap_cw & 0xFF)


def check_packable(frame_hw) -> None:
    if frame_hw[0] >= 1 << 15 or frame_hw[1] >= 1 << 16:
        raise ValueError(f"frames {tuple(frame_hw)} too large for the packed "
                         "16-bit tap coordinates")


def _taps(s: torch.Tensor):
    """Integer tap origin and first-tap weight of one axis (`_mat_chunk_h`)."""
    s0 = torch.floor(s)
    w = torch.round(WEIGHT * (1.0 - (s - s0))).to(torch.int32)
    return s0.to(torch.int32), w


def build_mat2_lut(lut, frame_hw: Tuple[int, int]) -> MatLUT2:
    """From a CompositeLUT, on the LUT's device."""
    return _materialize2(build_tiled_lut(lut, frame_hw))


def _materialize2(tlut: TiledLUT) -> MatLUT2:
    """The staged kernel's state: the per-pixel state and its staging
    table."""
    return with_staging_table(_per_pixel2(tlut))


def with_staging_table(ml):
    """A per-pixel state (`MatLUT2` or `MatLUT`) with the staging table of
    its kernel pixels' taps (`ops/staging.py`) over its panorama."""
    f = ml.fields()
    kern = torch.nonzero(ml.tap_cw >= 0).reshape(-1)
    table, stage_bytes, n_direct = staging_table(
        [(kern, f["cam"][kern], f["x0"][kern], f["y0"][kern])], ml.pano_hw,
        ml.frame_hw)
    return dataclasses.replace(ml, stage_table=table, stage_bytes=stage_bytes,
                               n_direct=n_direct)


def _per_pixel2(tlut: TiledLUT) -> MatLUT2:
    fh, fw = tlut.frame_hw
    check_packable(tlut.frame_hw)
    Hp, Wp = tlut.pano_hw
    T = tlut.sx.shape[0]

    def flat(a):
        return untile(a, tlut.grid_hw, tlut.pano_hw).reshape(-1)

    cam = flat(tlut.cidx)
    sx, sy, gain = flat(tlut.sx), flat(tlut.sy), flat(tlut.gain)
    fb = flat(tlut.fallback[:, None].expand(T, P))
    covered = cam >= 0
    x0, a = _taps(sx)
    y0, ay = _taps(sy)
    tap_xy, tap_cw = pack_taps(cam, x0, a, y0, ay)
    tap_cw = torch.where(covered, tap_cw, UNCOVERED)
    tap_cw = torch.where(fb, FALLBACK, tap_cw)
    fb_index = (torch.cumsum(fb, 0, dtype=torch.int32) - 1)
    tap_xy = torch.where(fb, fb_index, tap_xy)
    fb_pix = torch.nonzero(fb).reshape(-1)
    return MatLUT2(
        tap_xy=tap_xy.contiguous(), tap_cw=tap_cw.contiguous(),
        gc=(gain * covered.to(torch.float32)).contiguous(),
        fb_pix=fb_pix, fb_cam=cam[fb_pix], fb_sx=sx[fb_pix],
        fb_sy=sy[fb_pix], fb_gain=gain[fb_pix],
        n_fallback=tlut.n_fallback, n_cams=tlut.n_cams,
        pano_hw=(Hp, Wp), frame_hw=(fh, fw))


def materialize2_used(tlut: TiledLUT) -> MatLUT2:
    """The state of a `concat_tiled_luts` window stack, for the pieces
    entry points below: `_materialize2`'s per-pixel state and staging table
    over the stack's own panorama (the windows stacked along rows).

    The reference's build of this name drops every tile group without a
    covered pixel from its launch grid, over an output the caller zero-fills.
    The port's staged kernel writes every block: a block without a kernel
    pixel stages nothing and stores its zeros, which writes the bytes a
    zero-fill pass would, once. So the state is the mat2 state of the stack,
    and the function computed is the same."""
    if tlut.pano_hw[0] * tlut.pano_hw[1] >= 1 << 31:
        raise ValueError(f"window stack {tlut.pano_hw} too large for int32 "
                         "pixel indices")
    return _materialize2(tlut)


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
    out[:, :, ml.fb_pix] = to_u8(vals)


def int_tap_values(planar_b_i8: torch.Tensor, f: dict, sel: torch.Tensor):
    """The kernels' integer path as plain PyTorch. `f` holds per-pixel
    fields (`unpack_taps`), `sel` the pixels to gather. Returns a function
    c -> [B, len(sel)] float32: channel c's
    float(sum of integer weights x int8 taps) * f32(1 / 16129)."""
    B, N, _, H, W = planar_b_i8.shape
    cam, x0, y0, a, ay = (f[k][sel].long() for k in
                          ("cam", "x0", "y0", "a", "ay"))
    # a tap on the frame's last row/column has weight 0 on its second tap
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    w00, w01 = (a * ay).int(), ((WEIGHT - a) * ay).int()
    w10, w11 = (a * (WEIGHT - ay)).int(), ((WEIGHT - a) * (WEIGHT - ay)).int()
    inv = torch.tensor(INV, dtype=torch.float32, device=planar_b_i8.device)
    flat = planar_b_i8.reshape(B, -1)

    def channel(c):
        base = (cam * 3 + c) * (H * W)

        def tap(yi, xi):
            return flat[:, base + yi * W + xi].to(torch.int32)

        s = (w00 * tap(y0, x0) + w01 * tap(y0, x1) + w10 * tap(y1, x0)
             + w11 * tap(y1, x1))
        return s.to(torch.float32) * inv

    return channel


def to_u8(v: torch.Tensor) -> torch.Tensor:
    """Round half to even, clamp, uint8: every kernel's last step."""
    return torch.round(v).clamp(0, 255).to(torch.uint8)


def seam_select_plain(planar_b_i8, tap_xy, tap_cw, gc) -> torch.Tensor:
    """(v + 128) * gc on every pixel with tap_cw >= 0, 0 elsewhere:
    [B, 3, npix] uint8."""
    out = torch.zeros((planar_b_i8.shape[0], 3, tap_cw.numel()),
                      dtype=torch.uint8, device=planar_b_i8.device)
    sel = torch.nonzero(tap_cw >= 0).reshape(-1)
    value = int_tap_values(planar_b_i8, unpack_taps(tap_xy, tap_cw), sel)
    g = gc[sel]
    for c in range(3):
        out[:, c, sel] = to_u8((value(c) + 128.0) * g)
    return out


def composite_mat2_plain(planar_b_i8: torch.Tensor,
                         ml: MatLUT2) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the integer gather, then the
    fallback tiles' float gather): [B, N, 3, H, W] int8 (value-128) ->
    [B, 3, Hp, Wp] uint8. The CPU path, and the version the kernel is held
    against on the card."""
    check_frames(planar_b_i8, ml)
    out = seam_select_plain(planar_b_i8, ml.tap_xy, ml.tap_cw, ml.gc)
    _overlay_fallback(out, planar_b_i8, ml)
    return out.reshape(planar_b_i8.shape[0], 3, *ml.pano_hw)


def check_frames(planar_b: torch.Tensor, ml) -> None:
    """Raise unless the frames are what a kernel of `ml` takes (`ml` has
    frame_hw, n_cams and device)."""
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


def check_staged(planar_b: torch.Tensor, state: Tuple[torch.Tensor, ...],
                 table: torch.Tensor) -> torch.Tensor:
    """The frames as the staged kernels take them, after checking the state
    tensors and the staging table: frames that are not contiguous or not
    16-byte aligned (the kernels copy their rows 16 bytes at a time) come
    back as a fresh contiguous copy, which the caching allocator aligns. The
    state must be contiguous and the table (read a slot at a time) 16-byte
    aligned; one frame set and the panorama must be indexable in int32."""
    N, _, H, W = planar_b.shape[1:]
    if N * 3 * H * W >= 1 << 31 or state[0].shape[-1] >= 1 << 31:
        raise ValueError(f"a frame set of {N}x3x{H}x{W} or its panorama is "
                         "too large for int32 offsets")
    if table is None:
        raise ValueError("the state has no staging table")
    if not all(t.is_contiguous() for t in (table,) + tuple(state)):
        raise ValueError("the state and its staging table must be "
                         "contiguous")
    if table.data_ptr() % 16:
        raise ValueError("the staging table must be 16-byte aligned")
    if not planar_b.is_contiguous() or planar_b.data_ptr() % 16:
        planar_b = planar_b.clone(memory_format=torch.contiguous_format)
        if planar_b.data_ptr() % 16:
            raise RuntimeError("the allocator returned frames that are not "
                               "16-byte aligned")
    return planar_b


def _composite(planar_b: torch.Tensor, ml: MatLUT2,
               kernel: _cuda.CudaKernel) -> torch.Tensor:
    if planar_b.device.type == "cpu":
        return composite_mat2_plain(planar_b, ml)
    if planar_b.device.type != "cuda":
        raise ValueError(f"no kernel for device {planar_b.device}")
    check_frames(planar_b, ml)
    planar_b = check_staged(planar_b, (ml.tap_xy, ml.tap_cw, ml.gc),
                            ml.stage_table)
    B, N, _, H, W = planar_b.shape
    Hp, Wp = ml.pano_hw
    out = torch.empty((B, 3, Hp * Wp), dtype=torch.uint8,
                      device=planar_b.device)
    kernel.launch(*(t.data_ptr() for t in (
                      planar_b, ml.tap_xy, ml.tap_cw, ml.gc, ml.fb_cam,
                      ml.fb_sx, ml.fb_sy, ml.fb_gain, ml.stage_table, out)),
                  B, N, H, W, Hp, Wp, ml.stage_bytes,
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


def _window_hw(ml: MatLUT2, pieces: int) -> Tuple[int, int]:
    Hs, Wb = ml.pano_hw
    if pieces < 1 or Hs % pieces:
        raise ValueError(f"a window stack of {Hs} rows does not split into "
                         f"{pieces} pieces")
    return Hs // pieces, Wb


def composite_mat2_pieces_plain(planar_b_i8: torch.Tensor, ml: MatLUT2,
                                pieces: int) -> torch.Tensor:
    """Plain PyTorch version of the pieces kernel: the mat2 composite of the
    window stack (integer gather, fallback tiles' float gather, rounded half
    to even and clamped to 0..255), cut into its windows and cast to
    bfloat16, which holds 0..255 exactly:
    [B, N, 3, H, W] int8 -> [B, pieces, 3, Hb, Wb] bfloat16. The CPU path,
    and the version the kernel is held against on the card."""
    Hb, Wb = _window_hw(ml, pieces)
    B = planar_b_i8.shape[0]
    out = composite_mat2_plain(planar_b_i8, ml)      # [B, 3, pieces*Hb, Wb]
    return out.reshape(B, 3, pieces, Hb, Wb).transpose(1, 2) \
              .to(torch.bfloat16).contiguous()


def _composite_pieces(planar_b: torch.Tensor, ml: MatLUT2, pieces: int,
                      kernel: _cuda.CudaKernel) -> torch.Tensor:
    if planar_b.device.type == "cpu":
        return composite_mat2_pieces_plain(planar_b, ml, pieces)
    if planar_b.device.type != "cuda":
        raise ValueError(f"no kernel for device {planar_b.device}")
    check_frames(planar_b, ml)
    Hb, Wb = _window_hw(ml, pieces)
    planar_b = check_staged(planar_b, (ml.tap_xy, ml.tap_cw, ml.gc),
                            ml.stage_table)
    B, N, _, H, W = planar_b.shape
    out = torch.empty((B, pieces, 3, Hb, Wb), dtype=torch.bfloat16,
                      device=planar_b.device)
    kernel.launch(*(t.data_ptr() for t in (
                      planar_b, ml.tap_xy, ml.tap_cw, ml.gc, ml.fb_cam,
                      ml.fb_sx, ml.fb_sy, ml.fb_gain, ml.stage_table, out)),
                  B, N, H, W, pieces, Hb, Wb, ml.stage_bytes,
                  torch.cuda.current_stream(planar_b.device).cuda_stream)
    return out


def composite_mat2_planar_pieces(planar_i8: torch.Tensor, ml: MatLUT2,
                                 pieces: int) -> torch.Tensor:
    """The multiband video path's warp stage for one frame set:
    [N, 3, H, W] int8 (value-128) + a `materialize2_used` state over a
    `concat_tiled_luts` window stack -> [pieces, 3, Hb, Wb] bfloat16 warped
    windows: uint8-quantised values with the gain and the folded seam mask
    applied, uncovered pixels exactly 0. On a CUDA tensor it launches the
    kernel (B = 1); on a CPU tensor it runs the plain version."""
    return _composite_pieces(planar_i8[None], ml, pieces, PIECES_SINGLE)[0]


def composite_mat2_planar_pieces_batched(planar_b_i8: torch.Tensor,
                                         ml: MatLUT2,
                                         pieces: int) -> torch.Tensor:
    """Micro-batch: [B, N, 3, H, W] int8 -> [B, pieces, 3, Hb, Wb] bfloat16,
    per frame set bit-identical to `composite_mat2_planar_pieces`. Any B in
    one launch: the state is read once for B frame sets."""
    return _composite_pieces(planar_b_i8, ml, pieces, PIECES_BATCHED)


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
