"""Composite LUT: the per-panorama-pixel gather table + its exact oracle.

Port of `stitchingvideo_tpu/video/lut.py`. Every panorama pixel knows its
source camera, its source coordinates and its gain, so a frame is composited
by one gather pass. `build_lut` is bit-exact with the JAX package's build
(canvas placement, first owner wins, equality-masked select, crop), and
`composite_frame` / `composite_frame_u8` are the plain bilinear gather the
kernels of the hot loop are held against.
"""
from __future__ import annotations

import dataclasses

import torch

from ..models.registration import Registration


@dataclasses.dataclass
class CompositeLUT:
    """cam_idx: [Hp, Wp] int32 (-1 where uncovered); src_x/src_y: [Hp, Wp]
    float32 source-frame coords; gain: [Hp, Wp] float32."""
    cam_idx: torch.Tensor
    src_x: torch.Tensor
    src_y: torch.Tensor
    gain: torch.Tensor

    @property
    def shape(self):
        return tuple(self.cam_idx.shape)

    def to(self, device) -> "CompositeLUT":
        return CompositeLUT(*(getattr(self, f.name).to(device)
                              for f in dataclasses.fields(self)))


def roi_placer(reg: Registration):
    """place(i, arr, fill): camera i's ROI array on a canvas of `fill`,
    oversized by one ROI so a ROI placed at any corner fits; callers crop to
    the canvas at the end."""
    CW, CH = reg.canvas_wh
    Hr, Wr = reg.roi_hw
    HP, WP = CH + Hr, CW + Wr
    corners = reg.corners.cpu().tolist()

    def place(i, arr, fill):
        canvas = torch.full((HP, WP), fill, dtype=arr.dtype, device=arr.device)
        # the start clamp of jax.lax.dynamic_update_slice
        y = min(max(int(corners[i][1]), 0), HP - Hr)
        x = min(max(int(corners[i][0]), 0), WP - Wr)
        canvas[y:y + Hr, x:x + Wr] = arr
        return canvas

    return place, (HP, WP)


def build_lut(reg: Registration, crop=None) -> CompositeLUT:
    """Flatten a registration into a CompositeLUT on the registration's
    device. crop=(y0, y1, x0, x1) applies the RT crop margins."""
    CW, CH = reg.canvas_wh
    n = reg.n_cameras
    dev = reg.device
    place, (HP, WP) = roi_placer(reg)

    own = [place(i, reg.seam_masks[i] & reg.valid[i], False) for i in range(n)]
    # first owner wins (argmax over the camera axis: 0 where nobody owns)
    cam = torch.zeros((HP, WP), dtype=torch.int32, device=dev)
    for i in reversed(range(n)):
        cam = torch.where(own[i], torch.tensor(i, dtype=torch.int32,
                                               device=dev), cam)
    covered = torch.stack(own).any(dim=0)
    cam_idx = torch.where(covered, cam, torch.tensor(-1, dtype=torch.int32,
                                                     device=dev))

    def take(maps, fill):
        # equality-masked select, camera by camera
        out = place(0, maps[0], fill)
        for i in range(1, n):
            out = torch.where(cam == i, place(i, maps[i], fill), out)
        return out

    src_x = take(reg.xmaps, 0.0)
    src_y = take(reg.ymaps, 0.0)
    gain = torch.where(covered, take(reg.gain_maps, 1.0),
                       torch.tensor(1.0, dtype=reg.gain_maps.dtype,
                                    device=dev))
    y0, y1, x0, x1 = crop if crop is not None else (0, CH, 0, CW)
    sl = (slice(y0, y1), slice(x0, x1))
    return CompositeLUT(cam_idx=cam_idx[sl].contiguous(),
                        src_x=src_x[sl].contiguous(),
                        src_y=src_y[sl].contiguous(),
                        gain=gain[sl].contiguous())


def composite_frame(frames: torch.Tensor, lut: CompositeLUT) -> torch.Tensor:
    """The exact bilinear gather through the composite LUT.

    frames: [N, H, W, C] (uint8 or float); returns [Hp, Wp, C] float32. Plain
    PyTorch: the oracle of the hot loop's kernels, and the path of
    `kernel='gather'`."""
    n, H, W, C = frames.shape
    flat = frames.reshape(n * H * W, C).float()
    base = lut.cam_idx.clamp(min=0).long() * (H * W)

    x0f = torch.floor(lut.src_x)
    y0f = torch.floor(lut.src_y)
    fx = lut.src_x - x0f
    fy = lut.src_y - y0f
    x0 = x0f.to(torch.int32).clamp(0, W - 1).long()
    y0 = y0f.to(torch.int32).clamp(0, H - 1).long()
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)

    def g(yi, xi):
        return flat[(base + yi * W + xi).reshape(-1)] \
            .reshape(*lut.cam_idx.shape, C)

    out = ((1 - fx) * (1 - fy))[..., None] * g(y0, x0) \
        + (fx * (1 - fy))[..., None] * g(y0, x1) \
        + ((1 - fx) * fy)[..., None] * g(y1, x0) \
        + (fx * fy)[..., None] * g(y1, x1)
    out = out * lut.gain[..., None]
    return torch.where((lut.cam_idx >= 0)[..., None], out,
                       torch.zeros((), dtype=out.dtype, device=out.device))


def composite_frame_u8(frames: torch.Tensor,
                       lut: CompositeLUT) -> torch.Tensor:
    """`composite_frame` rounded half to even and clamped: [Hp, Wp, C] u8."""
    return torch.round(composite_frame(frames, lut)).clamp(0, 255) \
        .to(torch.uint8)
