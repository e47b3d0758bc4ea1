"""Generic remap: resampling through an arbitrary backward map by gather.

Port of `stitchingvideo_tpu/ops/remap.py` (cv::remap as the reference's
warpers use it, warpers_inl.hpp:63-99: INTER_LINEAR + BORDER_REFLECT for
images, INTER_NEAREST + BORDER_CONSTANT for masks). The taps are gathered
from the flattened [H*W, C] image; borders are index remaps (reflect,
replicate, wrap) or zeroed tap weights (constant), never branches on
values. The multi-camera hot-loop gather is `ops/remap_tiled.py` (kernel
K6); this module is the registration-time path.
"""
from __future__ import annotations

import torch

from .fma import fma

BORDER_CONSTANT = "constant"
BORDER_REPLICATE = "replicate"
BORDER_REFLECT = "reflect"        # fedcba|abcdefgh|hgfedcb  (cv::BORDER_REFLECT)
BORDER_REFLECT101 = "reflect101"  # gfedcb|abcdefgh|gfedcba  (cv::BORDER_REFLECT_101)
BORDER_WRAP = "wrap"


def _map_index(idx: torch.Tensor, size: int, border: str) -> torch.Tensor:
    """Map possibly out-of-range integer indices into [0, size)."""
    if border in (BORDER_CONSTANT, BORDER_REPLICATE):
        # constant: the caller masks the weights; clamp for memory safety
        return torch.clamp(idx, 0, size - 1)
    if border == BORDER_REFLECT:
        m = torch.remainder(idx, 2 * size)
        return torch.where(m < size, m, 2 * size - 1 - m)
    if border == BORDER_REFLECT101:
        if size == 1:
            return torch.zeros_like(idx)
        m = torch.remainder(idx, 2 * (size - 1))
        return torch.where(m < size, m, 2 * (size - 1) - m)
    if border == BORDER_WRAP:
        return torch.remainder(idx, size)
    raise ValueError(f"unknown border mode {border}")


def remap(image: torch.Tensor, xmap, ymap, interp: str = "linear",
          border: str = BORDER_CONSTANT, cval: float = 0.0) -> torch.Tensor:
    """Sample `image` at float coordinates (xmap, ymap).

    image: [H, W] or [H, W, C]; xmap/ymap: [...out] float32 on its device.
    Returns [...out] or [...out, C] in the image's dtype (integer images are
    computed in float32, rounded half to even and clamped to the dtype).
    """
    squeeze = image.dim() == 2
    if squeeze:
        image = image[..., None]
    H, W, C = image.shape
    img = image.to(torch.float32).reshape(H * W, C)
    x = torch.as_tensor(xmap, dtype=torch.float32, device=image.device)
    y = torch.as_tensor(ymap, dtype=torch.float32, device=image.device)
    out_shape = x.shape

    def take(flat):
        return img.index_select(0, flat.reshape(-1)).reshape(*out_shape, C)

    def inside(xi, yi):
        return (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)

    def clamped(xi, yi):
        return torch.clamp(yi, 0, H - 1) * W + torch.clamp(xi, 0, W - 1)

    if interp == "nearest":
        # cv::INTER_NEAREST rounds half up on positive coordinates
        xi = torch.floor(x + 0.5).to(torch.int64)
        yi = torch.floor(y + 0.5).to(torch.int64)
        if border == BORDER_CONSTANT:
            out = torch.where(inside(xi, yi)[..., None], take(clamped(xi, yi)),
                              torch.full((), cval, device=img.device))
        else:
            out = take(_map_index(yi, H, border) * W
                       + _map_index(xi, W, border))
    elif interp == "linear":
        x0 = torch.floor(x)
        y0 = torch.floor(y)
        fx = x - x0
        fy = y - y0
        x0i = x0.to(torch.int64)
        y0i = y0.to(torch.int64)
        wsum = torch.zeros(out_shape, dtype=torch.float32, device=img.device)
        terms = []
        for dy in (0, 1):
            for dx in (0, 1):
                wgt = (fx if dx else (1.0 - fx)) * (fy if dy else (1.0 - fy))
                xi = x0i + dx
                yi = y0i + dy
                if border == BORDER_CONSTANT:
                    wgt = torch.where(inside(xi, yi), wgt,
                                      torch.zeros_like(wgt))
                    flat = clamped(xi, yi)
                else:
                    flat = _map_index(yi, H, border) * W \
                        + _map_index(xi, W, border)
                terms.append((wgt[..., None], take(flat)))
                wsum = wsum + wgt
        # the sum of the four weighted taps, rounded as XLA contracts it:
        # the first two products fuse into one FMA, each later one into its
        # own
        (w0, v0), (w1, v1) = terms[:2]
        acc = fma(w0, v0, w1 * v1)
        for w, v in terms[2:]:
            acc = fma(w, v, acc)
        out = acc + (1.0 - wsum)[..., None] * cval \
            if border == BORDER_CONSTANT else acc
    else:
        raise ValueError(f"unknown interp {interp}")

    if not image.dtype.is_floating_point:
        info = torch.iinfo(image.dtype)
        out = torch.clamp(torch.round(out), info.min, info.max) \
            .to(image.dtype)
    else:
        out = out.to(image.dtype)
    return out[..., 0] if squeeze else out
