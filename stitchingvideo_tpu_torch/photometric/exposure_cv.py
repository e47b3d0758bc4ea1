"""OpenCV-faithful BlocksGainCompensator (per-image block grids).

Port of `stitchingvideo_tpu/photometric/exposure_cv.py`: the compensator,
`_resize_linear` and `_smooth121` are the same numpy code (float64 solves
on the host); `apply_dev` and `_resize_linear_dev` are torch on the image's
device, the latter on the two taps a row of the reference's resampling
matrix holds (`_resample_taps`) rather than the dense matrix.

Parity target: cv::detail::BlocksGainCompensator / GainCompensator
(reference src/exposure_compensate.cpp:73-246). The fast variant in
exposure.py uses canvas-aligned blocks; this module reproduces the
reference's exact semantics for the pixel-parity still-compose path:

- each image is tiled into ceil(w/32) x ceil(h/32) blocks with per-image
  adjusted block sizes (exposure_compensate.cpp:176-199);
- every block is one unknown of the Brown-Lowe gain system; pairwise overlap
  statistics N(k,l), I(k,l) come from rect intersections of block ROIs
  (:91-125), including the self term N(k,k) = max(1, own mask pixels) that
  enters the beta prior (:133-141, the j==i iteration);
- alpha = 0.01, beta = 100, A x = b solve (:127-146);
- per-image gain grids smoothed twice with the separable [.25 .5 .25]
  kernel (:211-222);
- apply = bilinear resize of the grid to the image size, per-pixel multiply
  with round-and-saturate to uint8 (:224-246).

Statistics are gathered with integral images over each image-pair overlap
(numpy, seam scale ~0.1 MP), so cost is O(pairs + blocks), not O(K^2 pixels).
"""
from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..ops.fma import fma

_ALPHA = 0.01
_BETA = 100.0


def _lum(img: np.ndarray) -> np.ndarray:
    """Per-pixel L2 norm over channels (norm(Vec3b), float64)."""
    f = img.astype(np.float64)
    return np.sqrt((f * f).sum(-1))


def _integral(x: np.ndarray) -> np.ndarray:
    """Summed-area table with a zero top/left border row/col."""
    s = np.zeros((x.shape[0] + 1, x.shape[1] + 1), np.float64)
    np.cumsum(np.cumsum(x, 0), 1, out=s[1:, 1:])
    return s


def _rect_sum(s: np.ndarray, x0: int, y0: int, x1: int, y1: int) -> float:
    return s[y1, x1] - s[y0, x1] - s[y1, x0] + s[y0, x0]


class BlocksGainCompensatorCV:
    """Reference-faithful block gain compensator."""

    def __init__(self, bl_width: int = 32, bl_height: int = 32):
        self.bl_width = bl_width
        self.bl_height = bl_height
        self.gain_maps: List[np.ndarray] = []

    # ------------------------------------------------------------------
    def feed(self, corners: Sequence[Tuple[int, int]],
             images: Sequence[np.ndarray],
             masks: Sequence[np.ndarray]) -> None:
        n = len(images)
        # per-image block grids (exposure_compensate.cpp:176-187)
        grids = []            # (nbx, nby, bw, bh)
        block_of = []         # global index of image i's block (by, bx)
        K = 0
        for i in range(n):
            h, w = images[i].shape[:2]
            nbx = (w + self.bl_width - 1) // self.bl_width
            nby = (h + self.bl_height - 1) // self.bl_height
            bw = (w + nbx - 1) // nbx
            bh = (h + nby - 1) // nby
            grids.append((nbx, nby, bw, bh))
            block_of.append(K)
            K += nbx * nby

        N = np.zeros((K, K), np.float64)
        I = np.zeros((K, K), np.float64)

        lums = [_lum(im) for im in images]
        bmasks = [m != 0 for m in masks]

        # self terms: N(k,k) = max(1, mask pixels in block)
        for i in range(n):
            nbx, nby, bw, bh = grids[i]
            h, w = images[i].shape[:2]
            sm = _integral(bmasks[i].astype(np.float64))
            for by in range(nby):
                for bx in range(nbx):
                    x0, y0 = bx * bw, by * bh
                    x1, y1 = min(x0 + bw, w), min(y0 + bh, h)
                    k = block_of[i] + by * nbx + bx
                    N[k, k] = max(1.0, _rect_sum(sm, x0, y0, x1, y1))

        # cross-image block pairs via per-image-pair integral images
        for i in range(n):
            hi, wi = images[i].shape[:2]
            cxi, cyi = corners[i]
            for j in range(i + 1, n):
                hj, wj = images[j].shape[:2]
                cxj, cyj = corners[j]
                ox0 = max(cxi, cxj); oy0 = max(cyi, cyj)
                ox1 = min(cxi + wi, cxj + wj); oy1 = min(cyi + hi, cyj + hj)
                if ox1 <= ox0 or oy1 <= oy0:
                    continue
                ri = (slice(oy0 - cyi, oy1 - cyi), slice(ox0 - cxi, ox1 - cxi))
                rj = (slice(oy0 - cyj, oy1 - cyj), slice(ox0 - cxj, ox1 - cxj))
                mm = (bmasks[i][ri] & bmasks[j][rj]).astype(np.float64)
                s_mm = _integral(mm)
                s_li = _integral(lums[i][ri] * mm)
                s_lj = _integral(lums[j][rj] * mm)

                nbxi, nbyi, bwi, bhi = grids[i]
                nbxj, nbyj, bwj, bhj = grids[j]
                # blocks of i whose rect intersects the overlap region
                bx0 = max(0, (ox0 - cxi) // bwi)
                bx1 = min(nbxi - 1, (ox1 - 1 - cxi) // bwi)
                by0 = max(0, (oy0 - cyi) // bhi)
                by1 = min(nbyi - 1, (oy1 - 1 - cyi) // bhi)
                for by in range(by0, by1 + 1):
                    for bx in range(bx0, bx1 + 1):
                        # block rect in global coords, clipped to image i
                        gx0 = cxi + bx * bwi
                        gy0 = cyi + by * bhi
                        gx1 = min(gx0 + bwi, cxi + wi)
                        gy1 = min(gy0 + bhi, cyi + hi)
                        k = block_of[i] + by * nbxi + bx
                        # blocks of j intersecting this rect
                        jx0 = max(0, (max(gx0, ox0) - cxj) // bwj)
                        jx1 = min(nbxj - 1, (min(gx1, ox1) - 1 - cxj) // bwj)
                        jy0 = max(0, (max(gy0, oy0) - cyj) // bhj)
                        jy1 = min(nbyj - 1, (min(gy1, oy1) - 1 - cyj) // bhj)
                        for jy in range(jy0, jy1 + 1):
                            for jx in range(jx0, jx1 + 1):
                                hx0 = cxj + jx * bwj
                                hy0 = cyj + jy * bhj
                                hx1 = min(hx0 + bwj, cxj + wj)
                                hy1 = min(hy0 + bhj, cyj + hj)
                                # block-pair rect intersection
                                px0 = max(gx0, hx0); px1 = min(gx1, hx1)
                                py0 = max(gy0, hy0); py1 = min(gy1, hy1)
                                if px1 <= px0 or py1 <= py0:
                                    continue
                                l = block_of[j] + jy * nbxj + jx
                                # clip to the overlap region and localize
                                qx0 = max(px0, ox0) - ox0
                                qx1 = min(px1, ox1) - ox0
                                qy0 = max(py0, oy0) - oy0
                                qy1 = min(py1, oy1) - oy0
                                if qx1 <= qx0 or qy1 <= qy0:
                                    continue
                                cnt = max(1.0, _rect_sum(s_mm, qx0, qy0, qx1, qy1))
                                N[k, l] = N[l, k] = cnt
                                I[k, l] = _rect_sum(s_li, qx0, qy0, qx1, qy1) / cnt
                                I[l, k] = _rect_sum(s_lj, qx0, qy0, qx1, qy1) / cnt

        # Brown-Lowe system (exposure_compensate.cpp:127-146)
        A = np.zeros((K, K), np.float64)
        b = np.zeros(K, np.float64)
        b += _BETA * N.sum(1)
        np.fill_diagonal(A, _BETA * N.sum(1) + 2 * _ALPHA * ((I * I * N).sum(1)
                                                             - np.diag(I) ** 2 * np.diag(N)))
        off = -2 * _ALPHA * I * I.T * N
        np.fill_diagonal(off, 0.0)
        A += off
        gains = np.linalg.solve(A, b)

        # per-image grids + double [.25 .5 .25] smoothing (:211-222)
        self.gain_maps = []
        k = 0
        for i in range(n):
            nbx, nby, _, _ = grids[i]
            g = gains[k:k + nby * nbx].reshape(nby, nbx).astype(np.float32)
            k += nby * nbx
            for _ in range(2):
                g = _smooth121(g)
            self.gain_maps.append(g)

    # ------------------------------------------------------------------
    def apply_dev(self, index: int, image_dev: torch.Tensor) -> torch.Tensor:
        """The reference's apply on `image_dev`'s device: uint8 image tensor
        in and out, the grid resized to the image, a float32 product, round
        half to even, saturate (a host image goes in as a CPU tensor)."""
        g = torch.from_numpy(self.gain_maps[index]).to(image_dev.device)
        h, w = image_dev.shape[:2]
        if tuple(g.shape) != (h, w):
            g = _resize_linear_dev(g, h, w)
        out = image_dev.to(torch.float32) * g[..., None]
        return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)

    def gain_grid(self, index: int) -> np.ndarray:
        return self.gain_maps[index]


@functools.lru_cache(maxsize=64)
def _resample_taps(n_out: int, n_in: int):
    """The two taps of each row of the reference's [n_out, n_in]
    INTER_LINEAR resampling matrix (its `_resample_matrix`: half-pixel
    centers, edge clamp, clamped duplicate taps summed in float32), in
    column order: (cols [n_out, 2] int64, weights [n_out, 2] float32); a
    row whose taps clamp onto one column carries their sum and a second
    tap of weight 0. Built without the dense matrix (a panorama-wide one
    is tens of MB)."""
    s = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(s).astype(np.int64)
    f = (s - i0).astype(np.float32)
    cols = np.stack([np.clip(i0, 0, n_in - 1), np.clip(i0 + 1, 0, n_in - 1)],
                    -1)
    wts = np.stack([np.float32(1.0) - f, f], -1)
    same = cols[:, 0] == cols[:, 1]
    wts[same, 0] = wts[same, 0] + wts[same, 1]
    wts[same, 1] = 0.0
    return cols, wts


def _resample_rows(x: torch.Tensor, n_out: int) -> torch.Tensor:
    """The resampling matrix [n_out, x.shape[0]] @ x, rounded as XLA's CPU
    matrix product rounds it at the reference's shapes: the first tap's
    product rounded to float32, the second added by a fused multiply-add
    (`ops/fma.py`, exact in float64 on any device)."""
    cols, wts = _resample_taps(n_out, x.shape[0])
    c = torch.from_numpy(cols).to(x.device)
    w = torch.from_numpy(wts).to(x.device)
    shape = (n_out,) + (1,) * (x.dim() - 1)
    first = w[:, 0].reshape(shape) * x[c[:, 0]]
    return fma(w[:, 1].reshape(shape), x[c[:, 1]], first)


def _resize_linear_dev(g: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Device mirror of _resize_linear (cv::resize INTER_LINEAR) as the
    reference's two resampling-matrix products, Wy @ g @ Wx^T, taken as
    two-tap gathers: a row of a resampling matrix has two taps. No matrix
    product runs, so TF32 cannot touch the result whatever the global
    flags say, and the CPU and the card give the same bits. The reference
    takes the products in float32 at Precision.HIGHEST; XLA's CPU backend
    rounds them with or without a fused multiply-add depending on the
    shape, so the two agree within three float32 ulps (equal at most of
    the reference's shapes)."""
    x = _resample_rows(g.to(torch.float32), h)
    return _resample_rows(x.T, w).T


def _resize_linear(g: np.ndarray, h: int, w: int) -> np.ndarray:
    """cv::resize INTER_LINEAR for float32: half-pixel centers, edge clamp."""
    gh, gw = g.shape
    ys = (np.arange(h, dtype=np.float64) + 0.5) * (gh / h) - 0.5
    xs = (np.arange(w, dtype=np.float64) + 0.5) * (gw / w) - 0.5
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    fy = (ys - y0).astype(np.float32)
    fx = (xs - x0).astype(np.float32)
    y0c = np.clip(y0, 0, gh - 1); y1c = np.clip(y0 + 1, 0, gh - 1)
    x0c = np.clip(x0, 0, gw - 1); x1c = np.clip(x0 + 1, 0, gw - 1)
    a = g[np.ix_(y0c, x0c)] * (1 - fy)[:, None] * (1 - fx)[None, :]
    b = g[np.ix_(y0c, x1c)] * (1 - fy)[:, None] * fx[None, :]
    c = g[np.ix_(y1c, x0c)] * fy[:, None] * (1 - fx)[None, :]
    d = g[np.ix_(y1c, x1c)] * fy[:, None] * fx[None, :]
    return (a + b + c + d).astype(np.float32)


def _smooth121(g: np.ndarray) -> np.ndarray:
    """Separable [0.25 0.5 0.25] filter with BORDER_REFLECT_101 edges,
    float32 accumulation (cv::sepFilter2D parity)."""
    if g.shape[0] > 1:
        p = np.pad(g, ((1, 1), (0, 0)), mode="reflect")
    else:
        p = np.pad(g, ((1, 1), (0, 0)), mode="edge")
    g = (0.25 * p[:-2] + 0.5 * p[1:-1] + 0.25 * p[2:]).astype(np.float32)
    if g.shape[1] > 1:
        p = np.pad(g, ((0, 0), (1, 1)), mode="reflect")
    else:
        p = np.pad(g, ((0, 0), (1, 1)), mode="edge")
    return (0.25 * p[:, :-2] + 0.5 * p[:, 1:-1] + 0.25 * p[:, 2:]).astype(np.float32)
