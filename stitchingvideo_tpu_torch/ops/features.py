"""ORB-class feature detection and description, batched over cameras.

Port of `stitchingvideo_tpu/ops/features.py` (the reference's FeaturesFinder
stage, src/matchers.cpp:272-434, grid-ORB variant :370-434): a dense FAST-9/16
mask ranked by the Harris response, 3x3 non-maximum suppression, a per-cell
score normalisation and one top-k; an intensity-centroid orientation; 256
seeded-Gaussian point pairs rotated by the keypoint angle ("rBRIEF-style"),
or, for the float modality, oriented gradient histograms. Every function
takes a camera axis in front ([N, H, W] gray; [H, W] for one image), so a
rig is one pass of whole-tensor ops. K keypoint slots with validity masks.

Carried across bit for bit: the FAST ring and its arc masks, the BRIEF
pattern (numpy seed 7) and the gradient pattern; the top-k order, ties
included (a stable descending sort, which is XLA's order); and the float
rounding of the filters, where XLA's CPU backend contracts multiply-adds
(`ops/fma.py`).
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import filters
from .filters import _pad2d
from .fma import fma

# FAST-9/16 circle offsets (x, y), radius 3 — standard Bresenham circle.
_FAST_OFFSETS = np.array([
    (0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3),
], np.int32)

_PATCH = 37          # descriptor/orientation patch size (odd)
_PATCH_R = _PATCH // 2
_ORIENT_R = 15       # intensity-centroid radius

# all 16 "9 consecutive of 16" circular run masks, one per start slot
_ARC9_RUNS = np.array([sum(1 << ((s + k) % 16) for k in range(9))
                       for s in range(16)], dtype=np.uint32)


def _batched(gray: torch.Tensor):
    """(gray as [N, H, W] float32, whether a camera axis was added)."""
    single = gray.dim() == 2
    g = gray[None] if single else gray
    return g.to(torch.float32), single


def _sep_small(img: torch.Tensor, kx: np.ndarray,
               ky: np.ndarray) -> torch.Tensor:
    """Separable filter of [N, H, W] by shift-and-accumulate, reflect-101
    padded: the detector path's filter, whose taps accumulate one at a time
    (vertical, then horizontal), each as one fused multiply-add."""
    N, H, W = img.shape
    rx = (len(kx) - 1) // 2
    ry = (len(ky) - 1) // 2
    x = _pad2d(img.to(torch.float32).permute(1, 2, 0), ry, rx) \
        .permute(2, 0, 1)
    kx = np.asarray(kx, np.float32).reshape(-1)
    ky = np.asarray(ky, np.float32).reshape(-1)
    v = torch.zeros((N, H, W + 2 * rx), dtype=torch.float32, device=img.device)
    for t, k in enumerate(ky):
        v = fma(float(k), x[:, t:t + H], v)
    out = torch.zeros((N, H, W), dtype=torch.float32, device=img.device)
    for t, k in enumerate(kx):
        out = fma(float(k), v[:, :, t:t + W], out)
    return out


_SOBEL_SMOOTH = np.array([1, 2, 1], np.float32)
_SOBEL_DERIV = np.array([-1, 0, 1], np.float32)


def _sobel_small(img: torch.Tensor, dx: int, dy: int) -> torch.Tensor:
    return _sep_small(img, _SOBEL_DERIV if dx else _SOBEL_SMOOTH,
                      _SOBEL_DERIV if dy else _SOBEL_SMOOTH)


def _harris_response(g: torch.Tensor) -> torch.Tensor:
    """Harris corner response of [N, H, W] (detector path)."""
    ix = _sobel_small(g, 1, 0)
    iy = _sobel_small(g, 0, 1)
    k = filters.gaussian_kernel(7, 2.0)
    sxx = _sep_small(ix * ix, k, k)
    syy = _sep_small(iy * iy, k, k)
    sxy = _sep_small(ix * iy, k, k)
    det = fma(sxx, syy, -(sxy * sxy))
    tr = sxx + syy
    return fma(-(0.04 * tr), tr, det)


def fast_score_map(gray: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9/16 corner mask * Harris response.

    gray: [N, H, W] (or [H, W]) float32 (0..255). Returns the response,
    0 where not a corner. The 16 ring tests are bits of an int32 map (16
    bits fit), and the 9-consecutive-of-16 arc test is 16 mask compares.
    """
    g, single = _batched(gray)
    hi = g + threshold
    lo = g - threshold
    bright = torch.zeros(g.shape, dtype=torch.int32, device=g.device)
    dark = torch.zeros_like(bright)
    for i, (dx, dy) in enumerate(_FAST_OFFSETS.tolist()):
        r = torch.roll(g, shifts=(-dy, -dx), dims=(1, 2))
        bright |= (r > hi).to(torch.int32) << i
        dark |= (r < lo).to(torch.int32) << i

    def has_run(bits):
        hit = torch.zeros(g.shape, dtype=torch.bool, device=g.device)
        for m in _ARC9_RUNS.tolist():
            hit |= (bits & m) == m
        return hit

    corner = has_run(bright) | has_run(dark)
    harris = _harris_response(g)
    out = torch.where(corner, torch.clamp(harris, min=1e-6),
                      torch.zeros_like(harris))
    return out[0] if single else out


def _nms3(score: torch.Tensor) -> torch.Tensor:
    """[N, H, W]: the score where it is its 3x3 neighbourhood's max (the
    pool pads with -inf), else 0."""
    mx = F.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]
    return torch.where(score >= mx, score, torch.zeros_like(score))


def harris_score_map(gray: torch.Tensor) -> torch.Tensor:
    """Pure Harris response (the 'harris_brief' detector option — corners
    without the FAST contrast gate)."""
    g, single = _batched(gray)
    out = torch.clamp(_harris_response(g), min=0.0)
    return out[0] if single else out


def detect(gray: torch.Tensor, threshold: float = 20.0, max_kp: int = 1024,
           border: int = 24, grid=(3, 1), detector: str = "fast",
           extent=None):
    """Top-k FAST/Harris keypoints of [N, H, W] (or [H, W]) gray.

    Returns (xy [N, K, 2] float32, response [N, K], valid [N, K] bool),
    without the N axis for one image. A per-grid-cell score normalisation
    spreads keypoints (OrbFeaturesFinder's grid, matchers.cpp:370-434).
    extent: the true (Ht, Wt) of bucket-padded images; keypoints are
    confined to the extent minus the border.
    """
    g, single = _batched(gray)
    N, H, W = g.shape
    Ht, Wt = (H, W) if extent is None else (int(extent[0]), int(extent[1]))
    if detector == "harris":
        raw = harris_score_map(g)
        raw = torch.where(raw > threshold, raw, torch.zeros_like(raw))
    else:
        raw = fast_score_map(g, threshold)
    score = _nms3(raw)
    yy = torch.arange(H, device=g.device)[:, None]
    xx = torch.arange(W, device=g.device)[None, :]
    inb = (xx >= border) & (xx < Wt - border) & (yy >= border) \
        & (yy < Ht - border)
    score = torch.where(inb, score, torch.zeros_like(score))

    gx, gy = grid
    if gx * gy > 1:
        # each cell competes on its own max; cells span the true extent and
        # padded rows/columns clamp into the last cell (their scores are 0)
        cw = -(-Wt // gx)
        ch = -(-Ht // gy)
        cell = torch.clamp((yy // ch) * gx + (xx // cw), max=gx * gy - 1)
        norm = torch.full(score.shape, 1e-12, dtype=torch.float32,
                          device=g.device)
        for c in range(gx * gy):
            in_c = cell == c
            cmax = torch.where(in_c, score, torch.zeros_like(score)) \
                .amax(dim=(1, 2), keepdim=True)
            norm = torch.where(in_c, torch.clamp(cmax, min=1e-12), norm)
        score = score / norm

    # exact top-k in XLA's order: descending, ties by the lower index
    vals, idx = torch.sort(score.reshape(N, -1), dim=1, descending=True,
                           stable=True)
    vals, idx = vals[:, :max_kp], idx[:, :max_kp]
    xy = torch.stack([(idx % W).to(torch.float32),
                      (idx // W).to(torch.float32)], dim=-1)
    valid = vals > 0.0
    if single:
        return xy[0], vals[0], valid[0]
    return xy, vals, valid


def _extract_patches(img: torch.Tensor, xy: torch.Tensor,
                     size: int) -> torch.Tensor:
    """[N, K, size, size] patches of [N, H, W] centred at the rounded
    keypoints [N, K, 2], clamped into the image."""
    N, H, W = img.shape
    r = size // 2
    xi = torch.clamp(torch.round(xy[..., 0]).to(torch.int64) - r, 0, W - size)
    yi = torch.clamp(torch.round(xy[..., 1]).to(torch.int64) - r, 0, H - size)
    d = torch.arange(size, device=img.device)
    rows = yi[..., None, None] + d[:, None]                # [N, K, size, 1]
    cols = xi[..., None, None] + d[None, :]                # [N, K, 1, size]
    flat = (rows * W + cols).reshape(N, -1)
    return torch.gather(img.reshape(N, -1), 1, flat) \
        .reshape(N, xy.shape[1], size, size)


def _orientation_weights():
    d = np.arange(-_ORIENT_R, _ORIENT_R + 1)
    yy, xx = np.meshgrid(d, d, indexing="ij")
    circ = (xx ** 2 + yy ** 2) <= _ORIENT_R ** 2
    return (xx * circ).astype(np.float32), (yy * circ).astype(np.float32)


_WX, _WY = _orientation_weights()


def orientations(gray: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per keypoint (radians): [N, H, W] gray and
    [N, K, 2] keypoints -> [N, K]."""
    patches = _extract_patches(gray.to(torch.float32), xy, 2 * _ORIENT_R + 1)
    wx = torch.as_tensor(_WX, device=gray.device)
    wy = torch.as_tensor(_WY, device=gray.device)
    m10 = (patches * wx).sum(dim=(2, 3))
    m01 = (patches * wy).sum(dim=(2, 3))
    return torch.atan2(m01, m10)


def brief_pattern(bits: int = 256, seed: int = 7) -> np.ndarray:
    """[bits, 4] (ax, ay, bx, by) sampling-pair offsets, Gaussian sigma=patch/5."""
    rng = np.random.default_rng(seed)
    sigma = _PATCH / 5.0
    pat = rng.normal(0.0, sigma, size=(bits, 4))
    lim = _PATCH_R - 3  # leave room for rotation + rounding
    return np.clip(pat, -lim * 0.7071, lim * 0.7071).astype(np.float32)


_PATTERN = brief_pattern()


def _rotate(ca, sa, px, py):
    """Pattern offsets [S] rotated by each keypoint's angle [N, K]:
    ([N, K, S], [N, K, S]) as the reference rounds them."""
    ca, sa = ca[..., None], sa[..., None]
    rx = fma(ca, px, -(sa * py))
    ry = fma(sa, px, ca * py)
    return rx, ry


def _patch_index(rx: torch.Tensor, ry: torch.Tensor) -> torch.Tensor:
    xi = torch.clamp(torch.round(rx).to(torch.int64) + _PATCH_R, 0, _PATCH - 1)
    yi = torch.clamp(torch.round(ry).to(torch.int64) + _PATCH_R, 0, _PATCH - 1)
    return yi * _PATCH + xi


def descriptors(blurred: torch.Tensor, xy: torch.Tensor,
                angle: torch.Tensor) -> torch.Tensor:
    """[N, K, 256] uint8 (0/1) rotated-BRIEF descriptors: the pre-blurred
    image [N, H, W] compared at pattern point pairs rotated by each
    keypoint's angle (nearest neighbour within the patch)."""
    patches = _extract_patches(blurred.to(torch.float32), xy, _PATCH)
    flat = patches.reshape(*patches.shape[:2], -1)         # [N, K, P*P]
    pat = torch.as_tensor(_PATTERN, device=blurred.device)
    ca, sa = torch.cos(angle), torch.sin(angle)
    ax, ay = _rotate(ca, sa, pat[:, 0], pat[:, 1])
    bx, by = _rotate(ca, sa, pat[:, 2], pat[:, 3])
    va = torch.gather(flat, 2, _patch_index(ax, ay))
    vb = torch.gather(flat, 2, _patch_index(bx, by))
    return (va < vb).to(torch.uint8)


# ---- float (SURF-class) descriptor: oriented gradient histograms ----------
# a 4x4 grid of 8-bin gradient-orientation histograms (128-dim), gradients
# rotated into the keypoint frame, Gaussian-weighted, L2-normalised with
# SIFT-style 0.2 clipping (the reference's default SURF + FLANN modality,
# src/matchers.cpp:316-368, :147-202)

_G_CELLS = 4           # 4x4 spatial grid
_G_BINS = 8            # orientation bins
_G_SUB = 3             # 3x3 samples per cell -> 144 samples


def _grad_pattern():
    """Sample offsets [S,2], per-sample cell one-hot [S, 16], Gaussian
    weights [S] (keypoint frame, patch radius ~14 of the 37-px patch)."""
    span = 28.0                        # descriptor support width (px)
    cell = span / _G_CELLS
    offs, cells, wts = [], [], []
    for cy in range(_G_CELLS):
        for cx in range(_G_CELLS):
            c0x = -span / 2 + cx * cell
            c0y = -span / 2 + cy * cell
            for sy in range(_G_SUB):
                for sx in range(_G_SUB):
                    px = c0x + (sx + 0.5) * cell / _G_SUB
                    py = c0y + (sy + 0.5) * cell / _G_SUB
                    offs.append((px, py))
                    cells.append(cy * _G_CELLS + cx)
                    wts.append(np.exp(-(px * px + py * py)
                                      / (2 * (span / 2.5) ** 2)))
    offs = np.asarray(offs, np.float32)
    oh = np.zeros((len(cells), _G_CELLS * _G_CELLS), np.float32)
    oh[np.arange(len(cells)), cells] = 1.0
    return offs, oh, np.asarray(wts, np.float32)


_G_OFFS, _G_CELL_OH, _G_WTS = _grad_pattern()


def grad_descriptors(gray: torch.Tensor, xy: torch.Tensor,
                     angle: torch.Tensor) -> torch.Tensor:
    """[N, K, 128] float32 oriented gradient-histogram descriptors."""
    gk5 = filters.gaussian_kernel(5, 1.2)
    g = _sep_small(gray.to(torch.float32), gk5, gk5)
    dx = _sobel_small(g, 1, 0)
    dy = _sobel_small(g, 0, 1)
    N, K = xy.shape[:2]
    px_patch = _extract_patches(dx, xy, _PATCH).reshape(N, K, -1)
    py_patch = _extract_patches(dy, xy, _PATCH).reshape(N, K, -1)
    ca, sa = torch.cos(angle), torch.sin(angle)
    offs = torch.as_tensor(_G_OFFS, device=gray.device)
    # sample positions rotated into the image frame
    flat_idx = _patch_index(*_rotate(ca, sa, offs[:, 0], offs[:, 1]))
    gx = torch.gather(px_patch, 2, flat_idx)                   # [N, K, S]
    gy = torch.gather(py_patch, 2, flat_idx)
    # gradients rotated into the keypoint frame
    ca, sa = ca[..., None], sa[..., None]
    gxr = fma(ca, gx, sa * gy)
    gyr = fma(-sa, gx, ca * gy)
    wts = torch.as_tensor(_G_WTS, device=gray.device)
    mag = torch.sqrt(fma(gxr, gxr, gyr * gyr)) * wts
    ori = torch.atan2(gyr, gxr)                                # [-pi, pi)
    fb = (ori + math.pi) * (_G_BINS / (2 * math.pi))
    # soft-assign into the two nearest orientation bins (linear vote)
    b0 = torch.remainder(torch.floor(fb).to(torch.int64), _G_BINS)
    b1 = torch.remainder(b0 + 1, _G_BINS)
    w1 = fb - torch.floor(fb)
    bins = torch.arange(_G_BINS, device=gray.device)
    oh = (b0[..., None] == bins) * (1.0 - w1)[..., None] \
        + (b1[..., None] == bins) * w1[..., None]             # [N, K, S, 8]
    cell_oh = torch.as_tensor(_G_CELL_OH, device=gray.device)
    hist = torch.einsum("nksb,sc->nkcb", oh * mag[..., None], cell_oh)
    d = hist.reshape(N, K, _G_CELLS * _G_CELLS * _G_BINS)
    # SIFT-style normalise -> clip 0.2 -> renormalise
    d = d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                        min=1e-12)
    d = torch.clamp(d, max=0.2)
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True),
                           min=1e-12)


def detect_and_describe(gray: torch.Tensor, threshold: float = 20.0,
                        max_kp: int = 1024, border: int = 24, grid=(3, 1),
                        detector: str = "fast", desc_kind: str = "brief",
                        extent=None):
    """The single-scale feature pipeline of [N, H, W] (or [H, W]) gray.

    Returns dict(xy, response, angle, valid, desc), [N, K, ...] (or
    [K, ...]). desc_kind: 'brief' (binary rBRIEF, uint8 0/1) or 'grad'
    (float gradient histograms). extent: see detect().
    """
    g, single = _batched(gray)
    xy, response, valid = detect(g, threshold, max_kp, border, grid,
                                 detector, extent)
    ang = orientations(g, xy)
    if desc_kind == "grad":
        desc = grad_descriptors(g, xy, ang)
        desc = torch.where(valid[..., None], desc, torch.zeros_like(desc))
    else:
        gk = filters.gaussian_kernel(7, 2.0)
        desc = descriptors(_sep_small(g, gk, gk), xy, ang)
        desc = torch.where(valid[..., None], desc, torch.zeros_like(desc))
    out = {"xy": xy, "response": response, "angle": ang, "valid": valid,
           "desc": desc}
    return {k: v[0] for k, v in out.items()} if single else out


def _linear_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of an antialiased linear resize (a triangle
    kernel widened by the downscale), as `jax.image.resize` builds them in
    float32."""
    scale = n_out / n_in
    inv_scale = torch.tensor(1.0 / scale, dtype=torch.float32)
    kernel_scale = torch.tensor(max(1.0 / scale, 1.0), dtype=torch.float32)
    sample_f = (torch.arange(n_out, dtype=torch.float32) + 0.5) * inv_scale \
        - 0.0 - 0.5
    x = (sample_f[None, :] - torch.arange(n_in, dtype=torch.float32)[:, None]) \
        .abs() / kernel_scale
    w = torch.clamp(1.0 - x.abs(), min=0.0)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def resize_linear(img: torch.Tensor, shape) -> torch.Tensor:
    """[H, W] float32 -> `shape`, `jax.image.resize(..., 'linear')`
    (antialiased when shrinking); the two contractions in float64, rounded
    once."""
    wy = _linear_weights(img.shape[0], shape[0], img.device).double()
    wx = _linear_weights(img.shape[1], shape[1], img.device).double()
    return (wy.T @ img.double() @ wx).float()


def detect_and_describe_pyramid(gray: torch.Tensor, threshold: float = 20.0,
                                max_kp: int = 1024, border: int = 24,
                                grid=(3, 1), levels: int = 3,
                                scale_factor: float = 1.5):
    """Multi-scale features of one [H, W] image (OpenCV ORB's pyramid, the
    reference's OrbFeaturesFinder nlevels, matchers.cpp:370-434): a budget
    per level, coordinates mapped back to level 0, descriptors sampled at
    the detection scale."""
    per_level = max_kp // levels
    parts = []
    gray = gray.to(torch.float32)
    img = gray
    scale = 1.0
    for lvl in range(levels):
        f = detect_and_describe(img, threshold, per_level, border, grid)
        parts.append(dict(f, xy=f["xy"] * scale))
        if lvl + 1 < levels:
            scale *= scale_factor
            nh = max(int(round(gray.shape[0] / scale)), 2 * border + 3)
            nw = max(int(round(gray.shape[1] / scale)), 2 * border + 3)
            img = resize_linear(gray, (nh, nw))
    out = {k: torch.cat([p[k] for p in parts], dim=0) for k in parts[0]}
    pad = max_kp - out["xy"].shape[0]
    if pad > 0:          # pad back to max_kp slots
        out = {k: torch.cat([v, v.new_zeros((pad,) + v.shape[1:])])
               for k, v in out.items()}
    return out
