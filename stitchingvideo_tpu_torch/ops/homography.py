"""Homography estimation: normalised DLT, 4-point and weighted refits.

Port of `stitchingvideo_tpu/ops/homography.py` (cv::findHomography's kernel
as the reference's matcher uses it, src/matchers.cpp:603-651). Every
function takes leading batch axes (pairs, hypotheses): points [..., M, 2],
weights [..., M]. The solves are `torch.linalg.solve_ex`, whose `info` is
ignored as JAX ignores it: a singular system gives a garbage H that scores
no inliers, without a raise or a sync with the host. Products that the
reference takes at `Precision.HIGHEST` are taken in float64 and rounded to
float32 (`matmul_highest`), which TF32 cannot touch.
"""
from __future__ import annotations

import math

import torch


def matmul_highest(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b in float32 at full precision on any device (float64
    accumulation, one rounding)."""
    return (a.double() @ b.double()).float()


def _normalization(pts: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Hartley normalisation [..., 3, 3] of weighted points [..., M, 2]."""
    wsum = torch.clamp(w.sum(-1), min=1e-12)                  # [...]
    c = (pts * w[..., None]).sum(-2) / wsum[..., None]         # [..., 2]
    d = torch.sqrt(((pts - c[..., None, :]) ** 2).sum(-1))
    mean_d = (d * w).sum(-1) / wsum
    s = math.sqrt(2.0) / torch.clamp(mean_d, min=1e-12)
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    return torch.stack([
        torch.stack([s, zero, -s * c[..., 0]], -1),
        torch.stack([zero, s, -s * c[..., 1]], -1),
        torch.stack([zero, zero, one], -1)], -2)


def _normalized_pair(pts1, pts2, w):
    """Hartley normalisation of both point sets: (p1, p2, T1, T2)."""
    T1 = _normalization(pts1, w)
    T2 = _normalization(pts2, w)
    p1 = pts1 * T1[..., None, 0, 0, None] + T1[..., None, :2, 2]
    p2 = pts2 * T2[..., None, 0, 0, None] + T2[..., None, :2, 2]
    return p1, p2, T1, T2


def _denormalize(Hn, T1, T2):
    """p2 = T2^-1 Hn T1 p1, rescaled to H[2,2] = 1 (guarded)."""
    s = T2[..., 0, 0]
    zero, one = torch.zeros_like(s), torch.ones_like(s)
    T2inv = torch.stack([
        torch.stack([1.0 / s, zero, -T2[..., 0, 2] / s], -1),
        torch.stack([zero, 1.0 / T2[..., 1, 1], -T2[..., 1, 2] / T2[..., 1, 1]],
                    -1),
        torch.stack([zero, zero, one], -1)], -2)
    H = T2inv @ Hn @ T1
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(h22.abs() < 1e-12, torch.full_like(h22, 1e-12),
                           h22)


def _h33_rows(p1, p2):
    """(A [..., 2M, 8], b [..., 2M]) of the h33=1 system A h = b
    (cv2.getPerspectiveTransform's formulation)."""
    x, y = p1[..., 0], p1[..., 1]
    xp, yp = p2[..., 0], p2[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([x, y, one, zero, zero, zero, -x * xp, -y * xp], -1)
    r2 = torch.stack([zero, zero, zero, x, y, one, -x * yp, -y * yp], -1)
    return torch.cat([r1, r2], dim=-2), torch.cat([xp, yp], dim=-1)


def _with_h33(h: torch.Tensor) -> torch.Tensor:
    return torch.cat([h, torch.ones_like(h[..., :1])], -1) \
        .reshape(*h.shape[:-1], 3, 3)


def dlt_homography(pts1: torch.Tensor, pts2: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """Weighted normalised DLT. pts [..., M, 2], w [..., M] >= 0. Returns H
    (p2 ~ H p1); the eigenvector's sign is free, the result divided by
    H[2,2]."""
    p1, p2, T1, T2 = _normalized_pair(pts1, pts2, w)
    x, y = p1[..., 0], p1[..., 1]
    xp, yp = p2[..., 0], p2[..., 1]
    zero, one = torch.zeros_like(x), torch.ones_like(x)
    r1 = torch.stack([-x, -y, -one, zero, zero, zero, x * xp, y * xp, xp], -1)
    r2 = torch.stack([zero, zero, zero, -x, -y, -one, x * yp, y * yp, yp], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], dim=-2)
    AtA = matmul_highest(A.transpose(-1, -2), A)
    _, vecs = torch.linalg.eigh(AtA)
    Hn = vecs[..., :, 0].reshape(*vecs.shape[:-2], 3, 3)
    return _denormalize(Hn, T1, T2)


def perspective_4pt(pts1: torch.Tensor, pts2: torch.Tensor) -> torch.Tensor:
    """Exact 4-point homographies [..., 3, 3] of [..., 4, 2] samples via
    the Hartley-normalised 8x8 system with h33=1 (the RANSAC hypothesis
    solver). A degenerate sample gives a garbage H that scores no
    inliers."""
    p1, p2, T1, T2 = _normalized_pair(pts1, pts2,
                                      torch.ones_like(pts1[..., 0]))
    A, b = _h33_rows(p1, p2)                          # [..., 8, 8], [..., 8]
    h, _info = torch.linalg.solve_ex(A, b)
    return _denormalize(_with_h33(h), T1, T2)


def weighted_refit_8pt(pts1: torch.Tensor, pts2: torch.Tensor,
                       w: torch.Tensor) -> torch.Tensor:
    """Weighted inlier refit via the h33=1 normal equations
    A^T W A h = A^T W b (8x8), with a 1e-8 ridge for degenerate weights;
    the caller's inlier-count gate discards a garbage refit."""
    p1, p2, T1, T2 = _normalized_pair(pts1, pts2, w)
    A, b = _h33_rows(p1, p2)                          # [..., 2M, 8], [..., 2M]
    ww = torch.cat([w, w], dim=-1)
    Awt = (A * ww[..., None]).transpose(-1, -2)
    G = matmul_highest(Awt, A) \
        + 1e-8 * torch.eye(8, dtype=A.dtype, device=A.device)
    h, _info = torch.linalg.solve_ex(G, matmul_highest(Awt, b[..., None])
                                     [..., 0])
    return _denormalize(_with_h33(h), T1, T2)


def transfer_error2(H: torch.Tensor, pts1: torch.Tensor,
                    pts2: torch.Tensor) -> torch.Tensor:
    """Squared forward transfer error per correspondence (findHomography's
    inlier criterion): H [..., 3, 3], pts [..., M, 2] -> [..., M]."""
    x, y = pts1[..., 0], pts1[..., 1]
    h = H[..., None, :, :]

    def row(r):
        return h[..., r, 0] * x + h[..., r, 1] * y + h[..., r, 2]

    d = row(2)
    d = torch.where(d.abs() < 1e-12, torch.full_like(d, 1e-12), d)
    px = row(0) / d
    py = row(1) / d
    return (px - pts2[..., 0]) ** 2 + (py - pts2[..., 1]) ** 2
