"""Focal auto-calibration from pairwise homographies.

Parity target: focalsFromHomography / estimateFocal (reference
src/autocalib.cpp:67-143) — the Brown–Lowe closed-form focal estimates from a
rotation-only homography between two images with centered principal points.
Host-side (numpy): runs once over O(N^2) tiny matrices.

A copy of `stitchingvideo_tpu/geometry/autocalib.py`: numpy host code in both packages.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def focals_from_homography(H: np.ndarray) -> Tuple[Optional[float], Optional[float]]:
    """(f0, f1) focal estimates for the source (f0) and destination (f1)
    cameras of H (dst ~ H src, centered coords). None where not estimable."""
    h = np.asarray(H, np.float64).ravel()

    f1 = None
    d1 = h[6] * h[7]
    d2 = (h[7] - h[6]) * (h[7] + h[6])
    v1 = -(h[0] * h[1] + h[3] * h[4]) / d1 if d1 != 0 else np.nan
    v2 = (h[0] * h[0] + h[3] * h[3] - h[1] * h[1] - h[4] * h[4]) / d2 if d2 != 0 else np.nan
    if np.isfinite(v1) and np.isfinite(v2) and v1 < v2:
        v1, v2 = v2, v1
        d1, d2 = d2, d1
    if np.isfinite(v1) and v1 > 0 and np.isfinite(v2) and v2 > 0:
        f1 = float(np.sqrt(v1 if abs(d1) > abs(d2) else v2))
    elif np.isfinite(v1) and v1 > 0:
        f1 = float(np.sqrt(v1))

    f0 = None
    d1 = h[0] * h[3] + h[1] * h[4]
    d2 = h[0] * h[0] + h[1] * h[1] - h[3] * h[3] - h[4] * h[4]
    v1 = -h[2] * h[5] / d1 if d1 != 0 else np.nan
    v2 = (h[5] * h[5] - h[2] * h[2]) / d2 if d2 != 0 else np.nan
    if np.isfinite(v1) and np.isfinite(v2) and v1 < v2:
        v1, v2 = v2, v1
        d1, d2 = d2, d1
    if np.isfinite(v1) and v1 > 0 and np.isfinite(v2) and v2 > 0:
        f0 = float(np.sqrt(v1 if abs(d1) > abs(d2) else v2))
    elif np.isfinite(v1) and v1 > 0:
        f0 = float(np.sqrt(v1))
    return f0, f1


def estimate_focal(img_sizes: List[Tuple[int, int]],
                   pair_list: List[Tuple[int, int, np.ndarray, int]]) -> float:
    """Median focal across pair estimates; fallback = mean(w + h).

    img_sizes: [(w, h)] per image; pair_list: (i, j, H, num_inliers) entries.
    Parity: estimateFocal (autocalib.cpp:98-143).
    """
    all_focals = []
    for _i, _j, H, ni in pair_list:
        if H is None or ni <= 0:
            continue
        f0, f1 = focals_from_homography(H)
        if f0 is not None and f1 is not None:
            all_focals.append(float(np.sqrt(f0 * f1)))
    if all_focals:
        return float(np.median(all_focals))
    return float(np.mean([w + h for (w, h) in img_sizes]))


def calibrate_rotating_camera(Hs: List[np.ndarray]) -> Optional[np.ndarray]:
    """Full K (upper-triangular, K[2,2]=1) of a rotating camera from inter-
    frame homographies H_k ~ K R_k K^-1.

    Parity target: calibrateRotatingCamera (reference src/autocalib.cpp:
    146-195): each H is det-normalized, the symmetric W = K K^T satisfies
    H W H^T = W, giving 6 linear equations per homography in W's 6 unique
    entries; the least-squares null vector (SVD) is normalized to W22=1 and
    Cholesky-factored into K. Returns None when W is not positive definite
    (degenerate motion, e.g. all rotations about one axis).
    """
    m = len(Hs)
    if m < 1:
        return None
    idx_map = ((0, 1, 2), (1, 3, 4), (2, 4, 5))
    A = np.zeros((6 * m, 6), np.float64)
    eq = 0
    for H in Hs:
        H = np.asarray(H, np.float64)
        det = np.linalg.det(H)
        if det == 0:
            return None
        H = H / np.cbrt(det)
        for i in range(3):
            for j in range(i, 3):
                for l in range(3):
                    for s in range(3):
                        A[eq, idx_map[l][s]] += H[i, l] * H[j, s]
                A[eq, idx_map[i][j]] -= 1.0
                eq += 1
    _, _, Vt = np.linalg.svd(A)
    w = Vt[-1]
    if w[5] == 0:
        return None
    w = w / w[5]
    W = np.array([[w[0], w[1], w[2]],
                  [w[1], w[3], w[4]],
                  [w[2], w[4], w[5]]], np.float64)
    # W = K K^T with K upper triangular <=> reversed-order Cholesky: flip W,
    # lower-Cholesky, flip back (a plain lower Cholesky yields a LOWER-
    # triangular factor, i.e. a non-physical K — the reference's in-place
    # variant has the same pitfall and returns a wrong K for generic pp)
    J = np.eye(3)[::-1]
    try:
        L = np.linalg.cholesky(J @ W @ J)
    except np.linalg.LinAlgError:
        return None
    K = J @ L @ J   # upper triangular, K K^T = W
    if K[2, 2] <= 0:
        return None
    return K / K[2, 2]
