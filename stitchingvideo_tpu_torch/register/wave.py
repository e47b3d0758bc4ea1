"""Wave correction: global up-vector fix for the camera set.

Parity target: cv::detail::waveCorrect (reference src/motion_estimators.cpp:
586-664): eigen-decompose the second moment of the camera x-axes, rebuild a
global rotation so the horizon is level. Validated against cv2.detail.waveCorrect
(tests/test_register.py). Host-side: N tiny 3x3 ops.

A copy of `stitchingvideo_tpu/register/wave.py`: numpy host code in both packages.
"""
from __future__ import annotations

import numpy as np


def wave_correct(Rs: np.ndarray, kind: str = "horiz") -> np.ndarray:
    """Rs: [N,3,3] -> corrected [N,3,3] (R := Rg @ R)."""
    Rs = np.asarray(Rs, np.float64)
    if Rs.shape[0] == 0:
        return Rs.astype(np.float32)
    cols0 = Rs[:, :, 0]                       # camera x-axes in pano frame
    moment = cols0.T @ cols0                  # sum of outer products
    vals, vecs = np.linalg.eigh(moment)       # ascending eigenvalues
    if kind == "horiz":
        rg1 = vecs[:, 0]                      # smallest eigenvalue
    elif kind == "vert":
        rg1 = vecs[:, 2]                      # largest eigenvalue
    else:
        raise ValueError(f"unknown wave-correct kind {kind}")

    img_k = Rs[:, :, 2].sum(axis=0)           # sum of camera z-axes
    rg0 = np.cross(rg1, img_k)
    n = np.linalg.norm(rg0)
    if n < 1e-12:
        return Rs.astype(np.float32)
    rg0 /= n
    rg2 = np.cross(rg0, rg1)

    if kind == "horiz":
        conf = float((cols0 @ rg0).sum())
    else:
        conf = -float((cols0 @ rg1).sum())
    if conf < 0:
        rg0, rg1 = -rg0, -rg1

    Rg = np.stack([rg0, rg1, rg2], axis=0)    # rows
    out = np.einsum("ab,nbc->nac", Rg, Rs)
    return out.astype(np.float32)
