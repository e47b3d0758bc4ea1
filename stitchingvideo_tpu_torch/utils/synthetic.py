"""Synthetic multi-camera scenes with known ground truth.

Port of `stitchingvideo_tpu/utils/synthetic.py`: N camera views of a
procedural panoramic texture rendered through the spherical camera model the
stitcher assumes, giving exact ground-truth focals and rotations. The
texture and the rig are numpy (the same code as the reference's, so the
same seed gives the same arrays); the views are rendered on the device by
the port's projections and remap.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..geometry import projections as proj
from ..ops.remap import remap


def panorama_texture(rng: np.random.Generator, h: int = 768, w: int = 2048,
                     blobs: int = 3000) -> np.ndarray:
    """Corner-rich colorful blob texture, wrap-continuous in x. [h, w, 3] uint8."""
    img = np.zeros((h, w, 3), np.float32)
    img += rng.uniform(30, 90, size=(1, 1, 3))
    yy = np.arange(h)[:, None]
    img[..., 0] += 40 * np.sin(yy / 37.0)
    img[..., 2] += 40 * np.cos(yy / 53.0)
    ys = rng.integers(0, h, blobs)
    xs = rng.integers(0, w, blobs)
    ss = rng.integers(3, 22, blobs)
    cs = rng.uniform(0, 255, (blobs, 3))
    for y, x, s, c in zip(ys, xs, ss, cs):
        y0, y1 = max(0, y - s), min(h, y + s)
        for xo in (x, x - w, x + w):  # wrap in x
            x0, x1 = max(0, xo - s), min(w, xo + s)
            if x0 < x1:
                img[y0:y1, x0:x1] = 0.35 * img[y0:y1, x0:x1] + 0.65 * c
    return np.clip(img, 0, 255).astype(np.uint8)


def yaw_cameras(n: int, fov_deg: float = 55.0, img_wh: Tuple[int, int] = (640, 480),
                overlap_frac: float = 0.35, tilt: float = 0.0,
                jitter: float = 0.0, seed: int = 0):
    """Ground-truth rig: n cameras spread in yaw with given overlap.

    Returns (K [3,3], Rs [n,3,3], focal).
    """
    w, h = img_wh
    f = 0.5 * w / np.tan(np.radians(fov_deg) / 2)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    step = np.radians(fov_deg) * (1 - overlap_frac)
    rng = np.random.default_rng(seed)
    Rs = []
    for i in range(n):
        yaw = (i - (n - 1) / 2) * step
        cy, sy = np.cos(yaw), np.sin(yaw)
        Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]], np.float64)
        ct, st = np.cos(tilt), np.sin(tilt)
        Rx = np.array([[1, 0, 0], [0, ct, -st], [0, st, ct]], np.float64)
        R = Rx @ Ry
        if jitter > 0:
            from scipy.spatial.transform import Rotation
            R = R @ Rotation.from_rotvec(rng.normal(0, jitter, 3)).as_matrix()
        Rs.append(R.astype(np.float32))
    return K, np.stack(Rs), float(f)


def render_views(texture: np.ndarray, K: np.ndarray, Rs: np.ndarray,
                 img_wh: Tuple[int, int], scale: float | None = None,
                 device=None) -> List[np.ndarray]:
    """Render each camera view by forward-projecting view pixels into the
    spherical texture (u in [-pi, pi] -> [0, W), v in [0, pi] -> [0, H)).
    Runs on `device` (CUDA unless given; with no CUDA present the default
    raises) and returns host uint8 [h, w, 3] views."""
    device = resolve_device(device, "render_views")
    th, tw = texture.shape[:2]
    w, h = img_wh
    if scale is None:
        scale = 1.0
    tex = torch.from_numpy(np.ascontiguousarray(texture)).to(device)
    gy, gx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=device),
                            torch.arange(w, dtype=torch.float32, device=device),
                            indexing="ij")
    views = []
    for R in Rs:
        r_kinv, _ = proj.camera_maps(torch.as_tensor(K, device=device),
                                     torch.as_tensor(R, device=device))
        u, v = proj.map_forward("spherical", scale, r_kinv, gx, gy)
        tx = (u + np.pi) / (2 * np.pi) * tw
        ty = v / np.pi * th
        views.append(remap(tex, tx, ty, interp="linear", border="wrap")
                     .cpu().numpy())
    return views


def make_scene(n: int = 4, img_wh: Tuple[int, int] = (640, 480),
               fov_deg: float = 55.0, overlap_frac: float = 0.35,
               tilt: float = 0.0, seed: int = 0, device=None):
    """Convenience: (views, K, Rs, focal, texture)."""
    rng = np.random.default_rng(seed)
    tex = panorama_texture(rng)
    K, Rs, f = yaw_cameras(n, fov_deg, img_wh, overlap_frac, tilt=tilt, seed=seed)
    views = render_views(tex, K, Rs, img_wh, device=device)
    return views, K, Rs, f, tex
