"""Rotation-warper projection family: forward and backward maps.

Port of `stitchingvideo_tpu/geometry/projections.py`: the 15 projection
types of the reference's rotation warpers (reference
include/opencv2/stitching/detail/warpers.hpp:122-501, warpers_inl.hpp:
207-765, src/warpers.cpp:50-78), under the Brown-Lowe rotation-camera model.

Conventions:
  setCameraParams: r_kinv = R @ K^-1, k_rinv = K @ R^T   (warpers.cpp:50-78)
  forward:  (x, y) source px -> ray = r_kinv @ (x, y, 1) -> (u, v) = scale * P(ray)
  backward: (u, v) -> ray = P^-1(u/scale, v/scale) -> p = k_rinv @ ray;
            (x, y) = (p.x/p.z, p.y/p.z) if p.z > 0 else (-1, -1)

The curved projections use lon = atan2(x_, z_) (about the vertical +y axis)
and w = y_/|ray| = sin(lat), +lat pointing down (image +y). Every function
is elementwise over the point tensors and broadcasts over a camera axis.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from ..ops.fma import fma

PROJECTION_KINDS = (
    "plane", "cylindrical", "spherical", "fisheye", "stereographic",
    "compressedPlaneA2B1", "compressedPlaneA1.5B1",
    "compressedPlanePortraitA2B1", "compressedPlanePortraitA1.5B1",
    "paniniA2B1", "paniniA1.5B1", "paniniPortraitA2B1", "paniniPortraitA1.5B1",
    "mercator", "transverseMercator",
)

_AB = {
    "compressedPlaneA2B1": (2.0, 1.0),
    "compressedPlaneA1.5B1": (1.5, 1.0),
    "compressedPlanePortraitA2B1": (2.0, 1.0),
    "compressedPlanePortraitA1.5B1": (1.5, 1.0),
    "paniniA2B1": (2.0, 1.0),
    "paniniA1.5B1": (1.5, 1.0),
    "paniniPortraitA2B1": (2.0, 1.0),
    "paniniPortraitA1.5B1": (1.5, 1.0),
}

_EPS = 1e-12


def _guard(x: torch.Tensor, eps: float = _EPS) -> torch.Tensor:
    """x with |x| < eps replaced by eps (a safe divisor)."""
    return torch.where(x.abs() < eps, torch.full_like(x, eps), x)


def camera_maps(K: torch.Tensor, R: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(r_kinv, k_rinv) for one or a batch of cameras.

    K: [...,3,3], R: [...,3,3] -> r_kinv = R @ K^-1, k_rinv = K @ R^T.
    """
    K = torch.as_tensor(K, dtype=torch.float32)
    R = torch.as_tensor(R, dtype=torch.float32, device=K.device)
    r_kinv = R @ torch.linalg.inv(K)
    k_rinv = K @ R.transpose(-1, -2)
    return r_kinv, k_rinv


def _apply33(M: torch.Tensor, x, y, z):
    """Apply a 3x3 to homogeneous coords; broadcasts over the point shape."""
    def row(r):     # rounded as XLA contracts it
        return fma(M[..., r, 2], z, fma(M[..., r, 0], x, M[..., r, 1] * y))

    return row(0), row(1), row(2)


def _lonw(x_, y_, z_):
    lon = torch.atan2(x_, z_)
    norm = torch.sqrt(x_ * x_ + y_ * y_ + z_ * z_)
    w = torch.clamp(y_ / torch.clamp(norm, min=_EPS), -1.0, 1.0)
    return lon, w


def _base(kind: str) -> str:
    return "compressedPlane" if kind.startswith("compressedPlane") \
        else "panini"


# -- per kind: ray -> (u, v) in unscaled units, and (u, v) -> ray -----------

def _fwd(kind: str, x_, y_, z_):
    if kind == "plane":
        zz = _guard(z_)
        return x_ / zz, y_ / zz
    lon, w = _lonw(x_, y_, z_)
    if kind == "spherical":
        return lon, math.pi - torch.arccos(w)
    if kind == "cylindrical":
        rh = torch.sqrt(torch.clamp(x_ * x_ + z_ * z_, min=_EPS))
        return lon, y_ / rh
    if kind == "fisheye":
        r = math.pi - torch.arccos(w)
        return r * torch.cos(lon), r * torch.sin(lon)
    if kind == "stereographic":
        theta = torch.arccos(w)          # angle from the +y axis
        r = torch.tan(theta * 0.5)
        return r * torch.cos(lon), r * torch.sin(lon)
    if kind == "mercator":
        wc = torch.clamp(w, -1.0 + 1e-7, 1.0 - 1e-7)
        return lon, torch.arctanh(wc)
    if kind == "transverseMercator":
        lat = torch.arcsin(w)
        B = torch.clamp(torch.cos(lat) * torch.sin(lon), -1.0 + 1e-7,
                        1.0 - 1e-7)
        return torch.arctanh(B), torch.atan2(torch.tan(lat), torch.cos(lon))
    if kind.startswith("compressedPlanePortrait") \
            or kind.startswith("paniniPortrait"):
        # portrait: axes swapped, then u negated
        a, b = _AB[kind]
        U, V = _fwd_ab(_base(kind), a, b, y_, x_, z_)
        return -U, V
    if kind.startswith("compressedPlane") or kind.startswith("panini"):
        a, b = _AB[kind]
        return _fwd_ab(_base(kind), a, b, x_, y_, z_)
    raise ValueError(f"unknown projection kind: {kind}")


def _fwd_ab(base: str, a: float, b: float, x_, y_, z_):
    lon, w = _lonw(x_, y_, z_)
    lat = torch.arcsin(w)
    if base == "compressedPlane":
        u = a * torch.tan(lon / a)
        v = b * torch.tan(lat / b) / torch.cos(lon)
        return u, v
    tg = a * torch.tan(lon / a)
    sinu = torch.sin(lon)
    small = sinu.abs() < 1e-7
    # tg / sin(lon) -> 1 as lon -> 0
    one = torch.ones_like(sinu)
    ratio = torch.where(small, one, tg / torch.where(small, one, sinu))
    v = b * torch.tan(lat / b) * ratio
    return tg, v


def _bwd(kind: str, u, v):
    """(u, v) unscaled -> ray (x_, y_, z_), not necessarily of unit length."""
    if kind == "plane":
        return u, v, torch.ones_like(u)
    if kind == "spherical":
        sinv = torch.sin(math.pi - v)
        return sinv * torch.sin(u), torch.cos(math.pi - v), \
            sinv * torch.cos(u)
    if kind == "cylindrical":
        return torch.sin(u), v, torch.cos(u)
    if kind == "fisheye":
        r = torch.sqrt(u * u + v * v)
        lon = torch.atan2(v, u)
        theta = math.pi - r           # forward: r = pi - theta
        st = torch.sin(theta)
        return st * torch.sin(lon), torch.cos(theta), st * torch.cos(lon)
    if kind == "stereographic":
        r = torch.sqrt(u * u + v * v)
        lon = torch.atan2(v, u)
        theta = 2.0 * torch.arctan(r)
        st = torch.sin(theta)
        return st * torch.sin(lon), torch.cos(theta), st * torch.cos(lon)
    if kind == "mercator":
        lat = torch.arcsin(torch.tanh(v))
        return _ray_lonlat(u, lat)
    if kind == "transverseMercator":
        lon = torch.atan2(torch.sinh(u), torch.cos(v))
        lat = torch.arcsin(torch.clamp(torch.sin(v) / torch.cosh(u),
                                       -1.0, 1.0))
        return _ray_lonlat(lon, lat)
    if kind.startswith("compressedPlanePortrait") \
            or kind.startswith("paniniPortrait"):
        a, b = _AB[kind]
        y_, x_, z_ = _bwd_ab(_base(kind), a, b, -u, v)
        return x_, y_, z_
    if kind.startswith("compressedPlane") or kind.startswith("panini"):
        a, b = _AB[kind]
        return _bwd_ab(_base(kind), a, b, u, v)
    raise ValueError(f"unknown projection kind: {kind}")


def _ray_lonlat(lon, lat):
    cl = torch.cos(lat)
    return cl * torch.sin(lon), torch.sin(lat), cl * torch.cos(lon)


def _bwd_ab(base: str, a: float, b: float, u, v):
    lon = a * torch.arctan(u / a)
    if base == "compressedPlane":
        lat = b * torch.arctan(v * torch.cos(lon) / b)
        return _ray_lonlat(lon, lat)
    sinu = torch.sin(lon)
    small = sinu.abs() < 1e-7
    one = torch.ones_like(sinu)
    ratio = torch.where(small, one, torch.where(small, one, sinu) / _guard(u))
    lat = b * torch.arctan(v * ratio / b)
    return _ray_lonlat(lon, lat)


# -- public API --------------------------------------------------------------

def map_forward(kind: str, scale, r_kinv: torch.Tensor, x, y, t=None):
    """Source pixel (x, y) -> panorama plane (u, v).

    Parity: RotationWarperBase<P>::warpPoint / P::mapForward
    (reference warpers_inl.hpp:63-99, :207-300).
    """
    x = torch.as_tensor(x, dtype=torch.float32, device=r_kinv.device)
    y = torch.as_tensor(y, dtype=torch.float32, device=r_kinv.device)
    x_, y_, z_ = _apply33(r_kinv, x, y, torch.ones_like(x))
    if kind == "plane" and t is not None:
        zz = _guard(z_)
        u = t[0] + x_ / zz * (1 - t[2])
        v = t[1] + y_ / zz * (1 - t[2])
        return scale * u, scale * v
    u, v = _fwd(kind, x_, y_, z_)
    return scale * u, scale * v


def map_backward(kind: str, scale, k_rinv: torch.Tensor, u, v, t=None):
    """Panorama (u, v) -> source pixel (x, y); behind the camera -> (-1, -1).

    Parity: P::mapBackward (reference warpers_inl.hpp:222-300).
    """
    u = torch.as_tensor(u, dtype=torch.float32, device=k_rinv.device) / scale
    v = torch.as_tensor(v, dtype=torch.float32, device=k_rinv.device) / scale
    if kind == "plane" and t is not None:
        u = (u - t[0]) / (1 - t[2])
        v = (v - t[1]) / (1 - t[2])
    x_, y_, z_ = _bwd(kind, u, v)
    px, py, pz = _apply33(k_rinv, x_, y_, z_)
    valid = pz > 0
    pz_safe = _guard(pz)
    minus1 = torch.full_like(px, -1.0)
    x = torch.where(valid, px / pz_safe, minus1)
    y = torch.where(valid, py / pz_safe, minus1)
    return x, y, valid


def uv_range(kind: str) -> Tuple[Tuple[float, float], Tuple[float, float]]:
    """Natural (unscaled) (u, v) bounds of the projection where bounded.

    Used by ROI detection for pole handling (spherical v in [0, pi]).
    """
    if kind == "spherical":
        return (-math.pi, math.pi), (0.0, math.pi)
    if kind in ("cylindrical", "mercator"):
        return (-math.pi, math.pi), (-math.inf, math.inf)
    return (-math.inf, math.inf), (-math.inf, math.inf)
