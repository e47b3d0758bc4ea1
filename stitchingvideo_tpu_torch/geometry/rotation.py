"""Rotation utilities: Rodrigues vector <-> matrix, branch-free.

Port of `stitchingvideo_tpu/geometry/rotation.py` (the reference's uses of
`cv::Rodrigues`, src/motion_estimators.cpp:445-581). The small-angle and
near-pi branches are `torch.where` masks, not host `if`s on values, so the
functions batch, run on the device without a sync and differentiate under
`torch.func`.
"""
from __future__ import annotations

import math

import torch


def _skew(x, y, z) -> torch.Tensor:
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], dim=-1),
        torch.stack([z, zero, -x], dim=-1),
        torch.stack([-y, x, zero], dim=-1),
    ], dim=-2)


def rodrigues_to_matrix(rvec: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrix [..., 3, 3]."""
    theta = torch.linalg.vector_norm(rvec, dim=-1, keepdim=True)   # [..., 1]
    small = theta[..., 0] < 1e-8
    axis = rvec / torch.where(theta < 1e-8, torch.ones_like(theta), theta)
    K = _skew(axis[..., 0], axis[..., 1], axis[..., 2])
    th = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    R = eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * (K @ K)
    # small angle: R ~ I + skew(rvec)
    Ksmall = _skew(rvec[..., 0], rvec[..., 1], rvec[..., 2])
    return torch.where(small[..., None, None], eye + Ksmall, R)


def matrix_to_rodrigues(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] -> axis-angle [..., 3]."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    # antisymmetric part = 2 sin(theta) * axis
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                     R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    sin_theta = torch.sin(theta)
    generic = v * (theta / torch.where(sin_theta.abs() < 1e-7,
                                       torch.ones_like(sin_theta),
                                       2.0 * sin_theta))[..., None]
    small = theta < 1e-6
    near_pi = theta > math.pi - 1e-3
    # near pi: the axis from the diagonal of (R + I) / 2 = a a^T
    A = (R + torch.eye(3, dtype=R.dtype, device=R.device)) * 0.5
    diag = torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), 0.0, 1.0)
    axis_abs = torch.sqrt(diag)
    # signs from the row of the largest component, which is made positive
    k = torch.argmax(axis_abs, dim=-1, keepdim=True)               # [..., 1]
    row = torch.take_along_dim(A, k[..., None].expand(*k.shape[:-1], 1, 3),
                               dim=-2)[..., 0, :]
    sgn = torch.sign(torch.where(row.abs() < 1e-12,
                                 torch.full_like(row, 1e-12), row))
    axis_pi = axis_abs * sgn * torch.take_along_dim(sgn, k, dim=-1)
    axis_pi = axis_pi / torch.clamp(
        torch.linalg.vector_norm(axis_pi, dim=-1, keepdim=True), min=1e-12)
    return torch.where(small[..., None], v * 0.5,
                       torch.where(near_pi[..., None],
                                   axis_pi * theta[..., None], generic))
