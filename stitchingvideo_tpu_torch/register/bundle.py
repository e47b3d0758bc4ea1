"""Bundle adjustment (Ray and Reproj cost models) as a fixed-iteration LM.

Port of `stitchingvideo_tpu/register/bundle.py` (BundleAdjusterBase/Ray/
Reproj, reference src/motion_estimators.cpp:172-581). Forward-mode Jacobians
(`torch.func.jacfwd`), a fixed iteration count, and accept/reject as
`torch.where` on the device: the loop never reads a value on the host.
The normal equations are formed at full float32 precision (float64
accumulation: TF32 cannot touch them).

Cost models:
  ray    (4 params/cam: f, rvec) — unit-ray distance scaled by sqrt(f_i f_j)
         (motion_estimators.cpp:445-581, the RT drivers' default)
  reproj (7 params/cam: f, ppx, ppy, aspect, rvec) — 2D reprojection error
         (motion_estimators.cpp:264-440)

Edge data is fixed-capacity: E edges x M correspondences with 0/1 weights.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.func import jacfwd

from ..geometry.rotation import matrix_to_rodrigues, rodrigues_to_matrix
from ..ops.homography import matmul_highest


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched small matrix product as elementwise products and a sum (no
    library GEMM, so no TF32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _apply(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """R [E, 3, 3] applied to vectors v [E, M, 3] -> [E, M, 3]."""
    return (v[..., None, :] * R[:, None, :, :]).sum(-1)


def _rays(f, R, pts):
    """Unit rays R @ K^-1 p of centred points pts [E, M, 2]; f [E]."""
    x = pts[..., 0] / f[:, None]
    y = pts[..., 1] / f[:, None]
    v = _apply(R, torch.stack([x, y, torch.ones_like(x)], -1))
    n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(n, min=1e-12)


def _residual_ray(params, edge_i, edge_j, pts1, pts2, w):
    """params [N,4] (f, rvec). Returns flattened residuals [E*M*3]."""
    f = params[:, 0]
    R = rodrigues_to_matrix(params[:, 1:4])
    fi, fj = f[edge_i], f[edge_j]
    r1 = _rays(fi, R[edge_i], pts1)
    r2 = _rays(fj, R[edge_j], pts2)
    mult = torch.sqrt(torch.clamp(fi * fj, min=1e-6))[:, None, None]
    return ((mult * (r1 - r2)) * w[..., None]).reshape(-1)


def _K(f, ppx, ppy, fy):
    zero, one = torch.zeros_like(f), torch.ones_like(f)
    return torch.stack([torch.stack([f, zero, ppx], -1),
                        torch.stack([zero, fy, ppy], -1),
                        torch.stack([zero, zero, one], -1)], -2)


def _residual_reproj(params, edge_i, edge_j, pts1, pts2, w):
    """params [N,7] (f, ppx, ppy, aspect, rvec). Residuals [E*M*2]."""
    f, ppx, ppy, asp = params[:, 0], params[:, 1], params[:, 2], params[:, 3]
    R = rodrigues_to_matrix(params[:, 4:7])
    fy = f * asp
    K = _K(f, ppx, ppy, fy)
    Kinv = _K(1.0 / f, -ppx / f, -ppy / fy, 1.0 / fy)
    H = _mm(_mm(_mm(K[edge_j], R[edge_j]), R[edge_i].transpose(-1, -2)),
            Kinv[edge_i])                                       # i -> j
    q = _apply(H, torch.cat([pts1, torch.ones_like(pts1[..., :1])], -1))
    z = q[..., 2:3]
    z = torch.where(z.abs() < 1e-12, torch.full_like(z, 1e-12), z)
    return ((q[..., :2] / z - pts2) * w[..., None]).reshape(-1)


def bundle_adjust(focals0: torch.Tensor, Rs0: torch.Tensor,
                  edge_i: torch.Tensor, edge_j: torch.Tensor,
                  pts1: torch.Tensor, pts2: torch.Tensor, w: torch.Tensor,
                  kind: str = "ray", iters: int = 50,
                  refine_focal: bool = True,
                  refine_ppx: bool = False,
                  refine_ppy: bool = False,
                  refine_aspect: bool = False
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """LM bundle adjustment, on the device of its inputs.

    Returns (focals [N], Rs [N,3,3], pp_aspect [N,3] = (ppx, ppy, aspect),
    final_cost). pts1/pts2: [E, M, 2] centred keypoint coords of each
    edge's correspondences; w: [E, M] 0/1 inlier weights.

    The refinement flags mirror the reference's 5-char ba_refine_mask
    gating of Jacobian columns (motion_estimators.cpp:389-438: (0,0)=fx,
    (0,2)=ppx, (1,2)=ppy, (1,1)=aspect; rotations always refined). Skew is
    read by neither adjuster; the Ray model honours only fx
    (motion_estimators.cpp:509-513).
    """
    n = focals0.shape[0]
    dev = focals0.device
    rvecs0 = matrix_to_rodrigues(Rs0)
    if kind == "ray":
        x0 = torch.cat([focals0[:, None], rvecs0], dim=1)          # [N,4]
        residual = _residual_ray
        free = [refine_focal, True, True, True]
    elif kind == "reproj":
        zeros = torch.zeros((n, 1), device=dev)
        ones = torch.ones((n, 1), device=dev)
        x0 = torch.cat([focals0[:, None], zeros, zeros, ones, rvecs0], dim=1)
        residual = _residual_reproj
        free = [refine_focal, refine_ppx, refine_ppy, refine_aspect,
                True, True, True]
    else:
        raise ValueError(kind)

    shape = x0.shape
    mask = torch.tensor(free, dtype=torch.float32, device=dev) \
        .expand(shape).reshape(-1)

    def res_flat(xf):
        r = residual(xf.reshape(shape), edge_i, edge_j, pts1, pts2, w)
        return r, r

    x = x0.reshape(-1)
    r0, _ = res_flat(x)
    cost = (r0 * r0).sum()
    lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
    eye = torch.eye(x.shape[0], dtype=torch.float32, device=dev)
    for _ in range(iters):
        J, r = jacfwd(res_flat, has_aux=True)(x)                   # [R, P]
        J = J * mask[None, :]
        JtJ = matmul_highest(J.T, J)
        Jtr = matmul_highest(J.T, r[:, None])[:, 0]
        d = torch.diagonal(JtJ)
        A = JtJ + lam * torch.diag(torch.clamp(d, min=1e-8)) + 1e-8 * eye
        delta, _info = torch.linalg.solve_ex(A, -Jtr)
        x_new = x + delta * mask
        r_new, _ = res_flat(x_new)
        cost_new = (r_new * r_new).sum()
        accept = cost_new < cost
        x = torch.where(accept, x_new, x)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-7),
                          torch.clamp(lam * 4.0, max=1e7))
        cost = torch.where(accept, cost_new, cost)
    xp = x.reshape(shape)
    if kind == "ray":
        Rs = rodrigues_to_matrix(xp[:, 1:4])
        pp_aspect = torch.cat([torch.zeros((n, 2), device=dev),
                               torch.ones((n, 1), device=dev)], dim=1)
    else:
        Rs = rodrigues_to_matrix(xp[:, 4:7])
        pp_aspect = xp[:, 1:4]            # (ppx, ppy, aspect), centred pp
    return xp[:, 0], Rs, pp_aspect, cost
