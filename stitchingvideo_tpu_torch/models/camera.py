"""Camera model as a struct of tensors.

Port of `stitchingvideo_tpu/models/camera.py`: `cv::detail::CameraParams
{focal, aspect, ppx, ppy, R, t}` batched over the camera axis.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass
class Cameras:
    """N pinhole cameras under the rotation-only model.

    focal:  [N]      focal length in px
    aspect: [N]      fy = focal * aspect
    ppx:    [N]      principal point x
    ppy:    [N]      principal point y
    R:      [N,3,3]  rotation (OpenCV stitching convention: ray_pano = R @ K^-1 @ p)
    t:      [N,3]    translation (always 0 in the rotation model; kept for parity)
    """
    focal: torch.Tensor
    aspect: torch.Tensor
    ppx: torch.Tensor
    ppy: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor

    @property
    def n(self) -> int:
        return self.focal.shape[0]

    def K(self) -> torch.Tensor:
        """[N,3,3] intrinsic matrices (camera.cpp:58-66 semantics)."""
        z = torch.zeros_like(self.focal)
        o = torch.ones_like(self.focal)
        return torch.stack([
            torch.stack([self.focal, z, self.ppx], dim=-1),
            torch.stack([z, self.focal * self.aspect, self.ppy], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ], dim=-2)

    def K_inv(self) -> torch.Tensor:
        """[N,3,3] closed-form inverse of K (upper triangular)."""
        f = self.focal
        fy = self.focal * self.aspect
        z = torch.zeros_like(f)
        o = torch.ones_like(f)
        return torch.stack([
            torch.stack([1.0 / f, z, -self.ppx / f], dim=-1),
            torch.stack([z, 1.0 / fy, -self.ppy / fy], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ], dim=-2)

    @classmethod
    def create(cls, focal, ppx, ppy, R=None, aspect=None, t=None,
               device=None) -> "Cameras":
        """device: 'cuda' unless given; with no CUDA present the default
        raises."""
        device = resolve_device(device, "Cameras")

        def f32(x):
            return torch.as_tensor(np.asarray(x, np.float32), device=device)

        focal = f32(focal)
        n = focal.shape[0]
        if aspect is None:
            aspect = np.ones((n,), np.float32)
        if R is None:
            R = np.tile(np.eye(3, dtype=np.float32)[None], (n, 1, 1))
        if t is None:
            t = np.zeros((n, 3), np.float32)
        return cls(focal=focal, aspect=f32(aspect), ppx=f32(ppx),
                   ppy=f32(ppy), R=f32(R), t=f32(t))

    def select(self, idx) -> "Cameras":
        """Subset/reorder cameras by integer index array."""
        idx = torch.as_tensor(idx, dtype=torch.long, device=self.focal.device)
        return Cameras(focal=self.focal[idx], aspect=self.aspect[idx],
                       ppx=self.ppx[idx], ppy=self.ppy[idx],
                       R=self.R[idx], t=self.t[idx])
