"""Registration state: everything the per-frame compose path needs.

Port of `stitchingvideo_tpu/models/registration.py`. `from_state_dict` is the
carry-across function: it takes the numpy dict that the JAX package writes
(`Registration.save`, `VideoStitcher.save_registration`) and returns the
port's state, as tensors on a given device. `state_dict` gives the same
numpy dict back, so a state can travel either way. Like every entry point
of the port, `from_state_dict` and `load` place the state on `cuda` unless
the caller passes `device="cpu"`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .camera import Cameras

_CAMERA_KEYS = ("focal", "aspect", "ppx", "ppy", "R", "t")
_ARRAY_KEYS = ("corners", "valid", "xmaps", "ymaps", "seam_masks", "gain_maps")


@dataclasses.dataclass
class Registration:
    """Cached registration output at compose scale.

    cameras:     Cameras (compose scale intrinsics)
    corners:     [N, 2] int32 canvas-space (x, y) of each warp ROI top-left
    valid:       [N, Hr, Wr] bool  warp footprint (padded ROI)
    xmaps/ymaps: [N, Hr, Wr] float32 backward maps: ROI pixel -> source pixel
    seam_masks:  [N, Hr, Wr] bool  seam ownership on the ROI grid
    gain_maps:   [N, Hr, Wr] float32 per-pixel exposure gain on the ROI grid
    canvas_wh:   (W, H) panorama canvas size (bucketed to 64 px)
    extent_wh:   (W, H) true covered extent before bucketing; None means
                 "unknown — treat canvas_wh as covered"
    roi_hw:      (Hr, Wr) padded per-camera ROI shape
    warp_kind / warp_scale: projection metadata
    src_indices: indices into the original rig frame list of the cameras
                 this registration kept; None means all, in order
    """
    cameras: Cameras
    corners: torch.Tensor
    valid: torch.Tensor
    xmaps: torch.Tensor
    ymaps: torch.Tensor
    seam_masks: torch.Tensor
    gain_maps: torch.Tensor
    canvas_wh: Tuple[int, int]
    roi_hw: Tuple[int, int]
    warp_kind: str
    warp_scale: float
    extent_wh: Optional[Tuple[int, int]] = None
    src_indices: Optional[Tuple[int, ...]] = None

    @property
    def n_cameras(self) -> int:
        return self.xmaps.shape[0]

    @property
    def device(self) -> torch.device:
        return self.xmaps.device

    def state_dict(self) -> dict:
        """numpy snapshot, key for key and dtype for dtype the JAX package's."""
        d = {k: getattr(self.cameras, k).cpu().numpy() for k in _CAMERA_KEYS}
        d.update({k: getattr(self, k).cpu().numpy() for k in _ARRAY_KEYS})
        d.update(
            canvas_wh=np.asarray(self.canvas_wh),
            extent_wh=np.asarray(self.extent_wh if self.extent_wh is not None
                                 else self.canvas_wh),
            roi_hw=np.asarray(self.roi_hw),
            warp_kind=np.asarray(self.warp_kind),
            warp_scale=np.asarray(self.warp_scale),
            src_indices=np.asarray(self.src_indices
                                   if self.src_indices is not None
                                   else np.arange(self.n_cameras)))
        return d

    @classmethod
    def from_state_dict(cls, d: dict, device=None) -> "Registration":
        """device: 'cuda' unless given; with no CUDA present the default
        raises (there is no silent CPU fallback)."""
        device = resolve_device(device, "Registration")

        def t(k):
            return torch.as_tensor(np.asarray(d[k]), device=device)

        def ints(k):
            return tuple(int(x) for x in np.asarray(d[k]))

        return cls(cameras=Cameras(**{k: t(k) for k in _CAMERA_KEYS}),
                   **{k: t(k) for k in _ARRAY_KEYS},
                   canvas_wh=ints("canvas_wh"),
                   extent_wh=ints("extent_wh") if "extent_wh" in d else None,
                   roi_hw=ints("roi_hw"),
                   warp_kind=str(np.asarray(d["warp_kind"])),
                   warp_scale=float(np.asarray(d["warp_scale"])),
                   src_indices=(ints("src_indices") if "src_indices" in d
                                else None))

    @classmethod
    def load(cls, path: str, device=None) -> "Registration":
        with np.load(path, allow_pickle=False) as z:
            return cls.from_state_dict({k: z[k] for k in z.files}, device)
