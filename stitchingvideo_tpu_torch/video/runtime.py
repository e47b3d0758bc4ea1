"""Video runtime: the serving subset of the cached-registration compositor.

Port of `stitchingvideo_tpu/video/runtime.py` for the seam-select hot loop
(`compose_mode='lut'`): load or install a registration, then composite one
frame set or a micro-batch through the mat2 kernel. The LUT swap is an
atomic reference assignment under a lock, and the output canvas is frozen
to the first registration's shape.

Registration itself (`register`, `run` with its re-registration thread), the
feather and multiband modes, the `mat`/`tiled` kernels and canvas sharding
are later slices of the port (ROADMAP.md, queue 1) and raise
`NotImplementedError` here.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..config import StitchConfig
from ..device import resolve_device
from ..models.registration import Registration
from ..ops.composite_mat import frames_to_planar_i8, planar_to_hwc
from ..ops.composite_mat2 import (build_mat2_lut, composite_mat2_planar,
                                  composite_mat2_planar_batched)
from .lut import CompositeLUT, build_lut, composite_frame_u8

_ROADMAP = "ROADMAP.md, queue 1"


def _fit2d(a: torch.Tensor, fill, shape) -> torch.Tensor:
    """Pad/crop a 2-D tensor to `shape` (the frozen-output fit primitive)."""
    H, W = shape
    h, w = a.shape
    out = torch.full((H, W), fill, dtype=a.dtype, device=a.device)
    out[:min(h, H), :min(w, W)] = a[:min(h, H), :min(w, W)]
    return out


@dataclass
class FrameStats:
    """Per-frame timing log (reference 'Stitching Frame'/'Read Frame' parity,
    32-bit driver :864-893)."""
    read_s: List[float] = field(default_factory=list)
    compose_s: List[float] = field(default_factory=list)
    frames: int = 0

    def fps(self, last: int = 50) -> float:
        if not self.compose_s:
            return 0.0
        w = self.compose_s[-last:]
        return len(w) / max(sum(w), 1e-9)

    def report(self) -> dict:
        """Machine-readable per-frame stats as JSON-ready dict."""
        def stats(xs):
            if not xs:
                return {}
            a = np.asarray(xs)
            return {"mean_ms": float(a.mean() * 1e3),
                    "p50_ms": float(np.median(a) * 1e3),
                    "p95_ms": float(np.percentile(a, 95) * 1e3),
                    "max_ms": float(a.max() * 1e3)}

        return {"frames": self.frames, "fps": self.fps(),
                "compose": stats(self.compose_s), "read": stats(self.read_s)}


class VideoStitcher:
    """Seam-select hot loop on one device.

    device: 'cuda' unless given; with no CUDA present the default raises
    (there is no silent CPU fallback). `device="cpu"` runs the kernels'
    plain PyTorch versions."""

    def __init__(self, config: Optional[StitchConfig] = None, device=None):
        cfg = config or StitchConfig()
        v = cfg.video
        if v.compose_mode != "lut":
            raise NotImplementedError(
                f"compose_mode={v.compose_mode!r} is slice 3 of the port "
                f"({_ROADMAP}, items 16-17); only 'lut' is ported")
        if v.kernel not in ("auto", "mat2", "gather"):
            raise NotImplementedError(
                f"kernel={v.kernel!r} is not ported yet ({_ROADMAP} item 6 "
                "and queue 2, K5/K6); use 'auto', 'mat2' or 'gather'")
        if cfg.parallel.canvas_shards > 1:
            raise NotImplementedError(
                "canvas_shards > 1 is slice 4 of the port "
                f"({_ROADMAP}, item 22)")
        self.device = resolve_device(device, "VideoStitcher")
        self.cfg = cfg
        self._lock = threading.Lock()
        self._lut: Optional[CompositeLUT] = None
        self._tlut = None                  # ("mat2", MatLUT2) or None
        self._reg: Optional[Registration] = None
        self._out_shape: Optional[tuple] = None
        self._frame_hw: Optional[tuple] = None
        self.stats = FrameStats()
        self.registrations = 0

    # -- slow path -----------------------------------------------------
    def register(self, frames, seed: int = 0) -> None:
        raise NotImplementedError(
            "registration is slice 2 of the port "
            f"({_ROADMAP}, items 9-15): load a registration the JAX package "
            "saved (load_registration) or install a LUT (install_lut)")

    def run(self, *args, **kwargs):
        raise NotImplementedError(
            "the streaming loop with re-registration is slice 2 of the port "
            f"({_ROADMAP}, item 15)")

    def install_lut(self, lut: CompositeLUT, frame_hw,
                    reg: Optional[Registration] = None) -> None:
        """Atomically swap in a composite LUT (the double-buffered UpdateMat
        step, 64-bit driver :696-722); the entry point for loaded state.
        With kernel 'auto' or 'mat2' it builds the mat2 state or raises,
        and then the previous state stays live."""
        lut = lut.to(self.device)
        frame_hw = tuple(int(x) for x in frame_hw)
        with self._lock:
            out_shape = self._out_shape or lut.shape
            if lut.shape != out_shape:
                lut = self._fit_lut(lut, out_shape)
            tlut = (None if self.cfg.video.kernel == "gather"
                    else ("mat2", build_mat2_lut(lut, frame_hw)))
            self._out_shape = out_shape
            if reg is not None:
                self._reg = reg
            self._frame_hw = frame_hw
            self._lut, self._tlut = lut, tlut
            self.registrations += 1

    def load_registration(self, path: str) -> None:
        """Load a registration `.npz` that the JAX package's
        `VideoStitcher.save_registration` wrote, and swap it in through
        install_lut."""
        with np.load(path, allow_pickle=False) as z:
            d = {k: z[k] for k in z.files}
        fhw = tuple(int(x) for x in d.pop("frame_hw"))
        reg = Registration.from_state_dict(d, self.device)
        CW, CH = reg.canvas_wh
        lut = build_lut(reg, crop=self._crop_slices((CH, CW), reg.extent_wh))
        self.install_lut(lut, fhw, reg=reg)

    def _crop_slices(self, shape, extent_wh=None):
        """Reference crop margins (64-bit driver :47): 10% top/bottom, 10 px
        left/right of the true covered extent. Returns (y0, y1, x0, x1)."""
        v = self.cfg.video
        H, W = shape
        if extent_wh is not None:
            eW, eH = extent_wh
            W, H = min(int(eW), W), min(int(eH), H)
        y0 = int(H * v.crop_top_frac)
        y1 = H - int(H * v.crop_bottom_frac)
        x0 = v.crop_left_px
        x1 = W - v.crop_right_px
        if y1 <= y0 or x1 <= x0:
            return 0, H, 0, W
        return y0, y1, x0, x1

    @staticmethod
    def _fit_lut(lut: CompositeLUT, shape) -> CompositeLUT:
        """Pad/crop a new LUT to the frozen output shape."""
        return CompositeLUT(cam_idx=_fit2d(lut.cam_idx, -1, shape),
                            src_x=_fit2d(lut.src_x, 0.0, shape),
                            src_y=_fit2d(lut.src_y, 0.0, shape),
                            gain=_fit2d(lut.gain, 1.0, shape))

    def _fit_frame(self, pano: np.ndarray) -> np.ndarray:
        """Pad/crop a composed HWC frame to the frozen output shape."""
        with self._lock:
            out_shape = self._out_shape
        if out_shape is None:
            return pano
        H, W = out_shape
        h, w = pano.shape[:2]
        if (h, w) == (H, W):
            return pano
        out = np.zeros((H, W) + pano.shape[2:], pano.dtype)
        out[:min(h, H), :min(w, W)] = pano[:min(h, H), :min(w, W)]
        return out

    def _select_frames(self, frames: List[np.ndarray],
                       reg: Optional[Registration] = None) -> List[np.ndarray]:
        """Select the registration's kept cameras from the full rig frame
        list (leaveBiggestComponent parity, matchers.cpp:552-573); only when
        the rig size differs from the registration's camera count."""
        if reg is None:
            with self._lock:
                reg = self._reg
        if reg is None:
            return frames
        idx = reg.src_indices
        if idx is None or len(frames) == reg.n_cameras:
            return frames
        if max(idx) >= len(frames):
            raise ValueError(
                f"registration expects rig camera indices {idx} but only "
                f"{len(frames)} frames were provided")
        return [frames[i] for i in idx]

    # -- hot path ------------------------------------------------------
    def composite(self, frames: List[np.ndarray]) -> np.ndarray:
        """One frame set through the cached registration: a list of HWC
        uint8 frames -> HWC uint8 panorama."""
        # one snapshot: frame selection and the kernel state come from the
        # same registration even if install_lut runs concurrently
        with self._lock:
            reg = self._reg
            lut, tlut = self._lut, self._tlut
        batch = torch.from_numpy(np.stack(self._select_frames(frames, reg)))
        out = self._planar_with(batch.to(self.device), lut, tlut)
        return self._fit_frame(planar_to_hwc(out).cpu().numpy())

    def composite_planar(self, batch: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] uint8 on the device -> [3, Hp, Wp] uint8 planar."""
        with self._lock:
            lut, tlut = self._lut, self._tlut
        return self._planar_with(batch, lut, tlut)

    def _planar_with(self, batch: torch.Tensor, lut, tlut) -> torch.Tensor:
        """Hot path on caller-snapshotted LUT state."""
        if lut is None:
            raise RuntimeError("not registered yet")
        if tlut is not None:
            return composite_mat2_planar(frames_to_planar_i8(batch), tlut[1])
        return composite_frame_u8(batch, lut).permute(2, 0, 1)

    def composite_microbatch(self, planar_batch: torch.Tensor) -> torch.Tensor:
        """Throughput serving path: B frame sets in one launch.

        planar_batch: [B, N, 3, H, W] int8 (value-128, the ingest-native
        planar layout) on the device. Returns [B, 3, Hp, Wp] uint8."""
        with self._lock:
            tlut = self._tlut
        if tlut is None:
            raise RuntimeError("micro-batch path requires the mat2 LUT "
                               "(install a registration with kernel "
                               "'auto' or 'mat2')")
        return composite_mat2_planar_batched(planar_batch, tlut[1])
