"""Video runtime: the serving subset of the cached-registration compositor.

Port of `stitchingvideo_tpu/video/runtime.py` for the three hot-loop modes:
seam-select (`compose_mode='lut'`, kernels `mat2`, `mat`, `tiled` and the
plain `gather`), `'feather'` and `'multiband'`. Load or install a
registration, then composite one frame set (or, in the first two modes, a
micro-batch) through the mode's kernel. A state swap is an atomic reference
assignment under a lock, and the output canvas is frozen to the first
registration's shape.

Still to port, each raising `NotImplementedError` with its ROADMAP.md item:
the stitcher's registration (`register`, items 13-15: `register_images`
gives the cameras, the seams and gains are still to come; and `run` with
its re-registration thread, item 15), the full blend that feather and multiband
fall back to without a kernel state (item 19) and canvas sharding (item 22).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

from ..config import StitchConfig
from ..device import resolve_device
from ..blend.multiband_video import (build_multiband_state,
                                     multiband_video_frame)
from ..models.registration import Registration
from ..ops.composite import build_tiled_lut, composite_tiled
from ..ops.composite_feather import (BlendLUT, build_blend_lut,
                                     build_feather_mat,
                                     composite_feather_planar,
                                     composite_feather_planar_batched)
from ..ops.composite_mat import (_materialize, composite_mat,
                                 composite_mat_planar_batched,
                                 frames_to_planar_i8, planar_to_hwc)
from ..ops.composite_mat2 import (_materialize2, composite_mat2_planar,
                                  composite_mat2_planar_batched)
from .lut import CompositeLUT, build_lut, composite_frame_u8

_ROADMAP = "ROADMAP.md, queue 1"
_BLEND_FILLS = dict(cam_a=-1, sx_a=0.0, sy_a=0.0, gw_a=0.0,
                    cam_b=-1, sx_b=0.0, sy_b=0.0, gw_b=0.0)


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
    """Seam-select, feather and multiband hot loops on one device.

    device: 'cuda' unless given; with no CUDA present the default raises
    (there is no silent CPU fallback). `device="cpu"` runs the kernels'
    plain PyTorch versions."""

    def __init__(self, config: Optional[StitchConfig] = None, device=None):
        cfg = config or StitchConfig()
        v = cfg.video
        if v.compose_mode not in ("lut", "feather", "multiband"):
            raise ValueError(f"unknown compose_mode {v.compose_mode!r}")
        if v.kernel not in ("auto", "mat2", "mat", "tiled", "gather"):
            raise ValueError(f"unknown kernel {v.kernel!r}")
        if cfg.parallel.canvas_shards > 1:
            raise NotImplementedError(
                "canvas_shards > 1 is not ported yet "
                f"({_ROADMAP}, item 22)")
        self.device = resolve_device(device, "VideoStitcher")
        self.cfg = cfg
        self._lock = threading.Lock()
        # serialises state builds and swaps (install_lut,
        # build_multiband_state); composite() never takes it
        self._install_lock = threading.Lock()
        self._lut: Optional[CompositeLUT] = None
        # seam-select kernel state: (kind, state) with kind 'mat2' | 'mat' |
        # 'tiled', or None for the plain gather
        self._tlut = None
        self._ftlut = None                 # ("fmat", FeatherMatLUT) or None
        self._ftlut_reg = None             # the Registration it was built from
        self._mbtlut = None                # (MultibandVideoState, crop_yx)
        self._mbtlut_reg = None            # the Registration it was built from
        self._reg: Optional[Registration] = None
        self._out_shape: Optional[tuple] = None
        self._frame_hw: Optional[tuple] = None
        self.stats = FrameStats()
        self.registrations = 0

    # -- slow path -----------------------------------------------------
    def register(self, frames, seed: int = 0) -> None:
        raise NotImplementedError(
            "the stitcher's registration (seams, exposure and the runtime's "
            f"slow path) is not ported yet ({_ROADMAP}, items 13-15): "
            "register_images gives the cameras; load a registration the JAX "
            "package saved (load_registration) or install a LUT "
            "(install_lut)")

    def run(self, *args, **kwargs):
        raise NotImplementedError(
            "the streaming loop with re-registration is not ported yet "
            f"({_ROADMAP}, item 15)")

    def install_lut(self, lut: CompositeLUT, frame_hw,
                    reg: Optional[Registration] = None) -> None:
        """Atomically swap in a composite LUT (the double-buffered UpdateMat
        step, 64-bit driver :696-722); the entry point for loaded state.
        In 'lut' mode it builds the configured kernel's state; in 'feather'
        and 'multiband' mode, given the registration, that mode's state. A
        build that fails raises, and so does a LUT with fallback tiles under
        kernel 'mat' or 'tiled' (`ValueError`); the previous state then
        stays live (the reference swallows a failed feather or multiband
        build and demotes to its full blend)."""
        lut = lut.to(self.device)
        frame_hw = tuple(int(x) for x in frame_hw)
        mode = self.cfg.video.compose_mode
        with self._install_lock:
            with self._lock:
                out_shape = self._out_shape or lut.shape
            if lut.shape != out_shape:
                lut = self._fit_lut(lut, out_shape)
            # the feather and multiband states build outside the lock that
            # composite() takes, so it serves the previous state meanwhile
            ftlut = (self._build_feather(reg, frame_hw, out_shape)
                     if mode == "feather" and reg is not None else None)
            mbtlut = (self._build_multiband(reg, frame_hw)
                      if mode == "multiband" and reg is not None else None)
            with self._lock:
                # the feather and multiband hot loops never run the
                # seam-select kernel; its build stays under the lock, as the
                # reference's does
                tlut = self._build_tiled(lut, frame_hw) if mode == "lut" \
                    else None
                self._out_shape = out_shape
                if reg is not None:
                    self._reg = reg
                self._frame_hw = frame_hw
                self._lut, self._tlut = lut, tlut
                if ftlut is not None:
                    self._ftlut, self._ftlut_reg = ftlut, reg
                if mbtlut is not None:
                    self._mbtlut, self._mbtlut_reg = mbtlut, reg
                self.registrations += 1

    def _build_tiled(self, lut: CompositeLUT, frame_hw):
        """The seam-select kernel state of cfg.video.kernel: 'auto' and
        'mat2' build mat2, 'mat' and 'tiled' their own, None for 'gather'.
        Neither of the last two kernels has a fallback path: a LUT with
        fallback tiles raises `ValueError` (the reference quietly composes
        through its gather instead)."""
        kernel = self.cfg.video.kernel
        if kernel == "gather":
            return None
        tlut = build_tiled_lut(lut, frame_hw)
        if kernel in ("auto", "mat2"):
            return ("mat2", _materialize2(tlut))
        if tlut.n_fallback != 0:
            raise ValueError(
                f"kernel={kernel!r} has no fallback path and the LUT has "
                f"{tlut.n_fallback} fallback tiles (tiles that touch more "
                "than two cameras or overflow their source window): use "
                "kernel='mat2', which composes them in its kernel, or "
                "kernel='gather'")
        return ("mat", _materialize(tlut)) if kernel == "mat" \
            else ("tiled", tlut)

    def _build_feather(self, reg: Registration, frame_hw, out_shape):
        """The feather kernel state from a registration."""
        return ("fmat", build_feather_mat(self._blend_lut(reg, out_shape),
                                          frame_hw))

    def _build_multiband(self, reg: Registration, frame_hw):
        """The multiband state from a registration: (state, crop_yx)."""
        CW, CH = reg.canvas_wh
        st, crop_yx = build_multiband_state(
            reg, frame_hw, self.cfg.compose.blend_strength,
            crop=self._crop_slices((CH, CW), reg.extent_wh))
        return st.to(self.device), crop_yx

    def build_multiband_state(self, frame_hw) -> bool:
        """Build and swap in the multiband state of the live registration.
        Returns False with no registration; a build that fails raises and
        the previous state stays live."""
        with self._install_lock:
            with self._lock:
                reg = self._reg
            if reg is None:
                return False
            mbtlut = self._build_multiband(reg,
                                           tuple(int(x) for x in frame_hw))
            with self._lock:
                self._mbtlut, self._mbtlut_reg = mbtlut, reg
        return True

    def _blend_lut(self, reg: Registration, out_shape) -> BlendLUT:
        """A registration's blend LUT, cropped by the RT margins and fitted
        to the frozen output shape."""
        blut = build_blend_lut(reg, self.cfg.compose.feather_sharpness) \
            .to(self.device)
        blut = blut.crop(*self._crop_slices(blut.shape, reg.extent_wh))
        if blut.shape != tuple(out_shape):
            blut = self._fit_blend(blut, out_shape)
        return blut

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
    def _fit_blend(blut: BlendLUT, shape) -> BlendLUT:
        """Pad/crop a blend LUT to the frozen output shape."""
        return blut.map(lambda k, a: _fit2d(a, _BLEND_FILLS[k], shape))

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
        uint8 frames -> HWC uint8 panorama, through the kernel of
        cfg.video.compose_mode ('lut': seam-select; 'feather': the top-2
        feather blend; 'multiband': the windowed Laplacian blend)."""
        # one snapshot: frame selection and the kernel state come from the
        # same registration even if install_lut runs concurrently
        with self._lock:
            reg = self._reg
            lut, tlut = self._lut, self._tlut
            ftlut, ft_reg = self._ftlut, self._ftlut_reg
            mbt, mb_reg = self._mbtlut, self._mbtlut_reg
        mode = self.cfg.video.compose_mode
        if mode == "feather":
            self._need_feather(ftlut)
            batch = self._to_device(self._select_frames(frames, ft_reg or reg))
            out = self._feather_planar(batch, ftlut)
        elif mode == "multiband":
            if mbt is None:
                raise RuntimeError(
                    "multiband state not built: install a registration "
                    "(load_registration, or install_lut with reg=) with "
                    "compose_mode='multiband'; the full blend without a "
                    f"cached state is not ported ({_ROADMAP}, item 19)")
            st, crop_yx = mbt
            batch = self._to_device(self._select_frames(frames, mb_reg or reg))
            out = multiband_video_frame(frames_to_planar_i8(batch), st,
                                        crop_yx=crop_yx)
        else:
            batch = self._to_device(self._select_frames(frames, reg))
            out = self._planar_with(batch, lut, tlut)
        return self._fit_frame(planar_to_hwc(out).cpu().numpy())

    def _to_device(self, frames: List[np.ndarray]) -> torch.Tensor:
        return torch.from_numpy(np.stack(frames)).to(self.device)

    @staticmethod
    def _need_feather(ftlut) -> None:
        if ftlut is None:
            raise RuntimeError(
                "feather state not built: install a registration "
                "(load_registration, or install_lut with reg=) with "
                "compose_mode='feather'; the full blend without a kernel "
                f"state is not ported ({_ROADMAP}, item 19)")

    def composite_planar(self, batch: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] uint8 on the device -> [3, Hp, Wp] uint8 planar,
        through the seam-select state."""
        with self._lock:
            lut, tlut = self._lut, self._tlut
        return self._planar_with(batch, lut, tlut)

    def _planar_with(self, batch: torch.Tensor, lut, tlut) -> torch.Tensor:
        """Hot path on caller-snapshotted LUT state."""
        if lut is None:
            raise RuntimeError("not registered yet")
        kind, state = tlut or ("gather", lut)
        if kind == "mat2":
            return composite_mat2_planar(frames_to_planar_i8(batch), state)
        if kind == "mat":
            return composite_mat(batch, state)
        if kind == "tiled":
            return composite_tiled(batch, state).permute(2, 0, 1)
        return composite_frame_u8(batch, lut).permute(2, 0, 1)

    def composite_feather_planar(self, batch: torch.Tensor) -> torch.Tensor:
        """Feather-blended hot path: [N, H, W, 3] uint8 on the device ->
        [3, Hp, Wp] uint8 planar."""
        with self._lock:
            ftlut = self._ftlut
        self._need_feather(ftlut)
        return self._feather_planar(batch, ftlut)

    @staticmethod
    def _feather_planar(batch: torch.Tensor, ftlut) -> torch.Tensor:
        """Feather hot path on a caller-snapshotted state."""
        return composite_feather_planar(frames_to_planar_i8(batch), ftlut[1])

    def composite_microbatch(self, planar_batch: torch.Tensor) -> torch.Tensor:
        """Throughput serving path: B frame sets in one launch.

        planar_batch: [B, N, 3, H, W] int8 (value-128, the ingest-native
        planar layout) on the device. Returns [B, 3, Hp, Wp] uint8, per
        frame set what the single-frame path gives. Served by the feather,
        mat2 and mat kernels."""
        with self._lock:
            tlut, ftlut = self._tlut, self._ftlut
        if self.cfg.video.compose_mode == "multiband":
            # never serve seam-select output at multiband quality unasked
            raise RuntimeError(
                "multiband has no micro-batch entry point on the stitcher; "
                "batch blend.multiband_video.multiband_video_frames_batched "
                "directly, or use compose_mode='lut' or 'feather'")
        if self.cfg.video.compose_mode == "feather":
            if ftlut is None:
                raise RuntimeError("feather micro-batch path requires the "
                                   "feather state (install a registration)")
            return composite_feather_planar_batched(planar_batch, ftlut[1])
        if tlut is not None and tlut[0] == "mat2":
            return composite_mat2_planar_batched(planar_batch, tlut[1])
        if tlut is not None and tlut[0] == "mat":
            return composite_mat_planar_batched(planar_batch, tlut[1])
        raise RuntimeError("micro-batch path requires a materialized LUT "
                           "(install a registration with kernel 'auto', "
                           "'mat2' or 'mat')")
