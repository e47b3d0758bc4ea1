"""Video runtime: cached-registration streaming compositor.

Port of `stitchingvideo_tpu/video/runtime.py` (the reference 64-bit RT
program's main loop and threads, stitching_detailed.cpp:724-856): a
compositing hot loop streams frames through cached per-pixel state while a
registration worker re-registers every `reregister_seconds` (:843, 30 s) or
on demand (`force_reregister`, the 'a' key, :768), swapping state
double-buffered (`UpdateMat` :696-722).

`register` runs the stitcher's registration (`models/stitcher.py`) on a
frame set, builds the LUT and installs it; `run` streams a `FrameSource`
with the re-registration worker; `save_registration` / `load_registration`
persist and restore the state. The hot loop has three modes: seam-select
(`compose_mode='lut'`, kernels `mat2`, `mat`, `tiled` and the plain
`gather`), `'feather'` and `'multiband'`; one frame set (or, in the first
two modes, a micro-batch) goes through the mode's kernel. In `'feather'`
and `'multiband'` mode, a registration with no state built for the mode is
served by the full blend (`_composite_blend`: the stitcher's warp and
canvas blend, every frame). A state swap is an atomic reference assignment
under a lock, and the output canvas is frozen to the first registration's
shape. `composite()` is the device half `_dispatch` (snapshot, upload,
launches) and a host finish; `video/stream.py`'s `StreamingComposer`, which
`run(pipeline_depth > 1)` uses, keeps frames in flight through the same
dispatch.

With a device mesh (`cfg.parallel.canvas_shards > 1`, or `mesh=`) every mode
composes over canvas bands (`parallel/`): the seam-select and feather states
are cut into row bands of the panorama, padded to the reference's band rows
and cropped after the join, and the multiband state into piece groups whose
partial canvases are summed on the first device. Each band launches on its
device's stream (`parallel/mesh.py`). As in the reference, 'auto' and
'mat2' shard the mat2 kernel, 'mat' and 'tiled' the mat kernel, and
'gather' stays on one device.
"""
from __future__ import annotations

import dataclasses
import logging
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from ..config import StitchConfig
from ..device import resolve_device
from ..blend.multiband_video import (build_multiband_state,
                                     multiband_video_frame)
from ..geometry.undistort import compose_maps, undistort_map_from_config
from ..models.registration import Registration
from ..models.stitcher import Stitcher, _blend_on_canvas, _remap_gain_batch
from ..ops.composite import build_tiled_lut, composite_tiled
from ..ops.composite_feather import (BLEND_FILLS, BlendLUT,
                                     _per_pixel_feather, build_blend_lut,
                                     build_feather_mat,
                                     composite_feather_planar,
                                     composite_feather_planar_batched)
from ..ops.composite_mat import (_materialize, _per_pixel,
                                 composite_mat_planar,
                                 composite_mat_planar_batched,
                                 frames_to_planar_i8, planar_to_hwc)
from ..ops.composite_mat2 import (_materialize2, _per_pixel2,
                                  composite_mat2_planar,
                                  composite_mat2_planar_batched)
from ..ops.remap import remap
from ..parallel.compose_feather import (pad_blend_rows_for_shards,
                                        shard_feather_lut)
from ..parallel.compose_mat import shard_mat_lut
from ..parallel.compose_mat2 import shard_mat2_lut
from ..parallel.compose_multiband import (ShardedMultiband,
                                          multiband_sharded_frame,
                                          shard_multiband_state)
from ..parallel.mesh import Mesh, canonical_device, make_mesh, run_banded
from ..utils.timing import (GLOBAL_TRACER as _tracer, Timer,
                            maybe_sync as _msync, set_sync_spans)
from .lut import (CompositeLUT, build_lut, composite_frame_u8,
                  pad_lut_rows_for_shards)
from .sources import FrameSource
from .stream import StreamingComposer

log = logging.getLogger(__name__)



def _fit2d(a: torch.Tensor, fill, shape) -> torch.Tensor:
    """Pad/crop a 2-D tensor to `shape` (the frozen-output fit primitive)."""
    H, W = shape
    h, w = a.shape
    out = torch.full((H, W), fill, dtype=a.dtype, device=a.device)
    out[:min(h, H), :min(w, W)] = a[:min(h, H), :min(w, W)]
    return out


class _Snapshot(NamedTuple):
    """The state one dispatch reads, taken together under the lock: frame
    selection and the kernel state come from one registration even while
    install_lut runs on another thread."""
    reg: Optional[Registration]
    lut: Optional[CompositeLUT]
    tlut: object
    ftlut: object
    ft_reg: Optional[Registration]
    mbt: object
    mb_reg: Optional[Registration]


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
    """Seam-select, feather and multiband hot loops on one device, or over
    the canvas bands of a device mesh.

    device: 'cuda' unless given (or the mesh's first device); with no CUDA
    present the default raises (there is no silent CPU fallback).
    `device="cpu"` runs the kernels' plain PyTorch versions.
    mesh: the `parallel.mesh.Mesh` to compose over; by default, with
    `cfg.parallel.canvas_shards > 1`, `make_mesh(canvas_shards,
    camera_shards)` over the visible CUDA cards, or on the CPU the CPU
    device once a band. Its first canvas device is the stitcher's device.
    """

    def __init__(self, config: Optional[StitchConfig] = None, device=None,
                 mesh: Optional[Mesh] = None):
        cfg = config or StitchConfig()
        v = cfg.video
        if v.compose_mode not in ("lut", "feather", "multiband"):
            raise ValueError(f"unknown compose_mode {v.compose_mode!r}")
        if v.kernel not in ("auto", "mat2", "mat", "tiled", "gather"):
            raise ValueError(f"unknown kernel {v.kernel!r}")
        if cfg.scales.compose_megapix > 0:
            # the hot loop takes raw full-resolution frames through the LUT
            # (the reference RT program works at native 1080p): the maps are
            # built in full-resolution source coordinates
            cfg = cfg.replace(scales=dataclasses.replace(
                cfg.scales, compose_megapix=-1.0))
        if mesh is not None and device is None:
            device = mesh.canvas_devices[0]
        self.device = resolve_device(device, "VideoStitcher")
        par = cfg.parallel
        if mesh is None and par.canvas_shards > 1:
            n = par.canvas_shards * par.camera_shards
            mesh = make_mesh(canvas=par.canvas_shards,
                             camera=par.camera_shards,
                             devices=None if self.device.type == "cuda"
                             else [self.device] * n)
        if mesh is not None and \
                mesh.canvas_devices[0] != canonical_device(self.device):
            raise ValueError(f"the mesh's first device "
                             f"{mesh.canvas_devices[0]} is not the "
                             f"stitcher's device {self.device}")
        # the canvas bands of the sharded compose, or None for one device
        self._mesh = mesh
        self.cfg = cfg
        self.stitcher = Stitcher(cfg, self.device)
        self._lock = threading.Lock()
        # serialises state builds and swaps (install_lut,
        # build_multiband_state); composite() never takes it
        self._install_lock = threading.Lock()
        self._lut: Optional[CompositeLUT] = None
        # seam-select kernel state: (kind, state) with kind 'mat2' | 'mat' |
        # 'tiled', or None for the plain gather; with a mesh the mat2 or mat
        # state is a `parallel.mesh.Banded` of them
        self._tlut = None
        # ("fmat", FeatherMatLUT, or with a mesh a Banded of them) or None
        self._ftlut = None
        self._ftlut_reg = None             # the Registration it was built from
        # (MultibandVideoState, or with a mesh ShardedMultiband, crop_yx)
        self._mbtlut = None
        self._mbtlut_reg = None            # the Registration it was built from
        # CUDA events after the live state's build (`_mark_built`)
        self._ready = None
        self._reg: Optional[Registration] = None
        self._out_shape: Optional[tuple] = None
        self._frame_hw: Optional[tuple] = None
        self._und_maps = None              # (xmap, ymap) full-res undistort
        self._reg_thread: Optional[threading.Thread] = None
        self._reg_requested = threading.Event()
        self._reg_busy = threading.Event()
        self._stop = threading.Event()
        self._latest_frames = None
        self._last_reg_time = 0.0
        self.stats = FrameStats()
        self.registrations = 0

    # -- slow path -----------------------------------------------------
    def register(self, frames: List[np.ndarray], seed: int = 0) -> None:
        """Full registration from a frame set (host HWC uint8 arrays, one a
        camera); builds the LUT and swaps it in atomically (GetPreStruct +
        UpdateMat parity). A failure raises and the previous state stays
        live."""
        frame_hw = tuple(int(x) for x in frames[0].shape[:2])
        if self.registrations == 0:
            # spans sync while this stitcher's first registration runs
            set_sync_spans(True)
        if self.cfg.undistort.enabled:
            # registration runs on undistorted frames; the undistort LUT is
            # composed into the final maps, so the hot loop takes raw frames
            # through one gather (the reference chains two remaps, 64-bit
            # RT program :741, :752)
            if self._und_maps is None:
                self._und_maps = undistort_map_from_config(
                    self.cfg.undistort, frame_hw, device=self.device)
            ux, uy = self._und_maps
            frames = [remap(torch.from_numpy(np.asarray(f)).to(self.device),
                            ux, uy, interp="linear", border="constant")
                      .cpu().numpy() for f in frames]
        reg, _reg_result, _cscale = self.stitcher.estimate_transform(frames,
                                                                     seed)
        if self.cfg.undistort.enabled:
            cx, cy = compose_maps(reg.xmaps, reg.ymaps, ux, uy)
            reg = dataclasses.replace(reg, xmaps=cx, ymaps=cy)
        with _tracer.span("lut_build"):
            CW, CH = reg.canvas_wh
            lut = build_lut(reg, crop=self._crop_slices((CH, CW),
                                                        reg.extent_wh))
            _msync(lut.cam_idx)
        with _tracer.span("install_lut"):
            self.install_lut(lut, frame_hw, reg=reg)
            _msync(lut.cam_idx)
        # the first successful registration defines the panorama geometry
        # for the life of the stream (reference model stabilization,
        # :447-532): re-registrations keep every shape
        self.stitcher.freeze_shapes()
        set_sync_spans(False)

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
                self._ready = self._mark_built()
                self._out_shape = out_shape
                if reg is not None:
                    self._reg = reg
                self._frame_hw = frame_hw
                self._lut, self._tlut = lut, tlut
                if ftlut is not None:
                    self._ftlut, self._ftlut_reg = ftlut, reg
                if mbtlut is not None:
                    self._mbtlut, self._mbtlut_reg = mbtlut, reg
                self._last_reg_time = time.monotonic()
                self.registrations += 1

    def _mark_built(self):
        """Under the lock, before a swap: CUDA events, one on the current
        stream of each device the state lives on (the stitcher's and the
        mesh's), after the new state's build. Every dispatch's stream waits
        on the events of the state it read (`_snapshot`), so a state built
        on another thread's stream is never read before its build has
        finished on the device; the band streams wait on the dispatch's
        stream (`parallel/mesh.py` `run_bands`). Each stream first waits on
        the previous events, so the new ones also cover states built on
        other streams. None on the CPU."""
        if self.device.type != "cuda":
            return None
        devices = {canonical_device(self.device)}
        if self._mesh is not None:
            devices.update(self._mesh.canvas_devices)
        events = []
        for d in sorted(devices, key=str):
            stream = torch.cuda.current_stream(d)
            for prev in self._ready or ():
                stream.wait_event(prev)
            ready = torch.cuda.Event()
            ready.record(stream)
            events.append(ready)
        return tuple(events)

    def _snapshot(self) -> _Snapshot:
        """The live state, read under the lock; the current stream then
        waits for its build (`_mark_built`)."""
        with self._lock:
            snap = _Snapshot(self._reg, self._lut, self._tlut, self._ftlut,
                             self._ftlut_reg, self._mbtlut, self._mbtlut_reg)
            ready = self._ready
        for ev in ready or ():
            torch.cuda.current_stream(self.device).wait_event(ev)
        return snap

    def _build_tiled(self, lut: CompositeLUT, frame_hw):
        """The seam-select kernel state of cfg.video.kernel: 'auto' and
        'mat2' build mat2, 'mat' and 'tiled' their own, None for 'gather'.
        With a mesh, 'auto' and 'mat2' build mat2 and 'mat' and 'tiled' mat,
        each cut into canvas bands (`parallel.mesh.Banded`, cropped back to
        the LUT's rows by `run_banded`). Neither 'mat' nor 'tiled' has a
        fallback path: a LUT with fallback tiles raises `ValueError` (the
        reference quietly composes through its gather instead)."""
        kernel = self.cfg.video.kernel
        if kernel == "gather":
            return None
        if self._mesh is not None:
            tlut = build_tiled_lut(pad_lut_rows_for_shards(
                lut, self._mesh.shape["canvas"]), frame_hw)
            Hp = lut.shape[0]
            if kernel in ("auto", "mat2"):
                return ("mat2", shard_mat2_lut(_per_pixel2(tlut), self._mesh,
                                               Hp))
            self._refuse_fallback(tlut)
            return ("mat", shard_mat_lut(_per_pixel(tlut), self._mesh, Hp))
        tlut = build_tiled_lut(lut, frame_hw)
        if kernel in ("auto", "mat2"):
            return ("mat2", _materialize2(tlut))
        self._refuse_fallback(tlut)
        return ("mat", _materialize(tlut)) if kernel == "mat" \
            else ("tiled", tlut)

    def _refuse_fallback(self, tlut) -> None:
        kernel = self.cfg.video.kernel
        if tlut.n_fallback != 0:
            raise ValueError(
                f"kernel={kernel!r} has no fallback path and the LUT has "
                f"{tlut.n_fallback} fallback tiles (tiles that touch more "
                "than two cameras or overflow their source window): use "
                "kernel='mat2', which composes them in its kernel, or "
                "kernel='gather'")

    def _build_feather(self, reg: Registration, frame_hw, out_shape):
        """The feather kernel state from a registration: ('fmat', state),
        the state cut into canvas bands with a mesh."""
        blut = self._blend_lut(reg, out_shape)
        if self._mesh is None:
            return ("fmat", build_feather_mat(blut, frame_hw))
        fml = _per_pixel_feather(pad_blend_rows_for_shards(
            blut, self._mesh.shape["canvas"]), frame_hw)
        return ("fmat", shard_feather_lut(fml, self._mesh, blut.shape[0]))

    def _build_multiband(self, reg: Registration, frame_hw):
        """The multiband state from a registration: (state, crop_yx), the
        state cut into piece groups over the mesh if there is one (only the
        groups are kept)."""
        CW, CH = reg.canvas_wh
        ndev = self._mesh.shape["canvas"] if self._mesh is not None else 0
        st, crop_yx = build_multiband_state(
            reg, frame_hw, self.cfg.compose.blend_strength,
            crop=self._crop_slices((CH, CW), reg.extent_wh),
            pad_pieces_to=ndev)
        st = st.to(self.device)
        if self._mesh is not None:
            st = shard_multiband_state(st, self._mesh)
        return st, crop_yx

    def build_feather_state(self, frame_hw) -> bool:
        """Build and swap in the feather kernel state of the live
        registration. Returns False with no registration; a build that
        fails raises and the previous state stays live (the reference
        demotes to its full blend)."""
        with self._install_lock:
            with self._lock:
                reg, out_shape = self._reg, self._out_shape
            if reg is None:
                return False
            ftlut = self._build_feather(reg, tuple(int(x) for x in frame_hw),
                                        out_shape)
            with self._lock:
                self._ready = self._mark_built()
                self._ftlut, self._ftlut_reg = ftlut, reg
        return True

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
                self._ready = self._mark_built()
                self._mbtlut, self._mbtlut_reg = mbtlut, reg
        return True

    def _blend_lut(self, reg: Registration, out_shape) -> BlendLUT:
        """A registration's blend LUT, cropped by the RT margins and fitted
        to the frozen output shape."""
        blut = build_blend_lut(reg, self.cfg.compose.feather_sharpness) \
            .to(self.device)
        blut = blut.crop(*self._crop_slices(blut.shape, reg.extent_wh))
        if out_shape is not None and blut.shape != tuple(out_shape):
            blut = self._fit_blend(blut, out_shape)
        return blut

    def save_registration(self, path: str) -> None:
        """Persist the live registration and the frame shape its kernels
        were built for, as the JAX package's `save_registration` does, so a
        later process (of either package) can stream without
        re-registering (`load_registration`)."""
        with self._lock:
            reg, fhw = self._reg, self._frame_hw
        if reg is None or fhw is None:
            raise RuntimeError("no live registration to save")
        d = reg.state_dict()
        d["frame_hw"] = np.asarray(fhw, np.int32)
        # through an open handle: np.savez_compressed(str) appends '.npz'
        # to a bare path, which load_registration would then miss
        with open(path, "wb") as f:
            np.savez_compressed(f, **d)

    def load_registration(self, path: str) -> None:
        """Load a registration `.npz` that `save_registration` of either
        package wrote, and swap it in through install_lut."""
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
        return blut.map(lambda k, a: _fit2d(a, BLEND_FILLS[k], shape))

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
        feather blend; 'multiband': the windowed Laplacian blend). In
        'feather' and 'multiband' mode a registration with no state built
        for the mode takes the full blend (`_composite_blend`)."""
        out, post, _snap = self._dispatch(frames)
        if isinstance(out, torch.Tensor):
            out = out.cpu().numpy()
        return out if post is None else post(out)

    def _dispatch(self, frames: List[np.ndarray], upload=None):
        """The device half of `composite()`, shared with the streaming
        composer (`video/stream.py`): one snapshot of the state, frame
        selection, the upload (`upload(frames)` -> [N, H, W, 3] uint8 on the
        device; `_to_device` by default) and the mode's launches, all on the
        current stream, which first waits for the state's build.

        Returns (panorama, postprocess, snapshot): the [Hp, Wp, 3] uint8
        panorama on the device, or a host array from the full blend (which
        is host-synchronous and fits its own output); `_fit_frame` for the
        feather and multiband outputs, or None (the seam-select LUT is
        fitted to the frozen shape at install); and the snapshot, which a
        caller keeps while the launches may still read it."""
        snap = self._snapshot()
        upload = upload or self._to_device
        mode = self.cfg.video.compose_mode
        if mode == "feather" and snap.ftlut is not None:
            batch = upload(self._select_frames(frames,
                                               snap.ft_reg or snap.reg))
            out = self._feather_planar(batch, snap.ftlut)
        elif mode == "multiband" and snap.mbt is not None:
            st, crop_yx = snap.mbt
            batch = upload(self._select_frames(frames,
                                               snap.mb_reg or snap.reg))
            planar = frames_to_planar_i8(batch)
            out = (multiband_sharded_frame(planar, st, crop_yx)
                   if isinstance(st, ShardedMultiband) else
                   multiband_video_frame(planar, st, crop_yx=crop_yx))
        elif mode == "lut":
            batch = upload(self._select_frames(frames, snap.reg))
            return planar_to_hwc(self._planar_with(batch, snap.lut,
                                                   snap.tlut)), None, snap
        else:
            return self._composite_blend(self._select_frames(
                frames, snap.reg), mode, snap.reg), None, snap
        return planar_to_hwc(out), self._fit_frame, snap

    def _composite_blend(self, frames: List[np.ndarray], mode: str,
                         reg: Optional[Registration] = None) -> np.ndarray:
        """The full blend: frames through the registration's maps and gains
        and the stitcher's canvas blend of `mode` ('feather' or
        'multiband'), with the hot paths' crop and frozen output shape."""
        if reg is None:
            with self._lock:
                reg = self._reg
        if reg is None:
            raise RuntimeError("not registered yet")
        batch = self._to_device(frames).to(torch.float32)
        warped = _remap_gain_batch(batch, reg.xmaps, reg.ymaps, reg.gain_maps)
        pano, _mask = _blend_on_canvas(
            warped, reg.seam_masks, reg.valid, reg.corners.cpu().numpy(),
            reg.canvas_wh, mode, self.cfg.compose.blend_strength,
            self.cfg.compose.feather_sharpness)
        CW, CH = reg.canvas_wh
        y0, y1, x0, x1 = self._crop_slices((CH, CW), reg.extent_wh)
        out = torch.clamp(torch.round(pano[y0:y1, x0:x1]), 0, 255) \
            .to(torch.uint8)
        return self._fit_frame(out.cpu().numpy())

    def _to_device(self, frames: List[np.ndarray]) -> torch.Tensor:
        return torch.from_numpy(np.stack(frames)).to(self.device)

    def composite_device(self, batch: torch.Tensor) -> torch.Tensor:
        """Device-resident hot path (no host transfer): [N, H, W, 3] uint8
        on the device -> [Hp, Wp, 3] uint8, through the seam-select state.
        `composite_planar` skips the HWC interleave."""
        return planar_to_hwc(self.composite_planar(batch))

    def composite_planar(self, batch: torch.Tensor) -> torch.Tensor:
        """[N, H, W, 3] uint8 on the device -> [3, Hp, Wp] uint8 planar,
        through the seam-select state."""
        snap = self._snapshot()
        return self._planar_with(batch, snap.lut, snap.tlut)

    def _planar_with(self, batch: torch.Tensor, lut, tlut) -> torch.Tensor:
        """Hot path on caller-snapshotted LUT state."""
        if lut is None:
            raise RuntimeError("not registered yet")
        kind, state = tlut or ("gather", lut)
        if kind == "mat2":
            return run_banded(composite_mat2_planar,
                              frames_to_planar_i8(batch), state)
        if kind == "mat":
            return run_banded(composite_mat_planar,
                              frames_to_planar_i8(batch), state)
        if kind == "tiled":
            return composite_tiled(batch, state).permute(2, 0, 1)
        return composite_frame_u8(batch, lut).permute(2, 0, 1)

    def composite_feather_planar(self, batch: torch.Tensor) -> torch.Tensor:
        """Feather-blended hot path: [N, H, W, 3] uint8 on the device ->
        [3, Hp, Wp] uint8 planar."""
        snap = self._snapshot()
        if snap.ftlut is None:
            raise RuntimeError(
                "feather state not built: install a registration "
                "(load_registration, or install_lut with reg=) with "
                "compose_mode='feather'")
        return self._feather_planar(batch, snap.ftlut)

    @staticmethod
    def _feather_planar(batch: torch.Tensor, ftlut) -> torch.Tensor:
        """Feather hot path on a caller-snapshotted state."""
        return run_banded(composite_feather_planar,
                          frames_to_planar_i8(batch), ftlut[1])

    def composite_microbatch(self, planar_batch: torch.Tensor) -> torch.Tensor:
        """Throughput serving path: B frame sets in one launch.

        planar_batch: [B, N, 3, H, W] int8 (value-128, the ingest-native
        planar layout) on the device. Returns [B, 3, Hp, Wp] uint8, per
        frame set what the single-frame path gives. Served by the feather,
        mat2 and mat kernels, on one device or, batched, once a band (the
        reference maps its sharded single-frame function over the batch;
        batched and single are bit-exact)."""
        snap = self._snapshot()
        tlut, ftlut = snap.tlut, snap.ftlut
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
            return run_banded(composite_feather_planar_batched, planar_batch,
                              ftlut[1])
        if tlut is not None and tlut[0] == "mat2":
            return run_banded(composite_mat2_planar_batched, planar_batch,
                              tlut[1])
        if tlut is not None and tlut[0] == "mat":
            return run_banded(composite_mat_planar_batched, planar_batch,
                              tlut[1])
        raise RuntimeError("micro-batch path requires a materialized LUT "
                           "(install a registration with kernel 'auto', "
                           "'mat2' or 'mat')")

    def force_reregister(self) -> None:
        """'a'-key parity (64-bit RT program :768): the worker of `run`
        re-registers on the latest frame set."""
        self._reg_requested.set()

    # -- streaming loop ------------------------------------------------
    def run(self, source: FrameSource,
            on_frame: Optional[Callable[[np.ndarray, int], None]] = None,
            max_frames: Optional[int] = None,
            pipeline_depth: Optional[int] = None) -> FrameStats:
        """Main loop with background re-registration every
        cfg.video.reregister_seconds (reference :832-848): registers on the
        first frame set if nothing is installed, then composites each frame
        set and hands it to on_frame(pano, i), every frame once and in
        order. A worker thread re-registers on the latest frame set when
        the period elapses or `force_reregister` asks; a failed
        re-registration keeps the previous state and retries on the next
        trigger (reference retry loop :822-826). At exit the loop waits
        for an in-flight re-registration.

        pipeline_depth (default cfg.video.pipeline_depth): 1 delivers frame
        set i before reading i+1 (the reference's hot loop); K > 1 keeps K
        frame sets in flight through `StreamingComposer`, so on_frame(i)
        fires up to K-1 frame sets behind ingest while the host copies,
        launches and device copies of neighbouring frame sets overlap.
        Every frame set is still delivered once, in order: the tail drains
        at the end of the stream. stats.compose_s then measures the submit;
        the composer's out_times the deliveries."""
        period = self.cfg.video.reregister_seconds
        depth = (self.cfg.video.pipeline_depth if pipeline_depth is None
                 else pipeline_depth)
        # re-entrancy: a previous run() set _stop in its finally; a fresh
        # loop needs a live worker
        self._stop.clear()
        self._reg_requested.clear()
        frames = source.read()
        if frames is None:
            raise RuntimeError("frame source empty")
        if self._lut is None:
            self.register(frames)

        def reg_worker():
            while not self._stop.is_set():
                if not self._reg_requested.wait(timeout=0.1):
                    continue
                self._reg_busy.set()        # before clearing the request:
                self._reg_requested.clear()  # the drain never sees both unset
                with self._lock:
                    latest = self._latest_frames
                try:
                    self.register(latest)
                except Exception:
                    log.warning(
                        "re-registration failed; keeping the previous LUT",
                        exc_info=True)
                finally:
                    self._reg_busy.clear()

        self._latest_frames = frames
        self._reg_thread = threading.Thread(target=reg_worker, daemon=True)
        self._reg_thread.start()
        sc = StreamingComposer(self, depth=depth) if depth > 1 else None
        try:
            i = 0
            delivered = 0
            while max_frames is None or i < max_frames:
                with Timer() as t_read:
                    if i > 0:
                        frames = source.read()
                        if frames is None:
                            break
                with self._lock:
                    self._latest_frames = frames
                with Timer() as t_comp:
                    pano = (sc.submit(frames) if sc is not None
                            else self.composite(frames))
                self.stats.read_s.append(t_read.elapsed)
                self.stats.compose_s.append(t_comp.elapsed)
                self.stats.frames += 1
                if pano is not None:
                    if on_frame is not None:
                        on_frame(pano, delivered)
                    delivered += 1
                if time.monotonic() - self._last_reg_time > period:
                    self._last_reg_time = time.monotonic()  # rearm
                    self._reg_requested.set()
                i += 1
            if sc is not None:
                for pano in sc.flush():      # the in-flight tail
                    if on_frame is not None:
                        on_frame(pano, delivered)
                    delivered += 1
        finally:
            # drain an in-flight re-registration before the worker stops
            deadline = time.monotonic() + 120.0
            while (self._reg_requested.is_set() or self._reg_busy.is_set()) \
                    and time.monotonic() < deadline:
                time.sleep(0.05)
            self._stop.set()
            self._reg_thread.join(timeout=30.0)
        return self.stats
