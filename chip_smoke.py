#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py            # from the root of a checkout, one card

What it does, in phases (any failure exits non-zero):
  1. prints the card's name and power limit (nvidia-smi) and the versions;
  2. builds every CUDA kernel of the port from `stitchingvideo_tpu_torch/csrc`
     (one nvcc per source, all started together);
  3. builds the product-size synthetic rig in numpy: bench.py's 5-camera
     cylindrical LUT (1080x1920 frames -> 1280x7168 panorama), once with a
     few tiles poisoned to span 3 cameras, so the mat2 fallback path is live,
     and once without, for the kernels that take no fallback tile;
  4. mat2 (`kernel='auto'`): `composite` of one frame set,
     `composite_microbatch` at B=16 and B=32; then the band-shift copy
     `shift_planar_bn` through its own entry point;
  5. mat (`kernel='mat'`): `composite` and `composite_microbatch` at B=16 on
     the un-poisoned rig; the output also equals mat2's on the same LUT, and
     so does its staging table (the same taps);
  6. tiled (`kernel='tiled'`): `composite`; and `remap_tiled` of one frame
     through one camera's map against `composite_tiled` on that LUT, with
     one `grid_sample` call on the same map as a yardstick;
  7. feather (`compose_mode='feather'`): a product-size registration (5
     cameras on the cylinder with overlapping ROIs, a few patches that bring
     a third camera into a tile) is written as `.npz` into a temporary
     directory and loaded with `load_registration`; `composite`,
     `composite_feather_planar`, `composite_microbatch` at B=16; the output
     is held to the exact dual gather within the reference's gates
     (median 0, max <= 3, fallback tiles <= 1).
  8. multiband (`compose_mode='multiband'`): the same rig with a seam
     partition (each canvas column owned by the nearest camera centre) and a
     patch of strong warp curvature, whose window tiles overflow their
     source window and take the fallback branch of the warp kernel; 7 bands
     on a 1664x7296 canvas, 5 windows of 1664x2048. `composite` (B=1, host
     to host), `multiband_video_frame` on device tensors,
     `multiband_video_frames_batched` at B=8; the warp kernel against its
     plain version (B=1, B=8, batched == single), the blended panorama with
     the kernel against the same chain fed by the plain warp, batched ==
     single for every frame set, and on a reduced registration the card's
     panorama against the same code on the CPU; one B=8 call split into
     warp / pyramids / canvas / level 0 by CUDA events;
  9. the window-copy probe (`window_probe`): [3, 32, 256] int8 windows
     staged into shared memory, one TMA copy each, at origins aligned to
     128, 32, 16, 8, 4, 2 and 1 columns: 512 windows of the TPU probe's
     3 x 1088 x 1920 frame, 16,384 of it (copies from L2) and 16,384 of a
     3 x 17408 x 1920 frame (100 MB, copies from HBM), bit-exact against
     the plain version (the HBM case on 1,024 sampled windows), each timed
     beside its byte bound, with an empty launch of the probe's grid beside
     them; origins off the frame, off their alignment or across its right
     edge come back as NaN.
  In every phase the launch counts are set to 0 before the main path and
  read after it, each kernel's output is held bit-exact against its plain
  PyTorch version on the card (TF32 off), batched output against single
  output, and the seam-select outputs against the exact gather oracle. The
  mat2, mat, feather and multiband phases also rebuild their state's
  staging table (the source boxes their kernels stage into shared memory)
  from its taps, time it, and print its direct-gather blocks, its bytes a
  stage and the blocks an SM holds.
  10. registration (`register_images`): the port's `utils/synthetic.py`
     renders a 360-degree ring of 5 cameras (72 degrees apart, fov 90) at
     the work scale of a 1080p frame (1033x581) on the card; the default
     config registers it, each stage timed cold and warm (median of 3); it
     must keep all 5 cameras, find the focal within 3% and every relative
     rotation within 1 degree (the reference's own gates); and a reduced
     scene (3 cameras, 320x240) registered on the card and on the CPU must
     agree within the slice tests' tolerance. No kernel of its own.
  11. stitcher (`VideoStitcher.register`, `run`): the port's
     `utils/synthetic.py` renders the product rig at full resolution (5 x
     1080p, 72 degrees apart, fov 90) on the card; the default config
     registers it (g++ builds the graph cut's max-flow library first),
     once and then twice warm, every span of the stitcher timed, and once
     in a fresh process (the start-up delay, PyTorch's first forward-mode
     derivative included); gates: all
     5 cameras kept, focal within 3%, relative rotations within 1 degree,
     every camera valid somewhere and owning output pixels, the canvas
     within one wrap, the output shape frozen across re-registrations;
     `composite` (K2) and `composite_microbatch` at B=16 (K1, 16 distinct
     frame sets: the views rolled by a different column count each) on that
     registration bit-exact against their plain versions and within the
     reference's tolerance of the gather; `run()` over the rendered frames
     with one forced re-registration delivers every frame in order, with
     the frame times during and outside the re-registration; and the
     reduced scene registered on the card and on the CPU must agree.
  12. shard (`VideoStitcher(cfg, mesh=...)`, `parallel/`): the sharded
     compose over 2 and 4 canvas bands of a mesh that lists the card once a
     band, on the stitcher phase's registration (865 x 6015 out), which the
     stream phase later re-registers, in 'lut' (K2 a band for `composite`,
     K1 a band for the micro-batch), 'feather' (K4) and 'multiband' (the
     pieces kernel's single entry a band), and on
     the mat2 cell's poisoned LUT (K2/K1) and clean LUT under kernel='mat'
     (K5); gates: `composite` and a micro-batch of 4 frame sets equal to the
     single-device stitcher's bit for bit (multiband: median 0, >= 99.9%
     within 2), each kernel launched once a band a call, the single-frame
     kernel on the band streams, every band's launch bit-exact against its
     plain version; a frame set's device path and the micro-batch per frame
     set, sharded beside one device. A box with several cards is not
     exercised: the card is listed once a band.
  13. stream (`StreamingComposer`, `run(pipeline_depth > 1)`): the stitcher
     phase's registration saved, loaded into one `VideoStitcher` and
     installed from it into one of each other mode; the stages of a
     streamed frame set on the host and the card, each alone;
     16 distinct frame sets (the views rolled as for K1) at depths 1, 2, 4
     and 8, 48 deliveries each, in the seam-select (K2), feather (K4) and
     multiband (pieces) modes: delivered fps, the gap between deliveries
     and the submit-to-delivery latency (p50/p95), the device_reduce
     checksum rate at depth 8, the serial `composite()` beside them; one
     `torch.profiler` window at depth 4 in seam-select mode (the card's
     busy share and the copies and kernels that overlap); gates: every
     delivery, compared after the last submit, equal to the serial
     `composite()` of its frame set, each mode's kernel launched once a
     submit and only on the composers' streams, distinct checksums, and
     `run(pipeline_depth=4)` with one forced re-registration delivering
     every frame set once, in order, with the output shape frozen. The
     saved registration file stays on disk for the next phase.
  14. ingest (`SharedMemorySource`, the producers, the CLI): after a check
     that /dev/shm holds the rings, five producer processes (the card
     hidden from them) republish the stitcher phase's 5 x 1080p views into
     shared-memory rings of 4 slots at 30 fps; `VideoStitcher.run` over
     `SharedMemorySource` from the stream phase's registration file in
     'lut' mode at depths 1 and 4, 48 deliveries each; the producers then
     free-running: `SharedMemorySource.read()` timed alone and `run()` at
     depth 4; then on paced producers the CLI as a subprocess,
     `video --mode shm_attach` with the file loaded (60 frames) and from a
     cold start (30 frames, one registration from the rings' frames);
     gates: every delivery equal to `composite()` of the views, K2
     launched once a delivery and bit-exact against its plain version,
     the CLI's rc 0, frame count and registrations (its `--log_timing`
     spans show a registration from frames only on the cold start), no
     ring of the phase left under /dev/shm.
  15. still (`Stitcher.stitch`, `compose_panorama`, the full blend): the
     stitcher phase's 5 x 1080p views through `Stitcher(StitchConfig())
     .stitch` (the OpenCV-faithful path: work-scale registration, block
     gains, graph-cut seams, the int16 multiband blender at full
     resolution), cold and twice warm, every span timed; `compose_panorama`
     on `estimate_transform`'s Registration for the multiband and feather
     blends; `VideoStitcher.composite` in feather mode with no feather
     state (the full blend) beside the feather kernel's on the same
     registration; gates: all 5 cameras kept, the panorama within one wrap
     plus a view, most of it covered and not black (the reference's own),
     every camera owning canvas pixels, every warm `stitch()` equal to the
     cold one, the full blend within the reference's gate of the kernel
     and launching no kernel; and on the reduced scene from identical
     cameras the card's faithful compose against the CPU's (median <= 1,
     >= 99.9% within 4, masks <= 0.5%), the int16 pyramid stages and
     `MultiBandBlenderCV` card == CPU, and from one Registration the float
     canvas blends (multiband on the float pyramids, feather, paste)
     within 1e-3 with equal masks and `compose_panorama` within one step
     on <= 0.1% of values. The phase runs under PyTorch's default flags
     (cuDNN's TF32 on), not the script's.
  16. times: each kernel's time beside its bound, its plain version's and,
     where one PyTorch call computes the same function, that call's; printed
     as a `{"kernels": [...]}` line and a `{"metrics": ...}` line, then the
     card line, then the last line `{"ok": true, "device": {...}}`.

Inputs are random, made from --seed; nothing is read from disk but the
checkout itself and the files the script wrote (registrations, the
producers' views).

    python3 chip_smoke.py --ab DIR   # instead of the phases above

times the staged kernels (mat2, mat, the multiband warp stage's pieces
kernel, feather) and the window-copy probe against other versions of their
sources (one subdirectory of DIR each, e.g. an earlier commit's `csrc/`) in
turns on the product rigs and the probe's origins, each version's output
held equal to the checkout's.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12        # float32 outside the tensor cores

FRAME_HW = (1080, 1920)
PANO_HW = (1280, 7168)
N_CAMS = 5
CSRC = "stitchingvideo_tpu_torch/csrc/"
PALLAS = "stitchingvideo_tpu/ops/pallas/"


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode != 0 or not r.stdout.strip():
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def synthetic_lut(seed: int, poison: bool, frame_hw=FRAME_HW,
                  pano_hw=PANO_HW):
    """bench.py's cylindrical 5-camera 360 LUT, in numpy; with `poison`,
    four tiles span 3 cameras (not representable by two windows)."""
    fh, fw = frame_hw
    pano_h, pano_w = pano_hw
    xx = np.arange(pano_w, dtype=np.float32)[None, :]
    yy = np.arange(pano_h, dtype=np.float32)[:, None]
    theta = (xx / pano_w) * 2 * np.pi - np.pi
    f = pano_w / (2 * np.pi)
    yaw_step = 2 * np.pi / N_CAMS
    cam = np.clip(np.round((theta + np.pi - yaw_step / 2) / yaw_step), 0,
                  N_CAMS - 1).astype(np.int32)
    cam = np.broadcast_to(cam, (pano_h, pano_w)).copy()
    local = theta - (cam * yaw_step - np.pi + yaw_step / 2)
    src_x = np.float32(f) * np.tan(local) + fw / 2
    v = (yy / pano_h - 0.5) * (fh / f * 1.1)
    src_y = np.broadcast_to(np.float32(f) * v / np.cos(local) + fh / 2,
                            (pano_h, pano_w))
    valid = (src_x >= 0) & (src_x < fw - 1) & (src_y >= 0) & (src_y < fh - 1)
    gain = (1.0 + 0.05 * np.sin(xx / 57.0)).astype(np.float32)
    cam = np.where(valid, cam, -1).astype(np.int32)
    if poison:
        rng = np.random.default_rng(seed)
        nty, ntx = pano_h // 8, pano_w // 128
        for ty, tx in zip(rng.integers(nty // 8, nty * 7 // 8, 4),
                          rng.integers(1, ntx - 1, 4)):
            y, x = int(ty) * 8, int(tx) * 128
            c = cam[y, x + 64]
            cam[y:y + 2, x + 10:x + 20] = (c + 1) % N_CAMS
            cam[y + 2:y + 4, x + 20:x + 30] = (c + 2) % N_CAMS
    return (cam, np.broadcast_to(src_x, (pano_h, pano_w)).astype(np.float32),
            np.ascontiguousarray(src_y, np.float32),
            np.broadcast_to(gain, (pano_h, pano_w)).astype(np.float32))


# -- the registration scene ---------------------------------------------------

# the product rig: 5 cameras in a closed 360-degree yaw ring, 72 degrees
# apart, fov 90, at the work scale of a 1920x1080 frame (0.6 megapixels)
REG_CAMS, REG_FOV, REG_OVERLAP, WORK_MEGAPIX = 5, 90.0, 0.2, 0.6
# a texture the views sample near 1:1: 2 pi f columns, pi f rows (f = 516.5
# px a radian at the work scale), with the reference's blob density
REG_TEX_HW, REG_BLOBS = (1624, 3248), 10000
# the reduced scene held card against CPU (the slice tests' sizes and config)
SMALL_SCENE = dict(n=3, img_wh=(320, 240), fov_deg=55.0, overlap_frac=0.4,
                   tex_hw=(768, 2048), blobs=3000)


# a fresh process's first forward-mode derivative, on the card: its seconds
# and the modules it imports
FIRST_FORWARD_AD = """
import json, sys, time, torch
import torch.autograd.forward_ad as fwAD
x = torch.ones(4, device="cuda")
torch.cuda.synchronize()
before = len(sys.modules)
t = time.perf_counter()
with fwAD.dual_level():
    y = fwAD.make_dual(x, torch.ones_like(x)) * torch.ones_like(x)
    fwAD.unpack_dual(y).tangent.sum().item()
print(json.dumps({"s": time.perf_counter() - t,
                  "modules_imported": len(sys.modules) - before}))
"""


def work_wh(frame_hw=FRAME_HW, megapix: float = WORK_MEGAPIX):
    """A frame's (w, h) at the registration's work scale (the reference
    stitcher's `_scale_for`, `models/stitcher.py:87-91`)."""
    h, w = frame_hw
    s = min(1.0, float(np.sqrt(megapix * 1e6 / (w * h))))
    return max(1, round(w * s)), max(1, round(h * s))


def registration_scene(seed: int, device, n=REG_CAMS, img_wh=None,
                       fov_deg=REG_FOV, overlap_frac=REG_OVERLAP,
                       tex_hw=REG_TEX_HW, blobs=REG_BLOBS):
    """(views, K, Rs, focal) of the synthetic ring, rendered by the port's
    `utils/synthetic.py` on `device`."""
    from stitchingvideo_tpu_torch.utils import synthetic as syn
    img_wh = img_wh or work_wh()
    tex = syn.panorama_texture(np.random.default_rng(seed + 7), *tex_hw,
                               blobs=blobs)
    K, Rs, f = syn.yaw_cameras(n, fov_deg, img_wh, overlap_frac, seed=seed)
    return syn.render_views(tex, K, Rs, img_wh, device=device), K, Rs, f


def rotation_errors_deg(R_est, R_true) -> list:
    """Angle (degrees, float64) between each estimated and true relative
    rotation R_a R_b^T, a < b."""
    R_est = np.asarray(R_est, np.float64)
    R_true = np.asarray(R_true, np.float64)
    out = []
    for a in range(len(R_est)):
        for b in range(a + 1, len(R_est)):
            d = (R_est[a] @ R_est[b].T) @ (R_true[a] @ R_true[b].T).T
            sin = np.linalg.norm(d - d.T) / (2 * np.sqrt(2))
            out.append(float(np.degrees(np.arctan2(sin,
                                                   (np.trace(d) - 1) / 2))))
    return out


def feather_registration(seed: int, frame_hw=FRAME_HW, step: int = 1400,
                         width: int = 1588, canvas_h: int = 1600,
                         f_src: float = 1100.0) -> dict:
    """A registration in `Registration.state_dict`'s format, in numpy: 5
    cameras a `step` apart on a cylinder, each seeing `width` canvas columns,
    so neighbours overlap by width - step columns and both feather slots are
    live across each overlap. Every camera owns all it sees (seam mask =
    footprint). Each ROI is 2 * step + (width - step) wide, so that camera i
    reaches the overlap of cameras i+1 and i+2: there a small patch of it is
    valid, and its feather weight beats camera i+2's at that camera's edge,
    which brings a third camera into those tiles (fallback tiles). With the
    runtime's crop (10% top and bottom, 10 px left and right of the extent)
    the defaults give the 1280x7168 panorama."""
    rng = np.random.default_rng(seed)
    fh, fw = frame_hw
    Hr, Wr = canvas_h, step + width
    extent_w = (N_CAMS - 1) * step + width
    canvas_w = -(-extent_w // 64) * 64
    f_pan = N_CAMS * step / (2 * np.pi)          # canvas columns a radian
    xr = np.arange(Wr, dtype=np.float32)[None, :]
    yr = np.arange(Hr, dtype=np.float32)[:, None]
    # the ROI's first `width` columns are the camera's view; the rest is
    # empty but for the patch
    theta = np.where(xr < width, (xr - width / 2) / np.float32(f_pan), 0.0)
    seen = np.broadcast_to(xr < width, (Hr, Wr))
    tan, cos = np.tan(theta), np.cos(theta)
    # vertical field chosen so the footprint stays inside the frame
    v = (yr / Hr - 0.5) * np.float32(0.72 * fh / f_src)
    xmaps, ymaps, valid, gains = [], [], [], []
    for i in range(N_CAMS):
        sx = np.where(seen, np.float32(f_src) * tan + fw / 2
                      + np.float32(rng.uniform(0, 1)), 0.0)
        sy = np.where(seen, np.float32(f_src) * v / cos + fh / 2
                      + np.float32(rng.uniform(0, 1)), 0.0)
        ok = seen & (sx >= 0) & (sx < fw - 1) & (sy >= 0) & (sy < fh - 1)
        if i + 2 < N_CAMS:
            # the patch: 8 rows x 24 columns at the left edge of camera i+2
            y0, x0 = canvas_h // 4 + 96 * i + 3, 2 * step
            patch = (slice(y0, y0 + 8), slice(x0, x0 + 24))
            sx[patch] = fw / 2 + 0.37 * (xr[:, patch[1]] - x0) \
                + 0.11 * (yr[patch[0]] - y0)
            sy[patch] = fh / 2 + 0.53 * (yr[patch[0]] - y0) \
                - 0.07 * (xr[:, patch[1]] - x0)
            ok[patch] = True
        xmaps.append(sx.astype(np.float32))
        ymaps.append(sy.astype(np.float32))
        valid.append(ok)
        gains.append(np.broadcast_to(
            (1.0 + 0.05 * np.sin(xr / (57.0 + i)) + 0.01 * i)
            .astype(np.float32), (Hr, Wr)).copy())
    valid = np.stack(valid)
    R = np.stack([np.eye(3, dtype=np.float32)] * N_CAMS)
    return {
        "focal": np.full(N_CAMS, f_src, np.float32),
        "aspect": np.ones(N_CAMS, np.float32),
        "ppx": np.full(N_CAMS, fw / 2, np.float32),
        "ppy": np.full(N_CAMS, fh / 2, np.float32),
        "R": R, "t": np.zeros((N_CAMS, 3), np.float32),
        "corners": np.asarray([(i * step, 0) for i in range(N_CAMS)],
                              np.int32),
        "valid": valid, "xmaps": np.stack(xmaps), "ymaps": np.stack(ymaps),
        "seam_masks": valid.copy(), "gain_maps": np.stack(gains),
        "canvas_wh": np.asarray((canvas_w, canvas_h)),
        "extent_wh": np.asarray((extent_w, canvas_h)),
        "roi_hw": np.asarray((Hr, Wr)),
        "warp_kind": np.asarray("cylindrical"),
        "warp_scale": np.asarray(float(f_pan)),
        "src_indices": np.arange(N_CAMS),
        "frame_hw": np.asarray(frame_hw, np.int32),
    }


def multiband_registration(seed: int, frame_hw=FRAME_HW, step: int = 1400,
                           width: int = 1588, canvas_h: int = 1600,
                           f_src: float = 1100.0) -> dict:
    """`feather_registration`'s rig with a seam partition: each canvas column
    is owned by the camera whose centre is nearest, so the overlaps are cut
    in the middle and every covered pixel has one owner. In the middle of
    camera 2's share a patch of 16 rows maps three source columns to each
    canvas column: its window tiles overflow the 256-column source window
    (fallback tiles of the warp stage)."""
    d = feather_registration(seed, frame_hw, step, width, canvas_h, f_src)
    fh, fw = frame_hw
    Hr, Wr = (int(v) for v in d["roi_hw"])
    xr = np.arange(Wr, dtype=np.float32)
    centres = np.arange(N_CAMS, dtype=np.float32) * step + width / 2
    seams = []
    for i in range(N_CAMS):
        owner = np.abs((i * step + xr)[:, None] - centres[None]).argmin(1)
        seams.append(d["valid"][i] & (owner == i)[None, :])
    d["seam_masks"] = np.stack(seams)
    pw = min(300, step // 2)
    r0, c0 = Hr // 2 // 8 * 8, width // 2 - pw // 2
    rows, cols = slice(r0, r0 + 16), slice(c0, c0 + pw)
    d["xmaps"][2][rows, cols] = 0.15 * fw + 3.0 * (xr[cols] - c0)[None, :]
    yr = np.arange(16, dtype=np.float32)
    d["ymaps"][2][rows, cols] = fh / 2 + 0.5 * yr[:, None]
    d["valid"][2][rows, cols] = True
    d["seam_masks"][2][rows, cols] = True
    return d


def sector_bytes(torch, taps, frame_hw) -> int:
    """Bytes of one frame set in the 32-byte sectors that the given taps
    read: the distinct (cam, row, column // 32) over every (cam, x0, y0, x1,
    y1) of `taps` (index tensors, second taps already clamped), times 3
    channels (the planes are 32-byte aligned, so each channel reads the same
    sectors)."""
    fh, fw = frame_hw
    if (fh * fw) % 32:
        fail(f"frame planes of {fh}x{fw} bytes are not 32-byte aligned")
    keys = [((cam.long() * fh + y.long()) * fw + x.long()) // 32
            for cam, x0, y0, x1, y1 in taps for y in (y0, y1)
            for x in (x0, x1)]
    return 3 * 32 * int(torch.unique(torch.cat(keys)).numel())


def int_taps(f: dict, frame_hw):
    """(cam, x0, y0, x1, y1) of the kernel pixels of unpacked fields `f`."""
    fh, fw = frame_hw
    kern = f["cam"] >= 0
    x0, y0 = f["x0"][kern], f["y0"][kern]
    return (f["cam"][kern], x0, y0, (x0 + 1).clamp(max=fw - 1),
            (y0 + 1).clamp(max=fh - 1))


def float_taps(m2, cam, sx, sy, frame_hw):
    """(cam, x0, y0, x1, y1) of the float gather at (sx, sy), cam >= 0."""
    live = cam >= 0
    x0, y0, x1, y1, _, _ = m2.bilinear_taps(sx[live], sy[live], *frame_hw)
    return cam[live], x0, y0, x1, y1


def bound(nbytes: float, ops: float):
    """The least time the card could take: (ms, what bounds it)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def mat2_needs(torch, ml, m2) -> dict:
    """What the mat2 function must read for this LUT, for its bound.

    frame_bytes: the sectors its taps touch (kernel pixels and covered
      fallback pixels);
    lut_bytes: the LUT as the kernel reads it: tap_cw of every pixel; tap_xy
      and gc of a kernel pixel; tap_xy and fb_cam of a fallback pixel, and
      fb_sx, fb_sy, fb_gain of a covered one;
    kernel_px, fallback_px: pixels on the integer path and covered pixels on
      the float path."""
    n_kern = int((ml.tap_cw >= 0).sum())
    n_fb_cov = int((ml.fb_cam >= 0).sum())
    taps = [int_taps(ml.fields(), ml.frame_hw),
            float_taps(m2, ml.fb_cam, ml.fb_sx, ml.fb_sy, ml.frame_hw)]
    return {"frame_bytes": sector_bytes(torch, taps, ml.frame_hw),
            "lut_bytes": (4 * ml.tap_cw.numel() + 8 * n_kern
                          + 8 * ml.fb_pix.numel() + 12 * n_fb_cov),
            "kernel_px": n_kern, "fallback_px": n_fb_cov}


def mat2_bound(need: dict, table_bytes: int, pano_px: int, B: int):
    """K1/K2's least time for B frame sets (`need` from `mat2_needs`): each
    input byte the function needs read once, each output written once: the
    frame sectors the taps touch, B times; the LUT as read and the staging
    table; B*3 output planes. ~14 operations a pixel, channel and frame set
    on the integer path (4 int multiplies, 3 adds, convert, 3 float ops,
    round, 2 clamps), ~16 on the float path of a fallback pixel."""
    return bound(B * need["frame_bytes"] + need["lut_bytes"] + table_bytes
                 + B * 3 * pano_px,
                 B * 3 * (14 * need["kernel_px"] + 16 * need["fallback_px"]))


def mat_needs(torch, ml) -> dict:
    """What the mat (K5) function must read for this LUT, for its bound:
    the frame sectors its taps touch; tap_cw of every pixel, tap_xy and gc
    of a kernel pixel."""
    n_kern = int((ml.tap_cw >= 0).sum())
    return {"frame_bytes": sector_bytes(
                torch, [int_taps(ml.fields(), ml.frame_hw)], ml.frame_hw),
            "lut_bytes": 4 * ml.tap_cw.numel() + 8 * n_kern,
            "kernel_px": n_kern}


def mat_bound(need: dict, table_bytes: int, pano_px: int, B: int):
    """K5's least time for B frame sets (`need` from `mat_needs`): the frame
    sectors, B times; the LUT as read and the staging table; B*3 output
    planes; ~14 operations a kernel pixel, channel and frame set."""
    return bound(B * need["frame_bytes"] + need["lut_bytes"] + table_bytes
                 + B * 3 * pano_px, B * 3 * 14 * need["kernel_px"])


def pieces_bound(need: dict, table_bytes: int, npix: int, B: int):
    """The multiband warp stage's least time for B frame sets of `npix`
    window pixels: the frame sectors the taps touch, B times; the state as
    read and the staging table; 2 bytes a value out. Operations as mat2's,
    plus a convert a value."""
    return bound(B * need["frame_bytes"] + need["lut_bytes"] + table_bytes
                 + B * 3 * npix * 2,
                 B * 3 * (15 * need["kernel_px"] + 17 * need["fallback_px"]
                          + 1 * npix))


def feather_needs(torch, m2, ml) -> dict:
    """What the feather function must read for this state, for its bound:
    the frame sectors the taps of both slots touch; the state as the kernel
    reads it (tap_cw of both slots, slot 0's alone on a fallback pixel;
    tap_xy and gw of a live slot; tap_xy and the four fb_* entries of both
    slots of a fallback pixel)."""
    npix = ml.pano_hw[0] * ml.pano_hw[1]
    live = ml.tap_cw >= 0
    n_live = [int(live[s].sum()) for s in range(2)]
    taps = [int_taps(ml.fields(s), ml.frame_hw) for s in range(2)]
    taps += [float_taps(m2, ml.fb_cam[:, s], ml.fb_sx[:, s], ml.fb_sy[:, s],
                        ml.frame_hw) for s in range(2)]
    n_fb = ml.fb_pix.numel()
    return {"frame_bytes": sector_bytes(torch, taps, ml.frame_hw),
            "state_bytes": 8 * npix - 4 * n_fb + 8 * sum(n_live) + 36 * n_fb,
            "live_slot_px": n_live, "fallback_px": n_fb,
            "fallback_live_px": int((ml.fb_cam >= 0).sum()),
            "pano_px": npix}


def feather_bound(need: dict, table_bytes: int, B: int):
    """K4's least time for B frame sets (`need` from `feather_needs`): a
    live slot ~12 operations a channel and frame set, a pixel's tail 4, a
    fallback pixel's live slot ~14; the state as read and the staging
    table."""
    npix = need["pano_px"]
    return bound(B * need["frame_bytes"] + need["state_bytes"] + table_bytes
                 + B * 3 * npix,
                 B * 3 * (12 * sum(need["live_slot_px"]) + 4 * npix
                          + 14 * need["fallback_live_px"]))


def staging_of(C, ml, what: str, library) -> dict:
    """The staging table of a staged kernel's state: rebuilt from the
    state's kernel taps and timed (the part of the state build it costs),
    checked equal to the state's, and printed with its direct-gather blocks,
    stage size and the blocks of the kernel (`library`) an SM holds at that
    stage size, which must be its launch bounds' 6 at any stage within the
    staging budget."""
    torch = C.torch
    fields = [ml.fields(s) for s in range(2)] if hasattr(ml, "gw") else \
        [ml.fields()]
    taps = []
    for f in fields:
        kern = torch.nonzero(f["cam"] >= 0).reshape(-1)
        taps.append((kern, f["cam"][kern], f["x0"][kern], f["y0"][kern]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    table, stage_bytes, n_direct = C.staging_table(taps, ml.pano_hw,
                                                   ml.frame_hw)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    if not torch.equal(table, ml.stage_table) or \
            (stage_bytes, n_direct) != (ml.stage_bytes, ml.n_direct):
        fail(f"{what}: the state's staging table is not its taps' table")
    blocks = table.shape[0]
    per_sm = library.blocks_per_sm(stage_bytes)
    per_sm_at_budget = library.blocks_per_sm(C.STAGE_BUDGET + 16)
    print(f"{what}: staging table of {blocks} blocks built in {build_s:.4f} "
          f"s; {n_direct} direct-gather blocks; {stage_bytes} bytes a stage; "
          f"{per_sm} blocks an SM ({per_sm_at_budget} at the budget's "
          f"{C.STAGE_BUDGET + 16} bytes a stage)", flush=True)
    if per_sm_at_budget < 6:
        fail(f"{what}: {per_sm_at_budget} blocks an SM at the staging "
             "budget, under the launch bounds' 6")
    return {"build_s": build_s, "blocks": blocks, "direct_blocks": n_direct,
            "stage_bytes": stage_bytes, "blocks_per_sm": per_sm,
            "table_bytes": table.numel() * 4}


def event_ms(torch, fn, reps: int, warmup: int = 1,
             queued: bool = False) -> float:
    """Mean device time of fn() over reps calls, by CUDA events. `queued`:
    the card first spins for ~10 ms while the host queues the calls, so
    calls shorter than their host-side issue run back to back and the time
    is the card's, not the host's pace."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)           # cycles: ~10 ms at ~2 GHz
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def latency(torch, fn, n: int) -> dict:
    """Host-clock time of fn() up to the end of its device work."""
    ts = []
    for _ in range(n + 2):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    ts = np.asarray(ts[2:])
    return {"p50_ms": float(np.median(ts)),
            "p95_ms": float(np.percentile(ts, 95)), "n": n}


def p50_p95(a) -> dict:
    """Median and 95th percentile of the values `a` (milliseconds)."""
    a = np.asarray(a)
    return ({"n": int(a.size), "p50_ms": float(np.median(a)),
             "p95_ms": float(np.percentile(a, 95))} if a.size else {"n": 0})


def max_err(a, b) -> int:
    return int((a.int() - b.int()).abs().max())


def chunked(fn, batch, step: int = 8):
    """fn over a batch in chunks (the plain versions hold B-fold temporaries)."""
    import torch
    return torch.cat([fn(batch[b:b + step])
                      for b in range(0, batch.shape[0], step)])


def gather_gate(got_planar, oracle_planar, within: int, what: str,
                oracle: str = "gather oracle"):
    """The reference's tolerance of a seam-select kernel against the exact
    gather: median <= 1 and >= 99.9% within `within`."""
    diff = (got_planar.int() - oracle_planar.int()).abs()
    med = float(diff.float().median())
    share = float((diff <= within).float().mean())
    print(f"{what} vs {oracle}: median |diff| {med}, within {within}: "
          f"{share:.6f}", flush=True)
    if med > 1 or share < 0.999:
        fail(f"{what} misses its tolerance against the {oracle}")


def launched(counts: dict) -> dict:
    """The kernels of `counts` that were launched, for printing."""
    return {k: n for k, n in counts.items() if n}


def kernel_row(kernel, source, replaces, launches, err, ms, plain_ms,
               bound_ms, bound_by, library_ms, replaces_in=PALLAS,
               **extra) -> dict:
    if launches < 1:
        fail(f"the main path never launched {kernel.name}")
    if err:
        fail(f"{kernel.name} != its plain version, max |diff| {err}")
    return {"name": kernel.name, "route": "cuda", "source": CSRC + source,
            "replaces": replaces_in + replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, **extra}


def video_cfg(C, **video):
    cfg = C.StitchConfig()
    return cfg.replace(video=dataclasses.replace(cfg.video, **video))


# -- mat2 (kernel='auto') and the band-shift copy ---------------------------

def phase_mat2(C):
    torch, m2, dev = C.torch, C.m2, C.dev
    planar32, frames, frames_d = C.planar32, C.frames, C.frames_d
    lut = C.CompositeLUT(*(torch.from_numpy(a)
                           for a in synthetic_lut(C.seed, poison=True)))
    vs = C.VideoStitcher()
    t0 = time.perf_counter()
    vs.install_lut(lut, FRAME_HW)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    if vs._tlut is None or vs._tlut[0] != "mat2":
        fail(f"kernel='auto' built {vs._tlut and vs._tlut[0]}, not mat2")
    ml = vs._tlut[1]
    n_kernel_px = int((ml.tap_cw >= 0).sum())
    print(f"mat2: install_lut {install_s:.3f} s; pano {ml.pano_hw}, "
          f"{ml.n_fallback} fallback tiles ({ml.fb_pix.numel()} px), "
          f"{n_kernel_px} kernel px", flush=True)
    if ml.n_fallback == 0:
        fail("the poisoned tiles did not become fallback tiles")
    staging = staging_of(C, ml, "mat2", C.cuda.COMPOSITE_MAT2)

    C.reset_counts()
    pano1 = vs.composite(frames)
    out16 = vs.composite_microbatch(planar32[:16])
    out32 = vs.composite_microbatch(planar32)
    torch.cuda.synchronize()
    launches = C.read_counts()
    print(f"mat2 main path launches: {launched(launches)}", flush=True)

    planar1 = C.frames_to_planar_i8(frames_d)
    plain1 = m2.composite_mat2_plain(planar1[None], ml)[0]
    got1 = torch.from_numpy(pano1).to(dev).permute(2, 0, 1)
    err = {"single": max_err(got1, plain1)}
    oracle = C.composite_frame_u8(frames_d, vs._lut).permute(2, 0, 1)
    gather_gate(got1, oracle, 4, "mat2")
    fb = ml.fb_pix
    if not torch.equal(got1.reshape(3, -1)[:, fb],
                       oracle.reshape(3, -1)[:, fb]):
        fail("fallback tiles are not bit-exact against the gather oracle")
    plain32 = chunked(lambda p: m2.composite_mat2_plain(p, ml), planar32)
    err["batched"] = max_err(out32, plain32)
    del plain32
    if not torch.equal(out16, out32[:16]):
        fail("B=16 and B=32 outputs differ on the same frame sets")
    for b in (0, 31):
        if not torch.equal(m2.composite_mat2_planar(planar32[b], ml),
                           out32[b]):
            fail(f"batched output {b} differs from the single-frame output")
    if not torch.equal(C.planar_to_hwc(got1).cpu(), torch.from_numpy(pano1)):
        fail("planar_to_hwc round trip")
    del out16, out32

    # the band-shift copy, through its own entry point
    planar16 = planar32[:16].contiguous()
    C.reset_counts()
    shifted = m2.shift_planar_bn(planar16)
    torch.cuda.synchronize()
    launches[m2.SHIFT_BN.name] = m2.SHIFT_BN.launches
    err["shift"] = max_err(shifted, m2.shift_planar_bn_plain(planar16))
    del shifted

    # times: the wrappers as the main path calls them
    Hp, Wp = ml.pano_hw
    npix = Hp * Wp
    need = mat2_needs(torch, ml, m2)
    print(f"mat2 reads {need['frame_bytes']} of "
          f"{N_CAMS * 3 * FRAME_HW[0] * FRAME_HW[1]} frame bytes a frame set "
          f"(the sectors its taps touch) and {need['lut_bytes']} LUT bytes",
          flush=True)

    rows = []
    for k, B, tpu_line, fn in (
            (m2.MAT2_SINGLE, 1, 388,
             lambda: m2.composite_mat2_planar(planar32[0], ml)),
            (m2.MAT2_BATCHED, 16, 624,
             lambda: m2.composite_mat2_planar_batched(planar32[:16], ml))):
        planar = planar32[:B]
        rows.append(kernel_row(
            k, "composite_mat2.cu", f"composite_mat2.py:{tpu_line}",
            launches[k.name], err["single" if B == 1 else "batched"],
            event_ms(torch, fn, reps=10, warmup=2),
            event_ms(torch, lambda: m2.composite_mat2_plain(planar, ml),
                     reps=2, warmup=1),
            *mat2_bound(need, staging["table_bytes"], npix, B),
            # no one PyTorch call computes the integer-weight gather
            library_ms=None, batch=B, direct_blocks=staging["direct_blocks"],
            stage_bytes=staging["stage_bytes"],
            blocks_per_sm=staging["blocks_per_sm"]))
    ms32 = event_ms(torch,
                    lambda: m2.composite_mat2_planar_batched(planar32, ml),
                    reps=5, warmup=1)

    def library_shift():
        tb = planar16.transpose(0, 1)
        return torch.stack([torch.nn.functional.pad(tb[..., s:], (0, s))
                            for s in range(0, 32 * m2.N_SHIFTS, 32)])

    rows.append(kernel_row(
        m2.SHIFT_BN, "shift_planar_bn.cu", "composite_mat2.py:869",
        launches[m2.SHIFT_BN.name], err["shift"],
        event_ms(torch, lambda: m2.shift_planar_bn(planar16), reps=10,
                 warmup=2),
        event_ms(torch, lambda: m2.shift_planar_bn_plain(planar16), reps=3),
        planar16.numel() * (1 + m2.N_SHIFTS) / HBM_BYTES_PER_S * 1e3, "bytes",
        library_ms=event_ms(torch, library_shift, reps=3),
        batch=16, path="shift_planar_bn"))

    fps, call = {}, {}
    for B in (16, 32):
        planar = planar32[:B]
        # a micro-batch call's device time against the host's time to issue
        # it (the kernel's own time is in the rows above)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(10):
            vs.composite_microbatch(planar)
        issue_ms = (time.perf_counter() - t) / 10 * 1e3
        ms = event_ms(torch, lambda: vs.composite_microbatch(planar), reps=10,
                      warmup=2)
        fps[f"b{B}"] = B / (ms / 1e3)
        call[f"b{B}"] = {"call_ms": ms, "host_issue_ms": issue_ms}
    metrics = {
        "fps_microbatch": fps, "microbatch_call": call,
        "b1_latency_host": latency(torch, lambda: vs.composite(frames), 20),
        "b1_latency_device": latency(
            torch, lambda: vs.composite_planar(frames_d), 20),
        "mat2_kernel_ms_b32": ms32, "mat2_bound_ms_b32":
        mat2_bound(need, staging["table_bytes"], npix, 32)[0],
        "mat2_needs": need, "install_lut_s": install_s, "staging": staging,
    }
    print("mat2: kernel outputs bit-exact against plain versions, batched "
          "== single; shift_planar_bn bit-exact", flush=True)
    return rows, metrics


# -- mat (kernel='mat') ------------------------------------------------------

def phase_mat(C):
    torch, m2, mat, dev = C.torch, C.m2, C.mat, C.dev
    planar16, frames, frames_d = C.planar32[:16], C.frames, C.frames_d
    vs = C.VideoStitcher(video_cfg(C, kernel="mat"))
    t0 = time.perf_counter()
    vs.install_lut(C.clean_lut, FRAME_HW)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    if vs._tlut is None or vs._tlut[0] != "mat":
        fail(f"kernel='mat' built {vs._tlut and vs._tlut[0]}, not mat")
    ml = vs._tlut[1]
    staging = staging_of(C, ml, "mat", C.cuda.COMPOSITE_MAT)

    C.reset_counts()
    pano1 = vs.composite(frames)
    out16 = vs.composite_microbatch(planar16)
    torch.cuda.synchronize()
    launches = C.read_counts()
    print(f"mat main path launches: {launched(launches)}", flush=True)

    planar1 = C.frames_to_planar_i8(frames_d)
    got1 = torch.from_numpy(pano1).to(dev).permute(2, 0, 1)
    err1 = max_err(got1, mat.composite_mat_plain(planar1[None], ml)[0])
    err16 = max_err(out16, chunked(lambda p: mat.composite_mat_plain(p, ml),
                                   planar16))
    for b in (0, 15):
        if not torch.equal(mat.composite_mat_planar(planar16[b], ml),
                           out16[b]):
            fail(f"mat batched output {b} differs from the single-frame one")
    # without fallback tiles, mat and mat2 are one function, and their
    # kernel pixels tap the same source pixels: the same staging table
    ml2 = m2.build_mat2_lut(vs._lut, FRAME_HW)
    if not torch.equal(m2.composite_mat2_planar(planar1, ml2), got1) or \
            not torch.equal(m2.composite_mat2_planar_batched(planar16, ml2),
                            out16):
        fail("mat output differs from mat2 output on the same LUT")
    if not torch.equal(ml.stage_table, ml2.stage_table) or \
            (ml.stage_bytes, ml.n_direct) != (ml2.stage_bytes, ml2.n_direct):
        fail("mat's staging table differs from mat2's on the same LUT")
    del ml2, out16
    oracle = C.composite_frame_u8(frames_d, vs._lut).permute(2, 0, 1)
    gather_gate(got1, oracle, 4, "mat")

    need = mat_needs(torch, ml)
    npix = ml.pano_hw[0] * ml.pano_hw[1]
    rows = []
    for k, B, err, fn in (
            (mat.MAT_SINGLE, 1, err1,
             lambda: mat.composite_mat_planar(planar16[0], ml)),
            (mat.MAT_BATCHED, 16, err16,
             lambda: mat.composite_mat_planar_batched(planar16, ml))):
        planar = planar16[:B]
        rows.append(kernel_row(
            k, "composite_mat2.cu", "composite_mat.py:150", launches[k.name],
            err, event_ms(torch, fn, reps=10, warmup=2),
            event_ms(torch, lambda: mat.composite_mat_plain(planar, ml),
                     reps=2, warmup=1),
            *mat_bound(need, staging["table_bytes"], npix, B),
            # no one PyTorch call computes the integer-weight gather
            library_ms=None, batch=B, direct_blocks=staging["direct_blocks"],
            stage_bytes=staging["stage_bytes"],
            blocks_per_sm=staging["blocks_per_sm"]))
    ms16 = event_ms(torch, lambda: vs.composite_microbatch(planar16), reps=10,
                    warmup=2)
    metrics = {
        "fps_microbatch_b16": 16 / (ms16 / 1e3),
        "b1_latency_device": latency(
            torch, lambda: vs.composite_planar(frames_d), 20),
        "install_lut_s": install_s, "staging": staging,
        "needs": need,
    }
    print("mat: kernel outputs bit-exact against the plain version and "
          "against mat2, batched == single; staging table == mat2's",
          flush=True)
    return rows, metrics


# -- tiled (kernel='tiled') --------------------------------------------------

def phase_tiled(C):
    torch, tiled, dev = C.torch, C.tiled, C.dev
    frames, frames_d = C.frames, C.frames_d
    vs = C.VideoStitcher(video_cfg(C, kernel="tiled"))
    t0 = time.perf_counter()
    vs.install_lut(C.clean_lut, FRAME_HW)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    if vs._tlut is None or vs._tlut[0] != "tiled":
        fail(f"kernel='tiled' built {vs._tlut and vs._tlut[0]}, not tiled")
    tl = vs._tlut[1]

    C.reset_counts()
    pano1 = vs.composite(frames)
    torch.cuda.synchronize()
    launches = C.read_counts()
    print(f"tiled main path launches: {launched(launches)}", flush=True)

    planar_u8 = frames_d.permute(0, 3, 1, 2).contiguous()
    got1 = torch.from_numpy(pano1).to(dev)
    err1 = max_err(got1, tiled.composite_tiled_plain(planar_u8, tl))
    oracle = C.composite_frame_u8(frames_d, vs._lut)
    diff = (got1.int() - oracle.int()).abs().float()
    med, mean = float(diff.median()), float(diff.mean())
    within3 = float((diff <= 3).float().mean())
    print(f"tiled vs gather oracle: median |diff| {med}, mean {mean:.4f}, "
          f"within 3: {within3:.6f}", flush=True)
    if med > 1 or mean >= 1.0 or within3 <= 0.999:
        fail("tiled misses the gather oracle's tolerance")
    del oracle, diff

    # remap_tiled: one frame through one camera's map is composite_tiled on
    # that one-camera LUT
    lut = vs._lut
    own = lut.cam_idx == 2
    zero, minus = torch.zeros((), device=dev), torch.full((), -1.0, device=dev)
    xmap = torch.where(own, lut.src_x, minus)
    ymap = torch.where(own, lut.src_y, minus)
    before = tiled.TILED.launches
    warped = C.remap_tiled(frames_d[2], xmap, ymap)
    if warped is None or tiled.TILED.launches != before + 1:
        fail("remap_tiled did not go through the tiled kernel")
    one = C.CompositeLUT(cam_idx=torch.where(own, 0, -1).to(torch.int32),
                         src_x=torch.where(own, lut.src_x, zero),
                         src_y=torch.where(own, lut.src_y, zero),
                         gain=torch.ones_like(lut.gain))
    one_tl = tiled.build_tiled_lut(one, FRAME_HW)
    if not torch.equal(warped, tiled.composite_tiled(frames_d[2:3], one_tl)) \
            or not torch.equal(warped, tiled.composite_tiled_plain(
                planar_u8[2:3].contiguous(), one_tl)):
        fail("remap_tiled differs from composite_tiled on the one-camera LUT")
    if int(warped[own].int().sum()) == 0 or int(warped[~own].int().sum()):
        fail("remap_tiled: empty inside the map or not 0 outside it")
    # a yardstick that the port never calls: grid_sample warps one image
    # through one map, as remap_tiled does, but with float32 weights on a
    # float32 image; held to the tiled kernel's tolerance against the gather
    F = torch.nn.functional
    image = frames_d[2].permute(2, 0, 1)[None].float()
    grid = torch.stack([xmap * (2.0 / (FRAME_HW[1] - 1)) - 1.0,
                        ymap * (2.0 / (FRAME_HW[0] - 1)) - 1.0], dim=-1)[None]

    def sample():
        return F.grid_sample(image, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    lib = torch.round(sample()[0]).clamp(0, 255).to(torch.uint8)
    gather_gate(warped.permute(2, 0, 1)[:, own], lib[:, own], 3,
                "remap_tiled", oracle="grid_sample")
    remap_ms = event_ms(torch, lambda: C.remap_tiled(frames_d[2], xmap, ymap),
                        reps=10, warmup=2)
    image_u8 = planar_u8[2:3].contiguous()
    remap_kernel_ms = event_ms(
        torch, lambda: tiled.composite_tiled_planar(image_u8, one_tl),
        reps=10, warmup=2)
    sample_ms = event_ms(torch, sample, reps=10, warmup=2)
    del warped, one, one_tl, image, image_u8, grid, lib

    Hp, Wp = tl.pano_hw
    covered = tl.cidx >= 0
    n_cov = int(covered.sum())
    x0 = torch.floor(tl.sx[covered]).long()
    y0 = torch.floor(tl.sy[covered]).long()
    frame_bytes = sector_bytes(
        torch, [(tl.cidx[covered], x0, y0,
                 (x0 + 1).clamp(max=FRAME_HW[1] - 1),
                 (y0 + 1).clamp(max=FRAME_HW[0] - 1))], FRAME_HW)
    # cidx of every tile pixel; sx, sy, gain of a covered one
    lut_bytes = 4 * tl.cidx.numel() + 12 * n_cov
    # a pixel: ~20 operations for its four hats, then a channel ~17 (4
    # converts, 7 multiplies, 3 adds, round, 2 clamps)
    bound_ms, bound_by = bound(frame_bytes + lut_bytes + 3 * Hp * Wp,
                               n_cov * (20 + 3 * 17))
    rows = [kernel_row(
        tiled.TILED, "composite_tiled.cu", "composite.py:173",
        launches[tiled.TILED.name], err1,
        event_ms(torch, lambda: tiled.composite_tiled_planar(planar_u8, tl),
                 reps=10, warmup=2),
        event_ms(torch, lambda: tiled.composite_tiled_plain(planar_u8, tl),
                 reps=2, warmup=1),
        bound_ms, bound_by,
        # grid_sample interpolates one image with float32 weights; no one
        # PyTorch call selects a camera per pixel with bfloat16 x-weights
        library_ms=None, batch=1)]
    metrics = {
        "b1_latency_device": latency(
            torch, lambda: vs.composite_planar(frames_d), 20),
        "install_lut_s": install_s,
        # remap_tiled builds its one-camera tile LUT in every call; the
        # kernel time is its launch on that LUT, the grid_sample time that
        # one call on prepared float32 inputs
        "remap_tiled_call_ms": remap_ms,
        "remap_tiled_kernel_ms": remap_kernel_ms,
        "remap_grid_sample_ms": sample_ms,
        "needs": {"frame_bytes": frame_bytes, "lut_bytes": lut_bytes,
                  "covered_px": n_cov},
    }
    print("tiled: kernel output bit-exact against the plain version; "
          "remap_tiled == composite_tiled", flush=True)
    return rows, metrics


def save_and_load(vs, state: dict) -> float:
    """Write `state` as the registration `.npz` and load it: seconds."""
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "registration.npz")
        with open(path, "wb") as f:
            np.savez(f, **state)
        t0 = time.perf_counter()
        vs.load_registration(path)
        if vs.device.type == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - t0


# -- feather (compose_mode='feather') ----------------------------------------

def phase_feather(C):
    torch, m2, fe, dev = C.torch, C.m2, C.fe, C.dev
    planar16, frames, frames_d = C.planar32[:16], C.frames, C.frames_d
    t0 = time.perf_counter()
    state = feather_registration(C.seed)
    rig_s = time.perf_counter() - t0
    vs = C.VideoStitcher(video_cfg(C, compose_mode="feather"))
    load_s = save_and_load(vs, state)
    del state
    if vs._ftlut is None or vs._ftlut[0] != "fmat" or vs._tlut is not None:
        fail("compose_mode='feather' did not build the feather state alone")
    ml = vs._ftlut[1]
    if ml.pano_hw != PANO_HW:
        fail(f"feather panorama is {ml.pano_hw}, not {PANO_HW}")
    t0 = time.perf_counter()
    vs._build_feather(vs._reg, FRAME_HW, vs._out_shape)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    npix = PANO_HW[0] * PANO_HW[1]
    live = ml.tap_cw >= 0
    n_live = [int(live[s].sum()) for s in range(2)]
    two_slot = float((live[0] & live[1]).float().mean())
    fb_share = ml.fb_pix.numel() / npix
    print(f"feather: rig {rig_s:.2f} s; load_registration {load_s:.3f} s; "
          f"build_feather_state {build_s:.3f} s; pano {ml.pano_hw}; two-slot "
          f"pixels {two_slot:.6f}; fallback tiles {ml.n_fallback} "
          f"({fb_share:.6f} of the pixels)", flush=True)
    if two_slot == 0 or fb_share == 0:
        fail("the feather rig has no two-slot pixels or no fallback tiles")
    staging = staging_of(C, ml, "feather", C.cuda.COMPOSITE_FEATHER)

    C.reset_counts()
    pano1 = vs.composite(frames)
    planar_out = vs.composite_feather_planar(frames_d)
    out16 = vs.composite_microbatch(planar16)
    torch.cuda.synchronize()
    launches = C.read_counts()
    print(f"feather main path launches: {launched(launches)}", flush=True)

    planar1 = C.frames_to_planar_i8(frames_d)
    got1 = torch.from_numpy(pano1).to(dev).permute(2, 0, 1)
    if not torch.equal(got1, planar_out):
        fail("composite and composite_feather_planar differ")
    err1 = max_err(got1, fe.composite_feather_plain(planar1[None], ml)[0])
    err16 = max_err(out16, chunked(
        lambda p: fe.composite_feather_plain(p, ml), planar16, step=4))
    for b in (0, 15):
        if not torch.equal(fe.composite_feather_planar(planar16[b], ml),
                           out16[b]):
            fail(f"feather batched output {b} differs from the single one")
    del out16, planar_out
    # the exact dual gather, with the reference's gates
    blut = vs._blend_lut(vs._reg, vs._out_shape)
    oracle = torch.round(fe.composite_blend_gather(frames_d, blut)) \
        .clamp(0, 255).to(torch.uint8).permute(2, 0, 1)
    diff = (got1.int() - oracle.int()).abs()
    med, worst = float(diff.float().median()), int(diff.max())
    fb_worst = int(diff.reshape(3, -1)[:, ml.fb_pix].max())
    print(f"feather vs dual-gather oracle: median |diff| {med}, max {worst}, "
          f"max on fallback tiles {fb_worst}", flush=True)
    if med != 0 or worst > 3 or fb_worst > 1:
        fail("feather misses the dual-gather oracle's gates")
    del blut, oracle, diff

    need = feather_needs(torch, m2, ml)
    rows = []
    for k, B, err, fn in (
            (fe.FEATHER_SINGLE, 1, err1,
             lambda: fe.composite_feather_planar(planar16[0], ml)),
            (fe.FEATHER_BATCHED, 16, err16,
             lambda: fe.composite_feather_planar_batched(planar16, ml))):
        planar = planar16[:B]
        rows.append(kernel_row(
            k, "composite_feather.cu", "composite_feather.py:354",
            launches[k.name], err, event_ms(torch, fn, reps=10, warmup=2),
            event_ms(torch, lambda: fe.composite_feather_plain(planar, ml),
                     reps=2, warmup=1),
            *feather_bound(need, staging["table_bytes"], B),
            # no one PyTorch call computes the dual integer-weight gather
            library_ms=None, batch=B, direct_blocks=staging["direct_blocks"],
            stage_bytes=staging["stage_bytes"],
            blocks_per_sm=staging["blocks_per_sm"]))
    ms16 = event_ms(torch, lambda: vs.composite_microbatch(planar16), reps=10,
                    warmup=2)
    metrics = {
        "fps_microbatch_b16": 16 / (ms16 / 1e3), "microbatch_call_ms": ms16,
        "b1_latency_host": latency(torch, lambda: vs.composite(frames), 10),
        "b1_latency_device": latency(
            torch, lambda: vs.composite_feather_planar(frames_d), 20),
        "build_feather_state_s": build_s, "load_registration_s": load_s,
        "two_slot_share": two_slot, "fallback_share": fb_share,
        "fallback_tiles": ml.n_fallback, "staging": staging,
        "needs": need,
    }
    print("feather: kernel outputs bit-exact against the plain version, "
          "batched == single", flush=True)
    return rows, metrics


# -- multiband (compose_mode='multiband') ------------------------------------

def phase_multiband(C):
    torch, m2, mb, dev = C.torch, C.m2, C.mb, C.dev
    planar8, frames, frames_d = C.planar32[:8], C.frames, C.frames_d
    cfg = video_cfg(C, compose_mode="multiband")
    vs = C.VideoStitcher(cfg)
    load_s = save_and_load(vs, multiband_registration(C.seed))
    if vs._mbtlut is None or vs._tlut is not None:
        fail("compose_mode='multiband' did not build the multiband state "
             "alone")
    t0 = time.perf_counter()
    vs.build_multiband_state(FRAME_HW)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    st, crop_yx = vs._mbtlut
    ml = st.warp_lut
    Nv = len(st.piece_cam)
    win = st.buf_hw[0] * st.buf_hw[1]
    npix = Nv * win
    uncovered = float((ml.tap_cw == m2.UNCOVERED).float().mean())
    print(f"multiband: load_registration {load_s:.3f} s; state rebuild "
          f"{build_s:.3f} s; {st.bands} bands, canvas {st.canvas_hw}, {Nv} "
          f"windows of {st.buf_hw} at x = {st.piece_ax}, out {st.out_hw}; "
          f"{ml.n_fallback} fallback tiles ({ml.fb_pix.numel()} px); "
          f"uncovered share of the window stack {uncovered:.4f}", flush=True)
    if st.out_hw != PANO_HW or st.bands != 7 or Nv != N_CAMS:
        fail(f"multiband state is {st.bands} bands, {Nv} windows, out "
             f"{st.out_hw}: not the product size")
    if ml.n_fallback == 0:
        fail("the curvature patch did not become fallback tiles")
    staging = staging_of(C, ml, "pieces", C.cuda.COMPOSITE_MAT2_PIECES)

    # -- the main path, counted
    planar1 = C.frames_to_planar_i8(frames_d)
    C.reset_counts()
    pano1 = vs.composite(frames)
    out1 = mb.multiband_video_frame(planar1, st, crop_yx)
    torch.cuda.synchronize()
    launches1 = C.read_counts()
    C.reset_counts()
    out8 = mb.multiband_video_frames_batched(planar8, st, crop_yx)
    torch.cuda.synchronize()
    launches8 = C.read_counts()
    # the single-frame-set entry point of the warp stage, on its own (the
    # main path goes through the batched one at B=1, as the reference's does)
    C.reset_counts()
    x_single = m2.composite_mat2_planar_pieces(planar1, ml, Nv)
    torch.cuda.synchronize()
    launches_single = C.read_counts()
    print(f"multiband main path launches: composite + frame "
          f"{launched(launches1)}; batched B=8 {launched(launches8)}",
          flush=True)
    if tuple(out8.shape) != (8, 3) + PANO_HW or out8.dtype != torch.uint8:
        fail(f"multiband output is {tuple(out8.shape)} {out8.dtype}")
    if not torch.equal(torch.from_numpy(pano1).to(dev).permute(2, 0, 1), out1):
        fail("composite and multiband_video_frame differ")

    # -- gate 1: the warp kernel against its plain version
    x1 = m2.composite_mat2_planar_pieces_batched(planar1[None], ml, Nv)
    x8 = m2.composite_mat2_planar_pieces_batched(planar8, ml, Nv)
    plain8 = chunked(lambda p: m2.composite_mat2_pieces_plain(p, ml, Nv),
                     planar8, step=2)
    err1 = float((x1[0].float() - m2.composite_mat2_pieces_plain(
        planar1[None], ml, Nv)[0].float()).abs().max())
    err8 = float((x8.float() - plain8.float()).abs().max())
    err_single = float((x_single.float() - x1[0].float()).abs().max())
    for b in range(8):
        if not torch.equal(m2.composite_mat2_planar_pieces(planar8[b], ml, Nv),
                           x8[b]):
            fail(f"warp stage: batched output {b} differs from the single "
                 "one")
    fb_vals = x8.transpose(1, 2).reshape(8, 3, npix)[:, :, ml.fb_pix]
    if float(fb_vals.float().max()) == 0:
        fail("the fallback tiles of the warp stage are empty")
    del fb_vals, x1, x_single
    # -- gate 2: the blended panorama with the kernel == the same chain fed
    # by the plain warp
    if not torch.equal(mb.multiband_blend_windows(plain8, st, crop_yx), out8):
        fail("multiband output with the kernel differs from the chain fed "
             "by the plain warp")
    del plain8
    # -- gate 3: batched == single, every frame set
    for b in range(8):
        if not torch.equal(mb.multiband_video_frame(planar8[b], st, crop_yx),
                           out8[b]):
            fail(f"multiband batched output {b} differs from the single one")
    # far from the seams a Laplacian blend gives the seam composite back, up
    # to the bfloat16 storage of the pyramid levels
    oracle = C.composite_frame_u8(frames_d, vs._lut).permute(2, 0, 1)
    diff = (out1.int() - oracle.int()).abs().float()
    seam_med, seam_within8 = float(diff.median()), float((diff <= 8).float()
                                                         .mean())
    covered = float((out1 > 0).float().mean())
    print(f"multiband vs seam-select gather: median |diff| {seam_med}, "
          f"within 8: {seam_within8:.4f}; non-zero share {covered:.4f}",
          flush=True)
    if covered < 0.9 or seam_med > 3:
        fail("the multiband panorama is empty or far from the seam composite")
    del oracle, diff

    # -- times
    need = mat2_needs(torch, ml, m2)
    rows = []
    for k, B, n_launch, err, path, fn in (
            (m2.PIECES_BATCHED, 1, launches1[m2.PIECES_BATCHED.name], err1,
             "composite, multiband_video_frame",
             lambda: m2.composite_mat2_planar_pieces_batched(planar1[None],
                                                             ml, Nv)),
            (m2.PIECES_BATCHED, 8, launches8[m2.PIECES_BATCHED.name], err8,
             "multiband_video_frames_batched",
             lambda: m2.composite_mat2_planar_pieces_batched(planar8, ml,
                                                             Nv)),
            (m2.PIECES_SINGLE, 1, launches_single[m2.PIECES_SINGLE.name],
             err_single, "composite_mat2_planar_pieces (own entry point)",
             lambda: m2.composite_mat2_planar_pieces(planar1, ml, Nv))):
        planar = planar8[:B]
        rows.append(kernel_row(
            k, "composite_mat2.cu",
            "composite_mat2.py:" + ("986" if k is m2.PIECES_SINGLE
                                    else "1029"),
            n_launch, err, event_ms(torch, fn, reps=10, warmup=2),
            event_ms(torch, lambda: m2.composite_mat2_pieces_plain(
                planar, ml, Nv), reps=1, warmup=1),
            *pieces_bound(need, staging["table_bytes"], npix, B),
            # no one PyTorch call computes the integer-weight gather
            library_ms=None, batch=B, path=path,
            direct_blocks=staging["direct_blocks"],
            stage_bytes=staging["stage_bytes"],
            blocks_per_sm=staging["blocks_per_sm"]))
    zero_ms = event_ms(torch, x8.zero_, reps=10, warmup=2)
    del x8

    def stage_split(planar):
        marks = [("start", torch.cuda.Event(enable_timing=True))]
        marks[0][1].record()

        def on_stage(name):
            marks.append((name, torch.cuda.Event(enable_timing=True)))
            marks[-1][1].record()

        mb.multiband_video_frames_batched(planar, st, crop_yx, on_stage)
        torch.cuda.synchronize()
        return {name: a.elapsed_time(b) for (_, a), (name, b)
                in zip(marks, marks[1:])}

    stage_split(planar8)
    split8 = stage_split(planar8)
    ms8 = event_ms(torch, lambda: mb.multiband_video_frames_batched(
        planar8, st, crop_yx), reps=3, warmup=1)
    metrics = {
        "fps_batched_b8": 8 / (ms8 / 1e3), "batched_call_ms_b8": ms8,
        "stage_ms_b8": split8,
        "b1_latency_host": latency(torch, lambda: vs.composite(frames), 10),
        "b1_latency_device": latency(
            torch, lambda: mb.multiband_video_frame(planar1, st, crop_yx), 20),
        "load_registration_s": load_s, "build_multiband_state_s": build_s,
        "zero_fill_ms_b8": zero_ms, "uncovered_share": uncovered,
        "staging": staging,
        "fallback_tiles": ml.n_fallback, "windows": Nv,
        "window_hw": list(st.buf_hw), "bands": st.bands,
        "vs_seam_select": {"median": seam_med, "within8": seam_within8},
        "needs": need,
    }
    del out1, out8, vs, st, ml

    # -- gate 4: a reduced registration, the card against the same code on
    # the CPU, within the tolerance of tests/test_torch_multiband.py (median
    # 0, <= 1 step on <= 1% of values, none above 2)
    small_hw = (128, 512)
    small = multiband_registration(C.seed, small_hw, step=200, width=260,
                                   canvas_h=128, f_src=150.0)
    rng = np.random.default_rng(C.seed + 4)
    worst, share = 0, 0.0
    pair = [C.VideoStitcher(cfg, device=d) for d in ("cuda", "cpu")]
    for v in pair:
        save_and_load(v, small)
    for _ in range(2):
        fs = list(rng.integers(0, 256, (N_CAMS,) + small_hw + (3,),
                               dtype=np.uint8))
        got, want = (v.composite(fs).astype(np.int16) for v in pair)
        d = np.abs(got - want)
        worst, share = max(worst, int(d.max())), max(share,
                                                     float((d > 0).mean()))
        if np.median(d) != 0 or (got > 0).mean() < 0.5:
            fail("reduced multiband panorama: empty or median |diff| != 0")
    print(f"multiband, reduced registration, card vs CPU: max |diff| {worst}, "
          f"differing share {share:.6f}", flush=True)
    if worst > 2 or share > 0.01:
        fail("the card's multiband panorama misses the CPU's tolerance")
    metrics["card_vs_cpu"] = {"max_abs_diff": worst, "differing_share": share}
    print("multiband: warp kernel bit-exact against its plain version, "
          "batched == single, kernel chain == plain-warp chain", flush=True)
    return rows, metrics


# -- the window-copy probe ----------------------------------------------------

PROBE_ALIGNS = (128, 32, 16, 8, 4, 2, 1)
PROBE_HW = (1088, 1920)          # the TPU probe's frame
PROBE_WINDOWS = 512              # the TPU probe's call
PROBE_MANY = 16384               # windows of a call long enough for the rate
PROBE_HBM_H = 17408              # [3, 17408, 1920]: 100 MB, twice the L2
PROBE_SAMPLE = 1024              # windows of the HBM case held to the plain


def probe_origins(torch, rng, n: int, hw, align: int, dev):
    """n window origins (oy, ox) in a frame of hw, rows multiples of 8 and
    columns multiples of `align`, as the TPU probe draws them."""
    H, W = hw
    oy = rng.integers(0, (H - 32) // 8, n) * 8
    ox = rng.integers(0, (W - 256) // align, n) * align
    return torch.from_numpy(np.stack([oy, ox], 1).astype(np.int32)).to(dev)


def probe_frames(C):
    """The probe's frames, drawn from the whole int8 range: the TPU probe's
    3 x 1088 x 1920 (the L2 holds it) and one of 3 x 17408 x 1920 (twice
    the L2), and the generator of their origins."""
    torch = C.torch
    rng = np.random.default_rng(C.seed + 3)
    frame = torch.from_numpy(rng.integers(-128, 128, (3,) + PROBE_HW,
                                          dtype=np.int8)).to(C.dev)
    gen = torch.Generator(device=C.dev).manual_seed(C.seed + 4)
    big = torch.randint(-128, 128, (3, PROBE_HBM_H, PROBE_HW[1]),
                        dtype=torch.int8, device=C.dev, generator=gen)
    return frame, big, rng


def probe_bound(torch, wp, org, hw, nout: int):
    """(bytes, ms, what bounds it): every distinct frame byte under a window
    once, the origins, the sums; one add a window byte."""
    touched = torch.zeros(hw, dtype=torch.bool, device=org.device)
    touched[wp.window_index(org)] = True
    nbytes = 3 * int(touched.sum()) + org.numel() * 4 + nout * 4
    return (nbytes, *bound(nbytes, org.shape[0] * 3 * wp.WIN_H * wp.WIN_W))


def probe_case(torch, wp, frame, org, align: int, reps: int) -> dict:
    """One size of the probe: its time, window rate and byte bound."""
    ms = event_ms(torch, lambda: wp.window_probe(frame, org, align),
                  reps=reps, warmup=2, queued=True)
    nbytes, bound_ms, bound_by = probe_bound(
        torch, wp, org, tuple(frame.shape[1:]), org.shape[0] * wp.WIN_W)
    window_bytes = org.shape[0] * 3 * wp.WIN_H * wp.WIN_W
    return {"windows": org.shape[0], "ms": ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "distinct_bytes": nbytes,
            "window_gb_per_s": window_bytes / (ms * 1e-3) / 1e9}


def phase_probe(C):
    """The window-copy probe K7 at every alignment from 128 to 1: 512
    windows of the TPU probe's frame (the kernel row), 16,384 windows of it
    (copies from L2) and 16,384 of a frame twice the L2 (copies from HBM),
    each bit-exact against the plain version (the HBM case on a sample) and
    timed beside its byte bound; an empty launch of the probe's grid beside
    them."""
    torch, wp, dev = C.torch, C.wp, C.dev
    H, W = PROBE_HW
    frame, big, rng = probe_frames(C)
    stream = torch.cuda.current_stream().cuda_stream
    empty = C.cuda.KernelLibrary("window_probe", [ctypes.c_void_p],
                                 entry="window_probe_empty")
    floor_ms = event_ms(torch, lambda: empty(stream), reps=50, warmup=5,
                        queued=True)
    per_sm = wp.blocks_per_sm()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"window_probe: grid {sms} SMs x {per_sm} blocks; an empty launch "
          f"of it {floor_ms * 1e3:.2f} us", flush=True)
    rows, metrics = [], {"launch_floor_ms": floor_ms, "blocks_per_sm": per_sm}
    for align in PROBE_ALIGNS:
        org = probe_origins(torch, rng, PROBE_WINDOWS, PROBE_HW, align, dev)
        C.reset_counts()
        got = wp.window_probe(frame, org, align)
        torch.cuda.synchronize()
        launches = wp.WINDOW_PROBE.launches
        want = wp.window_probe_plain(frame, org)
        err = 0.0 if torch.equal(got, want) else \
            float((got - want).abs().nan_to_num(nan=float("inf")).max())
        case = probe_case(torch, wp, frame, org, align, reps=50)
        rows.append(kernel_row(
            wp.WINDOW_PROBE, "window_probe.cu", "test_misaligned_dma.py:21",
            launches, err, case["ms"],
            event_ms(torch, lambda: wp.window_probe_plain(frame, org),
                     reps=3, warmup=1), case["bound_ms"], case["bound_by"],
            # no one PyTorch call sums windows at given origins
            library_ms=None, replaces_in="scripts/", align=align,
            window_gb_per_s=case["window_gb_per_s"],
            launch_floor_ms=floor_ms))
        # 16,384 windows of the same frame, which the L2 holds
        many = probe_origins(torch, rng, PROBE_MANY, PROBE_HW, align, dev)
        if not torch.equal(wp.window_probe(frame, many, align),
                           wp.window_probe_plain(frame, many)):
            fail(f"window_probe at {PROBE_MANY} windows, align {align}, "
                 "differs from its plain version")
        l2 = probe_case(torch, wp, frame, many, align, reps=10)
        # 16,384 windows of a frame twice the L2: the copies come from HBM
        far = probe_origins(torch, rng, PROBE_MANY, (PROBE_HBM_H, W), align,
                            dev)
        sample = torch.from_numpy(rng.choice(PROBE_MANY, PROBE_SAMPLE,
                                             replace=False)).to(dev)
        if not torch.equal(wp.window_probe(big, far, align)[sample],
                           wp.window_probe_plain(big, far[sample])):
            fail(f"window_probe from HBM, align {align}, differs from its "
                 "plain version")
        hbm = probe_case(torch, wp, big, far, align, reps=10)
        metrics[f"align{align}"] = {"windows_512": case, "l2_16384": l2,
                                    "hbm_16384": hbm}
        print(f"window_probe align {align}: " + "; ".join(
            f"{what} {c['windows']} windows {c['ms'] * 1e3:.2f} us, "
            f"{c['window_gb_per_s']:.1f} GB/s of window bytes, bound "
            f"{c['bound_ms'] * 1e3:.2f} us"
            for what, c in (("L2", case), ("L2", l2), ("HBM", hbm))) +
            f"; empty launch {floor_ms * 1e3:.2f} us", flush=True)
    # an origin off the frame, off its alignment or crossing the right edge
    # comes back as NaN; the last column origin that fits is summed
    bad = torch.tensor([[H - 8, 0], [0, 130], [0, W - 255], [8, W - 256]],
                       dtype=torch.int32, device=dev)
    nan = wp.window_probe(frame, bad[:2], 128).isnan()
    edge = wp.window_probe(frame, bad[2:], 1)
    if not bool(nan.all()) or not bool(edge[0].isnan().all()) or \
            not torch.equal(edge[1], wp.window_probe_plain(frame, bad[3:])[0]):
        fail("window_probe copied a window it must refuse, or refused one "
             "it must take")
    print("window_probe: bit-exact against the plain version at every "
          "alignment and size", flush=True)
    return rows, metrics


def phase_registration(C):
    """register_images on the work-scale 5-camera ring: stage times cold
    and warm, the reference's gates, and card against CPU on the reduced
    scene."""
    torch, dev = C.torch, C.dev
    from stitchingvideo_tpu_torch.register import pipeline as rp
    cfg = C.StitchConfig()
    t0 = time.perf_counter()
    views, _K, Rs_true, f_true = registration_scene(C.seed, dev)
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0

    def stages():
        times = []
        t = time.perf_counter()
        feats = rp.compute_features(views, cfg, dev)
        times.append(time.perf_counter() - t)
        t = time.perf_counter()
        pairs = rp.match_all_pairs(feats, cfg, C.seed, dev)
        times.append(time.perf_counter() - t)
        t = time.perf_counter()
        reg = rp.estimate_cameras(feats, pairs, cfg, dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        return feats, reg, times

    feats, reg, cold = stages()
    warm = [stages()[2] for _ in range(3)]
    # what the first forward-mode derivative in a process costs on this host
    # (PyTorch imports its forward-AD decompositions then): the bundle
    # adjustment's Jacobian pays it in the cold estimate_cameras
    probe = subprocess.run([sys.executable, "-c", FIRST_FORWARD_AD],
                           capture_output=True, text=True, timeout=300)
    if probe.returncode != 0:
        fail(f"the forward-AD probe failed: {probe.stderr.strip()}")
    first_ad = json.loads(probe.stdout)
    names = ("find_features", "pairwise_matching", "estimate_cameras")
    stage_s = {n: {"cold_s": cold[k],
                   "warm_s": float(np.median([w[k] for w in warm]))}
               for k, n in enumerate(names)}
    if reg.cameras.focal.device.type != "cuda":
        fail("register_images did not return cameras on the card")
    focals = reg.cameras.focal.cpu().numpy()
    R_est = reg.cameras.R.cpu().numpy()
    if reg.indices != list(range(REG_CAMS)):
        fail(f"registration kept cameras {reg.indices}, not all {REG_CAMS}")
    focal_err = np.abs(focals - f_true) / f_true
    rot_err = rotation_errors_deg(R_est, Rs_true)
    if not np.all(np.isfinite(focals)) or focal_err.max() > 0.03:
        fail(f"registration focals {focals} are not within 3% of {f_true}")
    if max(rot_err) >= 1.0:
        fail(f"a relative rotation is {max(rot_err):.3f} degrees off")
    metrics = {
        "views": [REG_CAMS, *work_wh()[::-1], 3], "scene_s": scene_s,
        "texture_hw": list(REG_TEX_HW), "stages": stage_s,
        "keypoints": [int(f["valid"].sum()) for f in feats],
        "pairs": {f"{i}-{j}": [nm, ni] for (i, j), (nm, ni, _c)
                  in reg.pair_stats.items()},
        "first_forward_ad": first_ad,
        "kept": reg.indices, "focal_true": f_true,
        "focals": focals.tolist(), "focal_rel_err_max": float(focal_err.max()),
        "rotation_err_deg_max": max(rot_err)}
    print("registration: " + ", ".join(
        f"{n} {v['cold_s']:.3f} s cold / {v['warm_s']:.3f} s warm"
        for n, v in stage_s.items()) + f"; kept {reg.indices}, focal error "
        f"<= {100 * focal_err.max():.3f}%, rotations <= {max(rot_err):.4f} "
        f"deg; a fresh process's first forward-mode derivative "
        f"{first_ad['s']:.3f} s ({first_ad['modules_imported']} modules "
        "imported)", flush=True)

    # the reduced scene on the card and on the CPU, the same RANSAC draws
    small_views = registration_scene(C.seed, "cpu", **SMALL_SCENE)[0]
    small = cfg.replace(
        features=dataclasses.replace(cfg.features, max_keypoints=256),
        match=dataclasses.replace(cfg.match, max_matches=128,
                                  ransac_iters=64),
        register=dataclasses.replace(cfg.register, ba_iters=10))
    on = {d: rp.register_images(small_views, small, C.seed, device=d)
          for d in (dev, "cpu")}
    card, cpu = on[dev], on["cpu"]
    f_card = card.cameras.focal.cpu().numpy()
    f_cpu = cpu.cameras.focal.numpy()
    rel_rot = rotation_errors_deg(card.cameras.R.cpu().numpy(),
                                  cpu.cameras.R.numpy())
    d_inl = max(abs(card.pair_stats[p][1] - cpu.pair_stats[p][1])
                for p in cpu.pair_stats)
    d_match = max(abs(card.pair_stats[p][0] - cpu.pair_stats[p][0])
                  for p in cpu.pair_stats)
    metrics["card_vs_cpu"] = {
        "kept": [card.indices, cpu.indices],
        "focal_rel_diff_max": float(np.max(np.abs(f_card - f_cpu) / f_cpu)),
        "rotation_diff_deg_max": max(rel_rot), "inliers_diff_max": d_inl,
        "matches_diff_max": d_match}
    print(f"registration card vs CPU (3 x 320x240): {metrics['card_vs_cpu']}",
          flush=True)
    if card.indices != cpu.indices or len(cpu.indices) != 3 \
            or metrics["card_vs_cpu"]["focal_rel_diff_max"] > 1e-3 \
            or max(rel_rot) >= 0.05 or d_inl > 2:
        fail("registration on the card misses the CPU's tolerance")
    return [], metrics


# -- the stitcher: frames -> registration -> LUT -> K1/K2 ---------------------

# the product rig at full resolution: 5 x 1080p views, 72 degrees apart, fov
# 90 (f = 960 px a radian), rendered from a texture the views sample near
# 1:1 (2 pi f columns, pi f rows) with the reference's blob density
STITCH_WH, STITCH_TEX_HW = (1920, 1080), (3016, 6032)
STITCH_BLOBS = int(REG_BLOBS * (3016 * 6032) / (REG_TEX_HW[0] * REG_TEX_HW[1]))
STITCH_SPANS = ("find_features", "pairwise_matching", "estimate_cameras",
                "seam_prep", "exposure_compensation", "seam_finding",
                "warp_field_build", "lut_build", "install_lut")
# composite_microbatch's 16 frame sets: set b rolled by STITCH_ROLL * b columns
STITCH_ROLL = 37
# run(): frame sets streamed, and the frame that asks for a re-registration
RUN_FRAMES, RUN_FORCE_AT = 160, 20

# a fresh process's first register() on the rendered frames (argv[1], an
# .npy): what a stream's start waits for, PyTorch's first forward-mode
# derivative (the bundle adjustment's Jacobian) included
FIRST_REGISTER = """
import json, sys, time
t0 = time.perf_counter()
import numpy as np, torch
from stitchingvideo_tpu_torch import VideoStitcher
from stitchingvideo_tpu_torch.utils.timing import GLOBAL_TRACER
frames = list(np.load(sys.argv[1]))
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t1 = time.perf_counter()
vs = VideoStitcher()
vs.register(frames)
torch.cuda.synchronize()
t2 = time.perf_counter()
out = {n: v[-1] for n, v in GLOBAL_TRACER.spans.items()}
out.update(total=t2 - t1, imports_and_context=t1 - t0)
print(json.dumps(out))
"""


def small_cfg(cfg):
    """The slice tests' registration config (the reduced scene's)."""
    return cfg.replace(
        features=dataclasses.replace(cfg.features, max_keypoints=256),
        match=dataclasses.replace(cfg.match, max_matches=128,
                                  ransac_iters=64),
        register=dataclasses.replace(cfg.register, ba_iters=10))


def phase_stitcher(C):
    """VideoStitcher.register on the full-resolution product rig (the
    first of this process, then two warm re-registrations, every span
    timed; and the first of a fresh process), composite (K2) and
    composite_microbatch at B=16 (K1) of 16 distinct frame sets on that
    registration, and run() over the rendered frames with one forced
    re-registration; then the reduced scene registered on the card and on
    the CPU."""
    torch, m2, dev = C.torch, C.m2, C.dev
    from stitchingvideo_tpu_torch.native import build as native_build
    from stitchingvideo_tpu_torch.utils import timing
    from stitchingvideo_tpu_torch.video.sources import ReplaySource
    t0 = time.perf_counter()
    native_build.load()          # g++ builds the max-flow library, or raises
    maxflow_build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    frames, _K, Rs_true, f_true = registration_scene(
        C.seed, dev, img_wh=STITCH_WH, tex_hw=STITCH_TEX_HW,
        blobs=STITCH_BLOBS)
    scene_s = time.perf_counter() - t0
    # the stream and still phases' views
    C.stitch_scene = (frames, Rs_true, f_true)
    print(f"stitcher: g++ max-flow library {maxflow_build_s:.2f} s; "
          f"{len(frames)} views {frames[0].shape} rendered in {scene_s:.2f} "
          f"s; focal {f_true:.1f}", flush=True)

    vs = C.VideoStitcher(C.StitchConfig())
    tracer = timing.GLOBAL_TRACER

    def register(fr):
        tracer.spans.clear()
        timing.set_sync_spans(True)          # every span ends synced
        t = time.perf_counter()
        vs.register(fr)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
        spans = {n: tracer.spans[n][-1] for n in STITCH_SPANS}
        return dict(spans, total=total)

    C.reset_counts()
    times = [register(frames)]
    shape0 = vs._out_shape
    times += [register(frames) for _ in range(2)]
    pano = vs.composite(frames)
    # 16 distinct frame sets: set b is the rendered views rolled by
    # STITCH_ROLL * b columns, so a kernel that reads another set's frames
    # disagrees with the plain version
    frames_d = torch.from_numpy(np.stack(frames)).to(dev)
    planar1 = C.frames_to_planar_i8(frames_d)
    planar16 = torch.stack([planar1.roll(STITCH_ROLL * b, dims=-1)
                            for b in range(16)])
    out16 = vs.composite_microbatch(planar16)
    torch.cuda.synchronize()
    launches = C.read_counts()
    print(f"stitcher main path launches: {launched(launches)}", flush=True)
    if vs._out_shape != shape0:
        fail(f"a re-registration changed the output shape {shape0} -> "
             f"{vs._out_shape}")
    if vs.stitcher.component() != list(range(N_CAMS)):
        fail(f"the stitcher kept cameras {vs.stitcher.component()}")
    reg, ml = vs._reg, vs._tlut[1]
    if vs._tlut[0] != "mat2":
        fail(f"register() built {vs._tlut[0]}, not mat2")
    focals = reg.cameras.focal.cpu().numpy()
    focal_err = np.abs(focals - f_true) / f_true
    rot_err = rotation_errors_deg(reg.cameras.R.cpu().numpy(), Rs_true)
    if focal_err.max() > 0.03 or max(rot_err) >= 1.0:
        fail(f"stitcher: focal error {focal_err.max():.4f}, rotation error "
             f"{max(rot_err):.3f} deg")
    valid_px = reg.valid.reshape(N_CAMS, -1).sum(1).tolist()
    owned = [int((vs._lut.cam_idx == i).sum()) for i in range(N_CAMS)]
    if min(valid_px) == 0 or min(owned) == 0:
        fail(f"a camera has no valid or no owned pixels: {valid_px}, {owned}")
    CW, CH = reg.canvas_wh
    if CW > 2 * np.pi * reg.warp_scale + 65:
        fail(f"canvas width {CW} exceeds one wrap at {reg.warp_scale}")
    if reg.xmaps.device.type != "cuda":
        fail("register() did not leave its state on the card")
    staging = staging_of(C, ml, "stitcher mat2", C.cuda.COMPOSITE_MAT2)
    # the first register() of a fresh process on the same frames
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "frames.npy")
        np.save(path, np.stack(frames))
        probe = subprocess.run([sys.executable, "-c", FIRST_REGISTER, path],
                               capture_output=True, text=True, timeout=600,
                               cwd=ROOT)
    if probe.returncode != 0:
        fail(f"the first-register probe failed: {probe.stderr.strip()}")
    first = json.loads(probe.stdout.strip().splitlines()[-1])

    # K2 and K1 on the port's own registration: bit-exact against their
    # plain versions, within the reference's tolerance of the gather
    plain1 = m2.composite_mat2_plain(planar1[None], ml)[0]
    got1 = torch.from_numpy(pano).to(dev).permute(2, 0, 1)
    err = {"single": max_err(got1, plain1),
           "batched": max_err(out16, m2.composite_mat2_plain(planar16, ml))}
    if err["single"] or err["batched"]:
        fail(f"stitcher: K2 / K1 differ from their plain versions: {err}")
    oracle = C.composite_frame_u8(frames_d, vs._lut).permute(2, 0, 1)
    gather_gate(got1, oracle, 4, "stitcher K2")
    last = 15
    oracle = C.composite_frame_u8(frames_d.roll(STITCH_ROLL * last, dims=2),
                                  vs._lut).permute(2, 0, 1)
    gather_gate(out16[last], oracle, 4, f"stitcher K1 (set {last})")
    del oracle
    gains = reg.gain_maps[reg.valid]
    print(f"stitcher: canvas_wh {reg.canvas_wh}, roi_hw {reg.roi_hw}, "
          f"extent_wh {reg.extent_wh}, output {tuple(vs._out_shape)}, "
          f"gains {float(gains.min()):.4f}..{float(gains.max()):.4f}; "
          f"focal error <= {100 * focal_err.max():.3f}%, rotations <= "
          f"{max(rot_err):.4f} deg; {ml.n_fallback} fallback tiles",
          flush=True)

    # run(): one forced re-registration mid-stream; frame times while it
    # runs and while none does
    seen, busy = [], []
    base = len(vs.stats.compose_s)
    regs0 = vs.registrations

    def on_frame(p, i):
        seen.append(i)
        busy.append(vs._reg_busy.is_set())
        if i == RUN_FORCE_AT:
            vs.force_reregister()

    t = time.perf_counter()
    vs.run(ReplaySource(frames, max_frames=RUN_FRAMES), on_frame=on_frame)
    run_s = time.perf_counter() - t
    torch.cuda.synchronize()
    if seen != list(range(RUN_FRAMES)):
        fail("run() did not deliver every frame once, in order")
    if vs.registrations - regs0 < 1 or vs._out_shape != shape0:
        fail("run() did not re-register, or changed the output shape")
    ct = np.asarray(vs.stats.compose_s[base:]) * 1e3
    during = ct[np.asarray(busy)]
    outside = ct[~np.asarray(busy)][5:]     # after the first few frames
    run_m = {"frames": RUN_FRAMES, "seconds": run_s,
             "registrations": vs.registrations,
             "frame_ms_during_reregistration": p50_p95(during),
             "frame_ms_outside": p50_p95(outside)}
    print(f"stitcher run(): {run_m}", flush=True)
    if during.size == 0:
        fail("no frame was composited while the re-registration ran")

    # the reduced scene, card against the CPU (the same RANSAC draws);
    # its 320-column frames are narrower than mat2's source window, so both
    # serve it through the plain gather
    small_views = registration_scene(C.seed, "cpu", **SMALL_SCENE)[0]
    on = {}
    for d in (dev, "cpu"):
        v = C.VideoStitcher(small_cfg(video_cfg(C, kernel="gather")),
                            device=d)
        v.register(small_views)
        on[str(d)] = v
    card, cpu = on[str(dev)], on["cpu"]
    rc, rp = card._reg, cpu._reg
    seam_diff = float((rc.seam_masks.cpu() != rp.seam_masks).float().mean())
    gain_diff = float((rc.gain_maps.cpu() - rp.gain_maps).abs().max())
    small_frames = list(registration_scene(C.seed + 1, "cpu",
                                           **SMALL_SCENE)[0])
    d_small = (torch.from_numpy(card.composite(small_frames)).int()
               - torch.from_numpy(cpu.composite(small_frames)).int()).abs()
    card_vs_cpu = {
        "kept": [card.stitcher.component(), cpu.stitcher.component()],
        "corners": [rc.corners.cpu().tolist(), rp.corners.tolist()],
        "canvas_wh": [rc.canvas_wh, rp.canvas_wh],
        "seam_mask_diff_share": seam_diff, "gain_diff_max": gain_diff,
        "composite_diff_median": float(d_small.float().median()),
        "composite_within_4": float((d_small <= 4).float().mean())}
    print(f"stitcher card vs CPU (3 x 320x240): {card_vs_cpu}", flush=True)
    if card_vs_cpu["kept"][0] != card_vs_cpu["kept"][1] \
            or card_vs_cpu["corners"][0] != card_vs_cpu["corners"][1] \
            or rc.canvas_wh != rp.canvas_wh or seam_diff > 5e-3 \
            or gain_diff > 1e-4 or card_vs_cpu["composite_diff_median"] > 1 \
            or card_vs_cpu["composite_within_4"] < 0.999:
        fail("stitcher on the card misses the CPU's tolerance")

    # times: the kernels as this registration gives them their state
    need = mat2_needs(torch, ml, m2)
    Hp, Wp = ml.pano_hw
    staging_bytes = ml.stage_table.numel() * 4

    rows = []
    for k, B, tpu_line, fn, plain in (
            (m2.MAT2_SINGLE, 1, 388,
             lambda: m2.composite_mat2_planar(planar1, ml),
             lambda: m2.composite_mat2_plain(planar1[None], ml)),
            (m2.MAT2_BATCHED, 16, 624,
             lambda: m2.composite_mat2_planar_batched(planar16, ml),
             lambda: m2.composite_mat2_plain(planar16, ml))):
        rows.append(kernel_row(
            k, "composite_mat2.cu", f"composite_mat2.py:{tpu_line}",
            launches[k.name], err["single" if B == 1 else "batched"],
            event_ms(torch, fn, reps=10, warmup=2),
            event_ms(torch, plain, reps=2, warmup=1),
            *mat2_bound(need, staging_bytes, Hp * Wp, B),
            library_ms=None, batch=B, path="stitcher"))
    metrics = {
        "maxflow_build_s": maxflow_build_s, "scene_s": scene_s,
        "views": [N_CAMS, STITCH_WH[1], STITCH_WH[0], 3],
        "texture_hw": list(STITCH_TEX_HW), "blobs": STITCH_BLOBS,
        "register_cold_s": times[0], "register_warm_s": times[1:],
        "register_fresh_process_s": first, "staging": staging,
        "canvas_wh": list(reg.canvas_wh), "roi_hw": list(reg.roi_hw),
        "extent_wh": list(reg.extent_wh), "out_shape": list(vs._out_shape),
        "gain_range": [float(gains.min()), float(gains.max())],
        "focal_true": f_true, "focal_rel_err_max": float(focal_err.max()),
        "rotation_err_deg_max": max(rot_err), "fallback_tiles":
        ml.n_fallback, "valid_px": valid_px, "owned_px": owned,
        "mat2_needs": need, "run": run_m, "card_vs_cpu": card_vs_cpu}
    C.stitch_vs = vs                   # the stream phase's registration
    print("stitcher: register cold " + ", ".join(
        f"{n} {times[0][n]:.3f}" for n in STITCH_SPANS)
        + f" (total {times[0]['total']:.3f} s); warm totals "
        + ", ".join(f"{t['total']:.3f}" for t in times[1:]) + " s; in a "
        f"fresh process {first['total']:.3f} s (estimate_cameras "
        f"{first['estimate_cameras']:.3f} s)", flush=True)
    return rows, metrics


# -- frames in flight: StreamingComposer and run(pipeline_depth > 1) ---------

# frame sets held in host memory (set b: the stitcher phase's views rolled by
# STITCH_ROLL * b columns), deliveries a timed run, the depths timed; run()'s
# frame sets and the frame that asks for a re-registration
STREAM_SETS, STREAM_DELIVERIES = 16, 48
STREAM_DEPTHS = (1, 2, 4, 8)
STREAM_RUN_FRAMES, STREAM_RUN_FORCE_AT = 40, 8


def stream_deliveries(sc, sets, n: int):
    """n submits of sets[k % len(sets)] through the composer `sc`, then its
    flush: the deliveries in order, and their fps (as bench.py's serial_fps:
    n over the wall time from the first submit to the last delivery), the
    gap between deliveries and the submit -> delivery latency."""
    got, t_sub = [], []
    for k in range(n):
        t_sub.append(time.perf_counter())
        out = sc.submit(sets[k % len(sets)])
        if out is not None:
            got.append(out)
    got += sc.flush()
    if len(got) != n or len(sc.out_times) < n:
        fail(f"the composer delivered {len(got)} of {n} frame sets")
    t_out = np.asarray(sc.out_times[-n:])
    return got, {"fps": n / (t_out[-1] - t_sub[0]),
                 "gap": p50_p95(np.diff(t_out) * 1e3),
                 "latency": p50_p95((t_out - np.asarray(t_sub)) * 1e3)}


def device_overlap(torch, fn) -> dict:
    """One fn() under torch.profiler: the device's busy share (the union of
    the intervals of its kernels and copies over the host clock of the same
    run; the profiler's own cost lengthens the run, so a lower bound), and
    for host -> device copies, kernels and device -> host copies how many
    ran and how many overlapped one of the other two kinds in time. None
    where the profiler saw no device activity (not measured)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        kind = ("h2d" if "HtoD" in e.name else "d2h" if "DtoH" in e.name
                else "other" if e.name.startswith(("Memcpy", "Memset"))
                else "kernel")
        spans.append((e.time_range.start, e.time_range.end, kind))
    return {"wall_s": wall, **interval_overlap(spans, wall * 1e6)}


def interval_overlap(spans, wall_us: float) -> dict:
    """`device_overlap`'s counts from (start, end, kind) intervals in us."""
    kinds = ("h2d", "kernel", "d2h")
    if not spans:
        return {"busy_share": None, "count": None, "overlapping": None}
    spans = sorted(spans)
    busy, end = 0.0, float("-inf")
    for a, b, _ in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    count = {k: sum(k2 == k for _, _, k2 in spans) for k in kinds}
    overlapping = {k: sum(1 for a, b, k2 in spans if k2 == k and any(
        a2 < b and a < b2 for a2, b2, k3 in spans if k3 in kinds and k3 != k))
        for k in kinds}
    return {"busy_share": busy / wall_us, "count": count,
            "overlapping": overlapping}


def host_stages(torch, sets, out_hw, dev) -> dict:
    """The stages of one streamed frame set, each alone (p50/p95 over the
    frame sets): the frame set copied into a pinned slot on one thread and
    a camera a thread (the composer's way); a pinned slot of the panorama's
    size (`out_hw`) copied out into fresh memory that is kept, as a caller
    keeps its panoramas; and on the device the upload and the copy back
    (CUDA events)."""
    from concurrent.futures import ThreadPoolExecutor
    slot = torch.empty((len(sets[0]),) + sets[0][0].shape, dtype=torch.uint8,
                       pin_memory=True)
    out = torch.empty(tuple(out_hw) + (3,), dtype=torch.uint8,
                      pin_memory=True)
    kept = []

    def timed(fn):
        ts = []
        for f in sets:
            t = time.perf_counter()
            fn(f)
            ts.append((time.perf_counter() - t) * 1e3)
        return p50_p95(ts)

    with ThreadPoolExecutor() as pool:
        m = {"copy_in_one_thread": timed(
                 lambda f: np.stack(f, out=slot.numpy())),
             "copy_in_a_camera_a_thread": timed(
                 lambda f: list(pool.map(np.copyto, slot.numpy(), f))),
             "copy_out_kept": timed(
                 lambda f: kept.append(out.numpy().copy()))}
    del kept
    slot_d = torch.empty_like(slot, device=dev)
    out_d = torch.empty_like(out, device=dev)
    m["upload_ms"] = event_ms(torch, lambda: slot_d.copy_(
        slot, non_blocking=True), reps=10)
    m["copy_back_ms"] = event_ms(torch, lambda: out.copy_(
        out_d, non_blocking=True), reps=10)
    return m


def phase_stream(C):
    """StreamingComposer on the stitcher phase's 5 x 1080p registration,
    saved, loaded into a 'lut' VideoStitcher and installed from there into a
    'feather' and a 'multiband' one: 16 distinct frame sets
    (the views rolled as the stitcher phase rolls them) at depths 1, 2, 4
    and 8, 48 deliveries each, in the seam-select (K2), feather (K4) and
    multiband (pieces) modes; every delivery equal to the serial
    composite() of its frame set, each mode's kernel launched on the
    composers' streams only; the device_reduce checksum rate at depth 8;
    one profiled window at depth 4 in 'lut' mode; run(pipeline_depth=4)
    with one forced re-registration."""
    torch, m2, fe, dev = C.torch, C.m2, C.fe, C.dev
    from stitchingvideo_tpu_torch.video.sources import ReplaySource
    from stitchingvideo_tpu_torch.video.stream import StreamingComposer
    t_phase = time.perf_counter()
    views = C.stitch_scene[0]
    sets = [[np.roll(v, STITCH_ROLL * b, axis=1) for v in views]
            for b in range(STREAM_SETS)]
    # saved and loaded once (each load decompresses ~2 s of arrays); the
    # loaded registration is installed in the other two modes. The file
    # stays on disk for the ingest phase, which removes it
    stitchers, load_s = {}, {}
    C.registration_dir = tempfile.TemporaryDirectory()
    path = C.registration_path = os.path.join(C.registration_dir.name,
                                              "registration.npz")
    t0 = time.perf_counter()
    C.stitch_vs.save_registration(path)
    save_s = time.perf_counter() - t0
    for mode in ("lut", "feather", "multiband"):
        v = C.VideoStitcher(video_cfg(C, compose_mode=mode))
        t0 = time.perf_counter()
        if mode == "lut":
            v.load_registration(path)
        else:
            first = stitchers["lut"]
            v.install_lut(first._lut, first._frame_hw, reg=first._reg)
        torch.cuda.synchronize()
        load_s[mode] = time.perf_counter() - t0
        stitchers[mode] = v
    planar1 = C.frames_to_planar_i8(
        torch.from_numpy(np.stack(sets[0])).to(dev))
    default = torch.cuda.default_stream().cuda_stream

    def checksum(o):
        return o[::31, ::41].to(torch.int32).sum()

    rows, metrics = [], {"sets": STREAM_SETS,
                         "deliveries": STREAM_DELIVERIES,
                         "save_registration_s": save_s,
                         "host_stages": host_stages(
                             torch, sets, C.stitch_vs._out_shape, dev)}
    print(f"stream host stages: {metrics['host_stages']}", flush=True)
    for mode, kernel in (("lut", m2.MAT2_SINGLE),
                         ("feather", fe.FEATHER_SINGLE),
                         ("multiband", m2.PIECES_BATCHED)):
        v = stitchers[mode]
        if mode == "lut":
            if v._tlut is None or v._tlut[0] != "mat2":
                fail("stream: 'lut' mode did not build mat2")
            ml = v._tlut[1]
            fn, plain = (
                lambda: m2.composite_mat2_planar(planar1, ml),
                lambda: m2.composite_mat2_plain(planar1[None], ml)[0])
            bnd = mat2_bound(mat2_needs(torch, ml, m2),
                             ml.stage_table.numel() * 4,
                             ml.pano_hw[0] * ml.pano_hw[1], 1)
            src, tpu = "composite_mat2.cu", "composite_mat2.py:388"
        elif mode == "feather":
            if v._ftlut is None or v._ftlut[0] != "fmat":
                fail("stream: 'feather' mode did not build its state")
            ml = v._ftlut[1]
            fn, plain = (
                lambda: fe.composite_feather_planar(planar1, ml),
                lambda: fe.composite_feather_plain(planar1[None], ml)[0])
            bnd = feather_bound(feather_needs(torch, m2, ml),
                                ml.stage_table.numel() * 4, 1)
            src, tpu = "composite_feather.cu", "composite_feather.py:354"
        else:
            if v._mbtlut is None:
                fail("stream: 'multiband' mode did not build its state")
            st = v._mbtlut[0]
            ml, Nv = st.warp_lut, len(st.piece_cam)
            fn, plain = (
                lambda: m2.composite_mat2_planar_pieces_batched(
                    planar1[None], ml, Nv),
                lambda: m2.composite_mat2_pieces_plain(planar1[None], ml,
                                                       Nv))
            bnd = pieces_bound(mat2_needs(torch, ml, m2),
                               ml.stage_table.numel() * 4,
                               Nv * st.buf_hw[0] * st.buf_hw[1], 1)
            src, tpu = "composite_mat2.cu", "composite_mat2.py:1029"
        serial, serial_ms = [], []
        for f in sets:
            t0 = time.perf_counter()
            serial.append(v.composite(f))
            serial_ms.append((time.perf_counter() - t0) * 1e3)

        # the main path, counted: every launch of the mode's kernel and the
        # stream it was issued on
        streams, launch, composers = [], kernel.launch, []

        def spy(*args):
            streams.append(torch.cuda.current_stream().cuda_stream)
            launch(*args)

        C.reset_counts()
        kernel.launch = spy
        submits, m = 0, {"load_or_install_s": load_s[mode],
                         "serial_composite": p50_p95(serial_ms[1:])}
        try:
            for depth in STREAM_DEPTHS:
                sc = StreamingComposer(v, depth=depth)
                composers.append(sc)
                stream_deliveries(sc, sets, depth)     # allocates the ring
                got, m[f"depth{depth}"] = stream_deliveries(
                    sc, sets, STREAM_DELIVERIES)
                submits += depth + STREAM_DELIVERIES
                # compared after the last submit: a delivery that still
                # aliased a ring slot would have changed since
                bad = [k for k, g in enumerate(got)
                       if not np.array_equal(g, serial[k % STREAM_SETS])]
                if bad:
                    fail(f"stream {mode} depth {depth}: deliveries {bad} "
                         "differ from the serial composite()")
                del got
            sc = StreamingComposer(v, depth=8, device_reduce=checksum)
            composers.append(sc)
            stream_deliveries(sc, sets, 8)
            checks, m["checksum_depth8"] = stream_deliveries(
                sc, sets, STREAM_DELIVERIES)
            submits += 8 + STREAM_DELIVERIES
        finally:
            del kernel.launch
        torch.cuda.synchronize()
        launches = C.read_counts()
        if len({int(c) for c in checks}) < STREAM_SETS:
            fail(f"stream {mode}: the checksums of distinct frame sets are "
                 "not distinct")
        own = {sc._compute.cuda_stream for sc in composers}
        if launches[kernel.name] != submits or len(streams) != submits \
                or default in streams or not set(streams) <= own:
            fail(f"stream {mode}: {launches[kernel.name]} launches of "
                 f"{kernel.name} for {submits} submits, on streams "
                 f"{sorted(set(streams))} (the composers': {sorted(own)})")
        m["launches"] = launched(launches)
        out, want = fn(), plain()
        err = float((out.float() - want.float()).abs().max())
        rows.append(kernel_row(
            kernel, src, tpu, launches[kernel.name], err,
            event_ms(torch, fn, reps=10, warmup=2),
            event_ms(torch, plain, reps=2, warmup=1), *bnd,
            library_ms=None, batch=1, path=f"stream ({mode})"))
        metrics[mode] = m
        print(f"stream {mode}: serial composite p50 "
              f"{m['serial_composite']['p50_ms']:.2f} ms; " + "; ".join(
                  f"depth {d}: {m[f'depth{d}']['fps']:.1f} fps, gap p50/p95 "
                  f"{m[f'depth{d}']['gap']['p50_ms']:.2f}/"
                  f"{m[f'depth{d}']['gap']['p95_ms']:.2f} ms, latency "
                  f"p50/p95 {m[f'depth{d}']['latency']['p50_ms']:.2f}/"
                  f"{m[f'depth{d}']['latency']['p95_ms']:.2f} ms"
                  for d in STREAM_DEPTHS)
              + f"; checksums at depth 8: {m['checksum_depth8']['fps']:.1f} "
              f"fps; {kernel.name} launched {launches[kernel.name]} times "
              f"on the composers' streams ({time.perf_counter() - t_phase:.1f}"
              " s into the phase)", flush=True)
        del serial, checks, composers, sc

    # one profiled window: 16 deliveries at depth 4 in 'lut' mode
    sc = StreamingComposer(stitchers["lut"], depth=4)
    stream_deliveries(sc, sets, 4)
    metrics["profile_lut_depth4"] = device_overlap(
        torch, lambda: stream_deliveries(sc, sets, STREAM_SETS))
    print(f"stream lut depth 4 under the profiler: "
          f"{metrics['profile_lut_depth4']} ({time.perf_counter() - t_phase:.1f}"
          " s into the phase)", flush=True)
    del sc, stitchers

    # run(pipeline_depth=4) with one forced re-registration, on the stitcher
    # phase's own stitcher
    vs, seen = C.stitch_vs, []
    shape0, regs0 = vs._out_shape, vs.registrations

    def on_frame(p, i):
        seen.append((i, p.shape))
        if i == STREAM_RUN_FORCE_AT:
            vs.force_reregister()

    t0 = time.perf_counter()
    vs.run(ReplaySource(views, max_frames=STREAM_RUN_FRAMES),
           on_frame=on_frame, pipeline_depth=4)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if [i for i, _ in seen] != list(range(STREAM_RUN_FRAMES)) \
            or {s for _, s in seen} != {tuple(shape0) + (3,)} \
            or vs._out_shape != shape0 or vs.registrations <= regs0:
        fail(f"run(pipeline_depth=4) delivered {[i for i, _ in seen]} of "
             f"shapes {sorted({s for _, s in seen})} with "
             f"{vs.registrations - regs0} re-registrations")
    metrics["run_depth4"] = {"frames": STREAM_RUN_FRAMES, "seconds": run_s,
                             "registrations": vs.registrations - regs0}
    print(f"stream run(pipeline_depth=4): {STREAM_RUN_FRAMES} frame sets in "
          f"order with {vs.registrations - regs0} re-registration(s), shape "
          f"{tuple(shape0)} kept, {run_s:.2f} s", flush=True)
    C.stitch_vs = None
    return rows, metrics


# -- ingest: producer processes, shared-memory rings, the CLI ---------------

# the rings' slots (the reference producers' default); the cameras' rate
# (the reference's cameras, spawn_replay_producer's default); deliveries a
# timed run() and its depths; reads timed alone; the CLI's frames with a
# loaded registration and from a cold start
INGEST_SLOTS, INGEST_FPS = 4, 30.0
INGEST_DELIVERIES, INGEST_DEPTHS, INGEST_READS = 48, (1, 4), 32
INGEST_CLI_FRAMES, INGEST_COLD_FRAMES = 60, 30
# the CLI's flags for the product rig: the real-time driver's warp and
# confidence (with them the CLI's config is StitchConfig()'s)
INGEST_CLI = ["--warp", "cylindrical", "--conf_thresh", "0.6"]

# a producer process: creates the ring argv[1] of argv[4] slots and
# republishes the view argv[2] (an .npy) into it with increasing seq, paced
# at argv[3] fps; SIGUSR1 toggles free-running (no sleep)
PRODUCER = """
import signal, sys, time
import numpy as np
from stitchingvideo_tpu_torch.video.sharemem import ShmRing
name, view, fps = sys.argv[1], np.load(sys.argv[2]), float(sys.argv[3])
free = [False]
signal.signal(signal.SIGUSR1, lambda *a: free.__setitem__(0, not free[0]))
ring = ShmRing.create(name, view.shape[1], view.shape[0], 3, int(sys.argv[4]))
seq, t_next = 0, time.monotonic()
while True:
    ring.publish(view, seq)
    seq += 1
    if free[0]:
        t_next = time.monotonic()
    else:
        t_next += 1.0 / fps
        time.sleep(max(0.0, t_next - time.monotonic()))
"""


def ingest_run(vs, names, depth: int, want) -> dict:
    """run() over a SharedMemorySource of the rings at `depth`: every one of
    INGEST_DELIVERIES deliveries equal to `want`; the delivery rate (the
    deliveries made while frames were read, the first excepted, over the
    time from the first: the depth - 1 flushed at the end of the stream
    come at once), run()'s wall time, and the reads' time, the first read
    (before the loop) left out."""
    from stitchingvideo_tpu_torch.video.sources import SharedMemorySource
    src = SharedMemorySource(names, timeout_s=5.0)
    got, t_out, n = [], [], INGEST_DELIVERIES

    def on_frame(p, i):
        t_out.append(time.perf_counter())
        got.append(p)

    reads0 = len(vs.stats.read_s)
    t0 = time.perf_counter()
    try:
        vs.run(src, on_frame=on_frame, max_frames=n, pipeline_depth=depth)
    finally:
        src.close()
    wall = time.perf_counter() - t0
    bad = [k for k, g in enumerate(got) if not np.array_equal(g, want)]
    if len(got) != n or bad:
        fail(f"ingest depth {depth}: {len(got)} of {n} deliveries, "
             f"{bad} differ from composite() of the rings' frame set")
    k = n - depth
    return {"fps": k / (t_out[k] - t_out[0]), "wall_s": wall,
            "read": p50_p95(np.asarray(vs.stats.read_s[reads0 + 1:]) * 1e3)}


def ingest_cli(argv, frames: int, from_frames: bool) -> dict:
    """`python -m stitchingvideo_tpu_torch.cli video ...` as a subprocess:
    rc 0, `frames` frames, one registration (a loaded file counts as one in
    both packages), and a registration from the rings' frames (the
    tracer's `find_features` span, printed by --log_timing) only when
    `from_frames`."""
    import re
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "stitchingvideo_tpu_torch.cli",
                        "video", *argv, "--log_timing"], capture_output=True,
                       text=True, timeout=300, cwd=ROOT)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"the CLI exited rc={r.returncode}: {r.stderr[-3000:]}")
    m = re.search(r"frames: (\d+), fps: ([0-9.]+), registrations: (\d+)",
                  r.stdout)
    spans = json.loads(r.stdout[r.stdout.index("{"):])
    got = spans.get("find_features", {}).get("count", 0)
    if m is None or int(m[1]) != frames or int(m[3]) != 1 \
            or got != int(from_frames):
        fail(f"the CLI printed {r.stdout[:400]!r}: want {frames} frames, "
             f"1 registration, {int(from_frames)} from frames (got {got})")
    return {"frames": frames, "printed_fps": float(m[2]), "wall_s": wall,
            "spans_s": {k: v["total_s"] for k, v in spans.items()}}


def phase_ingest(C):
    """The product's real-time entry point on the card: five producer
    processes republish the stitcher phase's 5 x 1080p views into
    shared-memory rings (paced at 30 fps, then free-running);
    `VideoStitcher.run(SharedMemorySource)` from the stream phase's saved
    registration in 'lut' mode at depths 1 and 4, every delivery equal to
    composite() of the views and K2 launched once a delivery; the reads'
    time; then the CLI (`video --mode shm_attach`) as a subprocess, with the
    registration loaded and from a cold start. No ring is left behind."""
    import signal
    import uuid
    torch, m2, dev = C.torch, C.m2, C.dev
    from stitchingvideo_tpu_torch.native import build as native_build
    from stitchingvideo_tpu_torch.video.sharemem import ShmRing
    from stitchingvideo_tpu_torch.video.sources import (SharedMemorySource,
                                                        producer_env)
    t_phase = time.perf_counter()
    views = C.stitch_scene[0]
    h, w = views[0].shape[:2]
    # each ring: its slots, the slots' sequence stamps and the header
    need = len(views) * (h * w * 3 * INGEST_SLOTS + 4096)
    st = os.statvfs("/dev/shm")
    free = st.f_bavail * st.f_frsize
    if free < need:
        fail(f"ingest: /dev/shm has {free} bytes free; {len(views)} rings "
             f"of {INGEST_SLOTS} slots of {h}x{w}x3 need {need}")
    t0 = time.perf_counter()
    native_build.load_sharemem()     # once, before the producers start
    metrics = {"dev_shm_free_bytes": free, "rings_bytes": need,
               "ring_library_s": time.perf_counter() - t0,
               "fps_paced": INGEST_FPS, "deliveries": INGEST_DELIVERIES}
    tag = uuid.uuid4().hex[:8]
    names = [f"/svt_smoke_{tag}_{k}" for k in range(len(views))]
    procs, rows = [], []
    tmp = tempfile.TemporaryDirectory()

    def toggle_free_running():
        for p in procs:
            p.send_signal(signal.SIGUSR1)

    try:
        t0 = time.perf_counter()
        for k, (n, v) in enumerate(zip(names, views)):
            path = os.path.join(tmp.name, f"view{k}.npy")
            np.save(path, v)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", PRODUCER, n, path, str(INGEST_FPS),
                 str(INGEST_SLOTS)], env=producer_env(), cwd=ROOT,
                stderr=subprocess.PIPE, text=True))
        for n, p in zip(names, procs):
            while True:
                try:
                    ShmRing.open(n).close()
                    break
                except OSError:
                    if p.poll() is not None:
                        fail(f"ingest: the producer of {n} exited "
                             f"rc={p.returncode}: {p.stderr.read()[-2000:]}")
                    if time.perf_counter() - t0 > 180:
                        fail(f"ingest: no ring {n} after 180 s")
                    time.sleep(0.05)
        metrics["producers_up_s"] = time.perf_counter() - t0

        vs = C.VideoStitcher(video_cfg(C, compose_mode="lut",
                                       reregister_seconds=1e9))
        t0 = time.perf_counter()
        vs.load_registration(C.registration_path)
        torch.cuda.synchronize()
        metrics["load_registration_s"] = time.perf_counter() - t0
        if vs._tlut is None or vs._tlut[0] != "mat2":
            fail("ingest: 'lut' mode did not build mat2")
        want = vs.composite(list(views))

        # the main path, counted: paced producers at depths 1 and 4
        C.reset_counts()
        for d in INGEST_DEPTHS:
            metrics[f"paced_depth{d}"] = ingest_run(vs, names, d, want)
        torch.cuda.synchronize()
        launches = C.read_counts()
        k2 = launches[m2.MAT2_SINGLE.name]
        if k2 != INGEST_DELIVERIES * len(INGEST_DEPTHS) \
                or sum(launches.values()) != k2:
            fail(f"ingest: launches {launched(launches)} for "
                 f"{INGEST_DELIVERIES * len(INGEST_DEPTHS)} deliveries")
        metrics["launches"] = launched(launches)
        print("ingest paced (30 fps producers): " + "; ".join(
            f"depth {d}: {metrics[f'paced_depth{d}']['fps']:.1f} fps, read "
            f"p50/p95 {metrics[f'paced_depth{d}']['read']['p50_ms']:.2f}/"
            f"{metrics[f'paced_depth{d}']['read']['p95_ms']:.2f} ms"
            for d in INGEST_DEPTHS) + f"; {m2.MAT2_SINGLE.name} launched "
            f"{k2} times", flush=True)

        # free-running producers: the reads alone, then the loop at depth 4
        toggle_free_running()
        src = SharedMemorySource(names, timeout_s=5.0)
        src.read()
        seq0 = [r.last_seq.value for r in src.rings]
        ts, t0 = [], time.perf_counter()
        for _ in range(INGEST_READS):
            t = time.perf_counter()
            if src.read() is None:
                fail("ingest: a free-running producer timed out")
            ts.append((time.perf_counter() - t) * 1e3)
        dt = time.perf_counter() - t0
        metrics["free_read"] = p50_p95(ts)
        metrics["free_publish_fps"] = [
            (r.last_seq.value - s) / dt for r, s in zip(src.rings, seq0)]
        src.close()
        metrics["free_depth4"] = ingest_run(vs, names, 4, want)
        print(f"ingest free-running: SharedMemorySource.read() of "
              f"{len(views)} x {h}x{w} p50/p95 "
              f"{metrics['free_read']['p50_ms']:.2f}/"
              f"{metrics['free_read']['p95_ms']:.2f} ms (producers at "
              f"{min(metrics['free_publish_fps']):.0f}-"
              f"{max(metrics['free_publish_fps']):.0f} fps seen); run() "
              f"depth 4: {metrics['free_depth4']['fps']:.1f} fps", flush=True)

        # the CLI on paced producers (the cameras' rate): the saved
        # registration, then a cold start (a registration from the rings)
        toggle_free_running()
        argv = ["--mode", "shm_attach", *names, "--pipeline_depth", "4",
                "--reregister_seconds", "1e9", "--output", "", *INGEST_CLI]
        metrics["cli_loaded"] = ingest_cli(
            argv + ["--frames", str(INGEST_CLI_FRAMES),
                    "--load_registration", C.registration_path],
            INGEST_CLI_FRAMES, from_frames=False)
        metrics["cli_cold"] = ingest_cli(
            argv + ["--frames", str(INGEST_COLD_FRAMES)],
            INGEST_COLD_FRAMES, from_frames=True)
        print(f"ingest CLI: {INGEST_CLI_FRAMES} frames from the saved "
              f"registration in {metrics['cli_loaded']['wall_s']:.2f} s "
              f"(printed {metrics['cli_loaded']['printed_fps']:.1f} fps); "
              f"cold start, {INGEST_COLD_FRAMES} frames and one "
              f"registration in {metrics['cli_cold']['wall_s']:.2f} s "
              f"(its spans {metrics['cli_cold']['spans_s']})", flush=True)

        # K2 on this registration against its plain version (not counted)
        ml = vs._tlut[1]
        planar1 = C.frames_to_planar_i8(
            torch.from_numpy(np.stack(views)).to(dev))
        fn, plain = (lambda: m2.composite_mat2_planar(planar1, ml),
                     lambda: m2.composite_mat2_plain(planar1[None], ml)[0])
        err = float((fn().float() - plain().float()).abs().max())
        rows.append(kernel_row(
            m2.MAT2_SINGLE, "composite_mat2.cu", "composite_mat2.py:388", k2,
            err, event_ms(torch, fn, reps=10, warmup=2),
            event_ms(torch, plain, reps=2, warmup=1),
            *mat2_bound(mat2_needs(torch, ml, m2), ml.stage_table.numel() * 4,
                        ml.pano_hw[0] * ml.pano_hw[1], 1),
            library_ms=None, batch=1, path="ingest (lut)"))
    finally:
        for p in procs:
            p.kill()
        for p in procs:
            p.wait()
        for n in names:
            try:
                ShmRing.open(n).close(unlink=True)
            except OSError:
                pass
        tmp.cleanup()
        C.registration_dir.cleanup()
    left = sorted(f for f in os.listdir("/dev/shm")
                  if f.startswith(f"svt_smoke_{tag}"))
    if left:
        fail(f"ingest: rings left under /dev/shm: {left}")
    metrics["phase_s"] = time.perf_counter() - t_phase
    return rows, metrics


# -- the still path: Stitcher.stitch, compose_panorama, the full blend -------

# warm stitch() calls after the first, and the frames the full blend and
# the feather kernel are timed over
STILL_WARM, STILL_FRAMES = 2, 5
STILL_SPANS = ("registration", "seam_prep", "exposure_compensation",
               "seam_finding", "compositing")


def pano_gates(pano, mask, what: str) -> dict:
    """The reference's own gates of a still panorama (tests/test_stitcher.py
    :47-59): most of it covered, the covered part not black."""
    cover = float(mask.mean())
    mean = float(pano[mask].mean()) if mask.any() else 0.0
    if pano.ndim != 3 or pano.shape[2] != 3 or pano.dtype != np.uint8 \
            or cover <= 0.5 or mean <= 30:
        fail(f"{what}: panorama {pano.shape} {pano.dtype}, mask mean "
             f"{cover:.3f}, covered mean {mean:.1f}")
    return {"shape": list(pano.shape), "mask_mean": cover,
            "covered_mean": mean}


def device_busy(torch, fn, top: int = 5) -> dict:
    """One fn() under torch.profiler: the device's kernel time (the sum of
    the device-side events' time, one stream) against the host clock
    of the same run, and the kernels that took the most. The profiler's own
    cost lengthens the run, so the busy share is a lower bound."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    dev_s = sum(e.self_device_time_total for e in kernels) / 1e6
    kernels.sort(key=lambda e: -e.self_device_time_total)
    # no device-side event: the profiler did not see the card (not measured)
    return {"wall_s": wall, "device_s": dev_s,
            "busy_share": dev_s / wall if kernels else None,
            "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                    for e in kernels[:top]]}


def phase_still(C):
    """The still path on the stitcher phase's 5 x 1080p views:
    Stitcher(StitchConfig()).stitch (faithful: work-scale registration, the
    OpenCV-faithful compose at full resolution), cold and warm, every span
    timed; compose_panorama (faithful=False) on estimate_transform's
    Registration for the multiband and feather blends; one
    VideoStitcher.composite in feather mode with no state (the full blend)
    beside the feather kernel's on the same registration. Then the reduced
    scene from identical cameras, card against CPU: the faithful compose,
    the float canvas blends (multiband on ops/pyramid.py, feather) and
    compose_panorama from one Registration, and the int16 pyramid stages
    bit for bit. The path launches no kernel of the port's own. The phase
    runs under PyTorch's default flags (cuDNN may use TF32, float32 matrix
    products may not), so nothing here leans on the script's own."""
    torch = C.torch
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    try:
        return still_under_default_flags(C)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def conv_tf32_err(torch, dev) -> float:
    """How far cuDNN's TF32 flag moves the depthwise convolution that
    ops/filters.py sep_filter2d runs for the float pyramids: the same
    F.conv2d on a channels-last 0..255 input with the flag on against off
    (0: the port's float pyramids need no flag of their own)."""
    import torch.nn.functional as F
    g = torch.Generator(device=dev).manual_seed(5)
    x = (torch.rand((1, 1088, 1920, 3), device=dev, generator=g) * 255) \
        .permute(0, 3, 1, 2)
    w = torch.tensor([1., 4., 6., 4., 1.], device=dev).div(16) \
        .reshape(1, 1, 5, 1).expand(3, 1, 5, 1)
    out = []
    for on in (True, False):
        torch.backends.cudnn.allow_tf32 = on
        out.append(F.conv2d(x, w, groups=3))
    torch.backends.cudnn.allow_tf32 = True
    return float((out[0] - out[1]).abs().max())


def still_under_default_flags(C):
    torch, dev = C.torch, C.dev
    from stitchingvideo_tpu_torch import Registration, Stitcher
    from stitchingvideo_tpu_torch.blend.multiband_cv import \
        MultiBandBlenderCV
    from stitchingvideo_tpu_torch.models import compose_cv as cc
    from stitchingvideo_tpu_torch.models.stitcher import (
        _blend_on_canvas, _remap_gain_batch, _resize_all, _scale_for)
    from stitchingvideo_tpu_torch.ops import pyramid_int as pi
    from stitchingvideo_tpu_torch.register.pipeline import register_images
    from stitchingvideo_tpu_torch.utils import timing
    from stitchingvideo_tpu_torch.video.lut import build_lut
    frames = C.stitch_scene[0]
    frame_hw = frames[0].shape[:2]
    tracer = timing.GLOBAL_TRACER

    def timed(fn):
        """(fn(), its spans and total seconds), every span ending synced."""
        tracer.spans.clear()
        timing.set_sync_spans(True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        total = time.perf_counter() - t
        return out, dict({n: v[-1] for n, v in tracer.spans.items()},
                         total=total)

    def compose_cfg(**compose):
        cfg = C.StitchConfig()
        return cfg.replace(compose=dataclasses.replace(cfg.compose,
                                                       **compose))

    C.reset_counts()
    # -- stitch(), the default config: faithful, cylindrical, gain_blocks,
    # gc_color, multiband, full-resolution compose
    st = Stitcher(C.StitchConfig())
    (pano, mask), cold = timed(lambda: st.stitch(frames))
    warm = [timed(lambda: st.stitch(frames)) for _ in range(STILL_WARM)]
    if st.component() != list(range(N_CAMS)):
        fail(f"stitch() kept cameras {st.component()}")
    wrap = 2 * np.pi * float(st._last_result.warped_image_scale) \
        / st.work_scale()
    if pano.shape[1] > wrap + STITCH_WH[0]:
        fail(f"stitch(): panorama width {pano.shape[1]} exceeds one wrap "
             f"({wrap:.0f}) plus a view")
    gates = {"stitch": pano_gates(pano, mask, "stitch()")}
    warm_equal = [bool(np.array_equal(p[0], pano)
                       and np.array_equal(p[1], mask)) for p, _t in warm]
    if not all(warm_equal):
        fail(f"a warm stitch() differs from the cold one: {warm_equal}")

    # -- compose_panorama on estimate_transform's Registration
    reg, res, cscale = Stitcher(compose_cfg(faithful=False)) \
        .estimate_transform(frames)
    owned = (reg.seam_masks & reg.valid).reshape(N_CAMS, -1).sum(1).tolist()
    if min(owned) == 0:
        fail(f"a camera owns no canvas pixels: {owned}")
    compose_s = {}
    for bt in ("multiband", "feather"):
        sp = Stitcher(compose_cfg(faithful=False, blend_type=bt))
        runs = [timed(lambda: sp.compose_panorama(frames, reg, res, cscale))
                for _ in range(2)]
        p, m = runs[0][0]
        gates[f"compose_{bt}"] = pano_gates(p, m, f"compose_panorama({bt})")
        compose_s[bt] = [r[1]["total"] for r in runs]

    # -- the runtime's full blend: a registration with no feather state
    # (installed in 'lut' mode with the plain gather, then the mode
    # switched), beside the feather kernel on the same registration
    blend_vs = C.VideoStitcher(video_cfg(C, kernel="gather"))
    CW, CH = reg.canvas_wh
    lut = build_lut(reg, crop=blend_vs._crop_slices((CH, CW),
                                                    reg.extent_wh))
    blend_vs.install_lut(lut, frame_hw, reg=reg)
    blend_vs.cfg = video_cfg(C, kernel="gather", compose_mode="feather")
    feather_vs = C.VideoStitcher(video_cfg(C, compose_mode="feather"))
    feather_vs.install_lut(lut, frame_hw, reg=reg)
    if blend_vs._ftlut is not None or feather_vs._ftlut is None:
        fail("the full blend's stitcher holds a feather state, or the "
             "kernel's does not")
    full = blend_vs.composite(frames)
    torch.cuda.synchronize()
    launches = C.read_counts()
    print(f"still main path launches: {launched(launches)}", flush=True)
    if any(launches.values()):
        fail("the still path or the full blend launched a kernel")
    hot = feather_vs.composite(frames)
    if C.fe.FEATHER_SINGLE.launches != 1:
        fail("the feather stitcher did not launch its kernel")
    if full.shape != hot.shape or (full.sum(-1) > 0).mean() <= 0.5:
        fail(f"full blend {full.shape} against the kernel's {hot.shape}")
    cov = (full.sum(-1) > 0) & (hot.sum(-1) > 0)
    d = np.abs(hot.astype(np.int16) - full.astype(np.int16))[cov]
    full_vs_kernel = {"median": float(np.median(d)),
                      "within_4": float((d <= 4).mean()), "max": int(d.max())}
    # the reference's gate of its feather kernel against its full blend
    # (tests/test_pallas_feather.py:100-110)
    if full_vs_kernel["median"] > 1 or full_vs_kernel["within_4"] <= 0.99:
        fail(f"full blend vs feather kernel: {full_vs_kernel}")
    frame_ms = {
        "full_blend": latency(torch, lambda: blend_vs.composite(frames),
                              STILL_FRAMES),
        "feather_kernel": latency(torch, lambda: feather_vs.composite(frames),
                                  STILL_FRAMES)}
    busy = {"stitch": device_busy(torch, lambda: st.stitch(frames)),
            "full_blend": device_busy(torch,
                                      lambda: blend_vs.composite(frames))}

    # -- the reduced scene from identical cameras, card against CPU
    small_views = registration_scene(C.seed, "cpu", **SMALL_SCENE)[0]
    small = small_cfg(C.StitchConfig())
    sh, sw = small_views[0].shape[:2]
    ws = _scale_for(small.scales.work_megapix, sw, sh)
    sres = register_images(_resize_all(small_views, ws, "cpu"), small,
                           C.seed, device="cpu")
    kept = [small_views[i] for i in sres.indices]
    out = {str(d): cc.compose_panorama_cv(
        kept, sres.cameras, float(sres.warped_image_scale), ws, small,
        device=d) for d in (dev, "cpu")}
    (pc, mc), (pp, mp) = out[str(dev)], out["cpu"]
    if pc.shape != pp.shape:
        fail(f"reduced compose: card {pc.shape}, CPU {pp.shape}")
    d = np.abs(pc.astype(np.int16) - pp.astype(np.int16))
    card_vs_cpu = {"kept": sres.indices, "shape": list(pc.shape),
                   "median": float(np.median(d)),
                   "within_4": float((d <= 4).mean()), "max": int(d.max()),
                   "mask_diff_share": float((mc != mp).mean())}
    # the int16 stages on identical inputs, bit for bit
    rng = np.random.default_rng(C.seed + 11)
    x = torch.from_numpy(rng.integers(-3000, 3000, (256, 352, 3))
                         .astype(np.int16))
    lap = {str(d): pi.create_laplace_pyr_i16(x.to(d), 5) for d in (dev,
                                                                  "cpu")}
    exact = {
        "create_laplace_pyr_i16": all(
            torch.equal(a.cpu(), b) for a, b in zip(lap[str(dev)],
                                                    lap["cpu"])),
        "restore_laplace_i16": torch.equal(
            pi.restore_laplace_i16(lap[str(dev)]).cpu(),
            pi.restore_laplace_i16(lap["cpu"]))}
    imgs = rng.integers(0, 256, (2, 200, 300, 3)).astype(np.int16)
    masks = np.zeros((2, 200, 300), np.uint8)
    masks[0, 10:190, 5:200] = 255
    masks[1, 20:180, 150:295] = 255
    masks[1, 100:110, 150:160] = 97         # partial weights
    blended = []
    for d in (dev, "cpu"):
        mb = MultiBandBlenderCV(5, device=d)
        mb.prepare((-7, -11, 430, 214))
        for i, tl in enumerate(((-7, 3), (123, -11))):
            mb.feed_dev(torch.from_numpy(imgs[i]).to(d),
                        torch.from_numpy(masks[i]).to(d), tl)
        blended.append(mb.blend())
    exact["MultiBandBlenderCV"] = all(
        np.array_equal(a, b) for a, b in zip(*blended))
    card_vs_cpu["int16_exact"] = exact
    # the float canvas blends and compose_panorama from one Registration
    # (the CPU's), card against CPU: warped inputs made once on the CPU
    fcfg = small_cfg(compose_cfg(faithful=False))
    reg_p, res_p, cs_p = Stitcher(fcfg, device="cpu") \
        .estimate_transform(small_views)
    reg_c = Registration.from_state_dict(reg_p.state_dict(), device=dev)
    kept_p = _resize_all([small_views[i] for i in res_p.indices], cs_p, "cpu")
    Hs = max(v.shape[0] for v in kept_p)
    Ws = max(v.shape[1] for v in kept_p)
    batch = np.zeros((len(kept_p), Hs, Ws, 3), np.float32)
    for i, v in enumerate(kept_p):
        batch[i, :v.shape[0], :v.shape[1]] = v
    warped = _remap_gain_batch(torch.from_numpy(batch), reg_p.xmaps,
                               reg_p.ymaps, reg_p.gain_maps)
    float_blend = {}
    for bt in ("multiband", "feather", "no"):
        got = [_blend_on_canvas(
            warped.to(d), r.seam_masks, r.valid, reg_p.corners.numpy(),
            reg_p.canvas_wh, bt, fcfg.compose.blend_strength,
            fcfg.compose.feather_sharpness) for d, r in ((dev, reg_c),
                                                         ("cpu", reg_p))]
        cfg_bt = fcfg.replace(compose=dataclasses.replace(
            fcfg.compose, blend_type=bt))
        u8 = [Stitcher(cfg_bt, device=d).compose_panorama(
            small_views, r, res_p, cs_p) for d, r in ((dev, reg_c),
                                                      ("cpu", reg_p))]
        du8 = np.abs(u8[0][0].astype(np.int16) - u8[1][0].astype(np.int16))
        float_blend[bt] = {
            "max_abs": float((got[0][0].cpu() - got[1][0]).abs().max()),
            "mask_equal": bool(torch.equal(got[0][1].cpu(), got[1][1])),
            "compose_u8_max": int(du8.max()),
            "compose_u8_diff_share": float((du8 > 0).mean()),
            "compose_mask_equal": bool(np.array_equal(u8[0][1], u8[1][1]))}
    card_vs_cpu["float_blend"] = float_blend
    card_vs_cpu["conv_tf32_err"] = conv_tf32_err(torch, dev)
    print(f"still card vs CPU (3 x 320x240, identical cameras): "
          f"{card_vs_cpu}", flush=True)
    # float blends: within 1e-3 on 0..255 (TF32 would miss by ~1e-1), masks
    # equal; through compose_panorama's rounding: one step on <= 0.1%
    if card_vs_cpu["median"] > 1 or card_vs_cpu["within_4"] < 0.999 \
            or card_vs_cpu["mask_diff_share"] > 5e-3 \
            or not all(exact.values()) or any(
                f["max_abs"] > 1e-3 or not f["mask_equal"]
                or f["compose_u8_max"] > 1
                or f["compose_u8_diff_share"] > 1e-3
                or not f["compose_mask_equal"]
                for f in float_blend.values()):
        fail("the still path on the card misses the CPU's tolerance")

    metrics = {
        "stitch_cold": cold, "stitch_warm": [t for _p, t in warm],
        "warm_equal_to_cold": warm_equal,
        "compose_panorama_s": compose_s, "frame_ms": frame_ms,
        "device_busy": busy,
        "full_blend_vs_feather_kernel": full_vs_kernel, "gates": gates,
        "owned_px": owned, "canvas_wh": list(reg.canvas_wh),
        "launches": launched(launches), "card_vs_cpu": card_vs_cpu}
    print("still: stitch() cold " + ", ".join(
        f"{n} {cold.get(n, 0.0):.3f}" for n in STILL_SPANS)
        + f" (total {cold['total']:.3f} s); warm totals "
        + ", ".join(f"{t['total']:.3f}" for _p, t in warm) + " s; "
        f"panorama {pano.shape}; compose_panorama multiband "
        f"{compose_s['multiband']} s, feather {compose_s['feather']} s; "
        f"composite host to host p50: full blend "
        f"{frame_ms['full_blend']['p50_ms']:.2f} ms, feather kernel "
        f"{frame_ms['feather_kernel']['p50_ms']:.2f} ms; device busy: "
        f"{busy}", flush=True)
    return [], metrics


# -- canvas bands on one card: the sharded compose ---------------------------

SHARD_BANDS = (2, 4)
SHARD_B = 4                  # frame sets of the shard phase's micro-batch


def shard_cells(C):
    """(cell, mode, video config, install, frames, planar micro-batch,
    kernels) of the shard phase: the stitcher phase's registration in three
    modes, the mat2 cell's poisoned LUT and its clean LUT under 'mat'."""
    torch, m2, mat, fe, dev = C.torch, C.m2, C.mat, C.fe, C.dev
    src = C.stitch_vs
    views = C.stitch_scene[0]
    reg_frames = [np.roll(v, STITCH_ROLL * 3, axis=1) for v in views]
    reg_planar = C.frames_to_planar_i8(torch.from_numpy(np.stack(
        [np.stack([np.roll(v, STITCH_ROLL * b, axis=1) for v in views])
         for b in range(SHARD_B)])).to(dev))
    poisoned = C.CompositeLUT(*(torch.from_numpy(a) for a in
                                synthetic_lut(C.seed, poison=True)))

    def from_reg(v):
        v.install_lut(src._lut, src._frame_hw, reg=src._reg)

    def lut_of(lut):
        return lambda v: v.install_lut(lut, FRAME_HW)

    cell_planar = C.planar32[:SHARD_B]
    return (
        ("stitcher", "lut", {}, from_reg, reg_frames, reg_planar,
         (m2.MAT2_SINGLE, m2.MAT2_BATCHED)),
        ("stitcher", "feather", {"compose_mode": "feather"}, from_reg,
         reg_frames, reg_planar, (fe.FEATHER_SINGLE, fe.FEATHER_BATCHED)),
        ("stitcher", "multiband", {"compose_mode": "multiband"}, from_reg,
         reg_frames, reg_planar, (m2.PIECES_SINGLE,)),
        ("mat2", "lut", {}, lut_of(poisoned), C.frames, cell_planar,
         (m2.MAT2_SINGLE, m2.MAT2_BATCHED)),
        ("mat2", "mat", {"kernel": "mat"}, lut_of(C.clean_lut), C.frames,
         cell_planar, (mat.MAT_SINGLE, mat.MAT_BATCHED)))


def shard_state(vs, mode):
    """The sharded state a stitcher holds in `mode` (the multiband piece
    groups, or the mode's kernel state cut into canvas bands), or fail."""
    from stitchingvideo_tpu_torch.parallel.compose_multiband import \
        ShardedMultiband
    from stitchingvideo_tpu_torch.parallel.mesh import Banded
    if mode == "multiband":
        st, want = vs._mbtlut and vs._mbtlut[0], ShardedMultiband
    else:
        held = vs._ftlut if mode == "feather" else vs._tlut
        kind = {"feather": "fmat", "mat": "mat"}.get(mode, "mat2")
        st, want = held and held[0] == kind and held[1], Banded
    if not isinstance(st, want):
        fail(f"shard: {mode} built no sharded state")
    return st


def shard_kernels(C, mode, st, planar):
    """Per kernel of the mode: (launch one band, its plain version, the
    band's bound) for band b, and the batch each takes."""
    torch, m2, mat, fe = C.torch, C.m2, C.mat, C.fe
    one = planar[:1]
    if mode == "multiband":
        def bnd(b, B):
            w = st.warp[b]
            return pieces_bound(mat2_needs(torch, w, m2),
                                w.stage_table.numel() * 4,
                                w.pano_hw[0] * w.pano_hw[1], B)
        return [(lambda b: m2.composite_mat2_planar_pieces(
                    one[0], st.warp[b], st.pd),
                 lambda b: m2.composite_mat2_pieces_plain(
                     one, st.warp[b], st.pd)[0], bnd, 1, st.warp)]
    bands = st.bands
    if mode == "feather":
        def bnd(b, B):
            return feather_bound(feather_needs(torch, m2, bands[b]),
                                 bands[b].stage_table.numel() * 4, B)
        return [(lambda b: fe.composite_feather_planar(one[0], bands[b]),
                 lambda b: fe.composite_feather_plain(one, bands[b])[0],
                 bnd, 1, bands),
                (lambda b: fe.composite_feather_planar_batched(planar,
                                                               bands[b]),
                 lambda b: fe.composite_feather_plain(planar, bands[b]),
                 bnd, SHARD_B, bands)]
    if mode == "mat":
        def bnd(b, B):
            ml = bands[b]
            return mat_bound(mat_needs(torch, ml), ml.stage_table.numel() * 4,
                             ml.pano_hw[0] * ml.pano_hw[1], B)
        return [(lambda b: mat.composite_mat_planar(one[0], bands[b]),
                 lambda b: mat.composite_mat_plain(one, bands[b])[0],
                 bnd, 1, bands),
                (lambda b: mat.composite_mat_planar_batched(planar,
                                                            bands[b]),
                 lambda b: mat.composite_mat_plain(planar, bands[b]),
                 bnd, SHARD_B, bands)]

    def bnd(b, B):
        ml = bands[b]
        return mat2_bound(mat2_needs(torch, ml, m2),
                          ml.stage_table.numel() * 4,
                          ml.pano_hw[0] * ml.pano_hw[1], B)
    return [(lambda b: m2.composite_mat2_planar(one[0], bands[b]),
             lambda b: m2.composite_mat2_plain(one, bands[b])[0],
             bnd, 1, bands),
            (lambda b: m2.composite_mat2_planar_batched(planar, bands[b]),
             lambda b: m2.composite_mat2_plain(planar, bands[b]),
             bnd, SHARD_B, bands)]


SHARD_SOURCE = {"lut": ("composite_mat2.cu", ("composite_mat2.py:388",
                                              "composite_mat2.py:624")),
                "mat": ("composite_mat2.cu", ("composite_mat.py:150",) * 2),
                "feather": ("composite_feather.cu",
                            ("composite_feather.py:354",) * 2),
                "multiband": ("composite_mat2.cu",
                              ("composite_mat2.py:986",))}


def phase_shard(C):
    """The sharded compose on one card: a mesh that lists the card once a
    band, 2 and 4 bands, through `VideoStitcher(cfg, mesh=...)`. On the
    stitcher phase's registration (865 x 6015 out) in 'lut' (K2 a band for
    composite(), K1 a band for the micro-batch), 'feather' (K4) and
    'multiband' (the pieces kernel's single entry a band); on the mat2 cell
    (1280 x 7168, its poisoned LUT: K2/K1) and its clean LUT under
    kernel='mat' (K5). Gates: composite() and the micro-batch of SHARD_B
    frame sets equal to the single-device stitcher's bit for bit
    (multiband: median 0, >= 99.9% within 2, the reference's gate of its
    sharded path), the mode's kernels launched once a band a call, the
    single-frame kernel on the band streams, each band's launch bit-exact
    against its plain version. Times: a frame set's device path sharded
    beside single-device (CUDA events), the micro-batch per frame set."""
    torch, dev = C.torch, C.dev
    from stitchingvideo_tpu_torch.blend.multiband_video import \
        multiband_video_frame
    from stitchingvideo_tpu_torch.parallel.compose_multiband import (
        ShardedMultiband, multiband_sharded_frame)
    from stitchingvideo_tpu_torch.parallel.mesh import make_mesh
    t_phase = time.perf_counter()
    rows, metrics = [], {}
    for cell, mode, video, install, frames, planar, kernels in \
            shard_cells(C):
        frames_d = torch.from_numpy(np.stack(frames)).to(dev)
        one = C.VideoStitcher(video_cfg(C, **video))
        install(one)
        want = one.composite(frames)
        want_mb = one.composite_microbatch(planar) if len(kernels) > 1 \
            else None

        def device_path(v):
            if mode == "feather":
                return lambda: v.composite_feather_planar(frames_d)
            if mode != "multiband":
                return lambda: v.composite_planar(frames_d)
            st, crop = v._mbtlut
            p = C.frames_to_planar_i8(frames_d)
            if isinstance(st, ShardedMultiband):
                return lambda: multiband_sharded_frame(p, st, crop)
            return lambda: multiband_video_frame(p, st, crop)

        single_ms = event_ms(torch, device_path(one), reps=5, warmup=1)
        single_mb_ms = (event_ms(torch, lambda: one.composite_microbatch(
            planar), reps=5, warmup=1) / SHARD_B if want_mb is not None
            else None)
        for n in SHARD_BANDS:
            key = f"{cell}_{mode}_{n}"
            mesh = make_mesh(canvas=n, devices=[dev] * n)
            vs = C.VideoStitcher(video_cfg(C, **video), mesh=mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            install(vs)
            torch.cuda.synchronize()
            build_s = time.perf_counter() - t0
            st = shard_state(vs, mode)
            # the main path, counted; the single-frame kernel's streams
            first, streams, launch = kernels[0], [], kernels[0].launch

            def spy(*args):
                streams.append(torch.cuda.current_stream().cuda_stream)
                launch(*args)

            C.reset_counts()
            first.launch = spy
            try:
                got = vs.composite(frames)
                got_mb = (vs.composite_microbatch(planar)
                          if want_mb is not None else None)
                torch.cuda.synchronize()
            finally:
                first.launch = launch
            launches = C.read_counts()
            if streams != [s.cuda_stream for s in mesh.band_streams()]:
                fail(f"shard {key}: {first.name} not launched once a band "
                     "on the band streams")
            for k in kernels:
                if launches[k.name] != n:
                    fail(f"shard {key}: {k.name} launched "
                         f"{launches[k.name]} times, not once a band")
            m = {"bands": n, "build_s": build_s,
                 "launches": launched(launches)}
            if mode == "multiband":
                d = np.abs(got.astype(np.int16) - want)
                m.update(diff_median=float(np.median(d)),
                         within_2=float((d <= 2).mean()), diff_max=int(d.max()))
                if m["diff_median"] != 0 or m["within_2"] < 0.999:
                    fail(f"shard {key}: multiband misses its tolerance {m}")
            elif not np.array_equal(got, want) or \
                    not torch.equal(got_mb, want_mb):
                fail(f"shard {key}: sharded output != single-device output")
            m["ms"] = event_ms(torch, device_path(vs), reps=5, warmup=1)
            m["single_ms"] = single_ms
            if want_mb is not None:
                m["microbatch_ms_per_set"] = event_ms(
                    torch, lambda: vs.composite_microbatch(planar), reps=5,
                    warmup=1) / SHARD_B
                m["single_microbatch_ms_per_set"] = single_mb_ms
            source, tpu = SHARD_SOURCE[mode]
            for k, (run, plain, bnd, B, bands), tpu_line in zip(
                    kernels, shard_kernels(C, mode, st, planar), tpu):
                err = max(max_err(run(b), plain(b))
                          for b in range(len(bands)))
                rows.append(kernel_row(
                    k, source, tpu_line, launches[k.name], err,
                    event_ms(torch, lambda: run(0), reps=5, warmup=1),
                    event_ms(torch, lambda: plain(0), reps=1, warmup=0),
                    *bnd(0, B), library_ms=None, batch=B,
                    path=f"shard {cell} {mode}", bands=n,
                    band_px=bands[0].pano_hw[0] * bands[0].pano_hw[1]))
            metrics[key] = m
            print(f"shard {key}: {n} bands built in {build_s:.3f} s; a frame "
                  f"set {m['ms']:.4f} ms sharded vs {single_ms:.4f} ms on "
                  "one device" + (
                      f"; micro-batch {m['microbatch_ms_per_set']:.4f} vs "
                      f"{single_mb_ms:.4f} ms a set" if want_mb is not None
                      else f"; {m}") + f"; launches {m['launches']}",
                  flush=True)
            del vs, st, got, got_mb
        del one, want, want_mb
    metrics["phase_s"] = time.perf_counter() - t_phase
    print("shard: every band's launch bit-exact against its plain version; "
          "composite() and the micro-batch equal to one device's",
          flush=True)
    return rows, metrics


# -- the staged kernels against other sources of theirs ----------------------

# each entry point of --ab: its source's stem, then for a staged entry its
# pointer and int arguments before and since its staged signature (...,
# stage table, out, B, N, H, W, <tail>, stage bytes, stream; before it: ...,
# out, B, N, H, W, <tail>, stream, with a 64-bit pixel count last in the
# tail); the probe's signature is told apart by its declaration alone
AB_ENTRIES = {
    "composite_mat2": ("composite_mat2", 7, 2),
    "composite_mat": ("composite_mat2", 3, 2),
    "composite_mat2_pieces": ("composite_mat2", 7, 3),
    "composite_feather": ("composite_feather", 7, 2),
    "window_probe": ("window_probe", None, None),
}


def ab_argtypes(entry: str, staged: bool) -> list:
    """The launch signature of `entry`: staged (frames, the state, the stage
    table, out, B, N, H, W, the tail's ints, stage bytes, stream) or the
    earlier one-thread-a-pixel one (no table, no stage bytes, the tail's
    last int a 64-bit pixel count: npix, or the window's pixels). For the
    probe, `staged` means its TMA signature (frame, origins, out, nwin, H, W,
    align, stream), and otherwise the earlier cp.async one (..., W, bytes a
    copy, blocks, stream)."""
    P_, I_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if entry == "window_probe":
        return [P_] * 3 + [I_] * (4 if staged else 5) + [P_]
    _, n_state, n_tail = AB_ENTRIES[entry]
    if staged:
        return [P_] * (n_state + 3) + [I_] * (4 + n_tail + 1) + [P_]
    # the earlier tails: npix (mat2, mat, feather); pieces, window pixels
    n_old = 1 if n_tail == 2 else 2
    return [P_] * (n_state + 2) + [I_] * (4 + n_old - 1) + [L_, P_]


def ab_in_turns(torch, fns, reps: int, queued: bool = False) -> dict:
    """Each (name, fn) timed by CUDA events forward and back (a, b, ..., b,
    a): {name: [ms, ms]}."""
    times = {name: [] for name, _ in fns}
    for name, fn in fns + fns[::-1]:
        times[name].append(event_ms(torch, fn, reps=reps, warmup=2,
                                    queued=queued))
    return times


def ab_held(torch, fns, what: str) -> None:
    """Every version's output equal to the checkout's (fns[0]'s)."""
    want = fns[0][1]()
    for name, fn in fns[1:]:
        if not torch.equal(fn(), want):
            fail(f"{what}: {name} differs from the checkout")


def phase_ab(C, ab_dir: str):
    """The staged kernels of the checkout (mat2, mat, the pieces kernel,
    feather) and the window-copy probe against other versions of their
    sources, on the same inputs of the product rigs and the probe's origins:
    each subdirectory of `ab_dir` may hold a `composite_mat2.cu`, a
    `composite_feather.cu` (with the headers they include) and a
    `window_probe.cu`; each entry point's signature, the checkout's or an
    earlier one, is read from its declaration. Every version's output is
    held equal to the checkout's bit for bit; then all are timed by CUDA events in turns, forward and back (a, b, ...,
    b, a). An entry with no other version is not run."""
    import re
    from pathlib import Path
    _cuda = C.cuda
    libs = {entry: [] for entry in AB_ENTRIES}
    for d in sorted(p for p in Path(ab_dir).resolve().iterdir()
                    if p.is_dir()):
        for entry, (stem, _, _) in AB_ENTRIES.items():
            src = d / f"{stem}.cu"
            if not src.exists():
                continue
            decl = re.search(r'extern "C" int ' + entry + r'_launch\((.*?)\)',
                             src.read_text(), re.S)
            if decl is None:
                continue
            staged = ("align" in decl.group(1) if entry == "window_probe"
                      else "stage_bytes" in decl.group(1))
            lib = _cuda.KernelLibrary(stem, ab_argtypes(entry, staged),
                                      entry=entry)
            lib.source = src
            libs[entry].append((d.name, staged, lib))
    build_s = _cuda.build_all([lib for found in libs.values()
                               for _, _, lib in found])
    out = {"build_s": build_s, "cases": []}
    if any(libs[entry] for entry in AB_ENTRIES if entry != "window_probe"):
        out["cases"] += ab_staged(C, libs)
    if libs["window_probe"]:
        out["cases"] += ab_window_probe(C, libs["window_probe"])
    return [], out


def ab_staged(C, libs: dict) -> list:
    """--ab for the staged kernels on the product rigs."""
    torch, m2, mat, fe = C.torch, C.m2, C.mat, C.fe
    cases = []
    lut = C.CompositeLUT(*(torch.from_numpy(a).to(C.dev)
                           for a in synthetic_lut(C.seed, poison=True)))
    mat2 = m2.build_mat2_lut(lut, FRAME_HW)
    single = mat.build_mat_lut(C.clean_lut.to(C.dev), FRAME_HW)
    vs = C.VideoStitcher(video_cfg(C, compose_mode="feather"))
    save_and_load(vs, feather_registration(C.seed))
    fml = vs._ftlut[1]
    vs = C.VideoStitcher(video_cfg(C, compose_mode="multiband"))
    save_and_load(vs, multiband_registration(C.seed))
    st = vs._mbtlut[0]
    wml, Nv = st.warp_lut, len(st.piece_cam)
    Hb, Wb = st.buf_hw
    stream = torch.cuda.current_stream().cuda_stream
    u8 = torch.uint8
    for entry, ml, state, new_fn, tail, out_shape, Bs in (
            ("composite_mat2", mat2,
             (mat2.tap_xy, mat2.tap_cw, mat2.gc, mat2.fb_cam, mat2.fb_sx,
              mat2.fb_sy, mat2.fb_gain), m2.composite_mat2_planar_batched,
             ((*PANO_HW,), (PANO_HW[0] * PANO_HW[1],)), (3,) + PANO_HW,
             (1, 16, 32)),
            ("composite_mat", single,
             (single.tap_xy, single.tap_cw, single.gc),
             mat.composite_mat_planar_batched,
             ((*PANO_HW,), (PANO_HW[0] * PANO_HW[1],)), (3,) + PANO_HW,
             (1, 16)),
            ("composite_mat2_pieces", wml,
             (wml.tap_xy, wml.tap_cw, wml.gc, wml.fb_cam, wml.fb_sx,
              wml.fb_sy, wml.fb_gain),
             lambda p, ml: m2.composite_mat2_planar_pieces_batched(p, ml, Nv),
             ((Nv, Hb, Wb), (Nv, Hb * Wb)), (Nv, 3, Hb, Wb), (1, 8)),
            ("composite_feather", fml,
             (fml.tap_xy, fml.tap_cw, fml.gw, fml.fb_cam, fml.fb_sx,
              fml.fb_sy, fml.fb_gw), fe.composite_feather_planar_batched,
             ((*PANO_HW,), (PANO_HW[0] * PANO_HW[1],)), (3,) + PANO_HW,
             (1, 16))):
        if not libs[entry]:
            continue
        dtype = torch.bfloat16 if entry == "composite_mat2_pieces" else u8
        for B in Bs:
            planar = C.planar32[:B]

            def version(lib, staged, dst):
                head = (planar,) + state + ((ml.stage_table,) if staged
                                            else ()) + (dst,)
                rest = tail[0] + (ml.stage_bytes,) if staged else tail[1]
                return lambda: (lib(*(t.data_ptr() for t in head), B, N_CAMS,
                                    *FRAME_HW, *rest, stream), dst)[1]

            fns = [("checkout", lambda: new_fn(planar, ml))]
            for name, staged, lib in libs[entry]:
                fns.append((name, version(lib, staged, torch.empty(
                    (B,) + out_shape, dtype=dtype, device=C.dev))))
            ab_held(torch, fns, f"{entry} at B={B}")
            times = ab_in_turns(torch, fns, reps=20)
            cases.append({"kernel": entry, "batch": B, "ms": times})
            print(f"ab {entry} B={B}: " + "; ".join(
                f"{name} {t[0]:.4f} / {t[1]:.4f}" for name, t in
                times.items()) + " ms", flush=True)
            del fns
    return cases


def ab_window_probe(C, versions: list) -> list:
    """--ab for the window-copy probe: each version on the same origins at
    every alignment it takes (the cp.async signature: 4 and above), at the
    three sizes of the probe phase."""
    torch, wp, dev = C.torch, C.wp, C.dev
    frame, big, rng = probe_frames(C)
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = []
    for align in PROBE_ALIGNS:
        for what, f, n, reps in (("l2", frame, PROBE_WINDOWS, 50),
                                 ("l2", frame, PROBE_MANY, 10),
                                 ("hbm", big, PROBE_MANY, 10)):
            org = probe_origins(torch, rng, n, tuple(f.shape[1:]), align, dev)

            def version(lib, tma, f=f, org=org, n=n):
                dst = torch.empty((n, 2, wp.WIN_W // 2), dtype=torch.float32,
                                  device=dev)
                head = (f.data_ptr(), org.data_ptr(), dst.data_ptr(), n,
                        *f.shape[1:])
                rest = (align,) if tma else (min(16, align), sms)
                return lambda: (lib(*head, *rest, stream), dst)[1]

            fns = [("checkout", lambda f=f, org=org: wp.window_probe(
                f, org, align))]
            fns += [(name, version(lib, tma)) for name, tma, lib in versions
                    if tma or align >= 4]
            if len(fns) < 2:
                continue
            ab_held(torch, fns, f"window_probe {what} {n} windows align "
                    f"{align}")
            times = ab_in_turns(torch, fns, reps, queued=True)
            cases.append({"kernel": "window_probe", "align": align,
                          "from": what, "windows": n, "ms": times})
            print(f"ab window_probe align {align} {what} {n} windows: " +
                  "; ".join(f"{name} {t[0] * 1e3:.2f} / {t[1] * 1e3:.2f}"
                            for name, t in times.items()) + " us",
                  flush=True)
    return cases


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", metavar="DIR", default="",
                    help="instead of the phases, hold the staged kernels "
                         "against the versions of their sources in the "
                         "subdirectories of DIR and time all in turns")
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    try:
        from stitchingvideo_tpu_torch import StitchConfig, VideoStitcher
        from stitchingvideo_tpu_torch.blend import multiband_video as mb
        from stitchingvideo_tpu_torch.ops import _cuda
        from stitchingvideo_tpu_torch.ops import composite as tiled
        from stitchingvideo_tpu_torch.ops import composite_feather as fe
        from stitchingvideo_tpu_torch.ops import composite_mat as mat
        from stitchingvideo_tpu_torch.ops import composite_mat2 as m2
        from stitchingvideo_tpu_torch.ops import window_probe as wp
        from stitchingvideo_tpu_torch.ops.remap_tiled import remap_tiled
        from stitchingvideo_tpu_torch.ops.staging import (STAGE_BUDGET,
                                                          staging_table)
        from stitchingvideo_tpu_torch.video.lut import (CompositeLUT,
                                                        composite_frame_u8)
    except ImportError as e:
        fail(f"the port's package is not beside chip_smoke.py ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = (m2.MAT2_SINGLE, m2.MAT2_BATCHED, m2.SHIFT_BN, mat.MAT_SINGLE,
               mat.MAT_BATCHED, tiled.TILED, fe.FEATHER_SINGLE,
               fe.FEATHER_BATCHED, m2.PIECES_SINGLE, m2.PIECES_BATCHED,
               wp.WINDOW_PROBE)

    def reset_counts():
        for k in kernels:
            k.launches = 0

    # -- 1. the card ---------------------------------------------------
    card = card_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}", flush=True)

    # -- 2. build ------------------------------------------------------
    build_s = _cuda.build_all(_cuda.LIBRARIES)
    print(f"build: {len({lib.source for lib in _cuda.LIBRARIES})} sources "
          f"in {build_s:.2f} s", flush=True)

    # -- 3. the rig ----------------------------------------------------
    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed + 1)
    frames = list(rng.integers(0, 256, (N_CAMS,) + FRAME_HW + (3,),
                               dtype=np.uint8))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    C = types.SimpleNamespace(
        torch=torch, dev=dev, seed=args.seed, m2=m2, mat=mat, tiled=tiled,
        fe=fe, mb=mb, wp=wp, StitchConfig=StitchConfig,
        VideoStitcher=VideoStitcher,
        CompositeLUT=CompositeLUT, composite_frame_u8=composite_frame_u8,
        frames_to_planar_i8=mat.frames_to_planar_i8,
        planar_to_hwc=mat.planar_to_hwc, remap_tiled=remap_tiled,
        reset_counts=reset_counts, staging_table=staging_table,
        STAGE_BUDGET=STAGE_BUDGET, cuda=_cuda,
        read_counts=lambda: {k.name: k.launches for k in kernels},
        frames=frames, frames_d=torch.from_numpy(np.stack(frames)).to(dev),
        planar32=torch.randint(-128, 128, (32, N_CAMS, 3) + FRAME_HW,
                               dtype=torch.int8, device=dev, generator=gen),
        clean_lut=CompositeLUT(*(torch.from_numpy(a) for a in
                                 synthetic_lut(args.seed, poison=False))))
    print(f"rig: {time.perf_counter() - t0:.2f} s", flush=True)

    # -- 4-9. the paths ------------------------------------------------
    rows, metrics = [], {"card": card, "kind": kind, "build_s": build_s}
    phases = (("mat2", phase_mat2), ("mat", phase_mat),
              ("tiled", phase_tiled), ("feather", phase_feather),
              ("multiband", phase_multiband), ("window_probe", phase_probe),
              ("registration", phase_registration),
              ("stitcher", phase_stitcher), ("shard", phase_shard),
              ("stream", phase_stream), ("ingest", phase_ingest),
              ("still", phase_still))
    if args.ab:
        phases = (("ab", lambda C: phase_ab(C, args.ab)),)
    for name, phase in phases:
        t0 = time.perf_counter()
        phase_rows, metrics[name] = phase(C)
        rows += phase_rows
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        print(f"{name}: phase took {time.perf_counter() - t0:.1f} s",
              flush=True)
    metrics["max_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"metrics": metrics}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
