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
  9. the window-copy probe (`window_probe`): 512 windows of [3, 32, 256]
     int8 staged into shared memory with asynchronous copies at origins
     aligned to 128, 32, 16, 8 and 4 columns, bit-exact against slices of
     the frame, each timed beside its byte bound.
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
  11. times: each kernel's time beside its bound, its plain version's and,
     where one PyTorch call computes the same function, that call's; printed
     as a `{"kernels": [...]}` line and a `{"metrics": ...}` line, then the
     card line, then the last line `{"ok": true, "device": {...}}`.

Inputs are random, made from --seed; nothing is read from disk but the
checkout itself and the registration file the script wrote.

    python3 chip_smoke.py --ab DIR   # instead of the phases above

times the staged kernels (mat2, mat, the multiband warp stage's pieces
kernel, feather) against other versions of their sources (one subdirectory
of DIR each, e.g. an earlier commit's `csrc/`) in turns on the product rigs,
each version's output held equal to the checkout's.
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


def event_ms(torch, fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of fn() over reps calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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

    def mat2_bound(B):
        # each input byte the function needs read once, each output written
        # once: the frame sectors the taps touch, B times; the LUT as read
        # and the staging table; B*3 output planes. ~14 operations a pixel,
        # channel and frame set on the integer path (4 int multiplies, 3
        # adds, convert, 3 float ops, round, 2 clamps), ~16 on the float
        # path of a fallback pixel
        return bound(B * need["frame_bytes"] + need["lut_bytes"]
                     + staging["table_bytes"] + B * 3 * npix,
                     B * 3 * (14 * need["kernel_px"]
                              + 16 * need["fallback_px"]))

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
            *mat2_bound(B),
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
        "mat2_kernel_ms_b32": ms32, "mat2_bound_ms_b32": mat2_bound(32)[0],
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

    Hp, Wp = ml.pano_hw
    npix = Hp * Wp
    n_kern = int((ml.tap_cw >= 0).sum())
    frame_bytes = sector_bytes(torch, [int_taps(ml.fields(), ml.frame_hw)],
                               ml.frame_hw)
    lut_bytes = 4 * npix + 8 * n_kern     # tap_cw; tap_xy, gc where covered

    def mat_bound(B):
        # the frame sectors, B times; the LUT as read and the staging
        # table; B*3 output planes
        return bound(B * frame_bytes + lut_bytes + staging["table_bytes"]
                     + B * 3 * npix, B * 3 * 14 * n_kern)

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
            *mat_bound(B),
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
        "needs": {"frame_bytes": frame_bytes, "lut_bytes": lut_bytes,
                  "kernel_px": n_kern},
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

    taps = [int_taps(ml.fields(s), ml.frame_hw) for s in range(2)]
    taps += [float_taps(m2, ml.fb_cam[:, s], ml.fb_sx[:, s], ml.fb_sy[:, s],
                        ml.frame_hw) for s in range(2)]
    frame_bytes = sector_bytes(torch, taps, ml.frame_hw)
    del taps
    n_fb = ml.fb_pix.numel()
    n_fb_live = int((ml.fb_cam >= 0).sum())
    # tap_cw of both slots (slot 0's alone on a fallback pixel); tap_xy and
    # gw of a live slot; tap_xy and the four fb_* entries of both slots of a
    # fallback pixel
    state_bytes = 8 * npix - 4 * n_fb + 8 * sum(n_live) + 36 * n_fb

    def feather_bound(B):
        # a live slot ~12 operations a channel and frame set, a pixel's tail
        # 4; a fallback pixel's live slot ~14. The state as read and the
        # staging table
        return bound(B * frame_bytes + state_bytes + staging["table_bytes"]
                     + B * 3 * npix,
                     B * 3 * (12 * sum(n_live) + 4 * npix + 14 * n_fb_live))

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
            *feather_bound(B),
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
        "needs": {"frame_bytes": frame_bytes, "state_bytes": state_bytes,
                  "live_slot_px": n_live, "fallback_px": n_fb},
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

    def pieces_bound(B):
        # frame sectors the taps touch, B times; the state as read and the
        # staging table; 2 bytes a value out. Operations as mat2, plus a
        # convert a value
        return bound(B * need["frame_bytes"] + need["lut_bytes"]
                     + staging["table_bytes"] + B * 3 * npix * 2,
                     B * 3 * (15 * need["kernel_px"]
                              + 17 * need["fallback_px"] + 1 * npix))

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
            *pieces_bound(B),
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

def phase_probe(C):
    torch, wp, dev = C.torch, C.wp, C.dev
    H, W, NWIN = 1088, 1920, 512                # the TPU probe's sizes
    rng = np.random.default_rng(C.seed + 3)
    frame = torch.from_numpy(rng.integers(-128, 127, (3, H, W),
                                          dtype=np.int8)).to(dev)
    window_bytes = NWIN * 3 * wp.WIN_H * wp.WIN_W
    rows, metrics = [], {}
    for align in (128, 32, 16, 8, 4):
        oy = rng.integers(0, (H - wp.WIN_H) // 8, NWIN) * 8
        ox = rng.integers(0, (W - wp.WIN_W) // align, NWIN) * align
        org = torch.from_numpy(np.stack([oy, ox], 1).astype(np.int32)).to(dev)
        C.reset_counts()
        got = wp.window_probe(frame, org, align)
        torch.cuda.synchronize()
        launches = wp.WINDOW_PROBE.launches
        want = wp.window_probe_plain(frame, org)
        err = 0.0 if torch.equal(got, want) else \
            float((got - want).abs().nan_to_num(nan=float("inf")).max())
        # every distinct frame byte under a window once, the origins, the sums
        touched = torch.zeros((H, W), dtype=torch.bool, device=dev)
        touched[wp.window_index(org)] = True
        nbytes = 3 * int(touched.sum()) + org.numel() * 4 + got.numel() * 4
        ms = event_ms(torch, lambda: wp.window_probe(frame, org, align),
                      reps=50, warmup=5)
        rows.append(kernel_row(
            wp.WINDOW_PROBE, "window_probe.cu", "test_misaligned_dma.py:21",
            launches, err, ms,
            event_ms(torch, lambda: wp.window_probe_plain(frame, org),
                     reps=3, warmup=1),
            *bound(nbytes, window_bytes),        # one add a window byte
            # no one PyTorch call sums windows at given origins
            library_ms=None, replaces_in="scripts/", align=align,
            copy_bytes=wp.copy_bytes(align),
            window_gb_per_s=window_bytes / (ms * 1e-3) / 1e9))
        # the same at 32 times the windows, where a call lasts long enough
        # for the copy rate, not the launch, to set its time
        many = org.repeat(32, 1)
        many_ms = event_ms(torch, lambda: wp.window_probe(frame, many, align),
                           reps=10, warmup=2)
        if not torch.equal(wp.window_probe(frame, many, align)[:NWIN], want):
            fail(f"window_probe at {many.shape[0]} windows differs")
        metrics[f"align{align}"] = {
            "ms": ms, "copy_bytes": wp.copy_bytes(align),
            "window_gb_per_s": rows[-1]["window_gb_per_s"],
            "distinct_bytes": nbytes, "windows_x32_ms": many_ms,
            "windows_x32_gb_per_s": 32 * window_bytes / (many_ms * 1e-3) / 1e9}
        print(f"window_probe align {align} ({wp.copy_bytes(align)}-byte "
              f"copies): {ms * 1e3:.2f} us, "
              f"{rows[-1]['window_gb_per_s']:.1f} GB/s of window bytes, "
              f"bound {rows[-1]['bound_ms'] * 1e3:.2f} us; at {many.shape[0]} "
              f"windows {many_ms * 1e3:.1f} us, "
              f"{metrics[f'align{align}']['windows_x32_gb_per_s']:.1f} GB/s",
              flush=True)
    # an origin off the frame or off its alignment comes back as NaN
    bad = torch.tensor([[H - 8, 0], [0, 130]], dtype=torch.int32, device=dev)
    if not bool(wp.window_probe(frame, bad, 128).isnan().all()):
        fail("window_probe copied a window it must refuse")
    print("window_probe: bit-exact against the plain version at every "
          "alignment", flush=True)
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


# -- the staged kernels against other sources of theirs ----------------------

# each staged entry point: its source's stem, its pointer and int arguments
# before and since its staged signature (..., stage table, out, B, N, H, W,
# <tail>, stage bytes, stream; before it: ..., out, B, N, H, W, <tail>,
# stream, with a 64-bit pixel count last in the tail)
AB_ENTRIES = {
    "composite_mat2": ("composite_mat2", 7, 2),
    "composite_mat": ("composite_mat2", 3, 2),
    "composite_mat2_pieces": ("composite_mat2", 7, 3),
    "composite_feather": ("composite_feather", 7, 2),
}


def ab_argtypes(entry: str, staged: bool) -> list:
    """The launch signature of `entry`: staged (frames, the state, the stage
    table, out, B, N, H, W, the tail's ints, stage bytes, stream) or the
    earlier one-thread-a-pixel one (no table, no stage bytes, the tail's
    last int a 64-bit pixel count: npix, or the window's pixels)."""
    P_, I_, L_ = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    _, n_state, n_tail = AB_ENTRIES[entry]
    if staged:
        return [P_] * (n_state + 3) + [I_] * (4 + n_tail + 1) + [P_]
    # the earlier tails: npix (mat2, mat, feather); pieces, window pixels
    n_old = 1 if n_tail == 2 else 2
    return [P_] * (n_state + 2) + [I_] * (4 + n_old - 1) + [L_, P_]


def phase_ab(C, ab_dir: str):
    """The staged kernels of the checkout (mat2, mat, the pieces kernel,
    feather) against other versions of their sources, on the same inputs of
    the product rigs: each subdirectory of `ab_dir` may hold a
    `composite_mat2.cu` and a `composite_feather.cu` (with the headers they
    include); each entry point's signature, the checkout's staged one or the
    earlier one-thread-a-pixel one, is read from its declaration. Every
    version's output is held equal to the checkout's bit for bit; then all
    are timed by CUDA events in turns, forward and back (a, b, ..., b, a)."""
    import re
    from pathlib import Path
    torch, m2, mat, fe, _cuda = C.torch, C.m2, C.mat, C.fe, C.cuda
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
            staged = "stage_bytes" in decl.group(1)
            lib = _cuda.KernelLibrary(stem, ab_argtypes(entry, staged),
                                      entry=entry)
            lib.source = src
            libs[entry].append((d.name, staged, lib))
    build_s = _cuda.build_all([lib for found in libs.values()
                               for _, _, lib in found])
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
    out = {"build_s": build_s, "cases": []}
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
            want = fns[0][1]()
            for name, fn in fns[1:]:
                if not torch.equal(fn(), want):
                    fail(f"{entry} at B={B}: {name} differs from the checkout")
            times = {name: [] for name, _ in fns}
            for name, fn in fns + fns[::-1]:
                times[name].append(event_ms(torch, fn, reps=20, warmup=2))
            case = {"kernel": entry, "batch": B, "ms": times}
            out["cases"].append(case)
            print(f"ab {entry} B={B}: " + "; ".join(
                f"{name} {t[0]:.4f} / {t[1]:.4f}" for name, t in
                times.items()) + " ms", flush=True)
            del want, fns
    return [], out


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
              ("registration", phase_registration))
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
