#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the root of a checkout, one card

What it does, in phases (any failure exits non-zero):
  1. prints the card's name and power limit (nvidia-smi) and the versions;
  2. builds every CUDA kernel of the port from `stitchingvideo_tpu_torch/csrc`
     (one nvcc per source, all started together);
  3. builds the product-size synthetic rig in numpy: bench.py's 5-camera
     cylindrical LUT (1080x1920 frames -> 1280x7168 panorama) with a few
     tiles poisoned to span 3 cameras, so the fallback path is live, and
     installs it with `VideoStitcher().install_lut`;
  4. the main path, with every launch count set to 0 before and read after:
     `composite` of one frame set, `composite_microbatch` at B=16 and B=32;
     each kernel's output is held bit-exact against its plain PyTorch
     version on the card (TF32 off), the single-frame output against the
     exact gather oracle (median <= 1, >= 99.9% within 4), and batched
     output against single output;
  5. the band-shift copy `shift_planar_bn` through its own entry point, bit-
     exact against its plain version;
  6. times: micro-batch fps at B=16/32, B=1 latency p50/p95, and each
     kernel's time beside its bound, its plain version's and a library
     call's; printed as a `{"kernels": [...]}` line and a `{"metrics": ...}`
     line, then the card line, then the last line
     `{"ok": true, "device": {...}}`.

Inputs are random, made from --seed; nothing is read from disk but the
checkout itself.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# H100 SXM peaks (NVIDIA data sheet, at the full 700 W power limit)
HBM_BYTES_PER_S = 3.35e12
CUDA_CORE_OPS_PER_S = 67e12        # float32 outside the tensor cores

FRAME_HW = (1080, 1920)
PANO_HW = (1280, 7168)
N_CAMS = 5
TPU_SRC = "stitchingvideo_tpu/ops/pallas/composite_mat2.py"


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


def synthetic_lut(seed: int):
    """bench.py's cylindrical 5-camera 360 LUT, in numpy, with four tiles
    poisoned to span 3 cameras (not representable by two windows)."""
    fh, fw = FRAME_HW
    pano_h, pano_w = PANO_HW
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


def mat2_needs(ml, m2) -> dict:
    """What the mat2 function must read for this LUT, for its bound.

    frame_bytes: bytes of one frame set in the 32-byte sectors that some
      pixel's four clamped taps read, the distinct (cam, row, column // 32)
      over kernel pixels and covered fallback pixels, times 3 channels (the
      planes are 32-byte aligned, so each channel reads the same sectors);
    lut_bytes: the LUT as the kernel reads it: tap_cw of every pixel; tap_xy
      and gc of a kernel pixel; tap_xy and fb_cam of a fallback pixel, and
      fb_sx, fb_sy, fb_gain of a covered one;
    kernel_px, fallback_px: pixels on the integer path and covered pixels on
      the float path."""
    import torch
    fh, fw = ml.frame_hw
    if (fh * fw) % 32:
        fail(f"frame planes of {fh}x{fw} bytes are not 32-byte aligned")
    f = ml.fields()
    kern = f["cam"] >= 0
    fb_cov = ml.fb_cam >= 0
    fx0, fy0, fx1, fy1, _, _ = m2.bilinear_taps(ml.fb_sx[fb_cov],
                                                ml.fb_sy[fb_cov], fh, fw)
    cam = torch.cat([f["cam"][kern].long(), ml.fb_cam[fb_cov].long()])
    x0, y0 = f["x0"][kern].long(), f["y0"][kern].long()
    xs = (torch.cat([x0, fx0]), torch.cat([(x0 + 1).clamp(max=fw - 1), fx1]))
    ys = (torch.cat([y0, fy0]), torch.cat([(y0 + 1).clamp(max=fh - 1), fy1]))
    sectors = torch.unique(torch.cat([((cam * fh + y) * fw + x) // 32
                                      for y in ys for x in xs]))
    n_kern, n_fb_cov = int(kern.sum()), int(fb_cov.sum())
    return {"frame_bytes": 3 * 32 * int(sectors.numel()),
            "lut_bytes": (4 * ml.tap_cw.numel() + 8 * n_kern
                          + 8 * ml.fb_pix.numel() + 12 * n_fb_cov),
            "kernel_px": n_kern, "fallback_px": n_fb_cov}


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this needs a CUDA card")
    try:
        from stitchingvideo_tpu_torch import VideoStitcher
        from stitchingvideo_tpu_torch.ops import _cuda
        from stitchingvideo_tpu_torch.ops import composite_mat2 as m2
        from stitchingvideo_tpu_torch.ops.composite_mat import (
            frames_to_planar_i8, planar_to_hwc)
        from stitchingvideo_tpu_torch.video.lut import (CompositeLUT,
                                                        composite_frame_u8)
    except ImportError as e:
        fail(f"the port's package is not beside chip_smoke.py ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kernels = (m2.MAT2_SINGLE, m2.MAT2_BATCHED, m2.SHIFT_BN)

    # -- 1. the card ---------------------------------------------------
    card = card_line()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}", flush=True)

    # -- 2. build ------------------------------------------------------
    build_s = _cuda.build_all(_cuda.LIBRARIES)
    print(f"build: {len(_cuda.LIBRARIES)} kernels in {build_s:.2f} s",
          flush=True)

    # -- 3. the rig ----------------------------------------------------
    t0 = time.perf_counter()
    cam, sx, sy, gain = synthetic_lut(args.seed)
    lut = CompositeLUT(*(torch.from_numpy(a) for a in (cam, sx, sy, gain)))
    rng = np.random.default_rng(args.seed + 1)
    frames = list(rng.integers(0, 256, (N_CAMS,) + FRAME_HW + (3,),
                               dtype=np.uint8))
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)
    planar32 = torch.randint(-128, 128, (32, N_CAMS, 3) + FRAME_HW,
                             dtype=torch.int8, device=dev, generator=gen)
    rig_s = time.perf_counter() - t0
    vs = VideoStitcher()
    t0 = time.perf_counter()
    vs.install_lut(lut, FRAME_HW)
    torch.cuda.synchronize()
    install_s = time.perf_counter() - t0
    ml = vs._tlut[1]
    n_kernel_px = int((ml.tap_cw >= 0).sum())
    print(f"rig: {rig_s:.2f} s; install_lut: {install_s:.3f} s; pano "
          f"{ml.pano_hw}, {ml.n_fallback} fallback tiles "
          f"({ml.fb_pix.numel()} px), {n_kernel_px} kernel px", flush=True)
    if ml.n_fallback == 0:
        fail("the poisoned tiles did not become fallback tiles")

    # -- 4. the main path ----------------------------------------------
    for k in kernels:
        k.launches = 0
    pano1 = vs.composite(frames)
    out16 = vs.composite_microbatch(planar32[:16])
    out32 = vs.composite_microbatch(planar32)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    print(f"main path launches: {launches}", flush=True)
    for k in (m2.MAT2_SINGLE, m2.MAT2_BATCHED):
        if launches[k.name] == 0:
            fail(f"the main path never launched {k.name}")

    frames_d = torch.from_numpy(np.stack(frames)).to(dev)
    planar1 = frames_to_planar_i8(frames_d)
    plain1 = m2.composite_mat2_plain(planar1[None], ml)[0]
    got1 = torch.from_numpy(pano1).to(dev).permute(2, 0, 1)
    err = {"single": int((got1.int() - plain1.int()).abs().max())}
    if err["single"]:
        fail(f"composite != plain version, max |diff| {err['single']}")
    oracle = composite_frame_u8(frames_d, vs._lut).permute(2, 0, 1)
    diff = (got1.int() - oracle.int()).abs()
    med, within4 = float(diff.float().median()), float((diff <= 4).float()
                                                         .mean())
    print(f"vs gather oracle: median |diff| {med}, within 4: {within4:.6f}",
          flush=True)
    if med > 1 or within4 < 0.999:
        fail("composite misses the gather oracle's tolerance")
    fb = ml.fb_pix
    if not torch.equal(got1.reshape(3, -1)[:, fb],
                       oracle.reshape(3, -1)[:, fb]):
        fail("fallback tiles are not bit-exact against the gather oracle")
    plain32 = torch.stack([m2.composite_mat2_plain(planar32[b:b + 8], ml)
                           for b in range(0, 32, 8)]).reshape(out32.shape)
    err["batched"] = int((out32.int() - plain32.int()).abs().max())
    if err["batched"]:
        fail(f"batched kernel != plain version, max |diff| {err['batched']}")
    if not torch.equal(out16, out32[:16]):
        fail("B=16 and B=32 outputs differ on the same frame sets")
    for b in (0, 31):
        if not torch.equal(m2.composite_mat2_planar(planar32[b], ml),
                           out32[b]):
            fail(f"batched output {b} differs from the single-frame output")
    if not torch.equal(planar_to_hwc(got1).cpu(), torch.from_numpy(pano1)):
        fail("planar_to_hwc round trip")
    print("main path: kernel outputs bit-exact against plain versions, "
          "batched == single", flush=True)

    # -- 5. the band-shift copy, through its own entry point ------------
    planar16 = planar32[:16].contiguous()
    m2.SHIFT_BN.launches = 0
    shifted = m2.shift_planar_bn(planar16)
    torch.cuda.synchronize()
    launches[m2.SHIFT_BN.name] = m2.SHIFT_BN.launches
    if launches[m2.SHIFT_BN.name] == 0:
        fail("shift_planar_bn never launched its kernel")
    shifted_plain = m2.shift_planar_bn_plain(planar16)
    err["shift"] = int((shifted.int() - shifted_plain.int()).abs().max())
    if err["shift"]:
        fail(f"shift_planar_bn != plain version, max |diff| {err['shift']}")
    del shifted, shifted_plain
    print("shift_planar_bn: bit-exact against its plain version", flush=True)

    # -- 6. times ------------------------------------------------------
    # the wrappers are timed as the main path calls them; their launch
    # counts were read in phase 4
    Hp, Wp = ml.pano_hw
    npix = Hp * Wp
    fh, fw = FRAME_HW
    need = mat2_needs(ml, m2)
    print(f"mat2 reads {need['frame_bytes']} of {N_CAMS * 3 * fh * fw} "
          f"frame bytes a frame set (the sectors its taps touch) and "
          f"{need['lut_bytes']} LUT bytes", flush=True)

    def mat2_bound(B):
        # each input byte the function needs read once, each output written
        # once: the frame sectors the taps touch, B times; the LUT as read;
        # B*3 output planes. ~14 operations a pixel, channel and frame set
        # on the integer path (4 int multiplies, 3 adds, convert, 3 float
        # ops, round, 2 clamps), ~16 on the float path of a fallback pixel
        nbytes = B * need["frame_bytes"] + need["lut_bytes"] + B * 3 * npix
        ops = B * 3 * (14 * need["kernel_px"] + 16 * need["fallback_px"])
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = ops / CUDA_CORE_OPS_PER_S * 1e3
        return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                     else "operations")

    rows = []
    for k, B, tpu_line, fn in (
            (m2.MAT2_SINGLE, 1, 388,
             lambda: m2.composite_mat2_planar(planar32[0], ml)),
            (m2.MAT2_BATCHED, 16, 624,
             lambda: m2.composite_mat2_planar_batched(planar32[:16], ml))):
        planar = planar32[:B]
        ms = event_ms(torch, fn, reps=20, warmup=2)
        plain_ms = event_ms(torch, lambda: m2.composite_mat2_plain(planar, ml),
                            reps=2, warmup=1)
        bound_ms, bound_by = mat2_bound(B)
        rows.append({
            "name": k.name, "route": "cuda",
            "source": "stitchingvideo_tpu_torch/csrc/composite_mat2.cu",
            "replaces": f"{TPU_SRC}:{tpu_line}",
            "launches": launches[k.name],
            "max_abs_err": err["single" if B == 1 else "batched"],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            # no one PyTorch call computes the integer-weight gather
            "library_ms": None, "batch": B})
    ms32 = event_ms(torch,
                    lambda: m2.composite_mat2_planar_batched(planar32, ml),
                    reps=10, warmup=1)

    def library_shift():
        tb = planar16.transpose(0, 1)
        return torch.stack([torch.nn.functional.pad(tb[..., s:], (0, s))
                            for s in range(0, 32 * m2.N_SHIFTS, 32)])

    sh_bytes = planar16.numel() * (1 + m2.N_SHIFTS)
    rows.append({
        "name": m2.SHIFT_BN.name, "route": "cuda",
        "source": "stitchingvideo_tpu_torch/csrc/shift_planar_bn.cu",
        "replaces": f"{TPU_SRC}:869",
        "launches": launches[m2.SHIFT_BN.name], "max_abs_err": err["shift"],
        "ms": event_ms(torch, lambda: m2.shift_planar_bn(planar16), reps=20,
                       warmup=2),
        "plain_ms": event_ms(torch, lambda: m2.shift_planar_bn_plain(planar16),
                             reps=5),
        "bound_ms": sh_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": event_ms(torch, library_shift, reps=5),
        "batch": 16, "path": "shift_planar_bn"})

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

    def latency(fn, n):
        ts = []
        for _ in range(n + 2):
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        ts = np.asarray(ts[2:])
        return {"p50_ms": float(np.median(ts)),
                "p95_ms": float(np.percentile(ts, 95)), "n": n}

    metrics = {
        "card": card, "kind": kind,
        "fps_microbatch": fps, "microbatch_call": call,
        "b1_latency_host": latency(lambda: vs.composite(frames), 40),
        "b1_latency_device": latency(lambda: vs.composite_planar(frames_d),
                                     40),
        "mat2_kernel_ms_b32": ms32, "mat2_bound_ms_b32": mat2_bound(32)[0],
        "mat2_needs": need,
        "build_s": build_s, "install_lut_s": install_s,
        "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"metrics": metrics}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
