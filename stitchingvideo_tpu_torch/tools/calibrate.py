"""Chessboard camera calibration tool.

Port of `stitchingvideo_tpu/tools/calibrate.py`. Parity target: the
out-of-repo OpenCV calibration tool that produced the reference's shipped
camera-mp4.yml (nframes=10, board 12x6, reference
OpenCV2.4.11-Stitching-64bit/x64/Release/camera-mp4.yml:1-30) -- the file
the RT driver was *meant* to load instead of its hard-coded intrinsics
(SURVEY §1 L4). Ours actually wires in: the JSON it writes loads straight
into UndistortConfig.

Host-side tool (cv2 for corner detection; the solve is
cv2.calibrateCamera):

    python -m stitchingvideo_tpu_torch.tools.calibrate IMAGES... \\
        [--board 12x6] [--square_size S] [--output camera_calib.json]
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import List, Sequence, Tuple

import numpy as np


def calibrate_chessboard(images: Sequence[np.ndarray],
                         board_size: Tuple[int, int] = (12, 6),
                         square_size: float = 1.0):
    """Returns dict(fx, fy, cx, cy, dist[k1 k2 p1 p2], rms, n_used)."""
    import cv2
    objp = np.zeros((board_size[0] * board_size[1], 3), np.float32)
    objp[:, :2] = np.mgrid[0:board_size[0], 0:board_size[1]].T.reshape(-1, 2)
    objp *= square_size

    obj_points: List[np.ndarray] = []
    img_points: List[np.ndarray] = []
    shape = None
    for img in images:
        gray = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY) if img.ndim == 3 else img
        shape = gray.shape[::-1]
        found, corners = cv2.findChessboardCorners(gray, board_size)
        if not found:
            continue
        corners = cv2.cornerSubPix(
            gray, corners, (11, 11), (-1, -1),
            (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 1e-3))
        obj_points.append(objp)
        img_points.append(corners)
    if len(obj_points) < 3:
        raise ValueError(f"only {len(obj_points)} usable calibration views")
    rms, K, dist, _rvecs, _tvecs = cv2.calibrateCamera(
        obj_points, img_points, shape, None, None)
    d = dist.ravel()
    return {
        "fx": float(K[0, 0]), "fy": float(K[1, 1]),
        "cx": float(K[0, 2]), "cy": float(K[1, 2]),
        "dist": [float(d[0]), float(d[1]), float(d[2]), float(d[3])],
        "rms": float(rms), "n_used": len(obj_points),
        "image_size": [int(shape[0]), int(shape[1])],
    }


def load_undistort_config(path: str):
    """JSON -> UndistortConfig (enabled)."""
    from ..config import UndistortConfig
    with open(path) as f:
        d = json.load(f)
    return UndistortConfig(enabled=True, fx=d["fx"], fy=d["fy"],
                           cx=d["cx"], cy=d["cy"], dist=tuple(d["dist"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="chessboard camera calibration")
    ap.add_argument("images", nargs="+")
    ap.add_argument("--board", default="12x6",
                    help="inner-corner grid, reference board was 12x6")
    ap.add_argument("--square_size", type=float, default=1.0)
    ap.add_argument("--output", default="camera_calib.json")
    args = ap.parse_args(argv)
    import imageio.v3 as iio
    imgs = [np.asarray(iio.imread(p)) for p in args.images]
    bw, bh = (int(x) for x in args.board.split("x"))
    result = calibrate_chessboard(imgs, (bw, bh), args.square_size)
    with open(args.output, "w") as f:
        json.dump(result, f, indent=2)
    print(f"rms={result['rms']:.3f} from {result['n_used']} views -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
