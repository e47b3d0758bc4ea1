"""Frame sources: the ingest abstraction over files, videos, shared memory.

Port of `stitchingvideo_tpu/video/sources.py`. Parity targets: the
reference's three ingest modes -- frame-dump replay (its snapshots
-20160328/0330), cv::VideoCapture RTSP (32-bit driver
stitching_detailed.cpp:996-1023), and the GetFromRtsp.exe shared-memory
producers (64-bit driver :785-793 + stitching_sharemem.cpp). A synthetic
source is added for deterministic benchmarks. `cv2` and `imageio` are
imported inside the sources that use them, so the module imports without
either; producer processes run with the card hidden (`producer_env`).
"""
from __future__ import annotations

import itertools
import os
import subprocess
import sys
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np


def producer_env() -> dict:
    """Subprocess env for frame producers: the card hidden
    (`CUDA_VISIBLE_DEVICES=""`), so a producer, which decodes and publishes
    on the host only, never takes a CUDA context."""
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


class FrameSource:
    """N synchronized camera channels."""

    num_cameras: int

    def read(self) -> Optional[List[np.ndarray]]:
        """Next frame set ([H,W,3] RGB uint8 per camera) or None at EOS."""
        raise NotImplementedError

    def close(self) -> None:
        pass


class ReplaySource(FrameSource):
    """Replays still images as an endless synchronized stream, optionally
    with photometric jitter so the stream is not static."""

    def __init__(self, images: Sequence[np.ndarray], loop: bool = True,
                 jitter: float = 0.0, max_frames: Optional[int] = None):
        self.frames = [np.asarray(im, np.uint8) for im in images]
        self.num_cameras = len(self.frames)
        self.loop = loop
        self.jitter = jitter
        self.max_frames = max_frames
        self._count = 0

    def read(self):
        if self.max_frames is not None and self._count >= self.max_frames:
            return None
        if not self.loop and self._count > 0:
            return None
        self._count += 1
        if self.jitter > 0:
            rng = np.random.default_rng(self._count)
            return [np.clip(f.astype(np.int16) +
                            rng.integers(-int(self.jitter),
                                         int(self.jitter) + 1),
                            0, 255).astype(np.uint8) for f in self.frames]
        return list(self.frames)


class DirectorySource(FrameSource):
    """One directory per camera of numbered frames."""

    def __init__(self, dirs: Sequence[str], pattern: str = "*.jpg",
                 loop: bool = False):
        import imageio.v3 as iio
        self._iio = iio
        self.paths = [sorted(Path(d).glob(pattern)) for d in dirs]
        if any(len(p) == 0 for p in self.paths):
            raise ValueError("empty camera directory")
        self.num_cameras = len(dirs)
        n = min(len(p) for p in self.paths)
        idx = range(n)
        self._iter = iter(itertools.cycle(idx) if loop else idx)

    def read(self):
        try:
            i = next(self._iter)
        except StopIteration:
            return None
        return [np.asarray(self._iio.imread(p[i]))[..., :3]
                for p in self.paths]


class VideoFileSource(FrameSource):
    """cv2.VideoCapture over N video files/URLs (RTSP-capable, as the 32-bit
    driver used VideoCapture on rtsp:// URLs)."""

    def __init__(self, uris: Sequence[str]):
        import cv2
        self._cv2 = cv2
        self.caps = [cv2.VideoCapture(u) for u in uris]
        if not all(c.isOpened() for c in self.caps):
            raise ValueError("failed to open all video sources")
        self.num_cameras = len(uris)

    def read(self):
        frames = []
        for c in self.caps:
            ok, f = c.read()
            if not ok:
                return None
            frames.append(self._cv2.cvtColor(f, self._cv2.COLOR_BGR2RGB))
        return frames

    def close(self):
        for c in self.caps:
            c.release()


class SharedMemorySource(FrameSource):
    """Consumes N native shm rings (one producer process per camera, the
    reference's GetFromRtsp model).

    stale_reads: a camera whose producer times out degrades gracefully for
    up to this many reads by re-serving its last good frame (the panorama
    keeps streaming through a producer hiccup/restart); after the budget is
    spent, read() returns None and the stream loop exits. The reference
    instead waits INFINITE on a dead producer and hangs the whole pipeline
    (stitching_sharemem.cpp:106)."""

    def __init__(self, names: Sequence[str], timeout_s: float = 2.0,
                 stale_reads: int = 0):
        from .sharemem import ShmRing
        self.rings = [ShmRing.open(n) for n in names]
        self.num_cameras = len(names)
        self.timeout_s = timeout_s
        self.stale_reads = stale_reads
        self._last_good: List[Optional[np.ndarray]] = [None] * len(names)
        self._stale_used = [0] * len(names)

    def read(self):
        frames = []
        for k, r in enumerate(self.rings):
            f = r.consume(self.timeout_s)
            if f is None:
                if (self._last_good[k] is None
                        or self._stale_used[k] >= self.stale_reads):
                    return None
                self._stale_used[k] += 1
                f = self._last_good[k]
            else:
                self._last_good[k] = f
                self._stale_used[k] = 0
            frames.append(f)
        return frames

    def close(self, unlink: bool = False):
        """unlink=True removes the shm names too: the owner of spawned
        producers passes it so /dev/shm segments don't leak across runs
        (and a PID-reused name can't attach to a stale ring)."""
        for r in self.rings:
            r.close(unlink)


def spawn_replay_producer(name: str, image_path: str, fps: float = 30.0,
                          frames: int = 0) -> subprocess.Popen:
    """Launch a separate producer process publishing a frame stream into a
    shm ring (the reference's WinExec(GetFromRtsp.exe ...) parity, 64-bit
    driver :785-793)."""
    code = (
        "import sys, time, numpy as np, imageio.v3 as iio;"
        "from stitchingvideo_tpu_torch.video.sharemem import ShmRing;"
        f"img = np.asarray(iio.imread({image_path!r}))[..., :3]"
        ".astype(np.uint8);"
        f"r = ShmRing.create({name!r}, img.shape[1], img.shape[0], 3, 4);"
        f"n = {frames} or 10**9;"
        "start = time.time();"
        "[_ for _ in ("
        " (r.publish(img, i), time.sleep(max(0, start + (i+1)/" + str(fps) +
        " - time.time())))"
        " for i in range(n))]"
    )
    return subprocess.Popen([sys.executable, "-c", code], env=producer_env(),
                            cwd=str(Path(__file__).resolve().parents[2]))


def spawn_video_producer(name: str, uri: str, fps: float = 0.0,
                         loop: bool = False,
                         frames: int = 0) -> subprocess.Popen:
    """Launch a real video-decode producer process: cv2.VideoCapture
    (FFmpeg) decoding `uri` (file or rtsp:// URL) into the shm ring `name`,
    the reference's `WinExec(GetFromRtsp.exe <rtsp-url> <shm-names...>)`
    spawn (64-bit driver :785-793) as a Python -m subprocess."""
    argv = [sys.executable, "-m", "stitchingvideo_tpu_torch.video.producer",
            uri, name, "--fps", str(fps), "--frames", str(frames)]
    if loop:
        argv.append("--loop")
    return subprocess.Popen(argv, env=producer_env(),
                            cwd=str(Path(__file__).resolve().parents[2]))


class SyntheticSource(FrameSource):
    """Deterministic random frames at a fixed size (benchmark input)."""

    def __init__(self, num_cameras: int, width: int, height: int,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.num_cameras = num_cameras
        self.frames = [rng.integers(0, 255, (height, width, 3), np.uint8)
                       for _ in range(num_cameras)]

    def read(self):
        return list(self.frames)
