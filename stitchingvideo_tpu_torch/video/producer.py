"""Video-decode producer process: decode a video file / RTSP URL into a
shared-memory ring.

Port of `stitchingvideo_tpu/video/producer.py`. Parity target: the
reference's GetFromRtsp.exe -- an external process that decodes ONE RTSP
stream via FFmpeg and publishes raw frames into named shared memory for the
stitcher to consume (binary-only in the reference repo; CLI contract
recovered from its spawn site, 64-bit stitching_detailed.cpp:785-793:
`GetFromRtsp.exe <rtsp-url> <shm-name> <mutex> <server-event> <client-event>`).

    python -m stitchingvideo_tpu_torch.video.producer <uri> <shm-name> \
        [--fps F] [--loop] [--frames N]

* Decode is cv2.VideoCapture (FFmpeg-backed): files, rtsp://, http:// all
  work, matching both reference ingest modes (32-bit driver VideoCapture
  :996-1023 and the GetFromRtsp shm model).
* Transport is the lock-free POSIX ShmRing (native/sharemem.cpp) instead of
  the reference's single-buffer mutex/event handshake: a dead producer can
  never hang the consumer (timeouts), and a slow consumer never blocks
  decode (ring overwrite, newest-wins).
* Pacing: files replay at their container FPS (or --fps); live sources
  publish as fast as decode delivers (the stream paces itself).

A producer works on the host only: cv2, numpy and the native ring. It is
spawned with the card hidden (`video/sources.py` `producer_env`).
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional


_LIVE_SCHEMES = ("rtsp://", "rtsps://", "http://", "https://", "udp://",
                 "tcp://", "rtp://")


def _is_live(uri: str) -> bool:
    return uri.startswith(_LIVE_SCHEMES)


def run_producer(uri: str, name: str, fps: float = 0.0, loop: bool = False,
                 max_frames: int = 0, slots: int = 4,
                 reconnect: int = -1, reconnect_wait_s: float = 0.5) -> int:
    """Decode `uri` and publish RGB frames into ShmRing `name`.

    Returns the number of frames published. fps<=0 = the source's native
    rate for files, free-running for live sources.

    reconnect: for LIVE sources (rtsp/http/udp/tcp), a dropped stream is
    re-opened up to this many consecutive times (each attempt backs off
    `reconnect_wait_s * attempt`); any successfully decoded frame resets the
    budget, so a stream that keeps coming back is followed forever. -1 picks
    the default: 5 for live sources, 0 (off) for files. The reference's
    production ingest (GetFromRtsp.exe) ran a live RTSP decoder per camera;
    its consumer waited INFINITE on a dead producer (stitching_sharemem.
    cpp:106) — here the producer survives the network and the consumer is
    timeout-safe either way."""
    import cv2

    from .sharemem import ShmRing

    if reconnect < 0:
        reconnect = 5 if _is_live(uri) else 0

    cap = cv2.VideoCapture(uri)
    if not cap.isOpened():
        raise OSError(f"cannot open video source {uri!r}")
    ok, frame = cap.read()
    if not ok:
        raise OSError(f"no frames from {uri!r}")
    h, w = frame.shape[:2]
    if fps <= 0:
        src_fps = cap.get(cv2.CAP_PROP_FPS)
        # live sources report 0/NaN FPS: publish as delivered
        fps = src_fps if src_fps and src_fps == src_fps and src_fps > 0 else 0.0

    def _reopen():
        """Re-open a dropped live stream; returns (cap, frame) or None."""
        for attempt in range(1, reconnect + 1):
            time.sleep(reconnect_wait_s * attempt)
            c = cv2.VideoCapture(uri)
            if not c.isOpened():
                c.release()
                continue
            ok2, f2 = c.read()
            if not ok2:
                c.release()
                continue
            if f2.shape[:2] != (h, w):
                # the ring's geometry is fixed at create(); a stream that
                # came back at a different size is a config error, not a hiccup
                c.release()
                raise OSError(
                    f"{uri!r} reconnected at {f2.shape[:2]}, ring is {(h, w)}")
            print(f"reconnected to {uri} after {attempt} attempt(s)",
                  file=sys.stderr, flush=True)
            return c, f2
        return None

    ring = ShmRing.create(name, w, h, 3, slots)
    published = 0
    start = time.monotonic()
    try:
        while True:
            ring.publish(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB), published)
            published += 1
            if max_frames and published >= max_frames:
                break
            if fps > 0:
                time.sleep(max(0.0, start + published / fps - time.monotonic()))
            ok, frame = cap.read()
            if not ok and loop and not _is_live(uri):
                cap.set(cv2.CAP_PROP_POS_FRAMES, 0)
                ok, frame = cap.read()
            if not ok and reconnect > 0:
                cap.release()
                re = _reopen()
                if re is not None:
                    cap, frame = re
                    ok = True
            if not ok:
                break
    finally:
        cap.release()
        ring.close(False)   # consumers may still be draining; no unlink
    return published


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="stitchingvideo-producer",
        description="decode one video/RTSP stream into a shared-memory ring "
                    "(GetFromRtsp.exe parity)")
    ap.add_argument("uri", help="video file path or rtsp:///http:// URL")
    ap.add_argument("name", help="shared-memory ring name (e.g. /cam0)")
    ap.add_argument("--fps", type=float, default=0.0,
                    help="publish rate; default = source native rate")
    ap.add_argument("--loop", action="store_true",
                    help="loop file sources forever")
    ap.add_argument("--frames", type=int, default=0,
                    help="stop after N frames (0 = until EOS)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--reconnect", type=int, default=-1,
                    help="max consecutive re-open attempts after a live "
                         "stream drops (-1 = 5 for live sources, 0 for "
                         "files; any decoded frame resets the budget)")
    ap.add_argument("--reconnect-wait", type=float, default=0.5,
                    help="base backoff seconds between re-open attempts")
    args = ap.parse_args(argv)
    n = run_producer(args.uri, args.name, fps=args.fps, loop=args.loop,
                     max_frames=args.frames, slots=args.slots,
                     reconnect=args.reconnect,
                     reconnect_wait_s=args.reconnect_wait)
    print(f"published {n} frames from {args.uri}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
