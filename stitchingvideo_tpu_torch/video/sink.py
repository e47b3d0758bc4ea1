"""Stitched-video output sinks: encoded file, frame directory, display.

Port of `stitchingvideo_tpu/video/sink.py`. Parity target: the reference's
output surface -- the 64-bit RT driver shows every composited frame
(`imshow("result", dst) + waitKey(30)`, stitching_detailed.cpp:762-768) and
the CLI writes `result.jpg`. This module is the product's way to actually
GET the stitched stream out: an encoded video file (cv2.VideoWriter), a
numbered-frame directory, a single still (first frame), or a live window.

All sinks take HWC uint8 RGB frames (the compositor's output layout) and
handle BGR conversion internally where an encoder wants it. `cv2` and
`imageio` are imported inside the sinks that use them.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

_VIDEO_EXTS = {".mp4", ".avi", ".mkv", ".mov", ".m4v", ".webm"}
_IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff"}

_FOURCC = {  # container -> preferred codec fourcc
    ".mp4": "mp4v", ".m4v": "mp4v", ".mov": "mp4v",
    ".avi": "MJPG", ".mkv": "mp4v", ".webm": "VP80",
}


class FrameSink:
    """Base: write(frame, index) then close(). frames_written is the count
    of frames actually delivered to the sink."""

    def __init__(self):
        self.frames_written = 0

    def write(self, frame: np.ndarray, index: int) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class VideoFileSink(FrameSink):
    """Encoded video via cv2.VideoWriter (mp4v/MJPG — the codecs available
    without an ffmpeg binary in this image). Opens lazily on the first frame
    (the panorama size isn't known until the first composite)."""

    def __init__(self, path: str, fps: float = 30.0):
        super().__init__()
        self.path = path
        self.fps = float(fps)
        self._writer = None
        self._wh: Optional[Tuple[int, int]] = None

    def _open(self, h: int, w: int):
        import cv2
        ext = os.path.splitext(self.path)[1].lower()
        fourcc = cv2.VideoWriter_fourcc(*_FOURCC.get(ext, "mp4v"))
        writer = cv2.VideoWriter(self.path, fourcc, self.fps, (w, h))
        if not writer.isOpened():
            raise RuntimeError(
                f"cv2.VideoWriter could not open {self.path!r} "
                f"({w}x{h} @ {self.fps} fps)")
        self._writer = writer
        self._wh = (w, h)

    def write(self, frame: np.ndarray, index: int) -> None:
        import cv2
        h, w = frame.shape[:2]
        if self._writer is None:
            self._open(h, w)
        elif (w, h) != self._wh:
            raise ValueError(f"frame size changed {self._wh} -> {(w, h)}")
        self._writer.write(cv2.cvtColor(np.ascontiguousarray(frame),
                                        cv2.COLOR_RGB2BGR))
        self.frames_written += 1

    def close(self) -> None:
        if self._writer is not None:
            self._writer.release()
            self._writer = None


class FrameDirSink(FrameSink):
    """Numbered frames (frame_000000.jpg ...) into a directory — the
    no-codec fallback and the debug-friendly output."""

    def __init__(self, directory: str, ext: str = ".jpg"):
        super().__init__()
        self.directory = directory
        self.ext = ext
        os.makedirs(directory, exist_ok=True)

    def write(self, frame: np.ndarray, index: int) -> None:
        import imageio.v3 as iio
        iio.imwrite(os.path.join(self.directory,
                                 f"frame_{index:06d}{self.ext}"), frame)
        self.frames_written += 1


class StillSink(FrameSink):
    """Single still image: first frame only (the pre-round-3 `video
    --output result.jpg` behavior, kept for image extensions)."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path

    def write(self, frame: np.ndarray, index: int) -> None:
        if self.frames_written == 0:
            import imageio.v3 as iio
            iio.imwrite(self.path, frame)
            self.frames_written += 1


class DisplaySink(FrameSink):
    """Live window (reference imshow/waitKey loop). Disables itself with a
    warning on headless machines instead of killing the stream.

    on_key (optional) receives each pressed key's code — the CLI wires 'a'
    to VideoStitcher.force_reregister, the reference's on-demand
    re-registration key (64-bit driver stitching_detailed.cpp:768)."""

    def __init__(self, title: str = "stitchingvideo-tpu", on_key=None):
        super().__init__()
        self.title = title
        self.on_key = on_key
        self._dead = False

    def write(self, frame: np.ndarray, index: int) -> None:
        if self._dead:
            return
        try:
            import cv2
            cv2.imshow(self.title, cv2.cvtColor(frame, cv2.COLOR_RGB2BGR))
            k = cv2.waitKey(1)
            if k >= 0 and self.on_key is not None:
                self.on_key(k & 0xFF)
            self.frames_written += 1
        except Exception:
            import logging
            logging.getLogger(__name__).warning(
                "display disabled (no GUI backend)", exc_info=True)
            self._dead = True

    def close(self) -> None:
        if not self._dead and self.frames_written:
            try:
                import cv2
                cv2.destroyWindow(self.title)
            except Exception:
                pass


class TeeSink(FrameSink):
    """Fan one stream out to several sinks (e.g. file + display)."""

    def __init__(self, *sinks: FrameSink):
        super().__init__()
        self.sinks = [s for s in sinks if s is not None]

    def write(self, frame: np.ndarray, index: int) -> None:
        for s in self.sinks:
            s.write(frame, index)
        self.frames_written += 1

    def close(self) -> None:
        for s in self.sinks:
            s.close()


def make_sink(path: Optional[str], fps: float = 30.0,
              display: bool = False, on_key=None) -> Optional[FrameSink]:
    """Route an --output argument to the right sink kind:

      *.mp4/.avi/...  -> encoded video, every frame
      *.jpg/.png/...  -> single still (first frame)
      anything else   -> numbered-frame directory
      None            -> display only (or no sink at all)

    on_key is forwarded to the DisplaySink (keypress callback).
    """
    file_sink: Optional[FrameSink] = None
    if path:
        ext = os.path.splitext(path)[1].lower()
        if ext in _VIDEO_EXTS:
            file_sink = VideoFileSink(path, fps=fps)
        elif ext in _IMAGE_EXTS:
            file_sink = StillSink(path)
        else:
            file_sink = FrameDirSink(path)
    disp = DisplaySink(on_key=on_key) if display else None
    if file_sink and disp:
        return TeeSink(file_sink, disp)
    return file_sink or disp
