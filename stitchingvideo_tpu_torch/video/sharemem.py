"""ctypes wrapper over the native POSIX shared-memory frame ring.

Port of `stitchingvideo_tpu/video/sharemem.py`, the Python face of
`native/sharemem.cpp` (see its header for the protocol and the reference
parity notes: the Stitching_sharemem / GetFromRtsp producer model). The
library is the JAX package's source byte for byte, so a ring that one
package's producer creates is read by the other package's consumer.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ..native import build as native_build


class ShmRing:
    """One camera channel: single producer, any number of consumers."""

    def __init__(self, handle, name: str, shape: Tuple[int, int, int]):
        self._lib = native_build.load_sharemem()
        self._h = handle
        self.name = name
        self.shape = shape  # (H, W, C)
        self.last_seq = ctypes.c_int64(-1)

    @classmethod
    def create(cls, name: str, width: int, height: int, channels: int = 3,
               slots: int = 4) -> "ShmRing":
        lib = native_build.load_sharemem()
        h = lib.shm_ring_create(name.encode(), width, height, channels, slots)
        if not h:
            raise OSError(f"shm_ring_create failed for {name}")
        return cls(h, name, (height, width, channels))

    @classmethod
    def open(cls, name: str) -> "ShmRing":
        lib = native_build.load_sharemem()
        h = lib.shm_ring_open(name.encode())
        if not h:
            raise OSError(f"shm_ring_open failed for {name} (producer not up?)")
        info = (ctypes.c_int * 4)()
        lib.shm_ring_info(h, info)
        return cls(h, name, (info[1], info[0], info[2]))

    def publish(self, frame: np.ndarray, seq: int = -1) -> None:
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.shape != self.shape:
            raise ValueError(f"frame shape {frame.shape} != ring {self.shape}")
        rc = self._lib.shm_ring_publish(
            self._h, frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            frame.nbytes, seq)
        if rc != 0:
            raise OSError("shm_ring_publish failed")

    def consume(self, timeout_s: float = 1.0) -> Optional[np.ndarray]:
        """Newest unseen frame, or None on timeout (dead-producer safe,
        unlike the reference's INFINITE wait)."""
        buf = np.empty(self.shape, np.uint8)
        seq = self._lib.shm_ring_consume(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            buf.nbytes, ctypes.byref(self.last_seq), timeout_s)
        if seq < 0:
            return None
        return buf

    def close(self, unlink: bool = False) -> None:
        if self._h:
            self._lib.shm_ring_close(self._h, int(unlink))
            self._h = None

    def __del__(self):
        try:
            self.close(False)
        except Exception:
            pass
