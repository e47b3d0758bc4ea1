"""Frames in flight: a K-deep pipeline of single frame-set composites.

Port of `stitchingvideo_tpu/video/stream.py`. `VideoStitcher.composite()`
pays its stages one after another: the host stacks the frame set, copies it
to the device, the kernel runs, and the host waits for the panorama's copy
back. `StreamingComposer` keeps K frame sets in flight so that these stages
overlap: `submit(frames)` dispatches a frame set and returns the oldest
finished panorama once K are in flight (None while the pipeline fills).
Frame set i is delivered before i+K is accepted, the bounded-lag contract of
the reference RT program's hot loop (stitching_detailed.cpp:724-770).

On a CUDA device:
- each frame set is copied into a ring slot of pinned host memory (in place
  of `np.stack`), a camera a worker thread, and uploaded by a non-blocking
  copy on a side stream, which the compute stream waits for;
- the dispatch (`VideoStitcher._dispatch`, the device half of `composite()`)
  launches on a stream of the composer's own;
- the panorama's copy to a pinned ring slot starts at submit, and a worker
  thread waits for the event recorded after it and copies the panorama out
  of the slot into an array of its own, which delivery hands to the caller.
The host copies run on threads because they, and the first touch of each
delivered array's memory, are what the host spends most of a frame set on
(PERF.md, section 6); numpy releases the interpreter lock while it copies.

A slot is written again `depth` submits later, after the frame set that used
it has been delivered, so every copy and launch that touched it, and the
copy out of it, has finished. Each in-flight item keeps the state snapshot
it was dispatched with, and its slots, until its delivery: in-flight frame
sets finish on the state they were dispatched with, and the caching
allocator cannot hand that memory out again while another stream may still
read it. On the CPU the same queue runs with plain tensors, no streams and
the same threads. Nothing falls back to the serial path: a failed pinning,
stream or launch raises.

`device_reduce` replaces the panorama by a device-side transform of it (a
checksum, a preview), which is fetched instead; the mode's postprocess is
then not applied.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["StreamingComposer"]


class _Item(NamedTuple):
    host: object          # a Future of the panorama's copy, or a host array
    post: Optional[Callable]
    keep: tuple           # the snapshot and slots the in-flight work reads


class StreamingComposer:
    """Pipelines single frame-set composites K deep over a VideoStitcher.

    Not thread-safe (one producer). State swaps inside the stitcher are
    safe: each submit takes the stitcher's snapshot as `composite()` does,
    so in-flight frame sets finish on the state they were dispatched with.
    """

    def __init__(self, stitcher, depth: int = 3,
                 device_reduce: Optional[Callable] = None):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        self._vs = stitcher
        self.depth = depth
        self._reduce = device_reduce
        self._q: deque = deque()
        self.out_times: List[float] = []     # wall time of each delivery
        self._cuda = stitcher.device.type == "cuda"
        # the compute stream and the upload's side stream
        self._compute = torch.cuda.Stream(stitcher.device) if self._cuda \
            else None
        self._upload = torch.cuda.Stream(stitcher.device) if self._cuda \
            else None
        self._rings: dict = {}     # name -> ((shape, dtype), [depth slots])
        self._submits = 0
        self._used: list = []
        # the host copies' threads, from the first submit until flush()
        self._pool: Optional[ThreadPoolExecutor] = None

    def _slot(self, name: str, shape, dtype, device) -> torch.Tensor:
        """This submit's slot of ring `name` (host rings are pinned on a
        CUDA device). A ring is allocated once for its shape, and again
        when the shape changes (a re-registration that drops a camera); the
        items in flight keep their slots of the old one."""
        key = (tuple(shape), dtype)
        ring = self._rings.get(name)
        if ring is None or ring[0] != key:
            pin = self._cuda and device == "cpu"
            ring = (key, [torch.empty(key[0], dtype=dtype, device=device,
                                      pin_memory=pin)
                          for _ in range(self.depth)])
            self._rings[name] = ring
        slot = ring[1][self._submits % self.depth]
        self._used.append(slot)
        return slot

    def _upload_frames(self, frames: List[np.ndarray]) -> torch.Tensor:
        """The frame set copied into its host slot, a camera a thread; on a
        CUDA device, copied to its device slot on the side stream, which the
        current (compute) stream waits for."""
        shape = (len(frames),) + tuple(np.shape(frames[0]))
        if any(np.shape(f) != shape[1:] for f in frames):
            raise ValueError("the frames of a frame set differ in shape: "
                             f"{[np.shape(f) for f in frames]}")
        host = self._slot("in", shape, torch.uint8, "cpu")
        list(self._pool.map(np.copyto, host.numpy(), frames))
        if not self._cuda:
            return host
        dev = self._slot("in_dev", shape, torch.uint8, self._vs.device)
        with torch.cuda.stream(self._upload):
            dev.copy_(host, non_blocking=True)
        torch.cuda.current_stream(dev.device).wait_stream(self._upload)
        return dev

    @staticmethod
    def _copy_out(host: torch.Tensor, done) -> np.ndarray:
        """On a worker: the panorama out of its slot, once its copy to the
        slot has landed (the slot is written again `depth` submits later)."""
        if done is not None:
            done.synchronize()
        return host.numpy().copy()

    def _finish(self, item: _Item) -> np.ndarray:
        host = item.host
        if isinstance(host, Future):
            host = host.result()
        # a device_reduce output is no longer a panorama, which the mode's
        # postprocess (_fit_frame) expects
        if item.post is not None and self._reduce is None:
            host = item.post(host)
        self.out_times.append(time.perf_counter())
        return host

    # -- public API --------------------------------------------------------

    def submit(self, frames: List[np.ndarray]) -> Optional[np.ndarray]:
        """Dispatch one rig frame set; return the oldest finished panorama
        once the pipeline is primed (None during the first `depth`-1
        submits)."""
        self._used = []
        if self._pool is None:
            self._pool = ThreadPoolExecutor(thread_name_prefix="stream")
        on_compute = torch.cuda.stream(self._compute) if self._cuda \
            else contextlib.nullcontext()
        with on_compute:
            out, post, snap = self._vs._dispatch(frames, self._upload_frames)
            if self._reduce is not None:
                out = self._reduce(torch.as_tensor(out,
                                                   device=self._vs.device))
            if isinstance(out, torch.Tensor):
                slot = self._slot("out", out.shape, out.dtype, "cpu")
                # started now, while the next frame sets dispatch
                slot.copy_(out, non_blocking=True)
                done = None
                if self._cuda:
                    done = torch.cuda.Event()
                    done.record(self._compute)
                host = self._pool.submit(self._copy_out, slot, done)
            else:
                host = out              # the full blend's host array
        self._submits += 1
        self._q.append(_Item(host, post, (snap, self._used)))
        if len(self._q) >= self.depth:
            return self._finish(self._q.popleft())
        return None

    def flush(self) -> List[np.ndarray]:
        """Deliver every in-flight panorama, in order, and stop the host
        copies' threads (ends the stream; a later submit starts another)."""
        outs = []
        while self._q:
            outs.append(self._finish(self._q.popleft()))
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        return outs

    def __len__(self) -> int:
        return len(self._q)
