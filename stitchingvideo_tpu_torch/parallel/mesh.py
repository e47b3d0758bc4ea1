"""The device mesh of the sharded compose, and the launches of its bands.

Port of `stitchingvideo_tpu/parallel/mesh.py`. The reference's compose is
single-process SPMD: `jax.shard_map` over the devices of one process, the
panorama split into canvas bands, one a device of the 'canvas' axis, with no
collective in the seam-select and feather hot loops. The port keeps that
split in one process: a `Mesh` is a [camera, canvas] array of
`torch.device`s, and each band's state lives on its canvas device, where its
launches run on a CUDA stream of the band (`run_bands`). A seam-select or
feather state cut into row bands is a `Banded`, which `run_banded` composes
through the kernel's one-device entry, once a band. A device may be
listed more than once: several bands then share one card (or the CPU), each
on its own stream, which is how one card, or the CPU in the tests, runs the
sharded paths. The compose names only the canvas axis, so it runs on the
first camera row; the camera axis only sizes the mesh, as in the reference.

Only ingest and the gain statistics span processes (`parallel/ingest.py`,
`parallel/compose.py`), over `torch.distributed`.

The reference's `canvas_sharding`, `camera_sharding` and `replicated` build
`NamedSharding`s; no module of the port places a tensor by sharding, so they
have no counterpart.
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.composite import TILE_H

AXES = ("camera", "canvas")


class Mesh:
    """A [camera, canvas] array of devices with the reference's axis names.

    `shape` maps each axis name to its size, as `jax.sharding.Mesh.shape`
    does. The band streams (`band_streams`) are created on first use and
    belong to the mesh."""

    def __init__(self, devices: np.ndarray):
        if devices.ndim != 2:
            raise ValueError(f"a mesh is 2-D, got {devices.shape}")
        self.devices = devices
        self._streams: Optional[List] = None
        self._lock = threading.Lock()

    @property
    def shape(self) -> dict:
        return dict(zip(AXES, self.devices.shape))

    @property
    def canvas_devices(self) -> List[torch.device]:
        """The devices of the canvas bands, in band order: the first camera
        row."""
        return list(self.devices[0])

    def band_streams(self) -> List:
        """One CUDA stream a canvas band, on its device (created once)."""
        with self._lock:
            if self._streams is None:
                self._streams = [torch.cuda.Stream(d)
                                 for d in self.canvas_devices]
            return self._streams

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, "
                f"{[str(d) for d in self.devices.reshape(-1)]})")


def canonical_device(d) -> torch.device:
    """`d` as a torch.device with its index (`cuda` -> `cuda:<current>`)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(canvas: Optional[int] = None, camera: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Mesh with ('camera', 'canvas') axes. Defaults: every visible CUDA
    card, all on the canvas axis. `devices` may name a device more than
    once (several bands on one device)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = [canonical_device(d) for d in devices]
    if canvas is None:
        canvas = len(devs) // camera
    if canvas < 1 or camera < 1:
        raise ValueError(f"need camera >= 1 and canvas >= 1, got "
                         f"camera={camera}, canvas={canvas}")
    if camera * canvas > len(devs):
        raise ValueError(f"need {camera * canvas} devices, have {len(devs)}")
    arr = np.empty((camera, canvas), dtype=object)
    for i, d in enumerate(devs[:camera * canvas]):
        arr[i // canvas, i % canvas] = d
    return Mesh(arr)


def _each(x, fn):
    """fn applied to every tensor of a tensor, or a list/tuple of them."""
    if isinstance(x, (list, tuple)):
        return type(x)(_each(v, fn) for v in x)
    return fn(x)


def run_bands(mesh: Mesh, x: torch.Tensor,
              fn: Callable[[int, torch.Tensor], object]) -> list:
    """fn(b, x_b) for every canvas band b, x_b being `x` on band b's device;
    returns the outputs (a tensor or a list/tuple of tensors each), moved to
    `x`'s device, in band order.

    On CUDA each band runs on its stream: the stream first waits for an
    event recorded now on the current stream (after whatever produced `x`,
    and the state's build, which the current stream has waited for); a
    band on `x`'s device marks `x` as used by its stream, so the caching
    allocator does not hand its memory out while the band still reads it;
    a band on another device reads a copy; and the current stream waits
    for every band's event before it may read the outputs.
    On the CPU the bands run one after the other."""
    devs = mesh.canvas_devices
    if x.device.type != "cuda":
        return [_each(fn(b, x.to(d)), lambda t: t.to(x.device))
                for b, d in enumerate(devs)]
    caller = torch.cuda.current_stream(x.device)
    ready = torch.cuda.Event()
    ready.record(caller)
    outs, done = [], []
    for b, (d, stream) in enumerate(zip(devs, mesh.band_streams())):
        with torch.cuda.stream(stream):
            stream.wait_event(ready)
            if d == x.device:
                x.record_stream(stream)
                out = fn(b, x)
            else:
                # cross-device copies are fenced both ways with this stream;
                # the outputs land in memory of the caller's stream
                out = _each(fn(b, x.to(d, non_blocking=True)),
                            lambda t: t.to(x.device, non_blocking=True))
            ev = torch.cuda.Event()
            ev.record(stream)
        outs.append(out)
        done.append(ev)
    for out, ev in zip(outs, done):
        caller.wait_event(ev)
        # made on a band stream, read on the caller's
        _each(out, lambda t: t.record_stream(caller))
    return outs


@dataclasses.dataclass
class Banded:
    """A per-pixel kernel state cut into canvas row bands: `bands[b]`, rows
    `rows[b]` of the band-padded panorama, on canvas device b; `Hp` the
    panorama's rows before the band padding."""
    bands: tuple
    rows: Tuple[Tuple[int, int], ...]
    Hp: int
    mesh: Mesh


def band_rows(Hp: int, ndev: int) -> List[Tuple[int, int]]:
    """ndev equal row bands of a panorama of Hp rows, each of whole tile
    rows (`video/lut.py` `pad_lut_rows_for_shards` pads Hp so that they
    exist)."""
    if Hp % (ndev * TILE_H):
        raise ValueError(f"{Hp} panorama rows do not split into {ndev} bands "
                         f"of whole {TILE_H}-row tiles: pad the LUT rows "
                         "first (pad_lut_rows_for_shards)")
    h = Hp // ndev
    return [(b * h, (b + 1) * h) for b in range(ndev)]


def placed(state, device):
    """A state dataclass with every tensor field contiguous on `device`."""
    return dataclasses.replace(state, **{
        f.name: getattr(state, f.name).contiguous().to(device)
        for f in dataclasses.fields(state)
        if isinstance(getattr(state, f.name), torch.Tensor)})


def cut_rows(state, mesh: Mesh, Hp: int, band_of) -> Banded:
    """A per-pixel state on a band-padded panorama cut into the canvas
    axis's row bands, band b being band_of(state, r0, r1, device b)."""
    devs = mesh.canvas_devices
    rows = band_rows(state.pano_hw[0], len(devs))
    return Banded(bands=tuple(band_of(state, r0, r1, d)
                              for (r0, r1), d in zip(rows, devs)),
                  rows=tuple(rows), Hp=Hp, mesh=mesh)


def run_banded(fn, x: torch.Tensor, state) -> torch.Tensor:
    """The kernel entry fn(x, state) on a one-device state; on a `Banded`
    state fn(x_b, bands[b]) on every canvas band (`run_bands`), the outputs
    [..., rows, W] joined along their rows in band order on x's device and
    cropped to the panorama's `Hp` rows."""
    if not isinstance(state, Banded):
        return fn(x, state)
    bands = state.bands
    out = torch.cat(run_bands(state.mesh, x, lambda b, xb: fn(xb, bands[b])),
                    dim=-2)
    return out[..., :state.Hp, :]
