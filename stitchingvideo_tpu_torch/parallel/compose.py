"""Sharded plain gather and the gain statistics over canvas strips.

Port of `stitchingvideo_tpu/parallel/compose.py`. Every output pixel of the
composite is an independent gather, so the panorama's columns split into
canvas bands with no communication: each band gathers its columns on its
device, and the columns are joined on the first. The gain statistics
(`gain_stats_sharded`) reduce each band's pixel strip to partial N(i, j) and
I(i, j) matrices, summed in band order on the mesh's first device: the
reference's psum over 'canvas'. Where a `torch.distributed` process group
is initialised, an all_reduce then sums them over the processes, each of
which passes its own pixels.
"""
from __future__ import annotations

from typing import Callable, List, Tuple

import torch
import torch.distributed as dist

from ..video.lut import CompositeLUT, composite_frame_u8
from .mesh import Mesh, run_bands


def _column_bands(W: int, n: int) -> List[Tuple[int, int]]:
    """n contiguous column ranges covering W, as even as they come."""
    edges = [W * b // n for b in range(n + 1)]
    return list(zip(edges[:-1], edges[1:]))


def shard_lut(lut: CompositeLUT, mesh: Mesh) -> List[CompositeLUT]:
    """The LUT's column bands, one a canvas device, each on its device."""
    devs = mesh.canvas_devices
    return [CompositeLUT(*(getattr(lut, k)[:, c0:c1].contiguous().to(d)
                           for k in ("cam_idx", "src_x", "src_y", "gain")))
            for (c0, c1), d in zip(_column_bands(lut.shape[1], len(devs)),
                                   devs)]


def sharded_composite_fn(mesh: Mesh) -> Callable:
    """The gather hot loop over column bands: f(frames [N, H, W, C],
    sharded LUT) -> [Hp, Wp, C] uint8 on the frames' device, equal to
    `composite_frame_u8` of the whole LUT."""

    def run(frames: torch.Tensor, luts: List[CompositeLUT]) -> torch.Tensor:
        outs = run_bands(mesh, frames,
                         lambda b, f: composite_frame_u8(f, luts[b]))
        return torch.cat(outs, dim=1)

    return run


def gain_stats_sharded(mesh: Mesh, lum: torch.Tensor,
                       mask: torch.Tensor) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """Cross-camera overlap statistics with the pixels split over the canvas
    bands: lum, mask [N, P] float32 -> (N [N, N], I [N, N]), N(i, j) =
    sum_p mask_i mask_j and I(i, j) = sum_p lum_i mask_i mask_j, on the
    first device. With a process group, the sums over every process's
    pixels."""
    lum_masked = lum * mask
    edges = _column_bands(lum.shape[1], mesh.shape["canvas"])

    def part(b, x):
        c0, c1 = edges[b]
        m = x[1, :, c0:c1]
        return [m @ m.T, x[0, :, c0:c1] @ m.T]

    parts = run_bands(mesh, torch.stack([lum_masked, mask]), part)
    n_mat, i_mat = parts[0]
    for n_b, i_b in parts[1:]:
        n_mat = n_mat + n_b
        i_mat = i_mat + i_b
    if dist.is_available() and dist.is_initialized():
        dist.all_reduce(n_mat)
        dist.all_reduce(i_mat)
    return n_mat, i_mat
