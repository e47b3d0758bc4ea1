"""Multi-host ingest: each process's cameras -> one global camera batch.

Port of `stitchingvideo_tpu/parallel/ingest.py`. The reference's transport
is single-host shared memory (one producer a camera into named rings). On
several hosts, each runs the decode producers of the cameras attached to it
(`video/producer.py` and the rings stay per host), and the per-host frame
batches assemble into one batch in global camera order:

    sl = local_camera_slice(n_cameras)           # this process's cameras
    local = torch.from_numpy(np.stack(my_sources.read()))
    frames = global_camera_batch(local)          # [n_cameras, H, W, 3]

The reference assembles a camera-sharded `jax.Array` over a global mesh; the
port's processes talk through `torch.distributed` (gloo on the CPU, NCCL
between cards, where the tensors must be on the process's card). The
process group is the caller's: give `init_process_group` its address
(`tcp://host:port`), world size and rank. With no process group both
functions are the single-process identity, the reference's degenerate case.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _rank_world(group=None):
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(group), dist.get_world_size(group)
    return 0, 1


def local_camera_slice(n_cameras: int, group=None) -> slice:
    """The global camera indices this process captures: a contiguous
    n_cameras / world_size run in rank order."""
    rank, world = _rank_world(group)
    if n_cameras % world:
        raise ValueError(f"{n_cameras} cameras not divisible by "
                         f"{world} processes")
    per = n_cameras // world
    return slice(rank * per, (rank + 1) * per)


def global_camera_batch(local_frames: torch.Tensor,
                        group=None) -> torch.Tensor:
    """Assemble the global camera batch from this process's cameras:
    local_frames [n_local, H, W, C] (the cameras of `local_camera_slice`,
    every process the same shape) -> [n_cameras, H, W, C] in rank order, in
    every process."""
    _rank, world = _rank_world(group)
    if world == 1:
        return local_frames
    local_frames = local_frames.contiguous()
    parts = [torch.empty_like(local_frames) for _ in range(world)]
    dist.all_gather(parts, local_frames, group=group)
    return torch.cat(parts)
