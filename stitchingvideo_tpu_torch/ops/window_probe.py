"""Window-copy probe: stage source windows into shared memory with
asynchronous copies, at a chosen alignment of the window origins.

Port of the TPU probe `scripts/test_misaligned_dma.py` (can an async copy
start at a 32-aligned instead of a 128-aligned column, and at what speed?).
On Hopper the question is which copy width an origin's alignment allows: a
16-byte `cp.async` needs 16-aligned columns (every 32- or 128-aligned origin
of a row whose width is a multiple of 16), 8- and 4-aligned origins take
8- and 4-byte copies. `chip_smoke.py` times each; the answer says how a
gather kernel that stages source rows may address taps at arbitrary x0.

Per window the probe returns the sums over (channel, window row) of each of
the 256 window columns, as float32 [2, 128], the TPU probe's output.
"""
from __future__ import annotations

import torch

from . import _cuda

WIN_H, WIN_W = 32, 256          # the TPU probe's window
COPY_BYTES = (16, 8, 4)         # widths of one asynchronous copy

WINDOW_PROBE = _cuda.CudaKernel("window_probe", _cuda.WINDOW_PROBE)


def copy_bytes(align: int) -> int:
    """The widest copy that every `align`-aligned origin allows."""
    for vec in COPY_BYTES:
        if align % vec == 0:
            return vec
    raise ValueError(f"origins aligned to {align} bytes allow no "
                     f"asynchronous copy (widths {COPY_BYTES})")


def window_index(org: torch.Tensor):
    """(rows [n, 32, 1], cols [n, 1, 256]) index tensors of the windows at
    org [n, 2] = (oy, ox)."""
    o = org.long()
    rows = o[:, 0, None] + torch.arange(WIN_H, device=org.device)
    cols = o[:, 1, None] + torch.arange(WIN_W, device=org.device)
    return rows[:, :, None], cols[:, None, :]


def window_probe_plain(frame: torch.Tensor, org: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: [3, H, W] int8 frame, [n, 2] int32 origins ->
    [n, 2, 128] float32. The CPU path, and the version the kernel is held
    against on the card."""
    _check(frame, org)
    rows, cols = window_index(org)
    win = frame[:, rows, cols]                       # [3, n, 32, 256]
    return win.to(torch.float32).sum(dim=(0, 2)).reshape(-1, 2, WIN_W // 2)


def _check(frame: torch.Tensor, org: torch.Tensor) -> None:
    if frame.dtype != torch.int8 or frame.dim() != 3 or frame.shape[0] != 3 \
            or frame.shape[1] < WIN_H or frame.shape[2] < WIN_W:
        raise ValueError(f"expected a [3, H >= {WIN_H}, W >= {WIN_W}] int8 "
                         f"frame, got {tuple(frame.shape)} {frame.dtype}")
    if org.dtype != torch.int32 or org.dim() != 2 or org.shape[1] != 2:
        raise ValueError("expected [n, 2] int32 (oy, ox) origins, got "
                         f"{tuple(org.shape)} {org.dtype}")
    if org.device != frame.device:
        raise ValueError(f"frame on {frame.device}, origins on {org.device}")
    if not (frame.is_contiguous() and org.is_contiguous()):
        raise ValueError("frame and origins must be contiguous")


def window_probe(frame: torch.Tensor, org: torch.Tensor,
                 align: int = 128) -> torch.Tensor:
    """[3, H, W] int8 frame, [n, 2] int32 window origins whose columns are
    multiples of `align` -> [n, 2, 128] float32 column sums. On a CUDA
    tensor it launches the probe kernel with the widest copy `align` allows;
    on a CPU tensor it runs the plain version. The kernel checks each origin
    itself (they live on the device): a window outside the frame or off its
    alignment comes back as NaN."""
    if frame.device.type == "cpu":
        return window_probe_plain(frame, org)
    if frame.device.type != "cuda":
        raise ValueError(f"no kernel for device {frame.device}")
    _check(frame, org)
    vec = copy_bytes(align)
    _, H, W = frame.shape
    if W % vec or frame.data_ptr() % vec:
        raise ValueError(f"{vec}-byte copies need a row width and a frame "
                         f"address that are multiples of {vec}: W={W}")
    n = org.shape[0]
    out = torch.empty((n, 2, WIN_W // 2), dtype=torch.float32,
                      device=frame.device)
    blocks = torch.cuda.get_device_properties(frame.device) \
        .multi_processor_count
    WINDOW_PROBE.launch(frame.data_ptr(), org.data_ptr(), out.data_ptr(), n,
                        H, W, vec, blocks,
                        torch.cuda.current_stream(frame.device).cuda_stream)
    return out
