"""The staging table of the seam-select (mat2) and feather kernels.

Both kernels give each CUDA block a square of BLOCK_H x BLOCK_W panorama
pixels. Before the block computes a plane (frame set b, channel c), it copies
the source rows its pixels tap into shared memory with 16-byte asynchronous
copies, and then gathers the taps from there. What it copies is set per block
at install time, here, from the per-pixel taps of the state:

  up to SLOTS slots a block, one per camera that a kernel pixel of the block
  taps (the cameras in ascending order), each a box of the camera's frame:
  rows `row0 .. row0 + rows - 1`, columns `col0 .. col0 + cols - 1`, with
  `col0` rounded down to a multiple of 16 and `cols` a multiple of 16, that
  holds every tap of the block's kernel pixels of that camera, the second
  taps clamped to the frame as the kernels clamp them.

The boxes of a block lie one after the other in a stage of shared memory,
each row-major with a pitch of `cols` bytes. A block that taps more than
SLOTS cameras, or whose boxes hold more than STAGE_BUDGET bytes, or any block
with a kernel pixel when the frame's width is not a multiple of 16 (its rows
do not start on 16-byte boundaries), takes the kernels' direct-gather branch
instead; its slot 0 holds DIRECT. Fallback-tile pixels are no kernel pixels:
they keep their exact float gather from device memory in either branch.

The table is [blocks, SLOTS, 4] int32, (camera, row0, col0, rows << 16 |
cols) a slot, camera -1 for an unused slot; blocks are row-major over the
panorama. `tests/test_torch_staging.py` holds its invariants.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

BLOCK_H = 32                 # panorama rows of a block
BLOCK_W = 32                 # panorama columns of a block
SLOTS = 2                    # cameras a staged block may tap
# Bytes of boxes a block stages for one plane. The kernels are launched for
# 6 blocks an SM (`__launch_bounds__(256, 6)`), and every block takes shared
# memory for the largest staged block of the state (`stage_bytes`), so a
# block with more box bytes than 6 blocks an SM leave room for goes direct
# instead of costing every block of the panorama its residency. An H100 SM
# has 228 KB of shared memory and reserves 1 KB of it a block: 6 blocks
# leave 37,888 bytes of dynamic shared memory a block. mat2 takes 3 ring stages of 3 planes (9 * stage_bytes) and
# feather 2 (6 * stage_bytes + 12,288 for its second slots); mat2's
# 37,888 // 9 = 4,209, down to a multiple of 16 less the 16 bytes past the
# boxes, bounds both. csrc/staging.cuh mirrors it as kBudget, and each kernel
# asserts at compile time that 6 blocks fit.
STAGE_BUDGET = 4192
COPY = 16                    # bytes of one asynchronous copy
DIRECT = -2                  # slot 0's camera on a direct-gather block


def grid_of(pano_hw) -> Tuple[int, int]:
    """Blocks down and across a panorama."""
    Hp, Wp = pano_hw
    return -(-Hp // BLOCK_H), -(-Wp // BLOCK_W)


def staging_table(taps: Sequence[Tuple[torch.Tensor, ...]], pano_hw,
                  frame_hw):
    """The staging table of a state: (table [blocks, SLOTS, 4] int32,
    stage_bytes, direct blocks).

    `taps` lists (pixel, cam, x0, y0) tensors, one entry per set of kernel
    taps (a slot's live pixels in the feather state): the row-major panorama
    pixel, the camera and the top-left tap in the frame. `stage_bytes` is the
    shared memory a stage of this state needs: the largest total of a staged
    block's boxes, rounded up to 16, plus 16 bytes that a zero-weight second
    tap at a box's last column may read past the boxes."""
    fh, fw = frame_hw
    Hp, Wp = pano_hw
    nby, nbx = grid_of(pano_hw)
    nb = nby * nbx
    dev = taps[0][0].device
    pix, cam, x0, y0 = (torch.cat([t[i].reshape(-1).long() for t in taps])
                        for i in range(4))
    # the second taps, clamped as the kernels clamp them
    x1 = (x0 + 1).clamp(max=fw - 1)
    y1 = (y0 + 1).clamp(max=fh - 1)
    blk = (pix // Wp // BLOCK_H) * nbx + (pix % Wp) // BLOCK_W
    ncam = int(cam.max()) + 1 if cam.numel() else 1
    key = blk * ncam + cam
    big = 1 << 30

    def reduce(v, how, init):
        return torch.full((nb * ncam,), init, dtype=torch.long, device=dev) \
            .scatter_reduce(0, key, v, how)

    ylo, yhi = reduce(y0, "amin", big), reduce(y1, "amax", -1)
    xlo, xhi = reduce(x0, "amin", big), reduce(x1, "amax", -1)
    present = (yhi >= 0).reshape(nb, ncam)
    rank = present.cumsum(1) - 1
    n_cams = present.sum(1)
    table = torch.zeros((nb, SLOTS, 4), dtype=torch.long, device=dev)
    total = torch.zeros(nb, dtype=torch.long, device=dev)
    for s in range(SLOTS):
        m = present & (rank == s)
        has = m.any(1)
        c = m.long().argmax(1)
        k = torch.arange(nb, device=dev) * ncam + c
        row0 = ylo[k]
        col0 = xlo[k] // COPY * COPY
        rows = yhi[k] - row0 + 1
        cols = (xhi[k] + 1 - col0 + COPY - 1) // COPY * COPY
        zero = torch.zeros((), dtype=torch.long, device=dev)
        table[:, s] = torch.stack([
            torch.where(has, c, -1), torch.where(has, row0, zero),
            torch.where(has, col0, zero),
            torch.where(has, (rows << 16) | cols, zero)], dim=1)
        total += torch.where(has, rows * cols, zero)
    direct = (n_cams > SLOTS) | (total > STAGE_BUDGET)
    if fw % COPY:
        direct |= n_cams > 0
    table[direct] = 0
    table[direct, 0, 0] = DIRECT
    table[direct, 1:, 0] = -1
    staged = total[~direct]
    top = int(staged.max()) if staged.numel() else 0
    stage_bytes = -(-top // COPY) * COPY + COPY
    return (table.to(torch.int32).contiguous(), stage_bytes,
            int(direct.sum()))


def unpack_table(table: torch.Tensor) -> dict:
    """The table's fields, each [blocks, SLOTS]: cam, row0, col0, rows,
    cols."""
    t = table.long()
    return dict(cam=t[..., 0], row0=t[..., 1], col0=t[..., 2],
                rows=t[..., 3] >> 16, cols=t[..., 3] & 0xFFFF)
