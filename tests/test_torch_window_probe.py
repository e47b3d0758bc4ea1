"""The window-copy probe K7: the port's plain version against the TPU kernel.

`scripts/test_misaligned_dma.py` `make_kernel(align)` is run through
`pl.pallas_call(..., interpret=True)` with the grid spec of that script's
`run` (a grid of one step a window, the origins as scalar prefetch, the frame
left in HBM, double-buffered VMEM windows and DMA semaphores), on the CPU.
The same seeded numpy frame and origins go through `window_probe_plain` and
the CPU `window_probe`; both must equal the TPU kernel's output bit for bit
(sums of 96 int8 values are exact in float32 in any order). The card's
kernel is held against the plain version in `tests/test_torch_cuda.py` and
`chip_smoke.py`.
"""
import importlib.util
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from stitchingvideo_tpu_torch.ops import window_probe as wp

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / \
    "test_misaligned_dma.py"


@pytest.fixture(scope="module")
def tpu_probe():
    spec = importlib.util.spec_from_file_location("test_misaligned_dma",
                                                  SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    path = list(sys.path)
    try:                                # the script puts its repo on the path
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
    return mod


def run_tpu_kernel(mod, frame: np.ndarray, org: np.ndarray,
                   align: int) -> np.ndarray:
    """The TPU probe's kernel over n windows, as its `run` calls it, in
    interpret mode: [3, H, W] int8, [n, 2] int32 -> [n, 2, 128] float32."""
    n = org.shape[0]
    out = pl.pallas_call(
        mod.make_kernel(align),
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=1,
            grid=(n,),
            in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
            out_specs=pl.BlockSpec((1, 2, 128), lambda t, *_: (t, 0, 0),
                                   memory_space=pltpu.VMEM),
            scratch_shapes=[
                pltpu.VMEM((2, 3, mod.WIN_H, mod.VXW), jnp.int8),
                pltpu.SemaphoreType.DMA((2,)),
            ],
        ),
        out_shape=jax.ShapeDtypeStruct((n, 2, 128), jnp.float32),
        interpret=True,
    )(jnp.asarray(org.ravel()), jnp.asarray(frame))
    return np.asarray(out)


def probe_inputs(hw, n: int, align: int, seed: int, extremes: bool):
    """A frame of the whole int8 range (or of -128 and 127 alone) and n
    origins as the TPU probe draws them: rows multiples of 8, columns
    multiples of `align`."""
    H, W = hw
    rng = np.random.default_rng(seed)
    if extremes:
        frame = np.where(rng.random((3, H, W)) < 0.5, -128, 127) \
            .astype(np.int8)
    else:
        frame = rng.integers(-128, 128, (3, H, W), dtype=np.int8)
    oy = rng.integers(0, (H - wp.WIN_H) // 8 + 1, n) * 8
    ox = rng.integers(0, (W - wp.WIN_W) // align + 1, n) * align
    return frame, np.stack([oy, ox], 1).astype(np.int32)


@pytest.mark.parametrize("extremes", (False, True), ids=("range", "extremes"))
@pytest.mark.parametrize("hw, n", (((64, 512), 4), ((1088, 1920), 6)),
                         ids=("64x512", "1088x1920"))
@pytest.mark.parametrize("align", (128, 32))
def test_plain_matches_the_tpu_kernel(tpu_probe, align, hw, n, extremes):
    frame, org = probe_inputs(hw, n, align, seed=align + n, extremes=extremes)
    want = run_tpu_kernel(tpu_probe, frame, org, align)
    assert want.shape == (n, 2, 128) and want.dtype == np.float32
    f, o = torch.from_numpy(frame), torch.from_numpy(org)
    plain = wp.window_probe_plain(f, o)
    assert np.array_equal(plain.numpy(), want)
    cpu = wp.window_probe(f, o, align)
    assert cpu.device.type == "cpu"
    assert np.array_equal(cpu.numpy(), want)

