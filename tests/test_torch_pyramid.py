"""The port's planar pyramid steps (strided shifted adds) against the JAX
package's (banded matrices): the border matrices equal, float32 results to
rounding, bfloat16 results with the same rounding points."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from stitchingvideo_tpu.ops import pyramid_planar as jpyr
from stitchingvideo_tpu_torch.ops import pyramid_planar as tpyr

# odd borders: the smallest sizes, a size that is no power of two, and the
# size the reference's own parity test uses
SHAPES = ((3, 8, 8), (2, 10, 12), (3, 96, 160))
STEPS = ("pyr_down_p", "pyr_up_p")


def _data(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape) \
        .astype(np.float32)


def _f32(a) -> np.ndarray:
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


@pytest.mark.parametrize("n", (2, 4, 8, 10, 96, 160))
def test_border_matrices_equal(n):
    np.testing.assert_array_equal(tpyr._up_mat(n), jpyr._up_mat(n))
    if n >= 4:
        np.testing.assert_array_equal(tpyr._down_mat(n), jpyr._down_mat(n))


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_step_is_its_matrix(step, shape):
    """The shifted adds compute the banded matrices' products (float64
    reference): reflect-101 on both sides going down, reflect on the left
    and edge-replicate on the right going up."""
    x = _data(shape)
    mat = tpyr._down_mat if step == "pyr_down_p" else tpyr._up_mat
    want = np.einsum("chw,hi,wj->cij", x.astype(np.float64),
                     mat(shape[1]), mat(shape[2]))
    got = getattr(tpyr, step)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_step_f32_matches(step, shape):
    """float32 in, float32 throughout: equal but for the order of the sums.
    The bound is 1e-3 absolute on 0..255 data (the reference holds its own
    two formulations to 2e-3); measured 4.6e-5."""
    x = _data(shape, 1)
    ref = _f32(getattr(jpyr, step)(jnp.asarray(x)))
    got = getattr(tpyr, step)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)


@pytest.mark.parametrize("out_dtype", (None, "float32"))
@pytest.mark.parametrize("step", STEPS)
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_step_bf16_matches(step, shape, out_dtype):
    """bfloat16 in: the H pass's float32 sums are rounded to bfloat16 before
    the W pass, and the W pass's to the output type. Products of bfloat16
    values and the taps are exact in float32, so only a sum that is inexact
    in float32 and lands on a bfloat16 rounding tie can differ: at most one
    bfloat16 step on at most 0.1% of values. Measured: every value equal."""
    xb = torch.from_numpy(_data(shape, 2)).to(torch.bfloat16)
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    ref = _f32(getattr(jpyr, step)(
        jx, None if out_dtype is None else jnp.float32))
    got = getattr(tpyr, step)(
        xb, None if out_dtype is None else torch.float32)
    assert got.dtype == (torch.bfloat16 if out_dtype is None
                         else torch.float32)
    got = got.float().numpy()
    assert got.shape == ref.shape
    step_size = np.maximum(np.abs(ref), 1e-30) * 2.0 ** -7   # >= 1 bf16 ulp
    diff = np.abs(got - ref)
    assert (diff <= step_size).all()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


def test_gaussian_pyramid_and_collapse():
    x = _data((3, 32, 48), 3)
    ref = jpyr.gaussian_pyramid_p(jnp.asarray(x), 2)
    got = tpyr.gaussian_pyramid_p(torch.from_numpy(x), 2)
    assert [tuple(g.shape) for g in got] == [(3, 32, 48), (3, 16, 24),
                                             (3, 8, 12)]
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), _f32(r), atol=1e-3)
    # a Laplacian pyramid built with the port's steps collapses to the image
    lap = [got[i] - tpyr.pyr_up_p(got[i + 1]) for i in range(2)] + [got[2]]
    np.testing.assert_allclose(tpyr.collapse_laplacian_p(lap).numpy(), x,
                               atol=1e-3)
    np.testing.assert_allclose(
        tpyr.collapse_laplacian_p(lap).numpy(),
        _f32(jpyr.collapse_laplacian_p([jnp.asarray(a.numpy())
                                        for a in lap])), atol=1e-3)


def test_steps_refuse_what_they_do_not_take():
    with pytest.raises(ValueError):
        tpyr.pyr_down_p(torch.zeros((1, 6, 7)))          # odd size
    with pytest.raises(ValueError):
        tpyr.pyr_down_p(torch.zeros((1, 2, 8)))          # below the taps
    with pytest.raises(ValueError):
        tpyr.pyr_up_p(torch.zeros((1, 4, 4), dtype=torch.float64))
