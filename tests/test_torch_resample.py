"""The port's resampling functions (`mgtpu_torch.ops.resample`) against
`mgtpu.ops.resample`, on the CPU, with numpy inputs from a seed."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mgtpu.ops import resample as jr
from mgtpu_torch.ops import resample as tr


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)


@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (1, 7, 5, 4), (2, 1, 3, 2)])
def test_maxpool2_ceil(shape):
    x = _x(shape)
    np.testing.assert_array_equal(tr.maxpool2_ceil(torch.from_numpy(x)).numpy(),
                                  np.asarray(jr.maxpool2_ceil(jnp.asarray(x))))


@pytest.mark.parametrize("k,s,pad,shape", [(3, 2, 1, (2, 112, 112, 4)), (3, 2, 1, (1, 7, 9, 3)),
                                           (2, 2, 0, (1, 7, 7, 2)), (3, 1, 1, (1, 5, 6, 2))])
def test_maxpool(k, s, pad, shape):
    """Floor mode with -inf padding (the 3x3/2 pad-1 stem pool)."""
    x = _x(shape, seed=1)
    got = tr.maxpool(torch.from_numpy(x), k, s, pad)
    ref = np.asarray(jr.maxpool(jnp.asarray(x), k, s, pad))
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("r,s,shape", [(7, 1, (2, 7, 7, 8)),   # global (the head)
                                       (2, None, (1, 8, 6, 3)),  # divisible (the stem)
                                       (3, 2, (1, 9, 8, 2)),     # general window
                                       (2, None, (1, 7, 7, 2))])  # VALID drops the edge
def test_avgpool_f32(r, s, shape):
    x = _x(shape, seed=2)
    got = tr.avgpool(torch.from_numpy(x), r, s).numpy()
    ref = np.asarray(jr.avgpool(jnp.asarray(x), r, s))
    assert got.shape == ref.shape
    # means of r*r f32 values, summed in another order
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("r,s,shape", [(7, 1, (2, 7, 7, 8)), (2, None, (1, 8, 6, 3))])
def test_avgpool_bf16_accumulates_in_f32(r, s, shape):
    x = _x(shape, seed=3).astype(ml_dtypes.bfloat16)
    ref = np.asarray(jr.avgpool(jnp.asarray(x), r, s)).astype(np.float32)
    got = tr.avgpool(torch.from_numpy(x.astype(np.float32)).bfloat16(), r, s)
    assert got.dtype == torch.bfloat16
    # both sum in f32 and round once to bf16; a different summation order
    # can move that rounding by one bf16 step (up to 2^-7 relative)
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=2.0 ** -7, atol=1e-6)


# the input pyramid's 2x2/2 averages: R-MG-34's and PR-MG-30's 224 px
# images and their 112 px scale, the CIFAR nets' 32 px images down to 4 px,
# the cluttered-MNIST nets' 64x64x1 down to 8 px
PYRAMID_SHAPES = [(2, 224, 224, 3), (2, 112, 112, 3), (4, 32, 32, 3), (4, 16, 16, 3),
                  (4, 8, 8, 3), (4, 4, 4, 3), (4, 64, 64, 1), (4, 32, 32, 1), (4, 16, 16, 1),
                  (4, 8, 8, 1)]


@pytest.mark.parametrize("shape", PYRAMID_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_avgpool2_is_bit_equal_to_jax(shape, dtype):
    """The pyramid's average, bit for bit: both add the four taps in f32
    in XLA's order for the row (((a + b) + c) + d for the 3-channel
    images, (a + b) + (c + d) for the 1-channel ones, whose W*C is a power
    of two) and divide by 4. A torch reduction (``mean``) is an ulp off
    at some pixels of the 3-channel images on the CPU."""
    x = (_x(shape, seed=6) * 37).astype(getattr(ml_dtypes, dtype) if dtype == "bfloat16"
                                         else np.float32)
    ref = np.asarray(jr.avgpool(jnp.asarray(x), 2)).astype(np.float32)
    xt = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    got = tr.avgpool(xt, 2)
    assert got.dtype == xt.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got.float().numpy(), ref)


@pytest.mark.parametrize("shape,out", [((2, 4, 4, 3), None), ((1, 4, 3, 2), (7, 5)),
                                       ((1, 3, 3, 2), (6, 5)), ((1, 2, 2, 1), (3, 4))])
def test_upsample_nearest2(shape, out):
    x = _x(shape, seed=4)
    oh, ow = out if out else (None, None)
    got = tr.upsample_nearest2(torch.from_numpy(x), oh, ow)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), np.asarray(jr.upsample_nearest2(jnp.asarray(x), oh, ow)))


def test_ceil_div2():
    assert [tr.ceil_div2(n) for n in range(9)] == [jr.ceil_div2(n) for n in range(9)]


def test_nchw_nhwc_views():
    """nchw is a copy-free channels_last view; nhwc of it returns the same
    memory."""
    x = torch.from_numpy(_x((2, 5, 4, 3), seed=5))
    v = tr.nchw(x)
    assert v.shape == (2, 3, 5, 4) and v.is_contiguous(memory_format=torch.channels_last)
    assert v.data_ptr() == x.data_ptr()
    assert tr.nhwc(v).data_ptr() == x.data_ptr()
