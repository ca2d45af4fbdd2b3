"""The port's 2x2/2 max pool (`mgtpu_torch.ops.cuda_pool`) against the
JAX package's Pallas kernel (`maxpool2_pallas`, interpret mode, even
sizes) and `maxpool2_ceil` (every size, NaN and -inf included), exactly,
on the CPU. The CUDA kernel is held to the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py)."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mgtpu.ops.pallas_pool import maxpool2_pallas
from mgtpu.ops.resample import maxpool2_ceil as jax_maxpool2_ceil
from mgtpu_torch.ops.cuda_pool import maxpool2, maxpool2_plain


def _x(shape, seed=0, specials=False):
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    if specials:
        x[0, 0, 0, 0] = np.nan
        x[0, -1, -1, -1] = np.inf
        x[-1, :2, :2, :] = -np.inf  # a window of -inf only
        x[-1, -1, -1, -1] = np.nan  # in a clipped edge window when H or W is odd
    return x


@pytest.mark.parametrize("shape", [(2, 8, 16, 5), (1, 4, 4, 3), (3, 16, 8, 7)])
def test_maxpool2_plain_matches_pallas(shape):
    x = _x(shape)
    with pltpu.force_tpu_interpret_mode():
        ref = maxpool2_pallas(jnp.asarray(x))
    np.testing.assert_array_equal(maxpool2_plain(torch.from_numpy(x)).numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(2, 7, 9, 3), (1, 1, 1, 4), (2, 15, 14, 6), (1, 8, 8, 2)])
@pytest.mark.parametrize("specials", [False, True])
def test_maxpool2_plain_matches_maxpool2_ceil(shape, specials):
    x = _x(shape, seed=1, specials=specials)
    got = maxpool2_plain(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_maxpool2_ceil(jnp.asarray(x))))


def test_maxpool2_plain_bf16_matches_maxpool2_ceil():
    """A max selects one input, so bf16 agrees bit for bit too."""
    x = _x((2, 9, 6, 5), seed=2, specials=True).astype(ml_dtypes.bfloat16)
    ref = np.asarray(jax_maxpool2_ceil(jnp.asarray(x))).astype(np.float32)
    xt = torch.from_numpy(x.astype(np.float32)).bfloat16()
    got = maxpool2_plain(xt)
    assert got.dtype == torch.bfloat16 and got.is_contiguous()
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_maxpool2_wrapper_on_cpu_is_the_plain_version():
    x = torch.from_numpy(_x((2, 7, 10, 3), seed=3, specials=True))
    torch.testing.assert_close(maxpool2(x), maxpool2_plain(x), rtol=0, atol=0, equal_nan=True)


def test_maxpool2_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        maxpool2(torch.zeros((1, 4, 4, 2), device="meta"))
