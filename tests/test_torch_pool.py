"""The port's 2x2/2 max pool (`mgtpu_torch.ops.cuda_pool`) against the
JAX package's Pallas kernel (`maxpool2_pallas`, interpret mode, even
sizes) and `maxpool2_ceil` (every size, NaN and -inf included), exactly,
on the CPU: the forward, and the backward with the Pallas kernel's
all-ties rule. The CUDA kernels are held to the plain versions on the
card (tests/test_torch_cuda.py and chip_smoke.py)."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mgtpu.ops.pallas_pool import maxpool2_pallas
from mgtpu.ops.resample import maxpool2_ceil as jax_maxpool2_ceil
from mgtpu_torch.ops.cuda_pool import maxpool2, maxpool2_bwd_plain, maxpool2_plain


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


def _port_vjp(x, g, ties="all"):
    """dx of the port's maxpool2 (its autograd Function) for cotangent g."""
    xt = torch.from_numpy(x).requires_grad_()
    maxpool2(xt, ties).backward(torch.from_numpy(g))
    return xt.grad.numpy()


# even sizes, the Pallas kernel's domain; "relu" inputs are ReLU outputs,
# whose all-zero windows tie four ways
@pytest.mark.parametrize("shape", [(2, 8, 16, 5), (1, 4, 4, 3), (3, 16, 8, 7)])
@pytest.mark.parametrize("relu", [False, True])
def test_maxpool2_backward_matches_pallas_vjp(shape, relu):
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape, dtype=np.float32)
    if relu:
        x = np.maximum(x, 0.0)
    g = rng.standard_normal((shape[0], shape[1] // 2, shape[2] // 2, shape[3]), dtype=np.float32)
    with pltpu.force_tpu_interpret_mode():
        ref = jax.vjp(maxpool2_pallas, jnp.asarray(x))[1](jnp.asarray(g))[0]
    np.testing.assert_array_equal(_port_vjp(x, g), np.asarray(ref))


def test_maxpool2_backward_tie_rule():
    """Every element tied for the window max gets the cotangent, as the
    Pallas backward (tests/test_pallas_pool.py) and unlike XLA's
    SelectAndScatter, which picks one winner."""
    dx = _port_vjp(np.zeros((1, 2, 2, 1), np.float32), np.ones((1, 1, 1, 1), np.float32))
    assert dx.sum() == 4.0


def test_maxpool2_backward_nan_window_gets_zero():
    x = _x((1, 4, 4, 2), seed=5)
    x[0, 1, 0, 1] = np.nan  # the window (0, 0) of channel 1 has a NaN max
    g = np.ones((1, 2, 2, 2), np.float32)
    dx = _port_vjp(x, g)
    assert not dx[0, :2, :2, 1].any()
    assert dx[0, :2, :2, 0].sum() == 1.0 and dx[0, 2:, :, :].sum() == 4.0


def _np_bwd(x, g):
    """The clipped all-ties rule in numpy: dx[i, j] = g[i//2, j//2] where
    x[i, j] equals its window's max (the port's plain version is not
    used to check itself)."""
    y = np.asarray(jax_maxpool2_ceil(jnp.asarray(x)))
    n, h, w, c = x.shape
    ii, jj = np.arange(h) // 2, np.arange(w) // 2
    yy, gg = y[:, ii][:, :, jj], g[:, ii][:, :, jj]
    return np.where(x == yy, gg, np.float32(0.0))


@pytest.mark.parametrize("shape", [(2, 7, 9, 3), (1, 1, 1, 4), (2, 15, 14, 6), (1, 8, 8, 2)])
@pytest.mark.parametrize("specials", [False, True])
def test_maxpool2_backward_odd_sizes_match_numpy(shape, specials):
    x = _x(shape, seed=6, specials=specials)
    n, h, w, c = shape
    g = np.random.default_rng(7).standard_normal((n, -(-h // 2), -(-w // 2), c),
                                                 dtype=np.float32)
    np.testing.assert_array_equal(_port_vjp(x, g), _np_bwd(x, g))


def test_maxpool2_backward_bf16_casts_g_to_x_dtype():
    x = torch.from_numpy(_x((2, 6, 5, 3), seed=8, specials=True)).bfloat16()
    g = torch.randn((2, 3, 3, 3), generator=torch.Generator().manual_seed(0))
    y = maxpool2_plain(x)
    dx = maxpool2_bwd_plain(x, y, g)
    assert dx.dtype == torch.bfloat16
    ref = _np_bwd(x.float().numpy(), g.bfloat16().float().numpy())
    np.testing.assert_array_equal(dx.float().numpy(), ref)


# values from {0, 1, 2}: most windows tie, at zero and at positive values
@pytest.mark.parametrize("shape", [(2, 8, 8, 3), (2, 7, 9, 5), (1, 1, 1, 2), (3, 15, 14, 4)])
def test_maxpool2_ceil_first_tie_rule_matches_xla(shape):
    """ties="first", the rule of the model's maxpool2_ceil: only the
    first tied element of a window in row-major order gets g, exactly as
    XLA's SelectAndScatter gives JAX's maxpool2_ceil its gradient; an
    all -inf window passes g to its first element."""
    rng = np.random.default_rng(9)
    x = rng.integers(0, 3, shape).astype(np.float32)
    x[0, :2, :2, 0] = -np.inf
    n, h, w, c = shape
    g = rng.standard_normal((n, -(-h // 2), -(-w // 2), c), dtype=np.float32)
    ref = jax.vjp(jax_maxpool2_ceil, jnp.asarray(x))[1](jnp.asarray(g))[0]
    np.testing.assert_array_equal(_port_vjp(x, g, "first"), np.asarray(ref))


def test_maxpool2_first_tie_rule_bf16_and_nan():
    x = torch.tensor([[1.0, 1.0], [0.5, 1.0]]).reshape(1, 2, 2, 1)
    x = torch.cat([x, torch.full_like(x, float("nan"))], dim=-1).bfloat16()
    g = torch.tensor([2.0, 3.0]).reshape(1, 1, 1, 2)
    dx = maxpool2_bwd_plain(x, maxpool2_plain(x), g, ties="first")
    assert dx.dtype == torch.bfloat16
    # the first of three tied ones; a NaN window passes nothing
    assert dx[0, :, :, 0].flatten().tolist() == [2.0, 0.0, 0.0, 0.0]
    assert not dx[..., 1].any()
    with pytest.raises(ValueError, match="ties"):
        maxpool2(x, ties="last")
