"""The port's 3x3 conv (`mgtpu_torch.ops.cuda_conv`) against the JAX
package's Pallas kernel (`mgtpu.ops.pallas_conv.conv3x3`, in interpret
mode, both variants) and its XLA formulation, in f32 on the CPU. On a
CPU tensor the wrapper takes the plain version; the CUDA kernel itself
is compared with the plain version on the card (tests/test_torch_cuda.py
and chip_smoke.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgtpu.ops.pallas_conv import conv3x3 as pallas_conv3x3
from mgtpu.ops.pallas_conv import xla_conv3x3
from mgtpu_torch.ops.cuda_conv import conv3x3, conv3x3_plain


def _data(n=2, h=8, w=16, ci=8, co=8, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, ci), dtype=np.float32)
    wt = (0.1 * rng.standard_normal((3, 3, ci, co))).astype(np.float32)
    b = rng.standard_normal(co, dtype=np.float32)
    return x, wt, b


def _jax(variant, x, wt, b, relu_out, with_stats):
    args = (jnp.asarray(x), jnp.asarray(wt), jnp.asarray(b))
    if variant == "xla":
        return xla_conv3x3(*args, relu_out=relu_out, with_stats=with_stats)
    return pallas_conv3x3(*args, variant=variant, relu_out=relu_out,
                          with_stats=with_stats, th=8, interpret=True)


@pytest.mark.parametrize("variant", ["rows", "slab", "xla"])
@pytest.mark.parametrize("relu_out", [False, True])
@pytest.mark.parametrize("with_stats", [False, True])
def test_conv3x3_plain_matches_jax(variant, relu_out, with_stats):
    x, wt, b = _data()
    y_ref, st_ref = _jax(variant, x, wt, b, relu_out, with_stats)
    y, st = conv3x3_plain(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b),
                          relu_out=relu_out, with_stats=with_stats)
    assert y.shape == (2, 8, 16, 8) and st.shape == (2, 8) and st.dtype == torch.float32
    # f32 on both sides: summation order only (72-term dot products)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    # stats sum 256 values per channel, in another order
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), rtol=1e-4, atol=1e-3)
    if not with_stats:
        assert not st.any()


@pytest.mark.parametrize("variant", ["rows", "slab", "xla"])
def test_conv3x3_plain_matches_jax_16_channels(variant):
    """The narrowest exchange conv of R-MG-34 (Ci = Co = 16), at the
    coarsest grid's odd 7x7 (rows and XLA) or an 8x8 slab."""
    h = 8 if variant == "slab" else 7
    x, wt, b = _data(n=2, h=h, w=h if variant != "slab" else 16, ci=16, co=16, seed=1)
    y_ref, st_ref = _jax(variant, x, wt, b, True, True)
    y, st = conv3x3_plain(torch.from_numpy(x), torch.from_numpy(wt), torch.from_numpy(b),
                          relu_out=True, with_stats=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), rtol=1e-4, atol=1e-3)


def test_conv3x3_wrapper_on_cpu_is_the_plain_version():
    x, wt, b = (torch.from_numpy(a) for a in _data(seed=2))
    for relu_out in (False, True):
        y, st = conv3x3(x, wt, b, relu_out=relu_out)
        y_ref, st_ref = conv3x3_plain(x, wt, b, relu_out=relu_out)
        torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
        torch.testing.assert_close(st, st_ref, rtol=0, atol=0)


def test_conv3x3_plain_takes_weight_slice():
    """The exchange passes an input-channel slice of a wider HWIO weight:
    conv(concat(x0, x1), W) = conv(x0, W[:, :, :c0]) + conv(x1, W[:, :, c0:])."""
    rng = np.random.default_rng(3)
    x0 = torch.from_numpy(rng.standard_normal((1, 6, 5, 4), dtype=np.float32))
    x1 = torch.from_numpy(rng.standard_normal((1, 6, 5, 3), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 7, 5), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal(5, dtype=np.float32))
    y0, _ = conv3x3(x0, w[:, :, :4], b, with_stats=False)
    y1, _ = conv3x3(x1, w[:, :, 4:], torch.zeros(5), with_stats=False)
    y, _ = conv3x3_plain(torch.cat([x0, x1], dim=-1), w, b, with_stats=False)
    torch.testing.assert_close(y0 + y1, y, rtol=1e-5, atol=1e-5)


def test_conv3x3_wrapper_refuses_other_devices():
    x, wt, b = (torch.from_numpy(a).to("meta") for a in _data())
    with pytest.raises(ValueError, match="unsupported device"):
        conv3x3(x, wt, b)
