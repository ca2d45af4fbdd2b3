"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and nvcc, is marked ``cuda`` and
skips without a card. This file imports no JAX, so it runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mgtpu_torch import kernels
from mgtpu_torch.ops.cuda_conv import conv3x3, conv3x3_plain
from mgtpu_torch.ops.cuda_pool import maxpool2, maxpool2_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    # the plain reference in full f32 (cuDNN convs default to TF32)
    old = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def _conv_inputs(n, h, w, ci, co, dtype, dev, seed=0, ci_total=None):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, h, w, ci), dtype=np.float32))
    wt = torch.from_numpy(0.1 * rng.standard_normal((3, 3, ci_total or ci, co),
                                                    dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal(co, dtype=np.float32))
    return x.to(dev, dtype), wt.to(dev, dtype), b.to(dev)


# (n, h, w, ci, co): the path's smallest and a 56x56 one, plus tails of
# every tile dimension (64 pixels, 16 or 32 input channels, 64 output
# channels); Ci or Co not a multiple of 8 takes the element-load path
CONV_SHAPES = [(2, 7, 7, 16, 16), (2, 56, 56, 64, 64), (3, 9, 5, 40, 24),
               (1, 14, 14, 96, 130), (2, 6, 5, 19, 40)]


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu_out", [False, True])
@pytest.mark.parametrize("with_stats", [False, True])
def test_conv3x3_kernel_matches_plain(dev, shape, dtype, relu_out, with_stats):
    x, w, b = _conv_inputs(*shape, dtype, dev)
    y, st = conv3x3(x, w, b, relu_out=relu_out, with_stats=with_stats)
    # reference: the plain version in f32 on the same (bf16-rounded) inputs
    y_ref, st_ref = conv3x3_plain(x.float(), w.float(), b, relu_out=relu_out,
                                  with_stats=with_stats)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == y_ref.shape
    scale = y_ref.abs().max().item()
    # f32: summation order only; bf16: one rounding of the output on top,
    # up to 2^-8 relative (8 significant bits), bounded at twice that
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), y_ref, rtol=rtol, atol=1e-5 * scale)
    if with_stats:
        # per-channel sums over N*H*W values, added with atomics in a
        # varying order
        torch.testing.assert_close(st, st_ref, rtol=1e-4,
                                   atol=1e-5 * st_ref.abs().max().item())
    else:
        assert not st.any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_kernel_takes_weight_slice(dev, dtype):
    """The exchange passes an input-channel slice of a wider weight."""
    x, w, b = _conv_inputs(2, 8, 8, 24, 32, dtype, dev, ci_total=56)
    ws = w[:, :, 16:40, :]
    y, _ = conv3x3(x, ws, b, with_stats=False)
    y_ref, _ = conv3x3_plain(x.float(), ws.float().contiguous(), b, with_stats=False)
    # as in test_conv3x3_kernel_matches_plain
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), y_ref, rtol=rtol, atol=1e-5 * y_ref.abs().max().item())


def test_conv3x3_wrapper_refuses(dev):
    x, w, b = _conv_inputs(1, 4, 4, 16, 16, torch.float32, dev)
    with pytest.raises(TypeError):
        conv3x3(x.half(), w.half(), b)
    with pytest.raises(TypeError):
        conv3x3(x, w, b.bfloat16())
    with pytest.raises(ValueError):
        conv3x3(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError):
        conv3x3(x, w.transpose(2, 3), b)
    with pytest.raises(NotImplementedError):
        conv3x3(x, w.requires_grad_(), b)


def _pool_input(shape, dtype, dev, seed=0):
    x = torch.from_numpy(np.random.default_rng(seed).standard_normal(shape, dtype=np.float32))
    x[0, 0, 0, 0] = float("nan")
    x[0, -1, -1, -1] = float("inf")
    x[-1, :2, :2, :] = float("-inf")  # a window of -inf only
    x[-1, -1, -1, -1] = float("nan")  # in a clipped edge window
    return x.to(dev, dtype)


@pytest.mark.parametrize("shape", [(2, 8, 16, 5), (2, 7, 9, 3), (1, 1, 1, 4),
                                   (4, 56, 56, 64), (3, 15, 14, 130)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxpool2_kernel_exact(dev, shape, dtype):
    x = _pool_input(shape, dtype, dev)
    y = maxpool2(x)
    torch.testing.assert_close(y, maxpool2_plain(x), rtol=0, atol=0, equal_nan=True)


def test_maxpool2_wrapper_refuses(dev):
    x = _pool_input((1, 4, 4, 2), torch.float32, dev)
    with pytest.raises(TypeError):
        maxpool2(x.half())
    with pytest.raises(ValueError):
        maxpool2(x.transpose(1, 2))
    with pytest.raises(NotImplementedError):
        maxpool2(x.clone().requires_grad_())


def test_rmg18_forward_launches_and_matches_cpu(dev):
    """A depth-18 f32 forward on the card goes through the kernels (56
    conv3x3 and 26 maxpool2 launches) and agrees with the plain CPU
    forward of the same weights."""
    from mgtpu_torch.models import get_net

    model = get_net("ilsvrc/rnmg")(depth=18, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 224, 224, 3),
                                                                  dtype=np.float32))
    with torch.inference_mode():
        ref = model(x)
        model.to(dev)
        kernels.reset_launches()
        got = model(x.to(dev)).cpu()
    assert kernels.LAUNCHES == {"conv3x3": 56, "maxpool2": 26}
    # f32 on both sides; the deep random-init net amplifies the
    # summation-order differences, so the bound is relative
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())
