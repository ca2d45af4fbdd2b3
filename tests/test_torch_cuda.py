"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and nvcc, is marked ``cuda`` and
skips without a card. This file imports no JAX, so it runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from chip_smoke import RMG34_POOLS, misaligned
from mgtpu_torch import kernels
from mgtpu_torch.ops.cuda_conv import (_route, _tile_forward, bn_relu_plain, conv3x3,
                                       conv3x3_bn_relu_in, conv3x3_bn_relu_in_plain,
                                       conv3x3_plain)
from mgtpu_torch.ops.cuda_pool import (_route as _pool_route, _simple_forward, maxpool2,
                                       maxpool2_backward, maxpool2_bwd_plain, maxpool2_plain)

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
# channels); Ci or Co not a multiple of 8 takes the element-load path.
# In bf16, the shapes with Ci and Co multiples of 64 take the sm90 design:
# 56x56, 7x7x512 and 14x14x256 (large shapes of R-MG-34), and 3x9x5,
# whose M (135), H and W are no multiples of its tiles
CONV_SHAPES = [(2, 7, 7, 16, 16), (2, 56, 56, 64, 64), (3, 9, 5, 40, 24),
               (1, 14, 14, 96, 130), (2, 6, 5, 19, 40), (2, 7, 7, 512, 512),
               (3, 9, 5, 64, 128), (2, 14, 14, 256, 256)]
SM90_SHAPES = [s for s in CONV_SHAPES if s[3] % 64 == 0 and s[4] % 64 == 0]


def _run(kernel, design, x, w, fn):
    """fn(), which must launch `kernel` once through `design` ("routed":
    the design _route picks)"""
    want = _route(x, w) if design == "routed" else design
    kernels.reset_launches()
    out = fn()
    assert kernels.ROUTES[(kernel, want)] == 1 and sum(kernels.ROUTES.values()) == 1
    return out


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu_out", [False, True])
@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("design", ["routed", "tile"])
def test_conv3x3_kernel_matches_plain(dev, shape, dtype, relu_out, with_stats, design):
    x, w, b = _conv_inputs(*shape, dtype, dev)
    fn = conv3x3 if design == "routed" else _tile_forward
    y, st = _run("conv3x3", design, x, w,
                 lambda: fn(x, w, b, relu_out=relu_out, with_stats=with_stats))
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
@pytest.mark.parametrize("ci, co, ci_total, start", [(24, 32, 56, 16), (64, 128, 192, 64)])
def test_conv3x3_kernel_takes_weight_slice(dev, dtype, ci, co, ci_total, start):
    """The exchange passes an input-channel slice of a wider weight (in
    bf16 the second goes to the sm90 design)."""
    x, w, b = _conv_inputs(2, 8, 8, ci, co, dtype, dev, ci_total=ci_total)
    ws = w[:, :, start:start + ci, :]
    y, _ = _run("conv3x3", "routed", x, ws, lambda: conv3x3(x, ws, b, with_stats=False))
    y_ref, _ = conv3x3_plain(x.float(), ws.float().contiguous(), b, with_stats=False)
    # as in test_conv3x3_kernel_matches_plain
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), y_ref, rtol=rtol, atol=1e-5 * y_ref.abs().max().item())


@pytest.mark.parametrize("shape", SM90_SHAPES)
@pytest.mark.parametrize("relu_out", [False, True])
@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("prologue", [False, True])
def test_sm90_design_matches_tile_design(dev, shape, relu_out, with_stats, prologue):
    """The two designs on the same bf16 operands: each rounds its f32 sum
    once to bf16, in another summation order, so they differ by at most
    about one bf16 step (2^-8 to 2^-7 relative)."""
    x, w, b = _conv_inputs(*shape, torch.bfloat16, dev)
    vectors = _bn(shape[3], dev) if prologue else ()
    kernel = "conv3x3_bn_relu_in" if prologue else "conv3x3"
    fn = conv3x3_bn_relu_in if prologue else conv3x3
    assert _route(x, w) == "sm90"
    y, st = _run(kernel, "sm90", x, w,
                 lambda: fn(x, w, b, *vectors, relu_out=relu_out, with_stats=with_stats))
    y_t, st_t = _run(kernel, "tile", x, w, lambda: _tile_forward(
        x, w, b, *vectors, relu_out=relu_out, with_stats=with_stats))
    torch.cuda.synchronize()
    torch.testing.assert_close(y.float(), y_t.float(), rtol=2.0 ** -7,
                               atol=1e-5 * y_t.float().abs().max().item())
    # per-channel sums of the f32 values, in two atomic orders
    torch.testing.assert_close(st, st_t, rtol=1e-4, atol=1e-5 * st_t.abs().max().item())


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
    with pytest.raises(ValueError, match="scale"):
        conv3x3_bn_relu_in(x, w, b, torch.ones(8, device=dev), torch.zeros(16, device=dev))


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


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("shape", RMG34_POOLS + [(8, 9, 64), (14, 14, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxpool2_sm90_equals_plain_and_simple(dev, shape, dtype):
    """At batch 128, the main path's (a block walks many chunks, so the
    ring wraps; 8x9 has an odd W), with NaN, +-inf and an all -inf
    window: the sm90 design equals the plain version and, bit for bit,
    the simple design (both select the input value by one rule)."""
    x = _pool_input((128, *shape), dtype, dev, seed=sum(shape))
    assert _pool_route(x) == "sm90"
    kernels.reset_launches()
    y, y_simple = maxpool2(x), _simple_forward(x)
    assert kernels.ROUTES[("maxpool2", "sm90")] == 1
    assert kernels.ROUTES[("maxpool2", "simple")] == 1
    torch.testing.assert_close(y, maxpool2_plain(x), rtol=0, atol=0, equal_nan=True)
    assert torch.equal(_bits(y), _bits(y_simple))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_maxpool2_misaligned_view_takes_the_simple_design(dev, dtype):
    x = _pool_input((2, 8, 8, 64), dtype, dev)
    xm = misaligned(x)
    assert _pool_route(x) == "sm90" and _pool_route(xm) == "simple"
    kernels.reset_launches()
    y = maxpool2(xm)
    assert kernels.ROUTES[("maxpool2", "simple")] == 1
    torch.testing.assert_close(y, maxpool2_plain(x), rtol=0, atol=0, equal_nan=True)


def test_maxpool2_wrapper_refuses(dev):
    x = _pool_input((1, 4, 4, 2), torch.float32, dev)
    with pytest.raises(TypeError):
        maxpool2(x.half())
    with pytest.raises(ValueError):
        maxpool2(x.transpose(1, 2))
    with pytest.raises(ValueError, match="ties"):
        maxpool2(x, ties="last")


def test_no_grad_call_on_grad_requiring_tensors_launches_the_kernels(dev):
    """A grad-requiring tensor under no_grad takes the forward kernels
    (the wrappers no longer refuse tensors that require grad)."""
    x, w, b = _conv_inputs(1, 8, 8, 16, 16, torch.float32, dev)
    kernels.reset_launches()
    with torch.no_grad():
        conv3x3(x.requires_grad_(), w.requires_grad_(), b)
        maxpool2(x)
    assert kernels.LAUNCHES["conv3x3"] == 1 and kernels.LAUNCHES["maxpool2"] == 1


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
    assert kernels.LAUNCHES == {"conv3x3": 56, "conv3x3_bn_relu_in": 0, "maxpool2": 26,
                                "maxpool2_bwd": 0}
    # f32 on both sides; the deep random-init net amplifies the
    # summation-order differences, so the bound is relative
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())


def _bn(ci, dev, seed=0):
    rng = np.random.default_rng(seed)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, ci).astype(np.float32))
    shift = torch.from_numpy(rng.normal(0.3, 0.5, ci).astype(np.float32))  # some > 0
    return scale.to(dev), shift.to(dev)


@pytest.mark.parametrize("shape", CONV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu_out", [False, True])
@pytest.mark.parametrize("zero_border", [False, True])
def test_conv3x3_bn_relu_in_kernel_matches_plain(dev, shape, dtype, relu_out, zero_border):
    """With exact zeros in x's border rows and columns, an in-image 0 must
    become relu(shift) (> 0 for most channels) while the halo stays 0:
    the sm90 design's TMA fill gives both the value 0."""
    x, w, b = _conv_inputs(*shape, dtype, dev)
    if zero_border:
        x[:, [0, -1]] = 0
        x[:, :, [0, -1]] = 0
    scale, shift = _bn(shape[3], dev)
    y, st = _run("conv3x3_bn_relu_in", "routed", x, w, lambda: conv3x3_bn_relu_in(
        x, w, b, scale, shift, relu_out=relu_out))
    # reference: the normalized input rounded to the operand type as the
    # kernel rounds it, then the plain conv in f32; bounds as for conv3x3
    y_ref, st_ref = conv3x3_plain(bn_relu_plain(x, scale, shift).float(), w.float(), b,
                                  relu_out=relu_out)
    torch.cuda.synchronize()
    assert y.dtype == dtype
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), y_ref, rtol=rtol, atol=1e-5 * y_ref.abs().max().item())
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-5 * st_ref.abs().max().item())


@pytest.mark.parametrize("shape", [(2, 8, 16, 5), (2, 7, 9, 3), (1, 1, 1, 4),
                                   (4, 56, 56, 64), (3, 15, 14, 130)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ties", ["all", "first"])
def test_maxpool2_bwd_kernel_exact(dev, shape, dtype, ties):
    x = _pool_input(shape, dtype, dev)
    x[0] = torch.relu(torch.round(x[0].float() * 2) / 2).to(dtype)  # ties at 0 and > 0
    y = maxpool2_plain(x)
    g = torch.randn(y.shape, device=dev)
    dx = maxpool2_backward(x, y, g, ties)
    assert torch.equal(dx, maxpool2_bwd_plain(x, y, g, ties))


def test_conv_functions_grads_match_plain_autograd(dev):
    """Kernel forward, cuDNN dgrad/wgrad and the prologue's reductions
    backward, against autograd of the plain versions (f32, no TF32:
    summation order only). Without relu_out: with it each side masks
    its gradient by its own y > 0, and the two forwards round some y to
    opposite sides of 0."""
    x, w, b = _conv_inputs(2, 14, 14, 32, 24, torch.float32, dev)
    scale, shift = _bn(32, dev)
    r = torch.randn((2, 14, 14, 24), device=dev)
    for fn, plain, extra in ((conv3x3, conv3x3_plain, ()),
                             (conv3x3_bn_relu_in, conv3x3_bn_relu_in_plain, (scale, shift))):
        grads = []
        for f in (fn, plain):
            ins = [t.clone().requires_grad_() for t in (x, w, b, *extra)]
            (f(*ins)[0] * r).sum().backward()
            grads.append([t.grad for t in ins])
        for g, g_ref in zip(*grads):
            torch.testing.assert_close(g, g_ref, rtol=1e-4, atol=1e-5 * g_ref.abs().max().item())


def test_rmg18_train_step_launches_and_matches_cpu(dev):
    """A depth-18 f32 training forward and backward on the card goes
    through all four kernels and gives the CPU's loss."""
    from mgtpu_torch.models import get_net
    from mgtpu_torch.models.base import nll_loss

    model = get_net("ilsvrc/rnmg")(depth=18, generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 224, 224, 3),
                                                                  dtype=np.float32))
    y = torch.tensor([3, 5])
    ref = nll_loss(model(x), y)
    model.to(dev)
    kernels.reset_launches()
    loss = nll_loss(model(x.to(dev)), y.to(dev))
    loss.backward()
    assert kernels.LAUNCHES == {"conv3x3": 38, "conv3x3_bn_relu_in": 18, "maxpool2": 26,
                                "maxpool2_bwd": 26}
    # f32 on both sides, summation order only
    torch.testing.assert_close(loss.cpu(), ref.detach(), rtol=1e-4, atol=0)
