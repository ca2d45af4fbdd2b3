"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and nvcc, is marked ``cuda`` and
skips without a card. This file imports no JAX, so it runs on a machine
that has only the port's dependencies:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q
"""

from collections import Counter

import numpy as np
import pytest
import torch

from chip_smoke import RMG34_POOLS, misaligned, pool_bwd_case
from mgtpu_torch import kernels
from mgtpu_torch.ops import cuda_conv
from mgtpu_torch.ops.cuda_conv import (_route, _tile_forward, _window_forward, _window_plan,
                                       bn_relu_plain, conv3x3, conv3x3_bn_relu_in,
                                       conv3x3_bn_relu_in_plain, conv3x3_plain)
from mgtpu_torch.ops.cuda_pool import (MAX_MEMBERS, SM90_STAGE_BYTES, _route as _pool_route,
                                       _simple_backward, _simple_forward, maxpool2,
                                       maxpool2_backward, maxpool2_backward_group,
                                       maxpool2_bwd_plain, maxpool2_plain)

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
@pytest.mark.parametrize("design", ["routed", "window", "tile"])
def test_conv3x3_kernel_matches_plain(dev, shape, dtype, relu_out, with_stats, design):
    x, w, b = _conv_inputs(*shape, dtype, dev)
    fn = {"routed": conv3x3, "window": _window_forward, "tile": _tile_forward}[design]
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


# the CIFAR nets' smallest grids on the sm90 design: at 2x2 the 3x3
# window's halo is larger than the image, and a tile of 128 output rows
# spans 32 images (8 at 4x4); the last shape's M (12) is less than a tile
CIFAR_SM90_SHAPES = [(128, 2, 2, 512, 512), (64, 2, 2, 64, 64), (128, 4, 4, 256, 512),
                     (64, 4, 4, 128, 128), (3, 2, 2, 64, 128)]


@pytest.mark.parametrize("shape", CIFAR_SM90_SHAPES)
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("zero_border", [False, True])
def test_sm90_small_grids_match_plain(dev, shape, prologue, zero_border):
    """conv3x3 and conv3x3_bn_relu_in through sm90 at 2x2 and 4x4 against
    the plain version in f32 (the prologue's normalized input rounded to
    bf16 as the kernel rounds it); with a zero border, the prologue's
    halo must stay 0 where an in-image 0 becomes relu(shift)."""
    x, w, b = _conv_inputs(*shape, torch.bfloat16, dev)
    if zero_border:
        x[:, [0, -1]] = 0
        x[:, :, [0, -1]] = 0
    assert _route(x, w) == "sm90"
    if prologue:
        scale, shift = _bn(shape[3], dev)
        y, st = _run("conv3x3_bn_relu_in", "sm90", x, w, lambda: conv3x3_bn_relu_in(
            x, w, b, scale, shift, relu_out=True))
        x_ref = bn_relu_plain(x, scale, shift).float()
    else:
        y, st = _run("conv3x3", "sm90", x, w, lambda: conv3x3(x, w, b, relu_out=True))
        x_ref = x.float()
    y_ref, st_ref = conv3x3_plain(x_ref, w.float(), b, relu_out=True)
    torch.cuda.synchronize()
    # as in test_conv3x3_kernel_matches_plain
    torch.testing.assert_close(y.float(), y_ref, rtol=2.0 ** -7,
                               atol=1e-5 * y_ref.abs().max().item())
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-5 * st_ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci, co, start", [(3, 64, 0), (3, 10, 1), (10, 20, 3), (10, 10, 7),
                                           (20, 40, 5), (102, 102, 1)])
def test_tile_conv_at_cifar_widths_with_unaligned_slices(dev, dtype, ci, co, start):
    """The design these shapes route to (window; tile before it) at the
    CIFAR stems' 3-channel image, rnmg's widths 10 and 20 and VGG's 102,
    with the weight a slice of a wider one at input channel ``start``:
    start * Co elements in, off a 16-byte boundary in both dtypes at (3,
    10, 1), (10, 10, 7) and (102, 102, 1), in bf16 at (10, 20, 3), as the
    exchange's slices can be."""
    x, w, b = _conv_inputs(4, 8, 8, ci, co, dtype, dev, ci_total=ci + start + 2)
    ws = w[:, :, start:start + ci, :]
    y, st = _run("conv3x3", "window", x, ws, lambda: conv3x3(x, ws, b))
    y_ref, st_ref = conv3x3_plain(x.float(), ws.float().contiguous(), b)
    torch.cuda.synchronize()
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), y_ref, rtol=rtol, atol=1e-5 * y_ref.abs().max().item())
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-5 * st_ref.abs().max().item())


# halo mode (-spatial): (pad_top, pad_bottom) of a slab's launch, and the
# shapes: the sm90 design's (bf16, Ci and Co multiples of 64: R-MG-34's
# 56-row scale and its 28-row one at 128 channels) and the window
# design's (narrow channels, in bf16 and f32)
PADS = [(1, 1), (1, 0), (0, 1), (0, 0)]
HALO_SHAPES = [(2, 16, 56, 64, 64), (2, 14, 28, 128, 128), (2, 12, 9, 24, 40)]


@pytest.mark.parametrize("shape", HALO_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pads", PADS, ids=[f"pads{a}{b}" for a, b in PADS])
@pytest.mark.parametrize("prologue", [False, True])
@pytest.mark.parametrize("design", ["routed", "window", "tile"])
def test_halo_launch_matches_plain_and_whole_image(dev, shape, dtype, pads, prologue, design):
    """A slab's launch under per-side padding (rows 4..h-4 of the image,
    with the halo rows its pads leave out of the padding) against the
    plain version of the same slab, and against the rows of the whole
    image's launch through the same design; one launch. The prologue's
    shift is positive, so a pad row that were normalized would show."""
    n, h, w_, ci, co = shape
    x, w, b = _conv_inputs(n, h, w_, ci, co, dtype, dev)
    pt, pb = pads
    lo, hi = (0 if pt else 4), (h if pb else h - 4)
    xs = x[:, lo - (1 - pt):hi + (1 - pb)].contiguous()
    vectors = ()
    if prologue:
        scale, shift = _bn(ci, dev)
        vectors = (scale, shift.abs() + 0.5)
    kernel = "conv3x3_bn_relu_in" if prologue else "conv3x3"
    if design == "routed":
        fn = conv3x3_bn_relu_in if prologue else conv3x3
    else:
        fn = _window_forward if design == "window" else _tile_forward

    y, st = _run(kernel, design, xs, w, lambda: fn(xs, w, b, *vectors, pad_top=pt,
                                                   pad_bottom=pb))
    y_all, _ = _run(kernel, design, x, w, lambda: fn(x, w, b, *vectors))
    xr = xs if not prologue else bn_relu_plain(xs, *vectors)
    y_ref, st_ref = conv3x3_plain(xr.float(), w.float(), b, pad_top=pt, pad_bottom=pb)
    torch.cuda.synchronize()
    assert y.shape == (n, hi - lo, w_, co)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    # as in test_conv3x3_kernel_matches_plain
    torch.testing.assert_close(y.float(), y_ref, rtol=rtol, atol=1e-5 * y_ref.abs().max().item())
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-5 * st_ref.abs().max().item())
    # the whole image's launch: the same taps in the same order per pixel
    torch.testing.assert_close(y, y_all[:, lo:hi], rtol=0, atol=0)


# the running part sum y_in through every design conv3x3 routes to: sm90
# at 64-wide tiles (M = 135, no multiple of the 128-pixel tile: the last
# tile's second warpgroup has no rows, its first a partial box) and at
# 128-wide ones (sm90's pick_bn takes 128 at 32x14x14x256->256 on 132
# SMs), window in bf16 (Co 16 in pairs; Co 13, odd, element by element)
# and in f32 on FMAs (Co 16 in float4s; 10 and 1 element by element),
# and window_tf32 (the dense wgmma branch; Ci 3, the packed one)
Y_IN_CASES = [("sm90", (3, 9, 5, 64, 128), torch.bfloat16),
              ("sm90", (32, 14, 14, 256, 256), torch.bfloat16),
              ("window", (2, 7, 7, 16, 16), torch.bfloat16),
              ("window", (2, 6, 5, 19, 13), torch.bfloat16),
              ("window", (2, 7, 7, 16, 16), torch.float32),
              ("window", (2, 6, 5, 19, 10), torch.float32),
              ("window", (2, 9, 5, 24, 1), torch.float32),
              ("window_tf32", (2, 16, 16, 64, 64), torch.float32),
              ("window_tf32", (2, 9, 7, 3, 10), torch.float32)]


@pytest.mark.parametrize("design, shape, dtype", Y_IN_CASES,
                         ids=[f"{d}-{'x'.join(map(str, s))}-{str(t)[6:]}"
                              for d, s, t in Y_IN_CASES])
@pytest.mark.parametrize("relu_out", [False, True])
@pytest.mark.parametrize("pads", PADS, ids=[f"pads{a}{b}" for a, b in PADS])
def test_conv3x3_y_in_matches_plain(dev, design, shape, dtype, relu_out, pads):
    """conv3x3 with a running part sum y_in, one launch through the routed
    design, counted in kernels.SUMMED: y = relu?(round(acc + bias +
    float(y_in))) against the plain version (in f32; for TF32 on the
    operands rounded as the kernel rounds them, in float64, to the
    bound of its f32 sums, one more term for y_in), the stats against
    the unrounded values', and under each pad pair (a slab's halo mode);
    y a new tensor."""
    pt, pb = pads
    x, w, b = _conv_inputs(*shape, dtype, dev)
    n, h, wd, ci, co = shape
    rows = h - (1 - pt) - (1 - pb)
    y_in = torch.randn((n, rows, wd, co), generator=torch.Generator().manual_seed(5)).to(dev,
                                                                                         dtype)
    torch.backends.cudnn.allow_tf32 = design == "window_tf32"  # the fixture restores it
    assert _route(x, w) == design
    kw = dict(relu_out=relu_out, pad_top=pt, pad_bottom=pb)
    kernels.reset_launches()
    y, st = cuda_conv.conv3x3_forward(x, w, b, y_in=y_in, **kw)
    torch.cuda.synchronize()
    assert kernels.SUMMED == {k: int(k == ("conv3x3", design)) for k in kernels.SUMMED}
    assert kernels.ROUTES[("conv3x3", design)] == 1 and sum(kernels.ROUTES.values()) == 1
    assert y.dtype == dtype and y.shape == y_in.shape and y.data_ptr() != y_in.data_ptr()
    if design == "window_tf32":
        xr, wr = (cuda_conv.tf32_round(t).double() for t in (x, w))
        y_ref = conv3x3_plain(xr, wr, b.double(), y_in=y_in.double(), with_stats=False, **kw)[0]
        mag = conv3x3_plain(xr.abs(), wr.abs(), b.double().abs(), y_in=y_in.double().abs(),
                            pad_top=pt, pad_bottom=pb, with_stats=False)[0]
        err = (y.double() - y_ref).abs() - (9 * ci + 2) * 2.0 ** -22 * mag
        assert err.max().item() <= 0
        st_ref = torch.stack([y.sum((0, 1, 2)), (y * y).sum((0, 1, 2))])
    else:
        y_ref, st_ref = conv3x3_plain(x.float(), w.float(), b, y_in=y_in.float(), **kw)
        # as in test_conv3x3_kernel_matches_plain
        rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(y.float(), y_ref, rtol=rtol,
                                   atol=1e-5 * y_ref.abs().max().item())
    torch.testing.assert_close(st, st_ref.float(), rtol=1e-4,
                               atol=1e-5 * st_ref.abs().max().item())


def test_conv3x3_y_in_refusals(dev):
    """The tile design takes no y_in; y_in must be contiguous, of y's
    shape and dtype, and lie on 16 bytes."""
    x, w, b = _conv_inputs(2, 8, 8, 64, 64, torch.bfloat16, dev)
    y_in = torch.randn((2, 8, 8, 64), device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="y_in"):
        cuda_conv._launch("conv3x3", "tile", x, w, b, (), False, False, (1, 1), y_in)
    for bad in (y_in[:, :4], y_in.float(), y_in.transpose(1, 2)):
        with pytest.raises(ValueError, match="y_in"):
            conv3x3(x, w, b, y_in=bad)
    off = torch.zeros(y_in.numel() + 1, dtype=torch.bfloat16, device=dev)[1:].view(y_in.shape)
    assert off.data_ptr() % 16
    with pytest.raises(ValueError, match="16 bytes"):
        conv3x3(x, w, b, y_in=off)


def test_conv3x3_y_in_exports_and_serves_on_the_card(dev):
    """A module calling conv3x3 with y_in exports (`torch.export`: the op
    ``mgtpu::conv3x3`` with its ``y_in``), launches once with a part sum
    and gives the eager call's bits."""
    x, w, b = _conv_inputs(2, 14, 14, 64, 64, torch.bfloat16, dev)
    y_in = torch.randn((2, 14, 14, 64), device=dev).to(torch.bfloat16)

    class Conv(torch.nn.Module):
        def forward(self, x, y_in):
            return conv3x3(x, w, b, relu_out=True, with_stats=False, y_in=y_in)[0]

    program = torch.export.export(Conv(), (x, y_in))
    kernels.reset_launches()
    with torch.no_grad():
        got = program.module()(x, y_in)
        torch.cuda.synchronize()
        assert kernels.SUMMED[("conv3x3", "sm90")] == 1
        assert torch.equal(got, Conv()(x, y_in))


# the window design (csrc/conv3x3_window.cu) at the widths it takes: every
# Ci of the zoo's narrow convs (packed taps below 16, chunks above 64 in
# f32) against every Co (n8 tiles of 8 to 64, several blocks above 64), M
# no multiple of a tile
WINDOW_CI = [1, 3, 8, 16, 24, 32, 64, 96]
WINDOW_CO = [1, 8, 10, 16, 32, 64, 128]


@pytest.mark.parametrize("ci", WINDOW_CI)
@pytest.mark.parametrize("co", WINDOW_CO)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prologue", [False, True])
def test_window_design_matches_plain(dev, ci, co, dtype, prologue):
    """Both kernels through the window design against the plain version
    in f32 (the prologue's normalized input rounded as the kernel rounds
    it), under all four pad pairs (a slab with its halo rows), the
    prologue's shift positive so a normalized pad would show; with the
    stats; M = 3 x 9 x 11 rows on no tile boundary."""
    x, w, b = _conv_inputs(3, 11, 11, ci, co, dtype, dev, seed=ci * 131 + co)
    kernel = "conv3x3_bn_relu_in" if prologue else "conv3x3"
    vectors = ()
    if prologue:
        scale, shift = _bn(ci, dev)
        vectors = (scale, shift.abs() + 0.5)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    for pt, pb in PADS:
        # a slab of 9 output rows: its halo rows where a pad is 0
        xs = x[:, pt:x.shape[1] - pb].contiguous()
        y, st = _run(kernel, "window", xs, w, lambda: _window_forward(
            xs, w, b, *vectors, relu_out=True, pad_top=pt, pad_bottom=pb))
        xr = bn_relu_plain(xs, *vectors) if prologue else xs
        y_ref, st_ref = conv3x3_plain(xr.float(), w.float(), b, relu_out=True, pad_top=pt,
                                      pad_bottom=pb)
        torch.cuda.synchronize()
        assert y.shape == (3, 9, 11, co)
        torch.testing.assert_close(y.float(), y_ref, rtol=rtol,
                                   atol=1e-5 * y_ref.abs().max().item())
        torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-5 * st_ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ci, co, ci_total, start", [(3, 10, 8, 1), (10, 20, 16, 3),
                                                     (24, 32, 40, 5), (96, 128, 101, 3),
                                                     (64, 1, 70, 5), (1, 64, 4, 1)])
def test_window_design_takes_unaligned_slices(dev, dtype, ci, co, ci_total, start):
    """Weight slices at unaligned starts (start * Co elements in: off 16
    bytes, so the weights load element by element) at M = 2 x 13 x 7,
    against the plain version on the sliced weight."""
    x, w, b = _conv_inputs(2, 13, 7, ci, co, dtype, dev, seed=start, ci_total=ci_total)
    ws = w[:, :, start:start + ci, :]
    y, st = _run("conv3x3", "window", x, ws, lambda: _window_forward(x, ws, b))
    y_ref, st_ref = conv3x3_plain(x.float(), ws.float().contiguous(), b)
    torch.cuda.synchronize()
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), y_ref, rtol=rtol, atol=1e-5 * y_ref.abs().max().item())
    torch.testing.assert_close(st, st_ref, rtol=1e-4, atol=1e-5 * st_ref.abs().max().item())


@pytest.mark.parametrize("ci, co", [(1, 64), (3, 10), (8, 8), (16, 8), (24, 10), (32, 16),
                                    (40, 40), (64, 1), (64, 32), (64, 64)])
@pytest.mark.parametrize("prologue", [False, True])
def test_window_f32_equals_tile_bit_for_bit(dev, ci, co, prologue):
    """In f32 each output is one fmaf chain from its bias, taps outer,
    channels inner, in both designs: up to Ci = 64 (one chunk of the
    window design) they give the same bits, at the saliency forward's
    widths and M on no tile boundary."""
    x, w, b = _conv_inputs(3, 19, 21, ci, co, torch.float32, dev, seed=ci + co)
    vectors = _bn(ci, dev) if prologue else ()
    assert _window_plan(3, 19, 21, ci, co, False, cuda_conv._sms(0)).chunks == 1
    y_w, _ = _window_forward(x, w, b, *vectors, relu_out=True)
    y_t, _ = _tile_forward(x, w, b, *vectors, relu_out=True)
    torch.cuda.synchronize()
    assert torch.equal(y_w, y_t)


def test_window_refuses_a_plan_of_other_shared_memory(dev):
    """The C side recomputes the plan's shared-memory layout and refuses
    a launch whose plan says other bytes (every launch checks it)."""
    x, w, b = _conv_inputs(2, 7, 7, 32, 32, torch.bfloat16, dev)
    p = _window_plan(2, 7, 7, 32, 32, True, cuda_conv._sms(0))
    y = torch.empty((2, 7, 7, 32), dtype=torch.bfloat16, device=dev)
    st = torch.zeros((2, 32), device=dev)
    with pytest.raises(RuntimeError, match="mg_conv3x3_window"):
        kernels.launch("conv3x3", "mg_conv3x3_window", x.device, x.data_ptr(), w.data_ptr(),
                       b.data_ptr(), 0, y.data_ptr(), st.data_ptr(), 2, 7, 7, 32, 32, w.stride(1),
                       0, 1, 1, 1, 1, p.ti, p.th, p.tw, p.bn, p.kc, p.stages, p.grid_x,
                       p.smem + 16, route="window")


def test_halo_launch_one_one_is_the_pad_one_launch(dev):
    """(1, 1) passed explicitly is the default launch, bit for bit."""
    x, w, b = _conv_inputs(2, 14, 14, 256, 256, torch.bfloat16, dev)
    y0, s0 = conv3x3(x, w, b)
    y1, s1 = conv3x3(x, w, b, pad_top=1, pad_bottom=1)
    torch.cuda.synchronize()
    assert torch.equal(y0, y1)
    torch.testing.assert_close(s0, s1, rtol=1e-5, atol=0)


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
    from mgtpu_torch.models import NetOpts, create_model

    model = create_model(NetOpts(depth=18), generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((1, 224, 224, 3),
                                                                  dtype=np.float32))
    with torch.inference_mode():
        ref = model(x)
        model.to(dev)
        kernels.reset_launches()
        got = model(x.to(dev)).cpu()
    assert kernels.LAUNCHES == {"conv3x3": 56, "conv3x3_bn_relu_in": 0, "maxpool2": 26,
                                "maxpool2_bwd": 0, "conv_i8": 0, "quant_i8": 0}
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
    """One pool's backward, a group of one, through the group design (and
    the simple design beside it), equal to the plain version."""
    x = _pool_input(shape, dtype, dev)
    x[0] = torch.relu(torch.round(x[0].float() * 2) / 2).to(dtype)  # ties at 0 and > 0
    y = maxpool2_plain(x)
    g = torch.randn(y.shape, device=dev)
    kernels.reset_launches()
    dx = maxpool2_backward(x, y, g, ties)
    assert kernels.ROUTES[("maxpool2_bwd", "group")] == 1
    assert torch.equal(dx, maxpool2_bwd_plain(x, y, g, ties))
    assert torch.equal(_simple_backward(x, y, g, ties), dx)
    assert kernels.ROUTES[("maxpool2_bwd", "simple")] == 1


def _assert_group_exact(xs, ys, gs, ties):
    kernels.reset_launches()
    dxs = maxpool2_backward_group(xs, ys, gs, ties)
    torch.cuda.synchronize()
    assert kernels.ROUTES[("maxpool2_bwd", "group")] == -(-len(xs) // MAX_MEMBERS)
    assert kernels.ROUTES[("maxpool2_bwd", "simple")] == 0
    for x, y, g, dx in zip(xs, ys, gs, dxs):
        assert dx.dtype == x.dtype and torch.equal(dx, maxpool2_bwd_plain(x, y, g, ties))


ZOO = ["ilsvrc/rnmg", "ilsvrc/prnmgseg", "cifar/nmg", "cifar/rnmg", "cifar/pnmg", "cifar/prnmg",
       "mnist-cluttered/unmg", "mnist-cluttered/pnmg.mnist", "mnist-cluttered/prnmg.mnist"]


@pytest.mark.parametrize("net", ZOO)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pool_bwd_group_equals_plain_at_every_zoo_group(dev, net, dtype):
    """Every group of pools a multigrid net's training step forms (its
    recipe's options, recorded on the CPU), at batch 2, one launch each,
    bit for bit under both tie rules."""
    from chip_smoke import SEG_RECIPES, cifar_opts, record_kernel_shapes
    from mgtpu_torch.models import NetOpts

    opt = (cifar_opts(net) if net.startswith("cifar/") else
           SEG_RECIPES[net][0] if net in SEG_RECIPES else NetOpts(depth=34))
    groups = record_kernel_shapes(True, opt)["maxpool2_bwd"]
    assert any(len(key) > 1 for key in groups)
    for k, key in enumerate(sorted(groups)):
        xs, ys, gs = pool_bwd_case([(2, *shape) for shape in key], dtype, 10 * k, ties=True)
        for ties in ("all", "first"):
            _assert_group_exact(xs, ys, gs, ties)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("ties", ["all", "first"])
def test_pool_bwd_group_edge_cases(dev, dtype, ties):
    """Odd sizes, NaN and all -inf windows, ties at 0 and > 0, members off
    a 16-byte boundary and one-element lanes beside 16-byte ones in one
    launch; MAX_MEMBERS + 1 members in two launches."""
    shapes = [(2, 7, 9, 3), (3, 15, 14, 130), (1, 1, 1, 4), (2, 57, 55, 64), (4, 56, 56, 64),
              (2, 8, 9, 64)]
    xs, ys, gs = pool_bwd_case(shapes, dtype, 80, ties=True)
    xs[3] = misaligned(xs[3])
    gs[5] = misaligned(gs[5])
    _assert_group_exact(xs, ys, gs, ties)
    many = [(2, 3 + j, 4 + j, 8 * (1 + j)) for j in range(MAX_MEMBERS + 1)]
    _assert_group_exact(*pool_bwd_case(many, dtype, 90, ties=True), ties)


def test_pool_bwd_group_refuses(dev):
    x = torch.zeros((1, 4, 4, 8), device=dev)
    y, g = maxpool2_plain(x), torch.zeros((1, 2, 2, 8), device=dev)
    with pytest.raises(ValueError, match="a group on"):
        maxpool2_backward_group([x, x.bfloat16()], [y, y.bfloat16()], [g, g], "first")
    with pytest.raises(ValueError, match="expected"):
        maxpool2_backward_group([x], [y[:, :1]], [g], "first")
    with pytest.raises(ValueError, match="unsupported device"):
        maxpool2_backward_group([x, x.cpu()], [y, y.cpu()], [g, g.cpu()], "first")
    with pytest.raises(ValueError, match="ties"):
        maxpool2_backward_group([x], [y], [g], "last")


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
    from mgtpu_torch.models import NetOpts, create_model
    from mgtpu_torch.models.base import nll_loss

    model = create_model(NetOpts(depth=18), generator=torch.Generator().manual_seed(0)).train()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 224, 224, 3),
                                                                  dtype=np.float32))
    y = torch.tensor([3, 5])
    ref = nll_loss(model(x), y)
    model.to(dev)
    kernels.reset_launches()
    loss = nll_loss(model(x.to(dev)), y.to(dev))
    loss.backward()
    # the 26 pools' backward in 15 launches: one a multigrid layer's group
    assert kernels.LAUNCHES == {"conv3x3": 38, "conv3x3_bn_relu_in": 18, "maxpool2": 26,
                                "maxpool2_bwd": 15, "conv_i8": 0, "quant_i8": 0}
    # f32 on both sides, summation order only
    torch.testing.assert_close(loss.cpu(), ref.detach(), rtol=1e-4, atol=0)


# the shapes the segmentation slice brings (n, h, w, ci, co): the 1-channel
# stems, pnmg.mnist's output conv (Co = 1; 10 on mnist-seg), prnmgseg's
# narrow 7x7 and 14x14 grids, a 64 px map
SEG_CONV_SHAPES = [(2, 64, 64, 1, 64), (2, 16, 16, 1, 16), (2, 64, 64, 64, 1),
                   (2, 64, 64, 64, 10), (2, 7, 7, 8, 16), (2, 14, 14, 16, 32),
                   (2, 7, 7, 32, 32), (2, 64, 64, 128, 64)]


@pytest.mark.parametrize("shape", SEG_CONV_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("prologue", [False, True])
def test_seg_shapes_match_plain(dev, shape, dtype, prologue):
    """conv3x3 (and conv3x3_bn_relu_in) at the new shapes, through the
    routed design, against the plain version in f32 on the same inputs:
    bf16 within two roundings, f32 within summation order."""
    n, h, w, ci, co = shape
    x, wt, b = _conv_inputs(n, h, w, ci, co, dtype, dev, seed=40)
    if prologue:
        scale, shift = _bn(ci, dev, seed=41)
        y, _ = _run("conv3x3_bn_relu_in", "routed", x, wt, lambda: conv3x3_bn_relu_in(
            x, wt, b, scale, shift, with_stats=False))
        ref, _ = conv3x3_plain(bn_relu_plain(x, scale, shift).float(), wt.float(), b,
                               with_stats=False)
    else:
        y, _ = _run("conv3x3", "routed", x, wt, lambda: conv3x3(x, wt, b, with_stats=False))
        ref, _ = conv3x3_plain(x.float(), wt.float(), b, with_stats=False)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
    torch.testing.assert_close(y.float(), ref, rtol=rtol, atol=1e-5 * ref.abs().max().item())


@pytest.mark.parametrize("shape", [(2, 64, 64, 64), (2, 64, 64, 128), (2, 16, 16, 512),
                                   (2, 32, 32, 16)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seg_pools_take_their_route_and_match_plain(dev, shape, dtype):
    """The 64 px nets' pools take the design _route's rule gives (sm90
    where a row pair, 2*W*C*itemsize bytes, fits a stage of the ring;
    simple where it does not: (2, 64, 64, 128) and (2, 16, 16, 512) in
    f32, 64 KB) and equal the plain version, as does their backward under
    the first-tie rule."""
    x = torch.from_numpy(np.maximum(np.random.default_rng(42).standard_normal(
        shape, dtype=np.float32), 0)).to(dev, dtype)
    row_pair = 2 * shape[2] * shape[3] * x.element_size()
    assert _pool_route(x) == ("sm90" if row_pair <= SM90_STAGE_BYTES else "simple")
    y = maxpool2(x)
    assert torch.equal(y, maxpool2_plain(x))
    g = torch.randn(y.shape, device=dev).to(dtype)
    assert torch.equal(maxpool2_backward(x, y, g, "first"), maxpool2_bwd_plain(x, y, g, "first"))


def test_unmg_forward_launches_and_matches_cpu(dev):
    """mnist-cluttered/unmg's f32 forward on the card goes through the
    kernels (25 conv3x3, 16 maxpool2 launches), its transposed convs and
    1x1 convs through stock ops, and agrees with the plain CPU forward."""
    from mgtpu_torch.models import NetOpts, create_model

    model = create_model(NetOpts(netType="mnist-cluttered/unmg"),
                         generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(np.random.default_rng(43).standard_normal((2, 64, 64, 1),
                                                                   dtype=np.float32))
    with torch.inference_mode():
        ref = model(x)
        model.to(dev)
        kernels.reset_launches()
        got = model(x.to(dev)).cpu()
    assert kernels.LAUNCHES == {"conv3x3": 25, "conv3x3_bn_relu_in": 0, "maxpool2": 16,
                                "maxpool2_bwd": 0, "conv_i8": 0, "quant_i8": 0}
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-5)


# (n, h, w, ci, co, k, stride, pad, ci_total, ofs): the 3x3 bulk (Ci a
# multiple of 16: 16-byte loads), the 7x7/2 stems on 3 and 1 channels,
# the 1x1 heads (Co = 10, 1), strided 1x1 and 3x3, Ci of one and a half
# chunks (24), a weight slice at input channel 3, tails of both tiles;
# the 3x3/s1 ones with channels and offsets multiples of 16 take sm90:
# Ci 16 (a zero-filled 32-byte box), 32, 64, 96, 128, 384 and 512 (channel
# boxes of 32, 64 and 128 bytes), Co 16 to 512 (tiles of 32, 64, 128), M
# not a multiple of 128
CONV_I8_SHAPES = [(2, 14, 14, 64, 64, 3, 1, 1, 64, 0), (1, 56, 56, 16, 32, 3, 1, 1, 48, 16),
                  (2, 35, 33, 3, 16, 7, 2, 3, 3, 0), (2, 64, 64, 1, 8, 7, 2, 3, 1, 0),
                  (3, 8, 8, 64, 10, 1, 1, 0, 64, 0), (1, 9, 7, 24, 1, 1, 2, 0, 27, 3),
                  (2, 9, 11, 24, 130, 3, 2, 1, 27, 3), (1, 7, 7, 512, 512, 3, 1, 1, 768, 256),
                  (3, 14, 14, 16, 16, 3, 1, 1, 48, 32), (2, 7, 7, 96, 128, 3, 1, 1, 224, 128),
                  (4, 28, 28, 128, 128, 3, 1, 1, 192, 0), (2, 7, 7, 384, 512, 3, 1, 1, 384, 0),
                  (5, 9, 13, 32, 48, 3, 1, 1, 96, 64)]


def _i8_operands(shape, dev, seed=7):
    from mgtpu_torch.ops.cuda_conv_i8 import pack_weight

    n, h, w, ci, co, k, stride, pad, ci_total, ofs = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    x8 = torch.randint(-127, 128, (n, h, w, ci), generator=g, device=dev).to(torch.int8)
    wide = torch.randint(-127, 128, (k, k, ci_total, co), generator=g, device=dev).to(torch.int8)
    v = 1e-4 + 1e-3 * torch.rand(co, generator=g, device=dev)
    return x8, wide[:, :, ofs:ofs + ci], pack_weight(wide), v, stride, pad


@pytest.mark.parametrize("shape", CONV_I8_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_conv_i8_is_bit_exact(dev, shape):
    """conv_i8 equals its plain version exactly: the int32 sums, and the
    fused f32 and bf16 dequants bit for bit, x aligned (the design _route
    picks: sm90 where it takes the shape) and 4 bytes off a 16-byte
    boundary (the simple design's byte loads); one launch a call."""
    from mgtpu_torch.ops.cuda_conv_i8 import _route, conv_i8, conv_i8_plain

    x8, w8, wk, v, stride, pad = _i8_operands(shape, dev)
    ref = conv_i8_plain(x8, w8, stride, pad)
    for x in (x8, misaligned(x8)):
        kernels.reset_launches()
        assert torch.equal(conv_i8(x, w8, stride, pad, wk=wk), ref)
        for dtype in (torch.float32, torch.bfloat16):
            got = conv_i8(x, w8, stride, pad, v, dtype, wk=wk)
            assert got.dtype == dtype
            assert torch.equal(got, conv_i8_plain(x8, w8, stride, pad, v, dtype))
        design = _route(x, w8, stride, pad, wk)
        assert kernels.LAUNCHES["conv_i8"] == 3 and kernels.ROUTES[("conv_i8", design)] == 3
    assert _route(x8, w8, stride, pad, wk) == _i8_design(shape)


def _i8_design(shape, aligned=True):
    """The design conv_i8 takes at a CONV_I8_SHAPES-style shape: sm90 for
    3x3/s1/p1 with channels and offsets multiples of 16 and x aligned;
    stem for Ci < 16, k * k * Ci <= 160 and Co 16, 32 or 64; 1x1 for
    1x1/s1/p0 with those multiples and x aligned; else simple."""
    n, h, w, ci, co, k, stride, pad, ci_total, ofs = shape
    sixteens = aligned and all(c % 16 == 0 for c in (ci, co, ci_total, ofs))
    if (k, stride, pad) == (3, 1, 1) and sixteens:
        return "sm90"
    if ci < 16 and k * k * ci <= 160 and co in (16, 32, 64):
        return "stem"
    return "1x1" if (k, stride, pad) == (1, 1, 0) and sixteens else "simple"


@pytest.mark.parametrize("shape", CONV_I8_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_i8_epilogues_equal_plain_through_both_designs(dev, shape, dtype):
    """Each epilogue variant (the scale sx read on the card; the running
    part sum y_in, written in place; the bias rounded to the output type;
    the ReLU) through the routed design and the simple design, against
    the plain version's torch sequence: equal bit for bit, also with the
    slice packed per call (no wk)."""
    from mgtpu_torch.ops.cuda_conv_i8 import _simple_forward, conv_i8, conv_i8_plain

    x8, w8, wk, v, stride, pad = _i8_operands(shape, dev, seed=8)
    g = torch.Generator(device=dev).manual_seed(9)
    sx = 0.5 + torch.rand((), generator=g, device=dev)
    bias = torch.randn(w8.shape[3], generator=g, device=dev)
    y0 = torch.randn(conv_i8_plain(x8, w8, stride, pad).shape, generator=g, device=dev).to(dtype)
    for kw in ({"sx": sx}, {"sx": sx, "bias": bias}, {"sx": sx, "y_in": y0, "relu": True},
               {"sx": sx, "y_in": y0, "bias": bias, "relu": True}):
        want = conv_i8_plain(x8, w8, stride, pad, v, dtype,
                             **{k: a.clone() if k == "y_in" else a for k, a in kw.items()})
        for fn in (lambda **a: conv_i8(x8, w8, stride, pad, v, dtype, wk=wk, **a),
                   lambda **a: conv_i8(x8, w8, stride, pad, v, dtype, **a),
                   lambda **a: _simple_forward(x8, w8, stride, pad, v, dtype, **a)):
            y_in = kw["y_in"].clone() if "y_in" in kw else None
            got = fn(**{**kw, "y_in": y_in})
            assert got.dtype == dtype and torch.equal(got, want)
            if y_in is not None:
                assert got.data_ptr() == y_in.data_ptr()  # the sum is updated in place


def test_conv_i8_refuses_what_it_does_not_take(dev):
    from mgtpu_torch.ops.cuda_conv_i8 import _check, _launch, conv_i8, pack_weight

    x8 = torch.zeros((1, 4, 4, 8), dtype=torch.int8, device=dev)
    w8 = torch.zeros((3, 3, 8, 4), dtype=torch.int8, device=dev)
    with pytest.raises(TypeError, match="int8"):
        conv_i8(x8.float(), w8, 1, 1)
    with pytest.raises(ValueError, match="not an HWIO input-channel slice"):
        conv_i8(x8, w8.transpose(2, 3).contiguous().transpose(2, 3), 1, 1)
    with pytest.raises(ValueError, match="contiguous f32"):
        conv_i8(x8, w8, 1, 1, torch.ones(5, device=dev), torch.float32)
    with pytest.raises(ValueError, match="leave no output"):
        conv_i8(x8, torch.zeros((7, 7, 8, 4), dtype=torch.int8, device=dev), 1, 0)
    with pytest.raises(TypeError, match="need a dequantized output"):
        conv_i8(x8, w8, 1, 1, bias=torch.zeros(4, device=dev))
    with pytest.raises(ValueError, match="y_in must be"):
        conv_i8(x8, w8, 1, 1, torch.ones(4, device=dev), torch.float32,
                y_in=torch.zeros((1, 4, 4, 4), dtype=torch.bfloat16, device=dev))
    with pytest.raises(ValueError, match="packed"):
        conv_i8(x8, w8, 1, 1, wk=pack_weight(w8)[:, :9])
    # the sm90 design refuses what _route never gives it: a 7x7 kernel, Ci = 8
    for x, w in ((torch.zeros((1, 9, 9, 16), dtype=torch.int8, device=dev),
                  torch.zeros((7, 7, 16, 16), dtype=torch.int8, device=dev)), (x8, w8)):
        shape = _check(x, w, 1, 1, None, torch.int32, None, None, None, None, (1, 1))
        with pytest.raises(RuntimeError, match="mg_conv_i8_sm90"):
            _launch(x, w, 1, 1, None, torch.int32, None, None, None, False, None, "sm90", shape,
                    (1, 1))
    # nor the stem design Co = 4, nor the 1x1 design a 3x3 kernel
    shape = _check(x8, w8, 1, 1, None, torch.int32, None, None, None, None, (1, 1))
    with pytest.raises(RuntimeError, match="mg_conv_i8_stem"):
        _launch(x8, w8, 1, 1, None, torch.int32, None, None, None, False, None, "stem", shape,
                (1, 1))
    x16, w16 = x8.repeat(1, 1, 1, 2), torch.zeros((3, 3, 16, 16), dtype=torch.int8, device=dev)
    shape = _check(x16, w16, 1, 1, None, torch.int32, None, None, None, None, (1, 1))
    with pytest.raises(RuntimeError, match="mg_conv_i8_1x1"):
        _launch(x16, w16, 1, 1, None, torch.int32, None, None, None, False, None, "1x1", shape,
                (1, 1))


# conv_i8's halo mode (-spatial): (n, h, w, ci, co, k, stride, pad) of the
# image and the slab's (pad_top, pad_bottom) pairs: 3x3/s1 parts that sm90
# takes (R-MG-34's 56-row scale at 64 channels, its 28-row one at 128) and
# one only simple takes (Ci 24); the 7x7/2 stem on 3 channels (simple),
# whose slab reads 3 rows above and 2 below
I8_HALO = [((2, 16, 56, 64, 64, 3, 1, 1), [(1, 0), (0, 1), (0, 0)]),
           ((2, 14, 28, 128, 128, 3, 1, 1), [(1, 0), (0, 1), (0, 0)]),
           ((2, 12, 9, 24, 40, 3, 1, 1), [(1, 0), (0, 1), (0, 0)]),
           ((2, 32, 30, 3, 16, 7, 2, 3), [(3, 0), (0, 2), (0, 0)])]
I8_HALO_CASES = [(shape, pads) for shape, pairs in I8_HALO for pads in pairs]


@pytest.mark.parametrize("shape,pads", I8_HALO_CASES,
                         ids=[f"{'x'.join(map(str, s))}-pads{a}{b}" for s, (a, b) in I8_HALO_CASES])
@pytest.mark.parametrize("design", ["routed", "simple"])
def test_conv_i8_halo_launch_matches_plain_and_whole_image(dev, shape, pads, design):
    """A slab's conv_i8 launch under per-side padding (output rows 4 // s
    .. on, with the halo rows its pads leave out of the padding) equals
    the plain version of the same slab and the rows of the whole image's
    launch through the same design, bit for bit, for the int32 sums and
    the bf16 epilogue with a part sum, the bias and the ReLU; each
    launch in halo mode is counted in kernels.PADDED."""
    from mgtpu_torch.ops.cuda_conv_i8 import (_route, _simple_forward, conv_i8, conv_i8_plain,
                                              epilogue_plain, out_size)
    from mgtpu_torch.parallel.axis import window_rows

    n, h, w_, ci, co, k, s, p = shape
    pt, pb = pads
    x8, w8, wk, v, _, _ = _i8_operands((n, h, w_, ci, co, k, s, p, ci, 0), dev, seed=11)
    top, bottom = window_rows(k, s, p)
    o0, o1 = (0 if pt else 4 // s), (out_size(h, k, s, p) if pb else out_size(h, k, s, p) - 2)
    xs = x8[:, o0 * s - top if not pt else 0:
            o1 * s + bottom if not pb else h].contiguous()
    assert out_size(xs.shape[1], k, s, pt, pb) == o1 - o0
    g = torch.Generator(device=dev).manual_seed(12)
    sx = 0.5 + torch.rand((), generator=g, device=dev)
    bias = torch.randn(co, generator=g, device=dev)
    part = torch.randn((n, o1 - o0, out_size(w_, k, s, p), co), generator=g,
                       device=dev).to(torch.bfloat16)
    routed = _route(xs, w8, s, p, wk)
    want_design = "simple" if design == "simple" else routed
    if design == "simple":
        fn = lambda x, **kw: _simple_forward(x, w8, s, p, **kw)  # noqa: E731
    else:
        fn = lambda x, **kw: conv_i8(x, w8, s, p, wk=wk, **kw)  # noqa: E731
    epi = dict(v=v, dtype=torch.bfloat16, sx=sx, bias=bias, relu=True)
    kernels.reset_launches()
    acc = fn(xs, pad_top=pt, pad_bottom=pb)
    y = fn(xs, pad_top=pt, pad_bottom=pb, y_in=part.clone(), **epi)
    padded = (pt, pb) != (p, p)
    assert kernels.ROUTES[("conv_i8", want_design)] == 2
    assert kernels.PADDED[("conv_i8", want_design)] == 2 * padded
    acc_all = fn(x8)
    y_all = fn(x8, **epi)
    assert kernels.PADDED[("conv_i8", want_design)] == 2 * padded
    torch.cuda.synchronize()
    assert torch.equal(acc, conv_i8_plain(xs, w8, s, p, pad_top=pt, pad_bottom=pb))
    assert torch.equal(y, conv_i8_plain(xs, w8, s, p, pad_top=pt, pad_bottom=pb,
                                        y_in=part.clone(), **epi))
    # the whole image's launch at the slab's rows
    assert torch.equal(acc, acc_all[:, o0:o1])
    assert torch.equal(y, epilogue_plain(acc_all[:, o0:o1], v, torch.bfloat16, sx=sx,
                                         y_in=part.clone(), bias=bias, relu=True))
    assert torch.equal(y_all[:, o0:o1], epilogue_plain(acc_all[:, o0:o1], v, torch.bfloat16,
                                                       sx=sx, bias=bias, relu=True))
    if design == "routed":
        assert routed == ("sm90" if k == 3 and ci % 16 == 0 else "stem" if ci < 16 else "simple")


# the int8 nets' conv_i8 parts that the stem and 1x1 designs take, as
# chip_smoke.i8_key records them without the epilogue flags: (h, w, ci,
# co, k, stride, pad, the weight's Ci, the slice's offset); the part sum
# and the bias as the forwards pass them (tests/test_torch_quant_kernels.py
# holds the list to the recorded forwards)
I8_STEM_1X1 = {
    "ilsvrc/rnmg": [(56, 56, 3, 16, 7, 2, 3, 3, 0), (112, 112, 3, 32, 7, 2, 3, 3, 0),
                    (224, 224, 3, 64, 7, 2, 3, 3, 0)],
    "cifar/prnmg": [(1, 1, 64, 128, 1, 1, 0, 192, 128), (1, 1, 128, 128, 1, 1, 0, 192, 0),
                    (1, 1, 128, 128, 1, 1, 0, 384, 256), (1, 1, 256, 128, 1, 1, 0, 384, 0),
                    (1, 1, 384, 384, 1, 1, 0, 896, 512), (1, 1, 512, 384, 1, 1, 0, 896, 0),
                    (8, 8, 3, 16, 3, 1, 1, 3, 0), (16, 16, 3, 32, 3, 1, 1, 3, 0),
                    (32, 32, 3, 64, 3, 1, 1, 3, 0)],
    "mnist-cluttered/unmg": [(16, 16, 1, 16, 3, 1, 1, 1, 0), (32, 32, 1, 32, 3, 1, 1, 1, 0),
                             (64, 64, 1, 64, 3, 1, 1, 1, 0)]}
I8_STEM_1X1_CASES = [(net, key) for net, keys in I8_STEM_1X1.items() for key in keys]


def _at_offset(t, off):
    """An int8 t's values in a contiguous tensor whose data starts ``off``
    bytes past a 16-byte boundary"""
    flat = torch.empty(t.numel() + 32, dtype=t.dtype, device=t.device)
    start = next(i for i in range(32) if (flat.data_ptr() + i) % 16 == off)
    view = flat[start:start + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.parametrize("net,key", I8_STEM_1X1_CASES,
                         ids=[f"{n.split('/')[1]}-{'x'.join(map(str, k))}"
                              for n, k in I8_STEM_1X1_CASES])
@pytest.mark.parametrize("batch", [1, 128])
def test_conv_i8_stem_and_1x1_equal_plain(dev, net, key, batch):
    """The stem and 1x1 designs at every part of the int8 nets they take,
    at batches 1 and 128: the int32 sums and each epilogue variant of
    chip_smoke.I8_VARIANTS (the part sum updated in place) equal to
    conv_i8_plain bit for bit, with x aligned and at byte offsets 4 and 7
    (the stem design takes any; a 1x1 part off 16 bytes goes to simple),
    under the plain padding and the halo pads of an H-slab (a launch
    each, counted by its design and, in halo mode, in kernels.PADDED)."""
    from chip_smoke import I8_VARIANTS
    from mgtpu_torch.ops.cuda_conv_i8 import _route, conv_i8, conv_i8_plain, epilogue_plain

    h, w_, ci, co, k, s, p, ci_total, ofs = key
    x8, w8, wk, v, _, _ = _i8_operands((batch, *key), dev, seed=21)
    g = torch.Generator(device=dev).manual_seed(22)
    sx = 0.5 + torch.rand((), generator=g, device=dev)
    bias = torch.randn(co, generator=g, device=dev)
    pads = [(p, p)] + ([(0, p), (p, 0), (1, 2)] if p == 3 else [(1, 0), (0, 1), (0, 0)]
                       if p == 1 else [])
    design = "stem" if ci < 16 else "1x1"
    for pt, pb in pads:
        acc = conv_i8_plain(x8, w8, s, p, pad_top=pt, pad_bottom=pb)
        y0 = torch.randn(acc.shape, generator=g, device=dev)
        for off in (0, 4, 7):
            xi = x8 if off == 0 else _at_offset(x8, off)
            want_design = design if off == 0 or design == "stem" else "simple"
            assert _route(xi, w8, s, p, wk) == want_design
            for dt, ops in I8_VARIANTS:
                kw = {} if dt == torch.int32 else {"v": v, "dtype": dt, "sx": sx}
                if "bias" in ops:
                    kw["bias"] = bias
                kw["relu"] = "relu" in ops
                y_in = y0.to(dt) if "y_in" in ops else None
                want = acc if dt == torch.int32 else epilogue_plain(
                    acc, v, dt, sx=sx, y_in=None if y_in is None else y_in.clone(),
                    bias=kw.get("bias"), relu=kw["relu"])
                kernels.reset_launches()
                got = conv_i8(xi, w8, s, p, wk=wk, y_in=y_in, pad_top=pt, pad_bottom=pb, **kw)
                assert kernels.ROUTES[("conv_i8", want_design)] == 1
                assert kernels.PADDED[("conv_i8", want_design)] == int((pt, pb) != (p, p))
                assert got.dtype == dt and torch.equal(got, want), (pt, pb, off, dt, ops)
                if y_in is not None:
                    assert got.data_ptr() == y_in.data_ptr()
    torch.cuda.synchronize()


def test_conv_i8_pad_pad_is_the_plain_launch(dev):
    """(pad, pad) passed explicitly is the default launch, bit for bit,
    through both designs, and no halo-mode launch."""
    from mgtpu_torch.ops.cuda_conv_i8 import _simple_forward, conv_i8

    for shape in ((2, 14, 14, 64, 64, 3, 1, 1, 64, 0), (2, 32, 30, 3, 16, 7, 2, 3, 3, 0)):
        x8, w8, wk, v, s, p = _i8_operands(shape, dev, seed=13)
        kernels.reset_launches()
        for fn in (lambda **kw: conv_i8(x8, w8, s, p, wk=wk, **kw),
                   lambda **kw: _simple_forward(x8, w8, s, p, **kw)):
            assert torch.equal(fn(), fn(pad_top=p, pad_bottom=p))
        torch.cuda.synchronize()
        assert not any(kernels.PADDED.values())


def test_quant_i8_dynamic_takes_the_reduced_scale(dev):
    """The dynamic quantizer of a slab whose absmax is made the whole
    tensor's between its two launches (quant.mesh_absmax, here fed the
    other slab's absmax as an all-reduce over two ranks would) gives the
    whole tensor's scale and its int8 rows, bit for bit; and those are the
    kernel's static launch fed that scale."""
    from mgtpu_torch.ops import quant

    x = _quant_input(2, 28, 28, 128, torch.bfloat16, dev, seed=3).float().nan_to_num(
        posinf=0, neginf=0).to(torch.bfloat16)
    x[:, 20:] *= 8  # the larger absmax in the second slab
    whole8, whole_sx = quant.quant_i8(x)
    other = x[:, 14:].float().abs().amax()
    original = quant.mesh_absmax
    quant.mesh_absmax = lambda t: t.copy_(torch.maximum(t, other))
    try:
        kernels.reset_launches()
        top8, top_sx = quant.quant_i8(x[:, :14].contiguous())
        assert kernels.LAUNCHES["quant_i8"] == 2
    finally:
        quant.mesh_absmax = original
    static8, _ = quant.quant_i8(x[:, :14].contiguous(), whole_sx.reshape(()))
    torch.cuda.synchronize()
    assert torch.equal(top_sx.reshape(()), whole_sx.reshape(()))
    assert torch.equal(top8, whole8[:, :14]) and torch.equal(static8, whole8[:, :14])


# (n, h, w, c, up): R-MG-34's part widths, 16-channel groups and not (c
# = 3, 24), "up" parts with even and odd crops
QUANT_SHAPES = [(2, 7, 7, 512, None), (2, 14, 14, 16, (28, 28)), (3, 7, 7, 32, (13, 14)),
                (2, 56, 56, 3, None), (1, 5, 6, 24, (9, 12)), (2, 1, 1, 64, (2, 2)),
                (2, 28, 28, 128, None)]


def _quant_input(n, h, w, c, dtype, dev, seed=0):
    """Values spread over the scale's steps, with exact .5 ties, +-0,
    +-inf and values past +-127 steps."""
    g = torch.Generator(device=dev).manual_seed(seed)
    x = 40 * torch.randn((n, h, w, c), generator=g, device=dev)
    flat = x.view(-1)
    specials = torch.tensor([0.5, 1.5, 2.5, -2.5, 0.0, -0.0, float("inf"), float("-inf"),
                             1e4, -1e4, 126.5, -127.5], device=dev)
    flat[:specials.numel()] = specials[:flat.numel()]
    return x.to(dtype)


@pytest.mark.parametrize("shape", QUANT_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_quant_i8_is_bit_exact(dev, shape, dtype, mode):
    """quant_i8 equals quantize_act's torch ops (and the nearest upsample
    of an "up" part) on the card bit for bit: ties to even, +-inf and
    values past +-127*sx clipped, 0 for +-0; the dynamic scale (with an
    inf in the tensor, inf/127: every finite value 0) equal too; one
    launch (static) or two (dynamic) a call. A finite dynamic case takes
    the tensor without its infinities."""
    from mgtpu_torch.ops.quant import quant_i8, quant_i8_plain

    n, h, w, c, up = shape
    x = _quant_input(n, h, w, c, dtype, dev)
    for xi in ((x,) if mode == "static" else (x, x.float().nan_to_num(posinf=0, neginf=0).to(dtype))):
        sx = torch.full((), 1.0, device=dev) if mode == "static" else None
        kernels.reset_launches()
        x8, s = quant_i8(xi, sx, up)
        ref8, ref_s = quant_i8_plain(xi, sx, up)
        assert kernels.LAUNCHES["quant_i8"] == (1 if mode == "static" else 2)
        assert x8.dtype == torch.int8 and torch.equal(x8, ref8)
        assert torch.equal(s.reshape(()), ref_s.reshape(()))


def test_quant_i8_nan_gives_zero(dev):
    """A NaN quantizes to 0 on both sides; under a dynamic scale it makes
    the scale NaN and every value 0, as the torch ops do."""
    from mgtpu_torch.ops.quant import quant_i8, quant_i8_plain

    x = _quant_input(1, 4, 4, 32, torch.float32, dev)
    x[0, 1, 1, 5] = float("nan")
    for sx in (torch.full((), 0.5, device=dev), None):
        x8, s = quant_i8(x, sx)
        ref8, ref_s = quant_i8_plain(x, sx)
        assert torch.equal(x8, ref8) and int(x8[0, 1, 1, 5]) == 0
        assert torch.equal(s.isnan(), ref_s.isnan())
    assert not x8.any()


def test_quant_i8_refuses(dev):
    from mgtpu_torch.ops.quant import quant_i8

    x = torch.zeros((1, 4, 4, 16), device=dev)
    with pytest.raises(ValueError, match="contiguous NHWC"):
        quant_i8(x.transpose(1, 2))
    with pytest.raises(ValueError, match="contiguous NHWC"):
        quant_i8(x.half())
    with pytest.raises(ValueError, match="up"):
        quant_i8(x, None, (9, 8))
    with pytest.raises(ValueError, match="one f32"):
        quant_i8(x, torch.ones(2, device=dev))


@pytest.mark.parametrize("net", ["ilsvrc/rnmg", "cifar/prnmg", "mnist-cluttered/unmg"])
@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_quant_i8_group_equals_plain_at_every_forward_table(dev, net, mode):
    """The group design at every member table an int8 forward of the net
    gives it (batch 2): one launch a table (two with dynamic scales),
    bit for bit the plain group and the per-part design
    (chip_smoke.check_quant_group)."""
    from chip_smoke import I8_SERVE, check_quant_group, quant_members, record_kernel_shapes

    stats = Counter()
    for i, keys in enumerate(record_kernel_shapes(False, I8_SERVE[net][0],
                                                  int8=True)["quant_i8"]):
        check_quant_group(quant_members(keys, 2, 100 + 20 * i, mode == "static"), str(keys),
                          stats)
    torch.cuda.synchronize()
    assert stats["tables"] > 0 and stats["bad"] == 0


@pytest.mark.parametrize("mode", ["static", "dynamic"])
def test_quant_i8_group_edge_tables(dev, mode):
    """Odd C, a 1x1 map upsampled, odd crops, f32 and bf16 in one launch,
    members off a 16-byte boundary, and MAX_MEMBERS + 1 members (two
    launches a pass); ties, +-0, +-inf, NaN and values past +-127 steps
    under static scales."""
    from chip_smoke import QUANT_EDGE_GROUPS, check_quant_group, quant_members

    stats = Counter()
    for i, (keys, dtypes, off) in enumerate(QUANT_EDGE_GROUPS):
        check_quant_group(quant_members(keys, 3, 40 * i, mode == "static", dtypes, off),
                          f"edge group {i}", stats)
    torch.cuda.synchronize()
    assert stats["tables"] == len(QUANT_EDGE_GROUPS) and stats["bad"] == 0


def test_quant_i8_group_reduces_its_absmaxes_once(dev):
    """A group's dynamic absmaxes reach quant.mesh_absmax once, as one
    vector between the two launches; the scales it leaves (here another
    rank's larger maxima) are the ones the quantize takes, bit for bit
    the static launch fed them."""
    from chip_smoke import quant_members
    from mgtpu_torch.ops import quant

    keys = [(14, 14, 64, 14, 14), (7, 7, 128, 14, 14), (7, 7, 32, 7, 7)]
    members = quant_members(keys, 2, 9, static=False)
    other = torch.tensor([1e3, 0.0, 2e3], device=dev)
    calls = []
    original = quant.mesh_absmax
    quant.mesh_absmax = lambda t: calls.append(t.clone()) or t.copy_(torch.maximum(t, other))
    try:
        got = quant.quant_i8_group(members)
    finally:
        quant.mesh_absmax = original
    assert len(calls) == 1 and calls[0].shape == (3,)
    assert torch.equal(calls[0], torch.stack([x.float().abs().amax() for x, _, _ in members]))
    static = quant.quant_i8_group([(x, s.reshape(()), up) for (x, _, up), (_, s) in zip(members,
                                                                                           got)])
    for j, ((x, _, _), (x8, s), (s8, _)) in enumerate(zip(members, got, static)):
        want = torch.clamp_min(torch.maximum(x.float().abs().amax(), other[j])
                               / torch.full((), 127.0, device=dev), 1e-12)
        assert torch.equal(x8, s8) and torch.equal(s.reshape(()), want)


def test_quant_i8_group_refuses(dev):
    """Members the kernels do not take, a group on two devices, and a
    member table the wrapper would not plan (refused by the C side)."""
    import ctypes

    from mgtpu_torch.ops import quant

    x = torch.zeros((1, 4, 4, 16), device=dev)
    sx = torch.ones((), device=dev)
    for members, match in (([(x, None, None), (x.transpose(1, 2), None, None)], "contiguous"),
                           ([(x.half(), None, None)], "contiguous NHWC"),
                           ([(x, None, (9, 8))], "up"),
                           ([(x, torch.ones(2, device=dev), None)], "one f32"),
                           ([(x, sx, None), (x.cpu(), None, None)], "a group on")):
        with pytest.raises(ValueError, match=match):
            quant.quant_i8_group(members)
    x8 = torch.empty((1, 4, 4, 16), dtype=torch.int8, device=dev)
    table, grid = quant._group_table([(x, x8, sx, -1, None)], quant._sms(0))
    table.m[0].tile0 = 1
    with pytest.raises(RuntimeError, match="mg_quant_i8_group"):
        kernels.launch("quant_i8", "mg_quant_i8_group", x.device, ctypes.byref(table),
                       ctypes.sizeof(table), grid, None, None, 0)
    with pytest.raises(RuntimeError, match="mg_quant_i8_group"):
        kernels.launch("quant_i8", "mg_quant_i8_group", x.device, ctypes.byref(table),
                       ctypes.sizeof(table) - 4, grid, None, None, 0)


def test_int8_server_launches_conv_i8_per_part(dev):
    """An int8 R-MG-18 served on the card launches conv_i8 once a conv
    part and no 3x3 conv kernel, and its f32 forward gives the CPU's with
    the same frozen scales (both sides: the same quantized activations,
    int32 sums and dequants; bound 1e-5 of the scale, chip_smoke.py's
    rule, which a quantize step flipped on one side exceeds)."""
    from chip_smoke import record_kernel_shapes
    from mgtpu_torch.models import NetOpts
    from mgtpu_torch.serve import Server

    opt = NetOpts(depth=18)
    per = {k: sum(c.values()) for k, c in record_kernel_shapes(False, opt, int8=True).items()}
    gpu = Server(opt, device=dev, compute_dtype=torch.float32, int8=True, int8_calib=1)
    cpu = Server(opt, device="cpu", compute_dtype=torch.float32, int8=True)
    for a, b in zip(cpu.model.modules(), gpu.model.modules()):
        if getattr(b, "quantized", False):
            a.sx = b.sx.cpu()
    x = np.random.default_rng(44).standard_normal((2, 224, 224, 3), dtype=np.float32)
    kernels.reset_launches()
    got = gpu.predict(x).cpu()
    assert kernels.LAUNCHES == per and per["conv3x3"] == 0 and per["conv_i8"] > 0
    ref = cpu.predict(x)
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()


def test_remat_step_on_the_card_equals_the_plain_step(dev):
    """-remat on the card: cifar/prnmg --isDropout, bf16, two micro-batches
    of 8: the remat step's parameters and running stats move from the
    plain step's by no more than three times the plain step's own change
    between two runs (the run again in the backward draws the first
    forward's masks and leaves the stats alone), and the forward's
    kernels launch twice."""
    from chip_smoke import PRNMG_DROPOUT_PER_MICRO
    from mgtpu_torch.models.base import NetOpts
    from mgtpu_torch.trainer import Trainer, synthetic_batch

    opt = NetOpts(netType="cifar/prnmg", isDropout=True)
    x, y = synthetic_batch(16, seed=1, n_classes=100, shape=(32, 32, 3))
    states = []
    for remat in (False, False, True):
        tr = Trainer(opt, seed=0, device=dev, compute_dtype=torch.bfloat16, iter_size=2,
                     remat=remat)
        kernels.reset_launches()
        tr.step(x, y, 1e-3, 5e-4)
        launches = dict(kernels.LAUNCHES)
        states.append({k: v.float().clone() for k, v in tr.model.state_dict().items()})
    fwd = ("conv3x3", "conv3x3_bn_relu_in", "maxpool2")
    assert launches == {k: 2 * n * (2 if k in fwd else 1)
                        for k, n in PRNMG_DROPOUT_PER_MICRO.items()}
    for k in states[0]:
        own = (states[1][k] - states[0][k]).abs().max().item()
        assert (states[2][k] - states[0][k]).abs().max().item() <= 3 * own, k


def test_saliency_probe_on_the_card_equals_the_host_probe(dev):
    """The saliency pipeline's device probe on CUDA tensors (argmax of
    int32 masks, the f32 product) against its numpy host probe on
    the same outputs: valid and points bit for bit, saliency at rtol
    1e-5 / atol 1e-6."""
    from mgtpu_torch.pipelines import saliency

    rng = np.random.default_rng(5)
    outs = rng.random((3, 1 + 30, 64, 64, 1)).astype(np.float32) * 0.8
    outs[1, 0] = 0.0  # nothing over the threshold
    outs[2, 0, :, :20] = 0.0
    mask = (rng.random((30, 64, 64, 1)) > 0.9).astype(np.float32)
    valid, points = saliency.interest_points(torch.from_numpy(outs[:, 0]).to(dev))
    sal = saliency.saliency_maps(torch.from_numpy(outs).to(dev), points,
                                 torch.from_numpy(mask).to(dev)).cpu().numpy()
    for j in range(3):
        host = saliency.interest_point(outs[j, 0])
        assert bool(valid[j]) == (host is not None)
        if host is not None:
            np.testing.assert_array_equal(points[j].cpu().numpy(), host)
            np.testing.assert_allclose(sal[j], saliency.saliency_map(outs[j], host, mask),
                                       rtol=1e-5, atol=1e-6)
    assert valid.tolist() == [True, False, True]


def test_custom_ops_launch_the_kernels(dev):
    """Each mgtpu:: op (`mgtpu_torch.ops.library`) on CUDA tensors
    launches its kernel once (twice for a dynamic quantize) and returns
    the wrapper's bits (a conv's stats: sums added with atomics in a
    varying order, to the bounds above); conv_i8's op writes a new tensor
    where the wrapper adds into y_in."""
    from mgtpu_torch.ops import cuda_conv_i8, library, quant  # noqa: F401 (the ops)

    ops = torch.ops.mgtpu

    x, w, b = _conv_inputs(2, 14, 14, 64, 64, torch.bfloat16, dev)
    sc, sh = torch.rand(64, device=dev) + 0.5, torch.randn(64, device=dev)
    x8 = torch.randint(-127, 128, (2, 14, 14, 64), dtype=torch.int8, device=dev)
    w8 = torch.randint(-127, 128, (3, 3, 64, 64), dtype=torch.int8, device=dev)
    v, sx = torch.rand(64, device=dev), torch.tensor(0.01, device=dev)
    y_in = torch.randn((2, 14, 14, 64), device=dev).to(torch.bfloat16)
    cases = [
        ("conv3x3", lambda: ops.conv3x3(x, w, b, True, True),
         lambda: conv3x3(x, w, b, relu_out=True, with_stats=True), 1),
        ("conv3x3_bn_relu_in", lambda: ops.conv3x3_bn_relu_in(x, w, b, sc, sh, False, True),
         lambda: conv3x3_bn_relu_in(x, w, b, sc, sh), 1),
        ("maxpool2", lambda: ops.maxpool2(x), lambda: maxpool2(x), 1),
        ("conv_i8", lambda: ops.conv_i8(x8, w8, 1, 1, v, torch.bfloat16, sx, y_in, b, True,
                                            None),
         lambda: cuda_conv_i8.conv_i8(x8, w8, 1, 1, v, torch.bfloat16, sx=sx,
                                      y_in=y_in.clone(), bias=b, relu=True), 1),
        ("quant_i8", lambda: ops.quant_i8(x, sx, [27, 28])[0],
         lambda: quant.quant_i8(x, sx, (27, 28))[0], 1),
        ("quant_i8", lambda: (lambda r: (r[0], r[1][1]))(ops.quant_i8(x, None, None)),
         lambda: quant.quant_i8(x), 2),
        ("quant_i8", lambda: (lambda r: (*r[0], r[1][1, 0]))(ops.quant_i8_group(
            [x, x[:, :7].contiguous()], [None, sx], [27, 28, 0, 0])),
         lambda: (lambda r: (r[0][0], r[1][0], r[0][1]))(quant.quant_i8_group(
             [(x, None, (27, 28)), (x[:, :7].contiguous(), sx, None)])), 2),
    ]
    with torch.no_grad():
        for kernel, op, wrapper, n in cases:
            kernels.reset_launches()
            got = op()
            torch.cuda.synchronize()
            assert kernels.LAUNCHES[kernel] == n, (kernel, dict(kernels.LAUNCHES))
            want = wrapper()
            pairs = zip(*((t,) if isinstance(t, torch.Tensor) else t for t in (got, want)))
            for i, (g, r) in enumerate(pairs):
                if kernel.startswith("conv3x3") and i == 1:
                    torch.testing.assert_close(g, r, rtol=1e-4, atol=1e-5 * r.abs().max().item())
                else:
                    assert torch.equal(g, r), kernel
