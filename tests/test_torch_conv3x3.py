"""The port's 3x3 convs (`mgtpu_torch.ops.cuda_conv`: ``conv3x3`` and
``conv3x3_bn_relu_in``) against the JAX package's Pallas kernels
(`mgtpu.ops.pallas_conv`, in interpret mode) and their XLA formulations,
in f32 on the CPU: values, stats, and the gradients of the autograd
Functions against ``jax.grad``; conv3x3's running part sum ``y_in``
against its formula and the stock sum, in f32 and bf16. On a CPU tensor
the wrapper takes the plain version; the CUDA kernels themselves are
compared with the plain versions on the card (tests/test_torch_cuda.py
and chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgtpu.ops.pallas_conv import conv3x3 as pallas_conv3x3
from mgtpu.ops.pallas_conv import conv3x3_bn_relu_in as pallas_conv3x3_bn_relu_in
from mgtpu.ops.pallas_conv import xla_conv3x3, xla_conv3x3_bn_relu_in
from mgtpu_torch.ops.cuda_conv import (conv3x3, conv3x3_bn_relu_in, conv3x3_bn_relu_in_plain,
                                       conv3x3_forward, conv3x3_plain, out_rows)


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


def _bn_data(ci=8, seed=4):
    """A BN scale and shift with some positive shifts, so relu(shift) > 0
    and a conv that normalized its zero halo would differ at the edge."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.5, 1.5, ci).astype(np.float32)
    shift = rng.normal(0.3, 0.5, ci).astype(np.float32)
    assert (shift > 0).any() and (shift < 0).any()
    return scale, shift


@pytest.mark.parametrize("variant", ["pallas", "xla"])
@pytest.mark.parametrize("relu_out", [False, True])
@pytest.mark.parametrize("with_stats", [False, True])
def test_conv3x3_bn_relu_in_plain_matches_jax(variant, relu_out, with_stats):
    x, wt, b = _data(seed=5)
    scale, shift = _bn_data()
    args = [jnp.asarray(a) for a in (x, wt, b, scale, shift)]
    if variant == "pallas":
        y_ref, st_ref = pallas_conv3x3_bn_relu_in(*args, relu_out=relu_out,
                                                  with_stats=with_stats, th=8, interpret=True)
    else:
        y_ref, st_ref = xla_conv3x3_bn_relu_in(*args, relu_out=relu_out, with_stats=with_stats)
    y, st = conv3x3_bn_relu_in_plain(*(torch.from_numpy(a) for a in (x, wt, b, scale, shift)),
                                     relu_out=relu_out, with_stats=with_stats)
    # as test_conv3x3_plain_matches_jax: summation order only
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(st.numpy(), np.asarray(st_ref), rtol=1e-4, atol=1e-3)
    if not with_stats:
        assert not st.any()


def test_conv3x3_bn_relu_in_keeps_the_halo_zero():
    """With x = 0 and a positive shift the normalized interior is
    relu(shift) everywhere, but pad positions stay 0, so the corner
    output sees 4 of the 9 taps: it is not the interior value."""
    x = torch.zeros((1, 4, 4, 1))
    w = torch.ones((3, 3, 1, 1))
    y, _ = conv3x3_bn_relu_in(x, w, torch.zeros(1), torch.ones(1), torch.full((1,), 2.0))
    assert y[0, 0, 0, 0] == 8.0 and y[0, 1, 1, 0] == 18.0


def test_conv3x3_bn_relu_in_wrapper_on_cpu_is_the_plain_version():
    x, wt, b = (torch.from_numpy(a) for a in _data(seed=6))
    scale, shift = (torch.from_numpy(a) for a in _bn_data())
    for relu_out in (False, True):
        y, st = conv3x3_bn_relu_in(x, wt, b, scale, shift, relu_out=relu_out)
        y_ref, st_ref = conv3x3_bn_relu_in_plain(x, wt, b, scale, shift, relu_out=relu_out)
        torch.testing.assert_close(y, y_ref, rtol=0, atol=0)
        torch.testing.assert_close(st, st_ref, rtol=0, atol=0)


def _port_grads(fn, arrays, r):
    ts = [torch.from_numpy(a).requires_grad_() for a in arrays]
    y, _ = fn(*ts)
    (y * torch.from_numpy(r)).sum().backward()
    return [t.grad.numpy() for t in ts]


# f32 on both sides; each gradient sums up to 2*8*16*9 products in
# another order than XLA
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("relu_out", [False, True])
def test_conv3x3_grads_match_jax(relu_out):
    """d/d(x, w, b) of sum(conv3x3(x, w, b) * r): the autograd Function
    (cuDNN's dgrad and wgrad on a card, the CPU conv backward here)
    against jax.grad of xla_conv3x3. The stats output is not
    differentiable, so the loss leaves it out."""
    x, wt, b = _data(seed=7)
    r = np.random.default_rng(8).standard_normal((2, 8, 16, 8), dtype=np.float32)
    ref = jax.grad(lambda *a: jnp.sum(xla_conv3x3(*a, relu_out=relu_out)[0] * r),
                   argnums=(0, 1, 2))(*map(jnp.asarray, (x, wt, b)))
    got = _port_grads(lambda *a: conv3x3(*a, relu_out=relu_out), (x, wt, b), r)
    for g, gr in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(gr), **GRAD_TOL)


@pytest.mark.parametrize("relu_out", [False, True])
def test_conv3x3_bn_relu_in_grads_match_jax(relu_out):
    """d/d(x, w, b, scale, shift) of sum(conv3x3_bn_relu_in(...) * r):
    the backward recomputes the normalized input, takes dxn from the
    conv backward, then dz = dxn * [x*scale + shift > 0], dx = dz*scale,
    dscale = sum dz*x, dshift = sum dz; against jax.grad of
    xla_conv3x3_bn_relu_in."""
    x, wt, b = _data(seed=9)
    scale, shift = _bn_data(seed=10)
    r = np.random.default_rng(11).standard_normal((2, 8, 16, 8), dtype=np.float32)
    arrays = (x, wt, b, scale, shift)
    ref = jax.grad(lambda *a: jnp.sum(xla_conv3x3_bn_relu_in(*a, relu_out=relu_out)[0] * r),
                   argnums=tuple(range(5)))(*map(jnp.asarray, arrays))
    got = _port_grads(lambda *a: conv3x3_bn_relu_in(*a, relu_out=relu_out), arrays, r)
    for g, gr in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(gr), **GRAD_TOL)


def test_conv3x3_grad_reaches_the_wide_weight_through_a_slice():
    """The exchange passes a view of a wider weight: the gradient lands
    in that slice of the wide weight and nowhere else."""
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((1, 5, 6, 3), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 7, 4), dtype=np.float32)).requires_grad_()
    y, _ = conv3x3(x, w[:, :, 2:5], torch.zeros(4))
    y.sum().backward()
    ws = w.detach()[:, :, 2:5].clone().requires_grad_()
    conv3x3_plain(x, ws, torch.zeros(4))[0].sum().backward()
    torch.testing.assert_close(w.grad[:, :, 2:5], ws.grad, rtol=1e-5, atol=1e-5)
    assert not w.grad[:, :, :2].any() and not w.grad[:, :, 5:].any()


# ---------------------------------------------------- the running part sum


def _y_in_case(dtype, seed=13):
    x, wt, b = (torch.from_numpy(a) for a in _data(seed=seed))
    y_in = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal((2, 8, 16, 8),
                                                                           dtype=np.float32))
    return x.to(dtype), wt.to(dtype), b, y_in.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("relu_out", [False, True])
@pytest.mark.parametrize("with_stats", [False, True])
@pytest.mark.parametrize("pads", [(1, 1), (0, 1)])
def test_conv3x3_y_in_adds_before_the_rounding(dtype, relu_out, with_stats, pads):
    """y = relu?(round(conv(x, w) + b + float(y_in))): the conv and the
    add in f32, one rounding to the dtype, then the ReLU; the stats of
    that y; y a new tensor, y_in left as it was; under each pad pair (an
    H-slab's halo mode: (0, 1) reads a halo row above). In bf16 the one
    rounding differs from the stock sum of the rounded conv (two
    roundings) somewhere."""
    x, wt, b, y_in = _y_in_case(dtype)
    pt, pb = pads
    y_in = y_in[:, :out_rows(x, pt, pb)].contiguous()
    acc = conv3x3_plain(x.float(), wt.float(), b, with_stats=False, pad_top=pt,
                        pad_bottom=pb)[0]
    want = (acc + y_in.float()).to(dtype)
    want = torch.relu(want) if relu_out else want
    keep = y_in.clone()
    y, st = conv3x3_forward(x, wt, b, relu_out=relu_out, with_stats=with_stats, y_in=y_in,
                            pad_top=pt, pad_bottom=pb)
    assert y.dtype == dtype and torch.equal(y, want)
    assert y.data_ptr() != y_in.data_ptr() and torch.equal(y_in, keep)
    wf = want.float()
    st_want = torch.stack([wf.sum((0, 1, 2)), (wf * wf).sum((0, 1, 2))])
    assert torch.equal(st, st_want if with_stats else torch.zeros_like(st_want))
    if dtype == torch.bfloat16:
        stock = conv3x3_plain(x, wt, b, with_stats=False, pad_top=pt, pad_bottom=pb)[0] + keep
        assert not torch.equal(y, torch.relu(stock) if relu_out else stock)


def test_conv3x3_y_in_refuses_another_shape():
    x, wt, b, y_in = _y_in_case(torch.float32)
    with pytest.raises(ValueError, match="y_in"):
        conv3x3(x, wt, b, y_in=y_in[:, :4].contiguous())
    with pytest.raises(ValueError, match="y_in"):
        conv3x3(x, wt, b, y_in=y_in.bfloat16())


@pytest.mark.parametrize("relu_out", [False, True])
def test_conv3x3_grads_reach_y_in(relu_out):
    """d/d(x, w, b, y_in) of sum(conv3x3(x, w, b, y_in=y_in) * r) against
    autograd through the stock sum relu?(conv3x3(x, w, b) + y_in): y_in
    takes the output's gradient, through the ReLU's mask."""
    x, wt, b, y_in = _y_in_case(torch.float32, seed=15)
    r = torch.from_numpy(np.random.default_rng(16).standard_normal((2, 8, 16, 8),
                                                                   dtype=np.float32))

    def grads(fn):
        ts = [t.clone().requires_grad_() for t in (x, wt, b, y_in)]
        (fn(*ts) * r).sum().backward()
        return [t.grad for t in ts]

    got = grads(lambda *t: conv3x3(*t[:3], relu_out=relu_out, y_in=t[3])[0])
    stock = (lambda *t: torch.relu(conv3x3(*t[:3])[0] + t[3])) if relu_out else \
        (lambda *t: conv3x3(*t[:3])[0] + t[3])
    for g, gr in zip(got, grads(stock)):
        torch.testing.assert_close(g, gr, rtol=1e-5, atol=1e-5)


def test_conv3x3_op_with_y_in_round_trips_through_export():
    """A module that calls conv3x3 with y_in exports (`torch.export`, the
    op ``mgtpu::conv3x3`` with its ``y_in``) and runs as the eager call."""
    x, wt, b, y_in = _y_in_case(torch.float32, seed=17)

    class Conv(torch.nn.Module):
        def forward(self, x, y_in):
            return conv3x3(x, wt, b, relu_out=True, with_stats=False, y_in=y_in)[0]

    program = torch.export.export(Conv(), (x, y_in))
    assert "mgtpu.conv3x3" in str(program.graph)
    torch.testing.assert_close(program.module()(x, y_in), Conv()(x, y_in), rtol=0, atol=0)
