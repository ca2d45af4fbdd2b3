"""The port's layers (`mgtpu_torch.nn`, `mgtpu_torch.ops.fold`) against
`mgtpu.nn` and `mgtpu.ops.fold`, on the CPU, in eval and train mode
(values, new running stats and gradients): the same numpy weights go
into both through `mgtpu_torch.utils.bridge.load_jax_tree`."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mgtpu import nn as jnn
from mgtpu.ops import mg as jmg
from mgtpu.ops.fold import fold_batchnorm as jax_fold
from mgtpu_torch import nn as tnn
from mgtpu_torch.ops import mg as tmg
from mgtpu_torch.ops.fold import fold_batchnorm
from mgtpu_torch.utils.bridge import export_jax_tree, load_jax_tree


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jitter_bn(p, s, seed=0):
    """Non-trivial BN affine and running stats (numpy), in place."""
    rng = np.random.default_rng(seed)
    p["bn"]["scale"] = rng.uniform(0.5, 1.5, p["bn"]["scale"].shape).astype(np.float32)
    p["bn"]["bias"] = rng.normal(0, 0.5, p["bn"]["bias"].shape).astype(np.float32)
    s["bn"]["mean"] = rng.normal(0, 0.5, s["bn"]["mean"].shape).astype(np.float32)
    s["bn"]["var"] = rng.uniform(0.25, 2.0, s["bn"]["var"].shape).astype(np.float32)
    return p, s


def _pair(c_in, c_out, k=3, relu=True, eps=1e-5, stride=1, seed=0, jdtype=None, tdtype=None):
    """A JAX ConvBN and the port's, holding the same weights."""
    jl = jnn.ConvBN(c_in, c_out, k, stride, relu=relu, eps=eps, dtype=jdtype)
    p, s = _jitter_bn(*_np(jl.init(jax.random.PRNGKey(seed))), seed=seed)
    tl = tnn.ConvBN(c_in, c_out, k, stride, relu=relu, eps=eps, compute_dtype=tdtype).eval()
    load_jax_tree(tl, p, s)
    return jl, p, s, tl


def _pyr(hws, cs, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((2, h, w, c), dtype=np.float32) for (h, w), c in zip(hws, cs)]


# (pyramid sizes, widths, k): exact-2x up parts go to _conv_up3; k=1 up
# parts are convolved coarse and then upsampled; the 7x7 grid's 4x4
# partner is not exact 2x, so its up part is materialized and goes to
# the 3x3 conv like the down and same parts
PART_CASES = {
    "exact2x_up": ([(8, 8), (4, 4), (2, 2)], [5, 4, 3], 3),
    "k1_up": ([(8, 8), (4, 4)], [5, 4], 1),
    "odd_partner_materialized": ([(7, 7), (4, 4), (2, 2)], [5, 4, 3], 3),
}


@pytest.mark.parametrize("case", sorted(PART_CASES))
@pytest.mark.parametrize("relu", [False, True])
def test_apply_parts_matches_jax(case, relu):
    hws, cs, k = PART_CASES[case]
    pyr = _pyr(hws, cs, seed=1)
    mixed = jmg.pyramid_widths_after_exchange(cs)
    for i in range(len(cs)):
        jl, p, s, tl = _pair(mixed[i], 6, k=k, relu=relu, seed=i)
        ref, _ = jl.apply_parts(p, s, jmg.exchange_parts(tuple(map(jnp.asarray, pyr)), i))
        got = tl.apply_parts(tmg.exchange_parts(tuple(map(torch.from_numpy, pyr)), i))
        # f32: summation order only (at most 9*12-term dot products)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_apply_parts_bf16_matches_jax():
    """compute_dtype bf16: parts, weights and outputs in bf16. The two
    frameworks round at different places (the port adds the conv bias
    inside the f32 accumulator of the first 3x3 launch, JAX after the
    bf16 sum of the parts), so values may differ by a bf16 step of the
    output's scale (measured equal on the CPU; the bound allows two
    bf16 steps)."""
    hws, cs, _ = PART_CASES["exact2x_up"]
    pyr = [a.astype(ml_dtypes.bfloat16) for a in _pyr(hws, cs, seed=2)]
    mixed = jmg.pyramid_widths_after_exchange(cs)
    for i in range(len(cs)):
        jl, p, s, tl = _pair(mixed[i], 6, seed=i, jdtype=jnp.bfloat16, tdtype=torch.bfloat16)
        ref, _ = jl.apply_parts(p, s, jmg.exchange_parts(tuple(map(jnp.asarray, pyr)), i))
        got = tl.apply_parts(tmg.exchange_parts(
            tuple(torch.from_numpy(a.astype(np.float32)).bfloat16() for a in pyr), i))
        assert got.dtype == torch.bfloat16
        ref = np.asarray(ref).astype(np.float32)
        np.testing.assert_allclose(got.float().detach().numpy(), ref, rtol=0,
                                   atol=2.0 ** -7 * np.abs(ref).max())


@pytest.mark.parametrize("hw", [(8, 8), (7, 5), (4, 6)])
def test_conv_up3_matches_jax(hw):
    """conv3x3(nearest_up2(x)) as conv_transpose2d(stride 2, padding 1)
    with the 4x4 kernel flipped and its channels swapped."""
    rng = np.random.default_rng(7)
    h, w = hw
    x = rng.standard_normal((2, h, w, 5), dtype=np.float32)
    ws = rng.standard_normal((3, 3, 5, 4), dtype=np.float32)
    ref = jnn._conv_up3(jnp.asarray(x), jnp.asarray(ws), 2 * h, 2 * w)
    got = tnn._conv_up3(torch.from_numpy(x), torch.from_numpy(ws), 2 * h, 2 * w)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="exact 2x"):
        tnn._conv_up3(torch.from_numpy(x), torch.from_numpy(ws), 2 * h - 1, 2 * w)


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_batchnorm_eval_matches_jax(eps, dtype):
    rng = np.random.default_rng(4)
    c = 6
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.normal(0, 0.5, c).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.5, c).astype(np.float32),
         # tiny variances make eps matter
         "var": rng.uniform(1e-4, 2e-3, c).astype(np.float32)}
    x = rng.standard_normal((2, 3, 4, c), dtype=np.float32)
    xt = torch.from_numpy(x)
    if dtype == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
        xt = xt.bfloat16()
    ref, _ = jnn.BatchNorm(c, eps=eps).apply(p, s, jnp.asarray(x))
    bn = load_jax_tree(tnn.BatchNorm(c, eps=eps).eval(), p, s)
    with torch.no_grad():
        got = bn(xt)
    assert got.dtype == xt.dtype
    ref = np.asarray(ref).astype(np.float32)
    # computed in f32 on both sides; bf16 rounds the f32 result once, and
    # f32 values a hair apart can round one bf16 step apart (up to 2^-7
    # relative)
    tol = dict(rtol=2.0 ** -7, atol=1e-5) if dtype == "bf16" else dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.float().numpy(), ref, **tol)


def test_batchnorm_train_mode_not_ported():
    """Train mode is ported; what stays refused, as in the JAX layer, is
    training a BatchNorm that was folded into its conv (eval only)."""
    bn = tnn.BatchNorm(4)
    bn.drop_folded()
    bn.train()
    with pytest.raises(ValueError, match="folded"):
        bn(torch.zeros(1, 2, 2, 4))
    with pytest.raises(ValueError, match="folded"):
        bn.batch_affine(torch.zeros(1, 2, 2, 4))
    assert torch.equal(bn.eval()(torch.ones(1, 2, 2, 4)), torch.ones(1, 2, 2, 4))


def _bn_train_case(c=8, seed=12):
    """The spec's input (tests/test_mg_ops.py: mean 1.5, std 3) and a
    non-trivial affine and running stats."""
    rng = np.random.default_rng(seed)
    p = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
         "bias": rng.normal(0, 1, c).astype(np.float32)}
    s = {"mean": rng.normal(0, 0.5, c).astype(np.float32),
         "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    x = (rng.standard_normal((4, 5, 5, c), dtype=np.float32) * 3 + 1.5)
    return p, s, x


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_batchnorm_train_matches_jax(eps):
    """Train-mode value, new running stats (momentum 0.1, unbiased
    variance) and the VJP of the custom two-reduction backward, against
    BatchNorm.apply(train=True) and its jax.grad, in f32."""
    p, s, x = _bn_train_case()
    jbn = jnn.BatchNorm(8, eps=eps)

    def loss(p, x):
        y, ns = jbn.apply(p, s, x, train=True)
        return jnp.sum(jnp.sin(y)), (y, ns)

    (_, (ref, ref_s)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    bn = load_jax_tree(tnn.BatchNorm(8, eps=eps), p, s).train()
    xt = torch.from_numpy(x).requires_grad_()
    y = bn(xt)
    torch.sin(y).sum().backward()
    # f32 moments over 100 values per channel in another order
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.mean.numpy(), np.asarray(ref_s["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(ref_s["var"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-5)
    for k, t in (("scale", bn.scale), ("bias", bn.bias)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(gp[k]), rtol=1e-4, atol=1e-4)


def test_batchnorm_train_bf16_matches_jax():
    """bf16 input: moments and normalization in f32, output rounded once
    to bf16; the running stats stay f32."""
    p, s, x = _bn_train_case(seed=13)
    xb = x.astype(ml_dtypes.bfloat16)
    ref, ref_s = jnn.BatchNorm(8).apply(p, s, jnp.asarray(xb), train=True)
    bn = load_jax_tree(tnn.BatchNorm(8), p, s).train()
    with torch.no_grad():
        y = bn(torch.from_numpy(xb.astype(np.float32)).bfloat16())
    assert y.dtype == torch.bfloat16 and bn.mean.dtype == torch.float32
    # f32 values a hair apart can round one bf16 step apart
    ref = np.asarray(ref).astype(np.float32)
    np.testing.assert_allclose(y.float().numpy(), ref, rtol=2.0 ** -7, atol=1e-5)
    np.testing.assert_allclose(bn.var.numpy(), np.asarray(ref_s["var"]), rtol=1e-5, atol=1e-6)


def test_batchnorm_batch_affine_is_the_custom_vjp():
    """The split form that feeds the conv3x3_bn_relu_in prologue: the
    batch (scale, shift) from the same one-pass moments, differentiated
    by autograd through the moments, gives relu(bn(x)) the same value,
    gradients and running stats as the custom-VJP forward."""
    p, s, x = _bn_train_case(seed=14)
    r = torch.from_numpy(np.random.default_rng(15).standard_normal(x.shape, dtype=np.float32))
    outs = []
    for split in (False, True):
        bn = load_jax_tree(tnn.BatchNorm(8), p, s).train()
        xt = torch.from_numpy(x).requires_grad_()
        if split:
            scale, shift = bn.batch_affine(xt)
            y = torch.relu(xt * scale + shift)
        else:
            y = torch.relu(bn(xt))
        (y * r).sum().backward()
        outs.append((y.detach(), xt.grad, bn.scale.grad, bn.bias.grad, bn.mean, bn.var))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# three parts with an exact-2x up part (the scale in the middle), and an
# odd up part that is materialized
TRAIN_PART_CASES = {
    "exact2x_up": ([(8, 8), (4, 4), (2, 2)], [5, 4, 3], 1),
    "odd_up_materialized": ([(7, 7), (4, 4), (2, 2)], [5, 4, 3], 0),
}


@pytest.mark.parametrize("case", sorted(TRAIN_PART_CASES))
@pytest.mark.parametrize("relu", [False, True])
def test_apply_parts_train_matches_jax(case, relu):
    """ConvBN.apply_parts in train mode: values, new running stats and
    the gradients with respect to the weights and every part."""
    hws, cs, i = TRAIN_PART_CASES[case]
    pyr = _pyr(hws, cs, seed=16)
    mixed = jmg.pyramid_widths_after_exchange(cs)
    jl, p, s, tl = _pair(mixed[i], 6, relu=relu, seed=i)
    r = np.random.default_rng(17).standard_normal((2, *hws[i], 6), dtype=np.float32)

    def loss(p, pyr):
        y, ns = jl.apply_parts(p, s, jmg.exchange_parts(pyr, i), train=True)
        return jnp.sum(y * r), (y, ns)

    (_, (ref, ref_s)), (gp, gpyr) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, p), tuple(map(jnp.asarray, pyr)))
    tl.train()
    tpyr = tuple(torch.from_numpy(a).requires_grad_() for a in pyr)
    y = tl.apply_parts(tmg.exchange_parts(tpyr, i))
    (y * torch.from_numpy(r)).sum().backward()
    # f32: summation order only
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    _, got_s = export_jax_tree(tl)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_s["bn"][k], np.asarray(ref_s["bn"][k]), rtol=1e-5,
                                   atol=1e-6)
    # gradients sum over the batch and the BN's two reductions
    tol = dict(rtol=1e-4, atol=1e-4)
    for got, want in ((tl.conv.w.grad, gp["conv"]["w"]), (tl.conv.b.grad, gp["conv"]["b"]),
                      (tl.bn.scale.grad, gp["bn"]["scale"]), (tl.bn.bias.grad, gp["bn"]["bias"])):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    for a, want in zip(tpyr, gpyr):
        if a.grad is not None:  # only the neighbours of scale i take part
            np.testing.assert_allclose(a.grad.numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("k", [3, 1])
def test_apply_parts_takes_unnormalized_same_part(k):
    """A "same" part that arrives as (y_raw, scale, shift) equals the
    part relu(y_raw * scale + shift), in value and gradients: through
    the conv3x3_bn_relu_in prologue for a 3x3 conv, materialized for a
    1x1 conv."""
    rng = np.random.default_rng(18)
    y_raw = rng.standard_normal((2, 6, 6, 4), dtype=np.float32)
    down = rng.standard_normal((2, 6, 6, 3), dtype=np.float32)
    scale, shift = rng.uniform(0.5, 1.5, 4).astype(np.float32), rng.normal(0.2, 0.5, 4)
    shift = shift.astype(np.float32)
    r = torch.from_numpy(rng.standard_normal((2, 6, 6, 5), dtype=np.float32))
    outs = []
    for fused in (False, True):
        tl = tnn.ConvBN(7, 5, k=k, generator=torch.Generator().manual_seed(3)).train()
        ts = [torch.from_numpy(a).requires_grad_() for a in (y_raw, down, scale, shift)]
        same = tuple(ts[i] for i in (0, 2, 3))
        if not fused:
            same = torch.relu(same[0] * same[1] + same[2])
        y = tl.apply_parts([("down", ts[1]), ("same", same)])
        (y * r).sum().backward()
        outs.append([y.detach(), tl.conv.w.grad, tl.conv.b.grad] + [t.grad for t in ts])
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("k,stride,pad", [(3, 1, None), (1, 1, None), (7, 2, 3)])
def test_convbn_forward_matches_jax(k, stride, pad):
    jl, p, s, tl = _pair(4, 6, k=k, stride=stride, relu=True, seed=5)
    if pad is not None:  # the stem's 7x7/2 pad 3
        jl.conv.pad = tl.conv.pad = pad
    x = np.random.default_rng(6).standard_normal((2, 11, 9, 4), dtype=np.float32)
    ref, _ = jl.apply(p, s, jnp.asarray(x))
    got = tl(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [None, "bf16"])
def test_dense_matches_jax(dtype):
    """Dense accumulates in f32 and adds the f32 bias in every compute
    dtype."""
    jl = jnn.Dense(12, 7, dtype=jnp.bfloat16 if dtype else None)
    p = _np(jl.init(jax.random.PRNGKey(0))[0])
    p["b"] = np.random.default_rng(1).standard_normal(7, dtype=np.float32)
    tl = load_jax_tree(tnn.Dense(12, 7, compute_dtype=torch.bfloat16 if dtype else None), p, {})
    x = np.random.default_rng(2).standard_normal((3, 12), dtype=np.float32)
    ref, _ = jl.apply(p, {}, jnp.asarray(x))
    got = tl(torch.from_numpy(x))
    assert got.dtype == torch.float32
    # bf16 operands multiply exactly in f32; both sum 12 f32 products
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_dropout_and_sequential_in_eval():
    x = torch.randn(2, 3, generator=torch.Generator().manual_seed(0))
    seq = tnn.Sequential([tnn.Dropout(0.5), tnn.Dropout(0.2)]).eval()
    assert torch.equal(seq(x), x)


def test_fold_matches_jax_fold():
    jl, p, s, tl = _pair(5, 6, k=3, seed=8, eps=1e-3)
    fp, _ = jax_fold(jl, p, s)
    fold_batchnorm(tl)
    assert tl.bn.folded
    np.testing.assert_allclose(tl.conv.w.detach().numpy(), np.asarray(fp["conv"]["w"]),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tl.conv.b.detach().numpy(), np.asarray(fp["conv"]["b"]),
                               rtol=1e-6, atol=1e-7)
    w = tl.conv.w.detach().clone()
    fold_batchnorm(tl)  # folding twice is a no-op
    assert torch.equal(tl.conv.w, w)


def test_fold_is_exact_and_refuses_biasless_conv():
    jl, p, s, tl = _pair(5, 6, k=3, seed=9)
    x = torch.from_numpy(np.random.default_rng(10).standard_normal((2, 6, 6, 5),
                                                                    dtype=np.float32))
    with torch.no_grad():
        y0 = tl(x)
        y1 = fold_batchnorm(tl)(x)
    # BN applied after the conv vs W*a folded in: f32 reassociation
    torch.testing.assert_close(y1, y0, rtol=1e-5, atol=1e-5)
    layer = tnn.ConvBN(3, 4)
    layer.conv.b = None
    with pytest.raises(ValueError, match="bias-less"):
        fold_batchnorm(layer)
