"""The port's int8 post-training quantization (`mgtpu_torch.ops.quant`,
`mgtpu_torch.ops.cuda_conv_i8`, the int8 branches of `mgtpu_torch.nn`,
`mgtpu_torch.ops.fold` and `mgtpu_torch.utils.bridge`) against
`mgtpu.ops.quant` and the JAX layers, on the CPU: the quantizers and the
int8 conv bit for bit, the layers' int8 forwards in f32 and bf16 with
dynamic and calibrated scales, calibration's scales and errors, the
quantized fold in both orders, and which convs a net quantizes. Inputs
are seeded numpy arrays handed to both sides."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mgtpu import nn as jnn
from mgtpu.ops import mg as jmg
from mgtpu.ops import quant as jq
from mgtpu.ops.fold import fold_batchnorm as jax_fold
from mgtpu.ops.resample import upsample_nearest2 as jax_up2
from mgtpu_torch import nn as tnn
from mgtpu_torch.ops import mg as tmg
from mgtpu_torch.ops import quant as tq
from mgtpu_torch.ops.cuda_conv_i8 import conv_i8_plain
from mgtpu_torch.ops.fold import fold_batchnorm
from mgtpu_torch.ops.resample import upsample_nearest2
from mgtpu_torch.utils.bridge import export_jax_tree, load_jax_tree
from test_torch_nn import PART_CASES, _jitter_bn, _np, _pyr


def _t(a):
    return torch.from_numpy(np.array(a))


def _equal(got: torch.Tensor, ref) -> bool:
    ref = np.asarray(ref)
    return got.dtype == torch.from_numpy(ref[:0].copy()).dtype and np.array_equal(
        got.numpy(), ref)


# --- the quantizers and the int8 conv: bit for bit ------------------------

@pytest.mark.parametrize("shape,spread", [((3, 3, 16, 24), 3.0), ((7, 7, 3, 16), 0.1),
                                          ((1, 1, 24, 8), 10.0), ((3, 3, 4, 4), 0.0)],
                         ids=["3x3", "7x7-stem", "1x1", "zero"])
def test_quantize_kernel_bit_equal_to_jax(shape, spread):
    """Per-output-channel scales (each channel its own magnitude) and the
    int8 weights equal JAX's bit for bit; a zero kernel gives scale 1e-12
    and zero weights on both sides."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal(shape) * rng.uniform(0.01, 1, shape[-1]) * spread).astype(np.float32)
    ref, got = jq.quantize_kernel(w), tq.quantize_kernel(torch.from_numpy(w))
    assert _equal(got["w8"], ref["w8"]) and _equal(got["scale"], ref["scale"])
    if spread == 0:
        assert float(got["scale"].max()) == np.float32(1e-12) and not got["w8"].any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["dynamic", "static", "zero"])
def test_quantize_act_bit_equal_to_jax(dtype, mode):
    """x8 and the scale equal JAX's: the dynamic scale over the whole
    tensor (batch included), a static scale that clips the tails, an
    all-zero tensor; bf16 input goes to f32 before the divide. Values on
    exact halves of the step check the round-half-to-even."""
    rng = np.random.default_rng(1)
    x = (7 * rng.standard_normal((4, 9, 9, 16))).astype(np.float32)
    if mode == "zero":
        x[:] = 0
    x[0, 0, 0, :4] = [0.5, 1.5, 2.5, -2.5]  # halves of a unit step (below)
    sx = {"dynamic": None, "static": np.float32(0.1), "zero": None}[mode]
    if mode == "static":
        x[0, 0, 0, :4] *= 0.1
    if dtype == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
    ref8, ref_sx = jq.quantize_act(jnp.asarray(x), None if sx is None else jnp.float32(sx))
    xt = torch.from_numpy(x.astype(np.float32))
    got8, got_sx = tq.quantize_act(xt.bfloat16() if dtype == "bf16" else xt,
                                   None if sx is None else torch.tensor(sx))
    assert _equal(got8, ref8)
    assert np.float32(got_sx) == np.float32(ref_sx)


# (k, stride, pad, Ci): the bulk 3x3, the 1x1 shortcuts and heads, the 7x7/2
# stems on 3- and 1-channel images, strided 3x3, Ci of one and a half chunks
CONV_CASES = [(3, 1, 1, 16), (1, 1, 0, 24), (7, 2, 3, 3), (7, 2, 3, 1), (3, 2, 1, 24),
              (1, 2, 0, 16), (3, 1, 1, 1), (7, 1, 3, 16)]


@pytest.mark.parametrize("k,stride,pad,ci", CONV_CASES)
def test_conv_i8_plain_equals_jax_exactly(k, stride, pad, ci):
    """int32 sums of full-range int8 operands, equal to JAX's conv_i8."""
    rng = np.random.default_rng(k * 100 + ci)
    x8 = rng.integers(-127, 128, (2, 11, 13, ci)).astype(np.int8)
    w8 = rng.integers(-127, 128, (k, k, ci, 10)).astype(np.int8)
    ref = jq.conv_i8(jnp.asarray(x8), jnp.asarray(w8), stride, pad)
    assert _equal(tq.conv_i8(_t(x8), _t(w8), stride, pad), ref)


@pytest.mark.parametrize("pads", [(0, 3), (3, 0), (1, 2)])
def test_conv_i8_plain_halo_stem_equals_jax(pads):
    """The 7x7/2/p3 stem on 3 channels under the halo pads of an H-slab
    (pad_top, pad_bottom), batch 2: conv_i8_plain equals JAX's conv_i8 of
    the slab zero-padded by those rows above and below and 3 columns each
    side, bit for bit."""
    pt, pb = pads
    rng = np.random.default_rng(40 + pt)
    x8 = rng.integers(-128, 128, (2, 21, 18, 3)).astype(np.int8)
    w8 = rng.integers(-127, 128, (7, 7, 3, 16)).astype(np.int8)
    ref = jq.conv_i8(jnp.asarray(np.pad(x8, ((0, 0), (pt, pb), (3, 3), (0, 0)))),
                     jnp.asarray(w8), 2, 0)
    assert _equal(conv_i8_plain(_t(x8), _t(w8), 2, 3, pad_top=pt, pad_bottom=pb), ref)


@pytest.mark.parametrize("k,pad", [(3, 1), (1, 0)])
def test_conv_i8_on_weight_slices_and_split_identity(k, pad):
    """A slice of the weight along its input channels (a view, as the
    exchange passes it) gives JAX's sums, and the slices' sums add up to
    the concat's exactly: the identity ConvBN's int8 parts rely on."""
    rng = np.random.default_rng(5)
    xa = rng.integers(-127, 128, (2, 8, 8, 8)).astype(np.int8)
    xb = rng.integers(-127, 128, (2, 8, 8, 19)).astype(np.int8)
    w8 = rng.integers(-127, 128, (k, k, 27, 12)).astype(np.int8)
    wt = _t(w8)
    parts = [conv_i8_plain(_t(xa), wt[:, :, :8], 1, pad),
             conv_i8_plain(_t(xb), wt[:, :, 8:], 1, pad)]
    assert wt[:, :, 8:].data_ptr() == wt.data_ptr() + 8 * 12  # a view
    assert _equal(parts[1], jq.conv_i8(jnp.asarray(xb), jnp.asarray(w8[:, :, 8:]), 1, pad))
    full = jq.conv_i8(jnp.asarray(np.concatenate([xa, xb], -1)), jnp.asarray(w8), 1, pad)
    assert _equal(parts[0] + parts[1], full)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_i8_dequant_is_the_layers_formula(dtype):
    """The fused epilogue's plain version is JAX's
    cast(acc.astype(f32) * (sx * scale), dtype), bit for bit."""
    rng = np.random.default_rng(6)
    x8 = rng.integers(-127, 128, (2, 6, 7, 16)).astype(np.int8)
    w8 = rng.integers(-127, 128, (3, 3, 16, 9)).astype(np.int8)
    sx, scale = np.float32(0.013), rng.uniform(1e-3, 1e-2, 9).astype(np.float32)
    acc = jq.conv_i8(jnp.asarray(x8), jnp.asarray(w8), 1, 1)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    ref = (acc.astype(jnp.float32) * (jnp.float32(sx) * jnp.asarray(scale))).astype(jdt)
    got = tq.conv_i8(_t(x8), _t(w8), 1, 1, torch.tensor(sx) * _t(scale), dtype)
    assert got.dtype == dtype
    assert np.array_equal(got.float().numpy(), np.asarray(ref).astype(np.float32))


@pytest.mark.parametrize("hw,out", [((5, 7), (9, 13)), ((4, 4), (8, 8)), ((3, 6), (5, 12))])
def test_quantize_coarse_then_upsample_equals_fine(hw, out):
    """Quantizing at coarse resolution then nearest-upsampling the int8
    values equals quantizing the upsampled tensor with the same scale,
    odd ceil-crops included, in the port as in JAX."""
    x = (4 * np.random.default_rng(2).standard_normal((2, *hw, 3))).astype(np.float32)
    _, sx = tq.quantize_act(_t(x))
    coarse = upsample_nearest2(tq.quantize_act(_t(x), sx)[0], *out)
    fine = tq.quantize_act(upsample_nearest2(_t(x), *out), sx)[0]
    assert torch.equal(coarse, fine)
    ref = jax_up2(jq.quantize_act(jnp.asarray(x), jnp.float32(sx))[0], *out)
    assert _equal(coarse, ref)


# --- the layers under int8 -------------------------------------------------

def _q_tree(p):
    """JAX's quantize_params of a numpy tree, back to numpy."""
    return _np(jq.quantize_params(jax.tree.map(jnp.asarray, p)))


def _bf16(a):
    return a.astype(ml_dtypes.bfloat16)


def _close(got, ref, dtype):
    """f32: both sides compute the same int32 sums and the same rounded
    dequant, so the outputs are equal up to the f32 bias add's order
    (none) and a quantize that an input a rounding apart flips (none at
    these sizes: measured equal). bf16 rounds the same f32 values, also
    equal; the bound allows one bf16 step of the output's scale."""
    ref = np.asarray(ref).astype(np.float32)
    got = got.detach().float().numpy()
    atol = (2.0 ** -8 if dtype == "bf16" else 1e-6) * np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=atol)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k,stride,pad", [(3, 1, 1), (1, 1, 0), (7, 2, 3)])
def test_conv_int8_matches_jax(k, stride, pad, dtype):
    """Conv.forward on a quantized kernel: the raw (f32) input quantized
    with no cast first, dequantized to the compute dtype, bias added."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (None, None)
    jl = jnn.Conv(5, 7, k, stride, pad, dtype=jdt)
    p, _ = _np(jl.init(jax.random.PRNGKey(k)))
    p["b"] = np.random.default_rng(3).normal(0, 0.5, 7).astype(np.float32)
    pq = _q_tree(p)
    x = np.random.default_rng(k).standard_normal((2, 11, 9, 5), dtype=np.float32)
    ref, _ = jl.apply(pq, {}, jnp.asarray(x))
    tl = load_jax_tree(tnn.Conv(5, 7, k, stride, pad, compute_dtype=tdt), pq, {})
    assert tl.quantized and tl.sx is None and not hasattr(tl, "w")
    with torch.no_grad():
        got = tl(torch.from_numpy(x))
    assert got.dtype == (tdt or torch.float32)
    _close(got, ref, dtype)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_convtranspose_stays_float_under_int8(dtype):
    """The U-Nets' 2x2/2 transposed conv is not quantized on either side
    (``quantize_params`` skips 2x2 kernels, `quantize_model` takes only
    `Conv`s), so a quantized tree carries its float kernel through the
    bridge and the forward matches JAX as the float one does; a quantized
    kernel dict on it is refused at the bridge."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (None, None)
    jl = jnn.ConvTranspose(4, 3, dtype=jdt)
    p, _ = _np(jl.init(jax.random.PRNGKey(0)))
    pq = _np(jq.quantize_params(p))
    assert isinstance(pq["w"], np.ndarray) and np.array_equal(pq["w"], p["w"])
    x = np.random.default_rng(0).standard_normal((2, 8, 8, 4), dtype=np.float32)
    ref, _ = jl.apply(pq, {}, jnp.asarray(x))
    tl = tq.quantize_model(tnn.ConvTranspose(4, 3, compute_dtype=tdt))
    assert isinstance(tl.w, torch.nn.Parameter) and "w8" not in tl._buffers
    load_jax_tree(tl, pq, {})
    with torch.no_grad():
        got = tl(torch.from_numpy(x))
    assert got.shape == ref.shape == (2, 16, 16, 3)
    # the same f32 (or bf16-operand) transposed conv, summed in other orders
    ref = np.asarray(ref).astype(np.float32)
    tol = 2.0 ** -7 if dtype == "bf16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(), ref, rtol=0, atol=tol * np.abs(ref).max())
    with pytest.raises(KeyError, match="quantized kernel goes only onto a Conv"):
        load_jax_tree(tnn.ConvTranspose(4, 3), dict(p, w=_np(jq.quantize_kernel(p["w"]))), {})


def _qpair(c_in, c_out, k, seed, jdt=None, tdt=None):
    """A JAX ConvBN on a quantized tree and the port's, quantized by the
    bridge from that tree."""
    jl = jnn.ConvBN(c_in, c_out, k, 1, relu=True, dtype=jdt)
    p, s = _jitter_bn(*_np(jl.init(jax.random.PRNGKey(seed))), seed=seed)
    pq = _q_tree(p)
    tl = load_jax_tree(tnn.ConvBN(c_in, c_out, k, compute_dtype=tdt).eval(), pq, s)
    return jl, pq, s, tl


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(PART_CASES))
def test_conv_parts_int8_matches_jax(case, dtype):
    """ConvBN.apply_parts on a quantized conv, dynamic scales: each part
    its own slot and slice of w8, the "up" part quantized coarse and
    upsampled as int8 (also for odd partners), parts summed in the
    compute dtype."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (None, None)
    hws, cs, k = PART_CASES[case]
    pyr = _pyr(hws, cs, seed=1)
    if dtype == "bf16":
        pyr = [_bf16(a) for a in pyr]
    mixed = jmg.pyramid_widths_after_exchange(cs)
    for i in range(len(cs)):
        jl, pq, s, tl = _qpair(mixed[i], 6, k, seed=i, jdt=jdt, tdt=tdt)
        ref, _ = jl.apply_parts(pq, s, jmg.exchange_parts(tuple(map(jnp.asarray, pyr)), i))
        tpyr = tuple(torch.from_numpy(a.astype(np.float32)) for a in pyr)
        if dtype == "bf16":
            tpyr = tuple(a.bfloat16() for a in tpyr)
        with torch.no_grad():
            got = tl.apply_parts(tmg.exchange_parts(tpyr, i))
        assert got.dtype == (tdt or torch.float32)
        _close(got, ref, dtype)


def _scales_of(x):
    """Three pyramid scales cut from one NHWC array (strided slices, exact
    on both sides): (8x8x5, 4x4x4, 2x2x3) from (n, 8, 8, 12). JAX's
    calibrate hands the model one array a batch."""
    return (x[..., :5], x[:, ::2, ::2, 5:9], x[:, ::4, ::4, 9:12])


class _JaxParts:
    """A JAX ConvBN fed the exchange parts of scale 1."""

    def __init__(self, layer):
        self.layer = layer

    def apply(self, p, s, x, *, train=False, rng=None):
        return self.layer.apply_parts(p, s, jmg.exchange_parts(_scales_of(x), 1), train=train)


class _PortParts(torch.nn.Module):
    def __init__(self, layer):
        super().__init__()
        self.layer = layer

    def forward(self, x):
        return self.layer.apply_parts(tmg.exchange_parts(_scales_of(x), 1))


def _batch(rng, n=2):
    """Each scale its own magnitude, so the three slots differ."""
    mag = np.repeat(np.float32([1.0, 3.0, 0.5]), [5, 4, 3])
    return (rng.standard_normal((n, 8, 8, 12)) * mag).astype(np.float32)


def test_calibrate_gives_jax_scales_per_slot():
    """calibrate freezes, per conv and slot (down, same, up), the largest
    dynamic scale over the batches: JAX's sx, bit for bit; the static
    forward then equals JAX's static forward."""
    jl, pq, s, tl = _qpair(12, 6, 3, seed=4)
    rng = np.random.default_rng(8)
    batches = [_batch(rng) for _ in range(3)]
    jq.calibrate(_JaxParts(jl), pq, s, batches)
    ref_sx = np.asarray(pq["conv"]["w"]["sx"])
    assert ref_sx.shape == (3,) and len(set(ref_sx.tolist())) == 3
    model = _PortParts(tl).eval()
    tq.calibrate(model, batches)
    assert _equal(tl.conv.sx, ref_sx)
    x = _batch(np.random.default_rng(9))
    ref, _ = _JaxParts(jl).apply(pq, s, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    _close(got, ref, "f32")
    # the bridge carries sx both ways
    assert _equal(torch.from_numpy(export_jax_tree(tl)[0]["conv"]["w"]["sx"]), ref_sx)
    again = load_jax_tree(tnn.ConvBN(12, 6, 3).eval(), pq, s)
    assert _equal(again.conv.sx, ref_sx)


def test_calibrate_drops_stale_scales():
    """A second pass re-records (a frozen scale would otherwise suppress
    the recording and make it a no-op), as JAX's drops its stale sx."""
    x = np.random.default_rng(10).standard_normal((2, 5, 5, 3), dtype=np.float32)
    conv = tq.quantize_model(tnn.Conv(3, 4))
    tq.calibrate(conv, [x])
    assert conv.sx.item() == np.float32(np.abs(x).max()) / np.float32(127)
    tq.calibrate(conv, [0.5 * x])
    assert conv.sx.item() == np.float32(np.abs(0.5 * x).max()) / np.float32(127)


class _JaxSlot1:
    """Reports a scale for slot 1 only."""

    def apply(self, p, s, x, *, train=False, rng=None):
        jq.record_scale(p["w"], 1, jnp.float32(0.5))
        return x, s


class _PortSlot1(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = tq.quantize_model(tnn.Conv(3, 4))

    def forward(self, x):
        tq.record_scale(self.conv, 1, torch.tensor(0.5))
        return x


def test_calibrate_errors_are_jax_errors():
    """Slots that are not 0..n-1 (a conv whose slots cannot be mapped to
    scales) raise JAX's AssertionError with its words (raised explicitly
    in the port, so it holds under python -O); a pass inside a running
    pass raises its RuntimeError."""
    x = np.zeros((1, 2, 2, 3), np.float32)
    q = {"w": jq.quantize_kernel(np.ones((3, 3, 3, 4), np.float32))}
    with pytest.raises(AssertionError) as ref:
        jq.calibrate(_JaxSlot1(), q, {}, [x])
    with pytest.raises(AssertionError) as got:
        tq.calibrate(_PortSlot1(), [x])
    assert str(got.value) == str(ref.value) == "non-contiguous calibration slots [1]"

    jq._CALIB = {}  # a JAX pass already running
    try:
        with pytest.raises(RuntimeError) as ref:
            jq.calibrate(_JaxSlot1(), q, {}, [x])
    finally:
        jq._CALIB = None
    model = _PortSlot1()
    model.conv.calibration = tq._Collector()  # a port pass already running on it
    with pytest.raises(RuntimeError) as got:
        tq.calibrate(model, [x])
    assert str(got.value) == str(ref.value) == "nested calibration passes"


@pytest.mark.parametrize("order", ["quantize-then-fold", "fold-then-quantize"])
def test_quantized_fold_matches_jax(order):
    """The fold of a quantized ConvBN scales ``scale`` by the BN's a and
    leaves w8 alone, as JAX's does; either order against the same order
    in JAX (a = gamma * rsqrt(var + eps) may differ in its last bit
    between the two: the fold test's bound of 1e-6, and w8 equal); each
    order serves what the unfolded quantized layer serves (JAX's own
    bound, tests/test_fold_bn.py)."""
    jl = jnn.ConvBN(4, 8, 3, relu=True)
    p, s = _jitter_bn(*_np(jl.init(jax.random.PRNGKey(5))), seed=5)
    x = np.random.default_rng(6).standard_normal((2, 9, 9, 4), dtype=np.float32)
    tl = load_jax_tree(tnn.ConvBN(4, 8, 3).eval(), p, s)
    if order == "quantize-then-fold":
        rp, _ = jax_fold(jl, _q_tree(p), s)
        w8 = tq.quantize_model(tl).conv.w8
        fold_batchnorm(tl)
        assert tl.conv.w8 is w8  # untouched
    else:
        fp, _ = jax_fold(jl, *jax.tree.map(jnp.asarray, (p, s)))
        rp = _q_tree(_np(fp))
        tq.quantize_model(fold_batchnorm(tl))
    got_p, _ = export_jax_tree(tl)
    np.testing.assert_array_equal(got_p["conv"]["w"]["w8"], np.asarray(rp["conv"]["w"]["w8"]))
    for got, ref in ((got_p["conv"]["w"]["scale"], rp["conv"]["w"]["scale"]),
                     (got_p["conv"]["b"], rp["conv"]["b"])):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-6, atol=1e-7)
    with torch.no_grad():
        folded = tl(torch.from_numpy(x))
    unfolded = load_jax_tree(tnn.ConvBN(4, 8, 3).eval(), _q_tree(p), s)
    with torch.no_grad():
        ref = unfolded(torch.from_numpy(x))
    np.testing.assert_allclose(folded.numpy(), ref.numpy(), atol=1e-4, rtol=1e-4)
