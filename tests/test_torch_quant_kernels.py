"""The int8 serving path's two kernels on the CPU, through their plain
versions (`mgtpu_torch.ops.quant.quant_i8`, the activation quantizer, and
`mgtpu_torch.ops.cuda_conv_i8.conv_i8` with its epilogue), against the
JAX package and against the torch sequence the layers ran before the
epilogue took it over; the K-major packed weight of the sm90 design and
its slice addressing; which design each int8 conv part of R-MG-34,
cifar/prnmg and unmg takes (`_route`, pinned). Inputs are seeded numpy
arrays handed to both sides. The kernels themselves run on the card:
`tests/test_torch_cuda.py` and `chip_smoke.py` hold them to these plain
versions."""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from chip_smoke import I8_PER_FORWARD, I8_ROUTES, I8_SERVE, i8_pins, i8_routes, record_kernel_shapes
from mgtpu import nn as jnn
from mgtpu.ops import mg as jmg
from mgtpu.ops import quant as jq
from mgtpu.ops.fold import fold_batchnorm as jax_fold
from mgtpu_torch import kernels
from mgtpu_torch import nn as tnn
from mgtpu_torch.ops import cuda_conv_i8 as ci8
from mgtpu_torch.ops import mg as tmg
from mgtpu_torch.ops import quant as tq
from mgtpu_torch.ops.fold import fold_batchnorm
from mgtpu_torch.utils.bridge import export_jax_tree, load_jax_tree
from test_torch_nn import PART_CASES, _jitter_bn, _np, _pyr
from test_torch_quant import _close, _q_tree

# values on the quantize's edges, in units of the scale: ties (to even),
# +-0, past +-127 steps, +-inf, NaN (0 on both sides)
SPECIALS = [0.5, 1.5, 2.5, -2.5, 0.0, -0.0, 126.5, -127.5, 300.0, -1e4, np.inf, -np.inf, np.nan]


def _act(shape, seed, specials=True):
    x = (40 * np.random.default_rng(seed).standard_normal(shape)).astype(np.float32)
    if specials:
        flat = x.reshape(-1)
        flat[:len(SPECIALS)] = SPECIALS
    return x


def _same(got: torch.Tensor, ref) -> bool:
    ref = np.asarray(ref)
    return got.dtype == torch.from_numpy(ref[:0].copy()).dtype and np.array_equal(
        got.numpy(), ref, equal_nan=True)


# (n, h, w, c, up): a "same" part, "up" parts with exact, odd and mixed
# crops, a 3-channel stem image, a 1x1 map upsampled
QUANT_CASES = [(2, 7, 7, 32, None), (2, 4, 4, 16, (8, 8)), (1, 5, 7, 24, (9, 13)),
               (2, 3, 6, 16, (5, 12)), (1, 9, 9, 3, None), (2, 1, 1, 64, (2, 2))]


@pytest.mark.parametrize("case", QUANT_CASES, ids=str)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["static", "dynamic", "dynamic-finite"])
def test_quant_i8_plain_equals_jax(case, dtype, mode):
    """The quantizer's plain version equals JAX's quantize_act, then
    materialize_part for an "up" part, bit for bit: x8 and the scale,
    with ties, +-0, values past +-127*sx, +-inf and a NaN in the input
    (a NaN quantizes to 0; under a dynamic scale a NaN or an inf makes
    the scale NaN or inf and every value 0, on both sides). A static
    scale of 0.25 puts the specials on exact quarter steps."""
    n, h, w, c, up = case
    x = _act((n, h, w, c), seed=c + h)
    if mode == "static":
        x.reshape(-1)[:len(SPECIALS)] *= 0.25
    if mode == "dynamic-finite":
        x = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
    if dtype == "bf16":
        x = x.astype(ml_dtypes.bfloat16)
    sx = np.float32(0.25) if mode == "static" else None
    ref8, ref_sx = jq.quantize_act(jnp.asarray(x), None if sx is None else jnp.float32(sx))
    if up is not None:
        ref8 = jmg.materialize_part("up", ref8, *up)
    xt = torch.from_numpy(x.astype(np.float32))
    xt = xt.bfloat16() if dtype == "bf16" else xt
    got8, got_sx = tq.quant_i8(xt, None if sx is None else torch.tensor(sx), up)
    assert _same(got8, ref8)
    assert _same(got_sx.reshape(1), np.asarray(ref_sx, np.float32).reshape(1))
    if mode == "dynamic-finite":
        assert np.isfinite(float(got_sx)) and got8.abs().max() == 127


def test_quant_i8_plain_is_quantize_act_then_upsample():
    """quant_i8 on a CPU tensor is quant_i8_plain, which is quantize_act
    followed by upsample_nearest2: the layers' sequence before the kernel
    took it over."""
    x = torch.from_numpy(_act((2, 5, 6, 16), seed=3))
    sx = torch.tensor(0.5)
    got8, got_sx = tq.quant_i8(x, sx, (9, 12))
    ref8, _ = tq.quantize_act(x, sx)
    assert got_sx is sx and torch.equal(got8, tq.upsample_nearest2(ref8, 9, 12))


def _operands(seed, n=2, h=7, w=9, ci=16, co=12, k=3, ci_total=48, ofs=16):
    rng = np.random.default_rng(seed)
    x8 = torch.from_numpy(rng.integers(-127, 128, (n, h, w, ci)).astype(np.int8))
    wide = torch.from_numpy(rng.integers(-127, 128, (k, k, ci_total, co)).astype(np.int8))
    v = torch.from_numpy(rng.uniform(1e-4, 1e-3, co).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.5, co).astype(np.float32))
    return x8, wide[:, :, ofs:ofs + ci], wide, v, torch.tensor(np.float32(0.0371)), bias


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("variant", ["dequant", "part-sum", "bias", "all"])
def test_conv_i8_epilogue_equals_the_torch_sequence(dtype, variant):
    """conv_i8's epilogue (plain version, CPU) equals, bit for bit, the
    sequence the int8 layers ran as torch ops: the dequant with sx *
    scale, the part sum ``y + yy`` and the bias ``y + b.to(dtype)`` in the
    compute dtype, then the ReLU; the running sum y_in takes the result."""
    x8, w8, wide, v, sx, bias = _operands(4)
    acc = ci8.conv_i8_plain(x8, w8, 1, 1)
    y_prev = torch.randn(acc.shape, generator=torch.Generator().manual_seed(1)).to(dtype)
    kw = {"part-sum": dict(y_in=y_prev.clone()), "bias": dict(bias=bias),
          "all": dict(y_in=y_prev.clone(), bias=bias, relu=True)}.get(variant, {})
    got = ci8.conv_i8(x8, w8, 1, 1, v, dtype, sx=sx, wk=ci8.pack_weight(wide), **kw)
    want = (acc.float() * (sx * v)).to(dtype)
    if "y_in" in kw:
        want = y_prev + want
        assert got.data_ptr() == kw["y_in"].data_ptr()
    if "bias" in kw:
        want = want + bias.to(dtype)
    if kw.get("relu"):
        want = torch.relu(want)
    assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_i8_dequant_of_v_alone_is_the_old_formula(dtype):
    """Without sx the dequant vector is v itself (the kernel multiplies by
    1.0, which is exact): cast(float(acc) * v), the form without a scale."""
    x8, w8, _, v, _, _ = _operands(5)
    acc = ci8.conv_i8_plain(x8, w8, 1, 1)
    assert torch.equal(ci8.conv_i8(x8, w8, 1, 1, v, dtype), (acc.float() * v).to(dtype))
    assert torch.equal(ci8.conv_i8(x8, w8, 1, 1, v, dtype, sx=torch.tensor(1.0)),
                       (acc.float() * v).to(dtype))


def test_conv_i8_refuses_epilogue_operands_without_a_dequant():
    x8, w8, _, v, sx, bias = _operands(6)
    for kw in (dict(sx=sx), dict(bias=bias), dict(relu=True)):
        with pytest.raises(TypeError, match="need a dequantized output"):
            ci8.conv_i8(x8, w8, 1, 1, **kw)


def _folded_qpair(c_in, c_out, k, seed, jdt=None, tdt=None):
    """A JAX ConvBN folded then quantized, and the port's, loaded through
    the bridge from that tree (BN folded: the identity in eval mode)."""
    jl = jnn.ConvBN(c_in, c_out, k, 1, relu=True, dtype=jdt)
    p, s = _jitter_bn(*_np(jl.init(jax.random.PRNGKey(seed))), seed=seed)
    fp, fs = jax_fold(jl, *jax.tree.map(jnp.asarray, (p, s)))
    pq, fs = _q_tree(_np(fp)), _np(fs)
    tl = load_jax_tree(fold_batchnorm(tnn.ConvBN(c_in, c_out, k, compute_dtype=tdt).eval()),
                       pq, fs)
    return jl, pq, fs, tl


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(PART_CASES))
def test_fused_epilogue_exchange_matches_jax(case, dtype):
    """A BN-folded quantized ConvBN's exchange, with the part sums, the
    bias and the ReLU in its conv_i8 launches' epilogues, against the JAX
    layer's int8 branch (mgtpu/nn.py: quantize each part, int8 "up"
    parts, dequant, sum in the compute dtype, bias, folded BN, ReLU), at
    R-MG-18's exchange shapes narrowed; and against the port's own unfused
    path (conv_parts, then the identity BN and torch.relu), bit for bit."""
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if dtype == "bf16" else (None, None)
    hws, cs, k = PART_CASES[case]
    pyr = _pyr(hws, cs, seed=2)
    if dtype == "bf16":
        pyr = [a.astype(ml_dtypes.bfloat16) for a in pyr]
    mixed = jmg.pyramid_widths_after_exchange(cs)
    for i in range(len(cs)):
        jl, pq, fs, tl = _folded_qpair(mixed[i], 6, k, seed=10 + i, jdt=jdt, tdt=tdt)
        ref, _ = jl.apply_parts(pq, fs, jmg.exchange_parts(tuple(map(jnp.asarray, pyr)), i))
        tpyr = tuple(torch.from_numpy(a.astype(np.float32)) for a in pyr)
        if dtype == "bf16":
            tpyr = tuple(a.bfloat16() for a in tpyr)
        with torch.no_grad():
            got = tl.apply_parts(tmg.exchange_parts(tpyr, i))
            unfused = torch.relu(tl.bn(tl.conv_parts(tmg.exchange_parts(tpyr, i))))
        assert got.dtype == (tdt or torch.float32) and torch.equal(got, unfused)
        _close(got, ref, dtype)


# --- the K-major packed weight ---------------------------------------------

def test_pack_weight_addresses_every_slice():
    """pack_weight lays the HWIO weight out K-major, (Co, k*k*Ci) with slot
    tap * Ci + c; a part's slice [ofs, ofs + c) of each tap is found at
    row offset tap * Ci_total + ofs, which is how the sm90 design's tiled
    map addresses it (_slice gives Ci_total and ofs from the view)."""
    rng = np.random.default_rng(0)
    w8 = torch.from_numpy(rng.integers(-127, 128, (3, 3, 48, 10)).astype(np.int8))
    wk = ci8.pack_weight(w8)
    assert wk.shape == (10, 9 * 48) and wk.is_contiguous() and wk.dtype == torch.int8
    for ofs, c in ((0, 16), (16, 32), (32, 16)):
        part = w8[:, :, ofs:ofs + c]
        assert ci8._slice(part) == (48, ofs)
        rows = wk.view(10, 9, 48)[:, :, ofs:ofs + c]  # (Co, tap, c)
        assert torch.equal(rows, part.permute(3, 0, 1, 2).reshape(10, 9, c))
    stem = torch.from_numpy(rng.integers(-127, 128, (7, 7, 3, 4)).astype(np.int8))
    assert torch.equal(ci8.pack_weight(stem)[2, 3 * 10 + 1], stem[1, 3, 1, 2])


def test_packed_weight_is_rebuilt_with_w8():
    """Conv.set_quantized packs wk from w8 every time it sets w8 (the
    bridge and quantize_model go through it); wk is a non-persistent
    buffer: not in the state dict, not in the JAX tree."""
    conv = tq.quantize_model(tnn.Conv(16, 8))
    assert torch.equal(conv.wk, ci8.pack_weight(conv.w8))
    q = tq.quantize_kernel(torch.randn(3, 3, 16, 8, generator=torch.Generator().manual_seed(3)))
    conv.set_quantized(**q)
    assert conv.w8 is q["w8"] and torch.equal(conv.wk, ci8.pack_weight(q["w8"]))
    assert "wk" not in conv.state_dict() and "wk" in dict(conv.named_buffers())
    p, _ = export_jax_tree(conv)
    assert set(p["w"]) == {"w8", "scale"}
    tree = {"w": _np(jq.quantize_kernel(np.ones((3, 3, 16, 8), np.float32) * np.arange(8))),
            "b": np.zeros(8, np.float32)}
    load_jax_tree(conv, tree, {})
    assert torch.equal(conv.wk, ci8.pack_weight(conv.w8))
    assert torch.equal(conv.w8, torch.from_numpy(np.array(tree["w"]["w8"])))


# --- the designs the int8 forwards take --------------------------------------

def _want_design(key) -> str:
    """The design a recorded conv_i8 part takes (x aligned): sm90 for
    3x3/s1/p1 with Ci, Co, the weight's Ci and the slice's offset
    multiples of 16; stem for Ci < 16 with k * k * Ci <= 160 and Co 16,
    32 or 64; 1x1 for 1x1/s1/p0 with those multiples of 16; else simple."""
    h, w, ci, co, k, stride, pad, ci_total, ofs = key[:9]
    sixteens = all(n % 16 == 0 for n in (ci, co, ci_total, ofs))
    if (k, stride, pad) == (3, 1, 1) and sixteens:
        return "sm90"
    if ci < 16 and k * k * ci <= 160 and co in (16, 32, 64):
        return "stem"
    return "1x1" if (k, stride, pad) == (1, 1, 0) and sixteens else "simple"


@pytest.mark.parametrize("net", sorted(I8_SERVE))
def test_int8_conv_routes_are_pinned(net):
    """_route sends each recorded int8 conv part of the net's serving
    forward to the pinned design: sm90 for the 3x3/s1/p1 parts whose Ci,
    Co, weight width and slice offset are multiples of 16 (all of
    R-MG-34's but its three 7x7/2 stems), stem for the stems on 3 and 1
    channels, 1x1 for cifar/prnmg's 1x1 shortcuts and heads, simple for
    the rest (unmg's 1x1 heads on 10 channels); the quantizer once a
    layer, its group of parts (twice under dynamic scales). The stem
    and 1x1 cases of tests/test_torch_cuda.py are exactly the parts that
    those two designs take."""
    from test_torch_cuda import I8_STEM_1X1

    shapes = record_kernel_shapes(False, I8_SERVE[net][0], int8=True)
    assert sorted(I8_STEM_1X1[net]) == sorted(
        key[:9] for key in shapes["conv_i8"] if _want_design(key) in ("stem", "1x1"))
    assert i8_routes(shapes["conv_i8"]) == I8_ROUTES[net]
    assert sum(I8_ROUTES[net].values()) == I8_PER_FORWARD[net]["conv_i8"]
    assert set(I8_ROUTES[net]) == set(ci8.DESIGNS) == {
        r for k, r in kernels.ROUTES if k == "conv_i8"} == {
        r for k, r in kernels.PADDED if k == "conv_i8"}
    for key, _ in shapes["conv_i8"].items():
        h, w, ci, co, k, stride, pad, ci_total, ofs = key[:9]
        x8 = torch.empty((1, h, w, ci), dtype=torch.int8)
        w8 = torch.empty((k, k, ci_total, co), dtype=torch.int8)[:, :, ofs:ofs + ci]
        assert ci8._route(x8, w8, stride, pad, ci8.pack_weight(
            torch.empty((k, k, ci_total, co), dtype=torch.int8))) == _want_design(key), key
    assert sum(shapes["quant_i8"].values()) == i8_pins(net)["quant_i8"]
    assert i8_pins(net, dynamic=True)["quant_i8"] == 2 * i8_pins(net)["quant_i8"]
    # one part sum and one bias: every part but a conv's first takes y_in,
    # its last the bias
    n_bias = sum(n for key, n in shapes["conv_i8"].items() if key[10])
    n_first = sum(n for key, n in shapes["conv_i8"].items() if not key[9])
    assert n_bias == n_first > 0


def test_route_takes_misaligned_x_and_odd_slices_to_simple():
    """x off a 16-byte boundary, a slice at an offset or of a weight width
    that is not a multiple of 16, Ci or Co not a multiple of 16, or no
    3x3/s1/p1: the simple design."""
    wide = torch.empty((3, 3, 48, 32), dtype=torch.int8)
    wk = ci8.pack_weight(wide)
    x = torch.empty((1, 7, 7, 16), dtype=torch.int8)
    assert ci8._route(x, wide[:, :, 16:32], 1, 1, wk) == "sm90"
    assert ci8._route(x, wide[:, :, 16:32], 1, 1) == "sm90"  # packed per call
    flat = torch.empty(7 * 7 * 16 + 16, dtype=torch.int8)
    off = next(i for i in range(1, 16) if (flat.data_ptr() + i) % 16)
    assert ci8._route(flat[off:off + 784].view(1, 7, 7, 16), wide[:, :, 16:32], 1, 1,
                      wk) == "simple"
    assert ci8._route(x, wide[:, :, 8:24], 1, 1, wk) == "simple"
    assert ci8._route(x, wide[:, :, 16:32], 2, 1, wk) == "simple"
    assert ci8._route(torch.empty((1, 7, 7, 24), dtype=torch.int8), wide[:, :, 16:40], 1, 1,
                      wk) == "simple"
    narrow = torch.empty((3, 3, 16, 10), dtype=torch.int8)
    assert ci8._route(x, narrow, 1, 1, ci8.pack_weight(narrow)) == "simple"


def _x_at(shape, off):
    """An int8 tensor of ``shape`` whose data starts ``off`` bytes past a
    16-byte boundary"""
    n = int(np.prod(shape))
    flat = torch.empty(n + 32, dtype=torch.int8)
    start = next(i for i in range(32) if (flat.data_ptr() + i) % 16 == off)
    return flat[start:start + n].view(shape)


def test_route_takes_the_stems_and_1x1_parts_to_their_designs():
    """Ci = 16 at 3x3/s1/p1 goes to sm90, not stem; a 7x7/2 on 3 channels
    and a 3x3 on 1 to stem at any byte offset of x; a 1x1 with Ci and Co
    multiples of 16 to 1x1, and to simple with x off 16 bytes or Co = 10;
    past the stem's limits (Ci 16, more than 160 taps x channels, Co 48
    or 128, a map too wide for a block's shared memory) to simple."""
    w3 = torch.empty((7, 7, 3, 64), dtype=torch.int8)
    for off in (0, 4, 7, 13):
        assert ci8._route(_x_at((1, 224, 224, 3), off), w3, 2, 3) == "stem"
        assert ci8._route(_x_at((1, 64, 64, 1), off),
                          torch.empty((3, 3, 1, 16), dtype=torch.int8), 1, 1) == "stem"
    assert ci8._route(_x_at((1, 14, 14, 16), 0),
                      torch.empty((3, 3, 16, 32), dtype=torch.int8), 1, 1) == "sm90"
    wide = torch.empty((1, 1, 896, 384), dtype=torch.int8)
    wk = ci8.pack_weight(wide)
    assert ci8._route(_x_at((4, 1, 1, 384), 0), wide[:, :, 512:], 1, 0, wk) == "1x1"
    assert ci8._route(_x_at((4, 1, 1, 384), 0), wide[:, :, 512:], 1, 0) == "1x1"
    assert ci8._route(_x_at((4, 1, 1, 384), 4), wide[:, :, 512:], 1, 0, wk) == "simple"
    assert ci8._route(_x_at((4, 1, 1, 384), 0), wide[:, :, 504:888], 1, 0, wk) == "simple"
    assert ci8._route(_x_at((2, 8, 8, 32), 0),
                      torch.empty((1, 1, 32, 10), dtype=torch.int8), 1, 0) == "simple"
    for x, w, s, p in (((1, 9, 9, 16), (3, 3, 16, 16), 2, 1),   # Ci 16, stride 2
                       ((1, 20, 20, 4), (7, 7, 4, 16), 2, 3),    # 196 taps x channels
                       ((1, 20, 20, 3), (7, 7, 3, 48), 2, 3),    # Co 48
                       ((1, 20, 20, 3), (7, 7, 3, 128), 2, 3),
                       ((1, 9, 8000, 3), (7, 7, 3, 64), 2, 3)):  # rows too wide
        assert ci8._route(_x_at(x, 0), torch.empty(w, dtype=torch.int8), s, p) == "simple", x
    assert not ci8._stem_takes(8000, 3, 64, 7, 2, 3) and ci8._stem_takes(224, 3, 64, 7, 2, 3)


def _stem_gather(x8, k, s, p, pt, pb, co, off, rng, reverse=False):
    """The A operand the stem kernel multiplies, (N, OH*OW, 32 * steps)
    bytes, rebuilt in numpy from the host's plan as conv_i8_stem.cu uses
    it: x placed ``off`` bytes past a 16-byte boundary among random bytes;
    each tile's patch buffer full of random bytes, then each input row's
    bulk copy (its bytes aligned down and up to 16, at a 16-byte boundary
    of the buffer; ``reverse``: rows in the other order, as the copies
    land in no order), then the zeroing of what taps read outside x; then
    each pixel's slot groups at its base plus the plan's offsets. Checks
    the copies' alignment and that they stay within the buffer."""
    n, h, w, ci = x8.shape
    plan = ci8._stem_plan(w, ci, co, k, s, p, 2)
    oh, ow = ci8.out_size(h, k, s, pt, pb), ci8.out_size(w, k, s, p)
    row = w * ci
    mem = rng.integers(0, 256, off + x8.size + 64).astype(np.uint8)
    mem[off:off + x8.size] = x8.reshape(-1).view(np.uint8)
    groups = np.zeros(8 * plan.steps, np.int64)
    for st in range(plan.steps):
        for t in range(4):
            for hh in range(2):
                groups[8 * st + 4 * hh + t] = plan.off[(st * 4 + t) * 2 + hh]
    a = np.zeros((n, oh * ow, 32 * plan.steps), np.uint8)
    for img in range(n):
        for q0 in range(0, oh * ow, ci8._STEM_TILE):
            q1 = min(q0 + ci8._STEM_TILE, oh * ow)
            oh0 = q0 // ow
            rows = ((q1 - 1) // ow - oh0) * s + k
            assert rows <= plan.rows
            ih0 = oh0 * s - pt
            src0 = off + (img * h + ih0) * row
            c0 = plan.lead + src0 % 16
            # the buffer and what the kernel may read past its end
            buf = rng.integers(0, 256, plan.patch_bytes + 64).astype(np.uint8)
            inside = [r for r in range(rows) if 0 <= ih0 + r < h]
            for r in reversed(inside) if reverse else inside:
                src = src0 + r * row
                first = src - src % 16
                length = -(-(src + row - first) // 16) * 16
                dst = r * plan.pitch + c0 - (src - first)
                assert dst % 16 == 0 and 0 <= dst and dst + length <= plan.patch_bytes
                buf[dst:dst + length] = mem[first:first + length]
            for r in range(rows):
                d = r * plan.pitch + c0
                assert d - plan.lm >= 0 and d + row + plan.rm <= plan.patch_bytes
                if r in inside:
                    buf[d - plan.lm:d] = 0
                    buf[d + row:d + row + plan.rm] = 0
                else:
                    buf[d - plan.lm:d + row + plan.rm] = 0
            q = np.arange(q0, q1)
            base = c0 + (q // ow - oh0) * s * plan.pitch + (q % ow * s - p) * ci
            idx = base[:, None, None] + groups[None, :, None] + np.arange(4)[None, None, :]
            assert idx.min() >= 0 and idx.max() < buf.size
            a[img, q0:q1] = buf[idx].reshape(q1 - q0, -1)
    return a.view(np.int8), plan


# (n, h, w, ci, co, k, stride, pad) with H cut: the zoo's stems (R-MG-34's
# 7x7/2 at its three widths, cifar/prnmg's and unmg's 3x3 on 3 and 1
# channels) and a 5x5 on 2 channels of a 7-px row (14 bytes a row)
STEM_PLAN_CASES = [(2, 20, 224, 3, 64, 7, 2, 3), (1, 13, 112, 3, 32, 7, 2, 3),
                   (2, 30, 56, 3, 16, 7, 2, 3), (2, 12, 32, 3, 64, 3, 1, 1),
                   (2, 9, 8, 3, 16, 3, 1, 1), (2, 10, 64, 1, 64, 3, 1, 1),
                   (3, 9, 7, 2, 16, 5, 1, 2)]


@pytest.mark.parametrize("case", STEM_PLAN_CASES, ids=lambda c: "x".join(map(str, c)))
@pytest.mark.parametrize("off", [0, 4, 7, 13])
def test_stem_plan_gathers_im2col(case, off):
    """The stem design's plan (cuda_conv_i8._stem_plan) walked as the
    kernel walks it, in numpy: for every tile, under the plain padding
    and the halo pads of an H-slab, x at byte offsets 0, 4, 7 and 13 and
    the rows' copies landing in either order, each pixel's gathered
    slots kh * run + kw * Ci + c hold numpy's im2col of the zero-padded x
    (the padding slots past k * Ci read anything: their weight is 0)."""
    n, h, w, ci, co, k, s, p = case
    rng = np.random.default_rng(hash(case) % 2**32 + off)
    x8 = rng.integers(-128, 128, (n, h, w, ci)).astype(np.int8)
    pads = [(p, p)] + ([(0, p), (p, 0), (1, p - 1)] if p > 1 else [(1, 0), (0, 1), (0, 0)])
    for pt, pb in pads:
        xp = np.pad(x8, ((0, 0), (pt, pb), (p, p), (0, 0)))
        oh, ow = ci8.out_size(h, k, s, pt, pb), ci8.out_size(w, k, s, p)
        cols = np.stack([xp[:, i * s:i * s + k, j * s:j * s + k, :]
                         for i in range(oh) for j in range(ow)], axis=1)  # (n, oh*ow, k, k, ci)
        for reverse in (False, True):
            a, plan = _stem_gather(x8, k, s, p, pt, pb, co, off, rng, reverse)
            assert plan.steps * 32 >= k * plan.run and plan.run % 4 == 0
            for kh in range(k):
                got = a[:, :, kh * plan.run:kh * plan.run + k * ci]
                np.testing.assert_array_equal(got, cols[:, :, kh].reshape(n, oh * ow, k * ci),
                                              err_msg=f"pads {(pt, pb)} row {kh}")
