"""The int8 activation quantizer's group design on the CPU: every
quantized-conv input of a multigrid layer in one call
(`mgtpu_torch.ops.quant.quant_i8_group`, through its plain version
`quant_i8_group_plain` here).

- The plain group against JAX's ``quantize_act`` and the int8 nearest
  upsample of an "up" part, member by member, and against the per-part
  ``quant_i8_plain``, bit for bit; its one ``mesh_absmax`` a group.
- The kernels' work plan (`_group_plan`, `_group_table`): a numpy walk of
  ``group_quant_kernel``'s index math over the table, tile by tile,
  gives the plain group's int8 values; every item is covered once.
- The ``mgtpu::quant_i8_group`` op and its fake.
- The int8 forwards of narrowed R-MG, ``cifar/prnmg`` and ``unmg``
  (tests/test_torch_int8_axis.py's plans), whose layers quantize in one
  group call each: bit for bit the forward that quantizes part by part
  (the layers before the group design), with the same calibrated scales,
  and within tests/test_torch_int8_serve.py's bound of JAX's eager int8
  forward; one multigrid layer's calibrated scales JAX's bit for bit.

Inputs are seeded numpy arrays handed to both sides. The kernels
themselves run on the card: `tests/test_torch_cuda.py` and
`chip_smoke.py` hold them to the plain group."""

import contextlib
import types

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from chip_smoke import I8_SERVE, record_kernel_shapes
from mgtpu.ops import mg as jmg
from mgtpu.ops import quant as jq
from mgtpu_torch.ops import mg as tmg
from mgtpu_torch.ops import quant as tq
from test_torch_int8_axis import NETS, _jax_model, _narrow, _opts
from test_torch_quant_kernels import SPECIALS, _act, _same

# (n, h, w, c, up): a "same" part, "up" parts with exact, odd and mixed
# crops, a 3-channel stem image, a 1x1 map upsampled, C not a multiple of 16
TABLE = [(2, 7, 7, 32, None), (2, 4, 4, 16, (8, 8)), (2, 5, 7, 24, (9, 13)),
         (2, 9, 9, 3, None), (2, 1, 1, 64, (2, 2)), (2, 3, 6, 5, (5, 12))]
MODES = ["static", "dynamic", "dynamic-finite"]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _members(mode, dtype, seed=0, table=TABLE):
    """[(x numpy, x torch, sx numpy or None, up)] of one table: values
    led by SPECIALS (without them past the first member under
    "dynamic-finite": no inf or NaN); static scales that put the
    specials on exact steps."""
    out = []
    for j, (n, h, w, c, up) in enumerate(table):
        x = _act((n, h, w, c), seed=seed + j)
        sx = None
        if mode == "static":
            x.reshape(-1)[:len(SPECIALS)] *= 0.25 * (j + 1)
            sx = np.float32(0.25 * (j + 1))
        if mode == "dynamic-finite":
            x = np.nan_to_num(x, nan=0.0, posinf=0.0, neginf=0.0)
        if dtype == "bf16":
            x = x.astype(ml_dtypes.bfloat16)
        xt = torch.from_numpy(x.astype(np.float32))
        out.append((x, xt.bfloat16() if dtype == "bf16" else xt, sx, up))
    return out


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", MODES)
def test_group_plain_equals_jax_member_by_member(mode, dtype):
    """quant_i8_group on CPU tensors (the plain group) gives each member
    JAX's quantize_act of it (its own scale: static, or its own absmax
    over 127), then materialize_part for an "up" part, bit for bit:
    ties, +-0, values past +-127*sx, +-inf and NaN (0), same and up
    parts in one table, a 1x1 map upsampled. A given scale comes back as
    it was given."""
    members = _members(mode, dtype)
    sxs = [None if sx is None else torch.tensor(sx) for _, _, sx, _ in members]
    got = tq.quant_i8_group([(xt, sx, up) for (_, xt, _, up), sx in zip(members, sxs)])
    for (x, _, sx, up), (x8, s), given in zip(members, got, sxs):
        ref8, ref_sx = jq.quantize_act(jnp.asarray(x), None if sx is None else jnp.float32(sx))
        if up is not None:
            ref8 = jmg.materialize_part("up", ref8, *up)
        assert _same(x8, ref8)
        assert _same(s.reshape(1), np.asarray(ref_sx, np.float32).reshape(1))
        assert given is None or s is given
    if mode == "dynamic-finite":
        assert all(np.isfinite(float(s)) and x8.abs().max() == 127 for x8, s in got)


@pytest.mark.parametrize("mode", MODES)
def test_group_plain_equals_per_part_plain(mode):
    """The plain group is quant_i8_plain member by member, bit for bit,
    and quant_i8 (one quantize) is a group of one; static and dynamic
    members may share a table."""
    members = [(xt, None if sx is None else torch.tensor(sx), up)
               for _, xt, sx, up in _members(mode, "bf16", seed=7)]
    if mode == "static":  # one dynamic member among the static ones
        members[2] = (members[2][0], None, members[2][2])
    got = tq.quant_i8_group_plain(members)
    for (x, sx, up), (x8, s) in zip(members, got):
        ref8, ref_s = tq.quant_i8_plain(x, sx, up)
        one8, one_s = tq.quant_i8(x, sx, up)
        assert torch.equal(x8, ref8) and torch.equal(one8, ref8)
        assert torch.equal(s.isnan(), ref_s.isnan()) and torch.equal(s.nan_to_num(),
                                                                     ref_s.nan_to_num())
        assert torch.equal(one_s.nan_to_num(), ref_s.nan_to_num())


def test_group_reduces_its_absmaxes_once(monkeypatch):
    """A group's dynamic absmaxes go to mesh_absmax once, as one vector
    (one all-reduce a layer across ranks); what it returns, here another
    rank's larger max, sets the scales, and the static members keep
    theirs."""
    members = [(xt, None if j % 2 else torch.tensor(0.5), up)
               for j, (_, xt, _, up) in enumerate(_members("dynamic-finite", "f32", seed=3))]
    other = torch.tensor([1e3, 0.0, 2e3])  # another rank's absmaxes of the dynamic three
    calls = []

    def reduce(absmax):
        calls.append(absmax.clone())
        return absmax.copy_(torch.maximum(absmax, other))

    monkeypatch.setattr(tq, "mesh_absmax", reduce)
    got = tq.quant_i8_group(members)
    assert len(calls) == 1 and calls[0].shape == (3,)
    dynamic = [m for m in members if m[1] is None]
    assert torch.equal(calls[0], torch.stack([x.abs().amax() for x, _, _ in dynamic]))
    for j, ((x, sx, up), (x8, s)) in enumerate(zip(members, got)):
        want = sx if sx is not None else torch.clamp_min(
            torch.maximum(x.abs().amax(), other[j // 2]) / torch.tensor(127.0), 1e-12)
        assert torch.equal(s, want)
        assert torch.equal(x8, tq.quant_i8_plain(x, want, up)[0])
    monkeypatch.undo()
    assert torch.equal(tq.quant_i8_group(members[1:2])[0][1], tq.quant_i8(*members[1])[1])


def _walk(table, members):
    """group_quant_kernel's index math over one member table, in numpy: for
    each block of the grid, its tiles blockIdx.x + k * gridDim.x; in each,
    every thread's items base + k * THREADS (k < per_thread) of the
    tile's member, read at item * G of the flat x (G 16 or 1) and stored
    at the flat item (no up) or to each output pixel of the input pixel's
    2x2 block inside the crop (up). Returns the int8 outputs and each
    member's count of item visits."""
    T = tq.GROUP_THREADS
    outs = [np.zeros((m.n, m.oh, m.ow, m.c), np.int8) for m in table.m[:table.count]]
    visits = [np.zeros(m.items, np.int64) for m in table.m[:table.count]]
    tile0 = [table.m[j].tile0 for j in range(table.count)]
    for tl in range(table.tiles):
        j = max(k for k in range(table.count) if tl >= tile0[k])
        m, (x, sx, _) = table.m[j], members[j]
        g = 16 if m.vec else 1
        xs = x.float().reshape(-1)
        q = tq.quant_i8_plain(xs, sx)[0].numpy() if sx is not None else None
        thread = np.arange(T)
        for k in range(table.per_thread):
            item = (tl - m.tile0) * table.per_thread * T + thread + k * T
            item = item[item < m.items]
            visits[j][item] += 1
            vals = q[item[:, None] * g + np.arange(g)]  # (items, G)
            out = outs[j].reshape(-1)
            if not m.up:
                out[item[:, None] * g + np.arange(g)] = vals
                continue
            cg = m.c // g
            pix, c0 = item // cg, item % cg * g
            qq, r, img = pix % m.w, pix // m.w % m.h, pix // m.w // m.h
            for a in (0, 1):
                for b in (0, 1):
                    keep = (2 * r + a < m.oh) & (2 * qq + b < m.ow)
                    dst = ((img * m.oh + 2 * r + a) * m.ow + 2 * qq + b) * m.c + c0
                    out[(dst[keep][:, None] + np.arange(g))] = vals[keep]
    return outs, visits


def test_kernel_walk_of_the_table_gives_the_plain_group():
    """The member table _group_table builds for one group (16-value lanes
    where C and the alignment allow, one value where not, up and same
    members, f32 and bf16) and the plan _group_plan makes for a card of
    4 SMs and of 132: walked as group_quant_kernel walks it, every item
    of every member is visited once and the int8 values are the plain
    group's, static scales."""
    members = [(xt, torch.tensor(0.5), up) for _, xt, _, up in _members("static", "f32", 11)]
    members[1] = (members[1][0].bfloat16(), members[1][1], members[1][2])
    rows = [(x, torch.empty((x.shape[0], *(x.shape[1:3] if up is None else up), x.shape[3]),
                            dtype=torch.int8), sx, -1, up) for x, sx, up in members]
    ref = tq.quant_i8_group_plain(members)
    for sms in (4, 132):
        table, grid = tq._group_table(rows, sms)
        assert 1 <= grid <= min(table.tiles, tq.GROUP_BLOCKS_PER_SM * sms)
        vecs = [table.m[j].vec for j in range(table.count)]
        aligned = [rows[j][0].data_ptr() % 16 == 0 and rows[j][1].data_ptr() % 16 == 0
                   for j in range(len(rows))]
        lanes = [(x.shape[3] % 16 == 0) if up is not None else (x.numel() % 16 == 0)
                 for x, _, up in members]
        assert vecs == [int(a and b) for a, b in zip(aligned, lanes)]
        outs, visits = _walk(table, [(x, sx, up) for x, _, sx, _, up in rows])
        assert all((v == 1).all() for v in visits)
        for out, (r8, _) in zip(outs, ref):
            assert np.array_equal(out, r8.numpy())


@pytest.mark.parametrize("net", sorted(I8_SERVE))
def test_group_plans_of_the_int8_forwards(net):
    """The plan of every group an int8 forward makes, at its serving
    batch on a 132-SM card: tiles cut at per_thread * GROUP_THREADS
    items of one member, their prefix sums, one resident wave at most,
    per_thread the most that still gives every resident block a tile.
    No group of the zoo's three int8 nets needs two launches."""
    batch = I8_SERVE[net][1][-1]
    resident = tq.GROUP_BLOCKS_PER_SM * 132
    for keys in record_kernel_shapes(False, I8_SERVE[net][0], int8=True)["quant_i8"]:
        assert len(keys) <= tq.MAX_MEMBERS
        items = tuple(batch * h * w * c // (16 if c % 16 == 0 else 1) for h, w, c, _, _ in keys)
        per_thread, grid, tiles, tile0 = tq._group_plan(items, 132)
        counts = [-(-i // (per_thread * tq.GROUP_THREADS)) for i in items]
        assert tile0 == tuple(np.cumsum([0] + counts[:-1])) and tiles == sum(counts)
        assert grid == min(tiles, resident)
        more = per_thread + 1
        assert per_thread == 1 or tiles >= resident
        assert more > tq.GROUP_MAX_ITEMS or sum(
            -(-i // (more * tq.GROUP_THREADS)) for i in items) < resident
    with pytest.raises(ValueError, match="members"):
        tq._group_plan((16,) * (tq.MAX_MEMBERS + 1), 132)


def test_group_op_and_its_fake():
    """mgtpu::quant_i8_group on CPU tensors returns the group's int8 values
    and the (absmax, scale) rows of its dynamic members (the scales
    twice on the CPU), a (2, 0) tensor without one; its fake gives the
    same shapes and dtypes."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from mgtpu_torch.ops import library  # noqa: F401 (registers the ops)

    members = [(xt, None if j == 1 else torch.tensor(0.5), up)
               for j, (_, xt, _, up) in enumerate(_members("dynamic-finite", "f32", seed=5))]
    ups = [v for _, _, up in members for v in (up or (0, 0))]
    xs, sxs = [m[0] for m in members], [m[1] for m in members]
    for args in ((xs, sxs, ups), (xs[:1], sxs[:1], ups[:2])):
        x8s, scales = torch.ops.mgtpu.quant_i8_group(*args)
        with FakeTensorMode(allow_non_fake_inputs=True):
            f8s, fscales = torch.ops.mgtpu.quant_i8_group(*args)
        for a, b in zip((*x8s, scales), (*f8s, fscales)):
            assert (tuple(a.shape), a.dtype) == (tuple(b.shape), b.dtype)
    x8s, scales = torch.ops.mgtpu.quant_i8_group(xs, sxs, ups)
    ref = tq.quant_i8_group_plain(members)
    assert all(torch.equal(a, b[0]) for a, b in zip(x8s, ref))
    assert torch.equal(scales, torch.stack((ref[1][1],) * 2).reshape(2, 1))
    assert torch.ops.mgtpu.quant_i8_group(xs[:1], sxs[:1], ups[:2])[1].shape == (2, 0)


# --- whole int8 forwards: the layers' groups ---------------------------------

@contextlib.contextmanager
def _per_part():
    """Within it, the layers quantize part by part (a quant_i8_plain call
    a part, each dynamic scale its own mesh_absmax): the forward before
    the group design."""
    original = tq.quant_i8_group
    tq.quant_i8_group = lambda members: [tq.quant_i8_plain(*m) for m in members]
    try:
        yield
    finally:
        tq.quant_i8_group = original


def _jax_side(net, pq, s, x, moved, calib):
    """In a spawned process of its own: JAX's eager int8 forward of the
    quantized tree ``pq`` on ``x`` and ``moved``, dynamic, then after
    JAX's calibration on ``calib``: ({mode: [outputs, moved outputs]},
    the calibrated tree). An eager forward's first pass compiles each
    primitive at its shape (14-24 s a net here alone), so the three nets
    run side by side."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    _narrow(package="mgtpu")
    jm = _jax_model(net)
    out = {"dynamic": [np.asarray(jm.apply(pq, s, jnp.asarray(a))[0]) for a in (x, moved)]}
    jq.calibrate(jm, pq, s, calib)
    out["static"] = [np.asarray(jm.apply(pq, s, jnp.asarray(a))[0]) for a in (x, moved)]
    return out, jax.tree.map(np.asarray, pq)


@pytest.fixture(scope="module")
def forwards():
    """Per net of tests/test_torch_int8_axis.py's narrowed plans, weights
    drawn with numpy, two images and two calibration batches of two:
    the port's int8 forward (the run loop's: the unfolded net,
    quantized) with dynamic scales and after `calibrate`, each grouped
    and part by part, with the calibrated scales of both; JAX's eager
    forward of the same quantized tree, dynamic and with JAX's own
    calibration, each also on the images moved by 1e-6 (`_jax_side`,
    the nets in spawned processes beside the port's work, each with a
    deadline); and the port's forward with JAX's calibrated scales."""
    import multiprocessing

    from mgtpu_torch.models import create_model, get_spec
    from mgtpu_torch.ops.quant import calibrate, quantize_model
    from mgtpu_torch.utils.bridge import export_jax_tree, load_jax_tree
    from test_torch_cifar_train import _jitter
    from test_torch_dp import _init_draw
    from test_torch_int8_axis import DEADLINE

    res, cases = {}, {}
    pool = multiprocessing.get_context("spawn").Pool(len(NETS))
    try:
        with pytest.MonkeyPatch.context() as mpatch:
            for package in ("mgtpu_torch", "mgtpu"):
                _narrow(mpatch.setattr, package)
            for seed, net in enumerate(NETS):
                opt = _opts(net)
                p, s = export_jax_tree(create_model(opt,
                                                    generator=torch.Generator().manual_seed(0)))
                rng = np.random.default_rng(40 + seed)
                p = _init_draw(p, rng)
                _jitter(p, s, rng)
                shape = get_spec(NETS[net][0]).image_shape
                x, c0, c1 = (rng.standard_normal((2, *shape), dtype=np.float32)
                             for _ in range(3))
                moved = x * (1 + 1e-6 * rng.standard_normal(x.shape, dtype=np.float32))
                port = lambda opt=opt, p=p, s=s: quantize_model(  # noqa: E731
                    load_jax_tree(create_model(opt), p, s)).eval()
                with torch.inference_mode():
                    pq = export_jax_tree(port())[0]
                job = pool.apply_async(_jax_side, (net, pq, s, x, moved, [c0, c1]))
                cases[net] = (opt, port, x, [c0, c1], job, s)
            for net, (opt, port, x, calib, job, s) in cases.items():
                r = types.SimpleNamespace()
                with torch.inference_mode():
                    m = port()
                    r.dynamic = m(torch.from_numpy(x)).numpy()
                    with _per_part():
                        r.dynamic_part = m(torch.from_numpy(x)).numpy()
                    r.sx = _scales(calibrate(m, calib))
                    r.static = m(torch.from_numpy(x)).numpy()
                    m_part = port()
                    with _per_part():
                        r.sx_part = _scales(calibrate(m_part, calib))
                        r.static_part = m_part(torch.from_numpy(x)).numpy()
                r.jax, pq = job.get(timeout=DEADLINE)
                with torch.inference_mode():
                    m = quantize_model(load_jax_tree(create_model(opt), pq, s)).eval()
                    r.static_jax_sx = m(torch.from_numpy(x)).numpy()
                res[net] = r
    finally:
        pool.terminate()
        pool.join()
    return res


def _scales(model) -> np.ndarray:
    return np.concatenate([m.sx.numpy() for m in model.modules()
                           if getattr(m, "quantized", False)])


@pytest.mark.parametrize("net", list(NETS))
def test_grouped_forward_is_the_per_part_forward(forwards, net):
    """The layers' group calls change no bit: with dynamic scales and
    after calibration the outputs equal the part-by-part forward's, and
    calibration freezes the same scales, slot by slot."""
    r = forwards[net]
    np.testing.assert_array_equal(r.dynamic, r.dynamic_part)
    np.testing.assert_array_equal(r.sx, r.sx_part)
    np.testing.assert_array_equal(r.static, r.static_part)


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("net", list(NETS))
def test_grouped_forward_matches_jax(forwards, net, mode):
    """The grouped int8 forward against JAX's eager one of the same
    quantized tree (static: JAX's calibration, carried into the port, as
    tests/test_torch_int8_serve.py carries it: each package calibrates
    on its own int8 forward, where a float op rounding an ulp apart
    flips a quantize step and the later layers' scales drift apart), at
    that file's bound: 1e-5 of the outputs' scale, or three times the
    change that moving the images by 1e-6 makes to JAX's own forward."""
    r = forwards[net]
    got = r.dynamic if mode == "dynamic" else r.static_jax_sx
    ref, moved = r.jax[mode]
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    own = np.abs(moved - ref).max()
    assert got.shape == ref.shape and err <= max(1e-5 * scale, 3 * own), (err, scale, own)


class _JaxLayer:
    """A JAX multigrid layer fed `_pyramid` of each batch (JAX's
    calibrate hands the model one array a batch)."""

    def __init__(self, layer, pyramid):
        self.layer, self.pyramid = layer, pyramid

    def apply(self, p, s, x, *, train=False, rng=None):
        return self.layer.apply(p, s, self.pyramid(x), train=train)


class _PortLayer(torch.nn.Module):
    def __init__(self, layer, pyramid):
        super().__init__()
        self.layer, self.pyramid = layer, pyramid

    def forward(self, x):
        return self.layer(self.pyramid(x))


def _three_scales(x):
    """(8x8x5, 4x4x4, 2x2x3) strided slices of an (n, 8, 8, 12) array,
    exact on both sides; each scale its own magnitude."""
    return (x[..., :5], x[:, ::2, ::2, 5:9] * 3, x[:, ::4, ::4, 9:12] * 0.5)


# layer -> (JAX layer, port layer, pyramid of a batch, batch shape)
LAYERS = {
    "MgConv": (lambda m: m.MgConv([5, 4, 3], [6, 5, 4]), _three_scales, (8, 8, 12)),
    "MgStem7x7": (lambda m: m.MgStem7x7([6, 5, 4]), lambda x: x, (16, 16, 3)),
    "MgConvInput": (lambda m: m.MgConvInput([6, 5, 4]), lambda x: x, (8, 8, 3))}


@pytest.mark.parametrize("layer", sorted(LAYERS))
def test_layer_calibration_equals_jax(layer):
    """One multigrid layer whose parts are quantized in one group: its
    calibrated scales, slot by slot over three batches, are JAX's bit for
    bit (each one an absmax of the layer's input over 127, taken before
    any int8 conv of the layer runs), and its static and dynamic f32
    forwards JAX's within tests/test_torch_quant.py's f32 bound."""
    from mgtpu_torch.ops.quant import calibrate
    from mgtpu_torch.utils.bridge import load_jax_tree
    from test_torch_nn import _jitter_bn, _np
    from test_torch_quant import _close, _q_tree

    make, pyramid, shape = LAYERS[layer]
    jl = make(jmg)
    p, s = _np(jl.init(jax.random.PRNGKey(3)))
    for i in p:
        _jitter_bn(p[i], s[i], seed=int(i))
    pq = _q_tree(p)
    port = _PortLayer(load_jax_tree(make(tmg).eval(), pq, s), pyramid).eval()
    rng = np.random.default_rng(12)
    batches = [rng.standard_normal((2, *shape), dtype=np.float32) for _ in range(3)]
    x = rng.standard_normal((2, *shape), dtype=np.float32)
    jax_layer = _JaxLayer(jl, pyramid)
    with torch.no_grad():
        dyn = port(torch.from_numpy(x))
    for got, ref in zip(dyn, jax_layer.apply(pq, s, jnp.asarray(x))[0]):
        _close(got, ref, "f32")
    jq.calibrate(jax_layer, pq, s, batches)
    calibrate(port, batches)
    for i, conv in enumerate(port.layer.convs):
        ref_sx = np.asarray(pq[str(i)]["conv"]["w"]["sx"])
        assert np.array_equal(conv.conv.sx.numpy(), ref_sx), (i, conv.conv.sx, ref_sx)
    with torch.no_grad():
        static = port(torch.from_numpy(x))
    for got, ref in zip(static, jax_layer.apply(pq, s, jnp.asarray(x))[0]):
        _close(got, ref, "f32")
