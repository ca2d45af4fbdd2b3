"""int8 serving across ranks in the port on the CPU, over gloo: the dynamic
activation scale as one max over the mesh (`mgtpu_torch.ops.quant.
mesh_absmax`), and -spatial under -int8 (`nn._int8_conv`: H-slabs,
int8 halo rows, `conv_i8` with per-side H padding).

Three groups of ranks run once for the module, over gloo: 2 x 1 (data),
1 x 2 (-spatial, 'model') and 2 x 2, in four spawned processes (the 2 x 2
first, then the other two side by side). Each runs the int8 eval step
(`make_eval_step`, the run loop's, on the unfolded quantized net) of
three nets on its part of one global batch of 4:

- a narrowed R-MG-34 at 224 px (tests/test_torch_model_axis.py's plan:
  H-slabs at 224, 112, 56 and 28 rows; the 7x7/2 stems on slabs, with
  3 halo rows above and 2 below), a narrowed ``cifar/prnmg`` at 32 px
  and a narrowed ``mnist-cluttered/unmg`` at 64 px (its 2x2 transposed
  convs stay float);
- with dynamic scales, on a batch whose second half (data rank 1's rows)
  is scaled by 8, and on a tail of 3 images padded with the last one to
  a multiple of the data ranks, as the run loop pads it; then with
  static scales, calibrated by each rank on two whole batches.

Each rank records every dynamic scale it quantizes with. Those must be
the one-rank forward's on the global batch, bit for bit; without the
max over the mesh a data rank's scale is its own rows' (the fault this
file was written for). The calibrated scales hold the same bits on every
rank. The outputs equal the one-rank forward's, bit for bit under
-spatial alone (every op on the path is exact or elementwise there; the
batch is the same), within 1e-5 of their scale where the batch is split
(the classifier's matmul runs at another batch); R-MG-34's match JAX's
eager one-device int8 forward of the same quantized tree at
tests/test_torch_int8_serve.py's bound. Weights are drawn with numpy
through the bridge (no JAX init). Every spawned process has a deadline.
"""

import contextlib
import os
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mgtpu_torch.main import free_port
from test_torch_dp import BLOCKS as CIFAR_BLOCKS, _init_draw
from test_torch_model_axis import RNMG_BLOCKS, RNMG_STEM, UNMG_BLOCKS

DEADLINE = 240
BATCH, TAIL, CALIB = 4, 3, 2  # the global batch, its tail, a calibration batch
# name -> (data ranks, model ranks); the axis is 'model' (-spatial)
MESHES = {"data": (2, 1), "spatial": (1, 2), "data-spatial": (2, 2)}
NETS = {"rnmg": ("ilsvrc/rnmg", "ilsvrc"), "prnmg": ("cifar/prnmg", "cifar100"),
        "unmg": ("mnist-cluttered/unmg", "mnist-seg")}
CASES = ("dynamic", "tail", "static")
# the net also held to JAX's eager forward: the main path's. An eager
# forward's first pass compiles every primitive at its shape (12-25 s a
# net here alone, most of this file's time): the other two nets' int8
# forwards are held to JAX's by tests/test_torch_int8_serve.py, and here
# to the port's one-rank one
JAX_NETS = ("rnmg",)
SCALED = 8.0  # the factor on the batch's second half


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _narrow(setattr_=setattr, package="mgtpu_torch"):
    """The narrowed plans in the model modules of ``package`` (a spawned
    process sets them for good, the test process those of both packages
    through a monkeypatch)."""
    import importlib

    rnmg, pnmg, unmg = (importlib.import_module(f"{package}.models.{m}")
                        for m in ("ilsvrc.rnmg", "cifar.pnmg", "mnist_cluttered.unmg"))
    setattr_(rnmg, "STEM", RNMG_STEM)
    setattr_(rnmg, "BLOCKS", RNMG_BLOCKS)
    setattr_(pnmg, "BLOCKS", CIFAR_BLOCKS["cifar/prnmg"])
    setattr_(unmg, "BLOCKS", UNMG_BLOCKS)


@pytest.fixture(autouse=True, scope="module")
def narrowed():
    with pytest.MonkeyPatch.context() as mpatch:
        for package in ("mgtpu_torch", "mgtpu"):
            _narrow(mpatch.setattr, package)
        yield


def _opts(net):
    from mgtpu_torch.models import NetOpts, net_options

    name, dataset = NETS[net]
    return net_options(NetOpts(netType=name, dataset=dataset))


def _port_model(net, path=None):
    """The port's ``net`` (its weights from the checkpoint ``path``),
    quantized as the run loop quantizes it (the unfolded net), in eval
    mode; and its spec."""
    from mgtpu_torch.models import create_model, get_spec
    from mgtpu_torch.ops.quant import quantize_model
    from mgtpu_torch.utils.bridge import load_jax_tree
    from mgtpu_torch.utils.checkpoint import load_checkpoint

    model = create_model(_opts(net), generator=torch.Generator().manual_seed(0))
    if path is not None:
        ck = load_checkpoint(path)
        load_jax_tree(model, ck["params"], ck["stats"])
        quantize_model(model)
    return model.eval(), get_spec(NETS[net][0])


@contextlib.contextmanager
def _dynamic_scales():
    """Within it, every dynamic scale the layers quantize with, in call
    order (f32 values), and the MAX all-reduces of the scales' absmaxes
    (``got.reduces``: the quantizer's only MAX; one a layer)."""
    from mgtpu_torch.ops import quant

    got, original, reduce = _Scales(), quant.quant_i8_group, dist.all_reduce

    def fn(members):
        res = original(members)
        got.extend(s.reshape(()).item() for (_, s), (_, sx, _) in zip(res, members)
                   if sx is None)
        return res

    def all_reduce(tensor, op=dist.ReduceOp.SUM, *a, **kw):
        got.reduces += op == dist.ReduceOp.MAX
        return reduce(tensor, op, *a, **kw)

    quant.quant_i8_group, dist.all_reduce = fn, all_reduce
    try:
        yield got
    finally:
        quant.quant_i8_group, dist.all_reduce = original, reduce


class _Scales(list):
    reduces = 0


def _batches(path):
    """{case: (x, y) global batch} and the two calibration batches."""
    d = np.load(path + ".npz")
    x, y = d["x"], d["y"]
    return {"dynamic": (x, y), "tail": (x[:TAIL], y[:TAIL]), "static": (x, y)}, [d["c0"], d["c1"]]


def _serve(mesh, net, path):
    """The int8 eval step of ``net`` on this rank (``mesh`` None: one rank
    on the global batch) for each case: its output rows, the dynamic
    scales it quantized with, and the calibrated static scales."""
    from mgtpu_torch.ops.quant import calibrate
    from mgtpu_torch.parallel import shard_batch
    from mgtpu_torch.train.step import make_eval_step

    from chip_smoke import int8_layers

    model, spec = _port_model(net, path)
    step = make_eval_step(model, spec.create_loss(_opts(net)), spec, "test", mesh)
    batches, calib = _batches(path)
    res = {"layers": int8_layers(model)}
    for case in CASES:
        if case == "static":
            calibrate(model, calib)  # whole batches, no group: every rank alike
            res["sx"] = np.concatenate([m.sx.numpy() for m in model.modules()
                                        if getattr(m, "quantized", False)])
        x, y = batches[case]
        if mesh is not None:  # the run loop's tail: the last image repeated
            pad = -len(x) % mesh.size
            x, y = (np.concatenate([a, np.repeat(a[-1:], pad, 0)]) for a in (x, y))
            x, y = shard_batch(mesh, {"x": torch.from_numpy(x), "y": torch.from_numpy(y)}, 0,
                               spatial=True).values()
        else:
            x, y = torch.from_numpy(x), torch.from_numpy(y)
        with _dynamic_scales() as scales:
            out = step({"x": x, "y": y})[1]
        res[f"{case}/out"] = out.numpy()
        res[f"{case}/scales"] = np.array(scales, dtype=np.float32)
        res[f"{case}/reduces"] = scales.reduces
    return res


# the meshes a spawned process joins in turn, as (mesh, its rank there):
# the four processes make the 2 x 2 mesh, then processes 0-1 the 2 x 1
# and 2-3 the 1 x 2 (one process group at a time; four starts, not eight)
STAGES = [[("data-spatial", p), ("data" if p < 2 else "spatial", p % 2)] for p in range(4)]


def _group(process, inits, out_dir, paths):
    """Spawned process ``process``: in each of its STAGES, a rank of that
    mesh (joined at ``inits[mesh]``) on every net; results in
    ``out_dir``/<mesh>.<net>.<rank>.npz."""
    from mgtpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    _narrow()
    for name, rank in STAGES[process]:
        n_data, n_model = MESHES[name]
        mesh = make_mesh(n_data, rank=rank, device="cpu", init_method=inits[name],
                         n_model=n_model)
        try:
            for net in NETS:
                np.savez(os.path.join(out_dir, f"{name}.{net}.{rank}.npz"),
                         **_serve(mesh, net, paths[net]))
        finally:
            dist.destroy_process_group()


def _inputs(net, tmp, seed):
    """Weights drawn with numpy by the init's laws (BN affines and stats
    jittered), the global batch (its second half scaled by SCALED) and
    two calibration batches; written as a checkpoint and an npz. Returns
    the path."""
    from mgtpu_torch.utils.bridge import export_jax_tree
    from mgtpu_torch.utils.checkpoint import write_checkpoint
    from test_torch_cifar_train import _jitter

    model, spec = _port_model(net)
    p, s = export_jax_tree(model)
    rng = np.random.default_rng(seed)
    p = _init_draw(p, rng)
    _jitter(p, s, rng)
    x, c0, c1 = (rng.standard_normal((n, *spec.image_shape), dtype=np.float32)
                 for n in (BATCH, CALIB, CALIB))
    x[BATCH // 2:] *= SCALED
    ts = spec.target_shape(_opts(net))
    y = ((rng.random((BATCH, *ts)) > 0.5).astype(np.float32) if ts
         else rng.integers(0, spec.n_classes(_opts(net)), BATCH))
    path = str(tmp / net)
    write_checkpoint(path, p, s, None)
    np.savez(path + ".npz", x=x, y=y, c0=c0, c1=c1)
    return path


def _jax_model(net):
    from mgtpu.models import get_net

    opt = _opts(net)
    return get_net(NETS[net][0]).create_model(types.SimpleNamespace(
        dataset=opt.dataset, nLayer=opt.nLayer, isDropout=opt.isDropout, depth=opt.depth,
        shortcutType=opt.shortcutType, nEpochs=opt.nEpochs))


def _port_trees(net, path):
    """The port's quantized tree of ``net`` as JAX trees: its kernels
    (`quantize_model`, bit for bit `mgtpu.ops.quant.quantize_params`:
    tests/test_torch_int8_serve.py; eager JAX takes seconds to compile
    that one) and, after its one-rank calibration, its static scales too
    (each package's calibration takes the absmax of its own float
    forward, which may round an ulp apart, and a scale an ulp apart flips
    quantize steps; tests/test_torch_int8_serve.py carries JAX's scales
    into the port the other way). Returns ({"dynamic": p, "static": p},
    stats)."""
    from mgtpu_torch.ops.quant import calibrate
    from mgtpu_torch.utils.bridge import export_jax_tree

    model = _port_model(net, path)[0]
    dynamic, stats = export_jax_tree(model)
    static = export_jax_tree(calibrate(model, _batches(path)[1]))[0]
    return {"dynamic": dynamic, "static": static}, stats


def _jax_forwards(_, net, path, trees, stats, out):
    """In a process of its own: JAX's eager one-device int8 forward of the
    global batch with each of ``trees`` (`_port_trees`), each also on the
    images moved by 1e-6; written to ``out``. Eager JAX compiles each
    primitive at its first shape (12-25 s a net here, alone), and the
    passes after the first reuse them."""
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    _narrow(package="mgtpu")
    jm = _jax_model(net)
    x = _batches(path)[0]["dynamic"][0]
    moved = x * (1 + 1e-6 * np.random.default_rng(99).standard_normal(x.shape, dtype=np.float32))
    np.savez(out, **{f"{case}{tag}": np.asarray(jm.apply(tree, stats, jnp.asarray(a))[0])
                     for case, tree in trees.items() for tag, a in (("", x), ("/moved", moved))})


def _join(ctxs, start):
    try:
        for ctx in ctxs:
            while not ctx.join(timeout=2):
                assert time.monotonic() < start + DEADLINE, f"the ranks took over {DEADLINE} s"
    finally:
        for ctx in ctxs:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()


@pytest.fixture(scope="module")
def int8_runs(tmp_path_factory):
    """Each net's inputs, the three meshes' ranks on all of them, and
    meanwhile the one-rank forwards and JAX's: ``results`` {(mesh, net):
    [rank 0, ...]}, ``one`` {net: the one-rank results}, ``jax`` {net:
    JAX's outputs by case, and on the moved images}."""
    tmp = tmp_path_factory.mktemp("int8_axis")
    paths = {net: _inputs(net, tmp, seed) for seed, net in enumerate(NETS)}
    start = time.monotonic()
    # JAX's cold passes are the longest: first
    ctxs = [mp.start_processes(_jax_forwards, args=(net, paths[net], *_port_trees(net, paths[net]),
                                                    str(tmp / f"jax.{net}")),
                               nprocs=1, join=False, start_method="spawn") for net in JAX_NETS]
    try:
        inits = {name: f"tcp://127.0.0.1:{free_port()}" for name in MESHES}
        ctxs.append(mp.start_processes(_group, args=(inits, str(tmp), paths), nprocs=len(STAGES),
                                       join=False, start_method="spawn"))
        one = {net: _serve(None, net, paths[net]) for net in NETS}
    finally:
        _join(ctxs, start)
    ref = {net: dict(np.load(tmp / f"jax.{net}.npz")) for net in JAX_NETS}
    results = {(name, net): [dict(np.load(tmp / f"{name}.{net}.{r}.npz"))
                             for r in range(MESHES[name][0] * MESHES[name][1])]
               for name in MESHES for net in NETS}
    return types.SimpleNamespace(results=results, one=one, jax=ref)


def _gathered(ranks, name, case):
    """The global batch's outputs: the data ranks' rows in order (model
    index 0's; every model rank holds them, checked equal bit for bit),
    the tail's padding dropped."""
    n_model = MESHES[name][1]
    for r, rk in enumerate(ranks):
        np.testing.assert_array_equal(rk[f"{case}/out"], ranks[r - r % n_model][f"{case}/out"])
    out = np.concatenate([rk[f"{case}/out"] for rk in ranks[::n_model]])
    return out[:TAIL] if case == "tail" else out


GRID = [(name, net) for name in MESHES for net in NETS]
IDS = [f"{a}-{b}" for a, b in GRID]


@pytest.mark.parametrize("case", ["dynamic", "tail"])
@pytest.mark.parametrize("name,net", GRID, ids=IDS)
def test_dynamic_scales_are_the_global_batchs(int8_runs, name, net, case):
    """Every rank quantizes each conv part with the scale the one-rank
    forward takes on the global batch (the tail: its three images), bit
    for bit: the absmax is all-reduced over the mesh. Rank 1 holds the
    rows scaled by 8, so a rank's own absmax is not the batch's."""
    want = int8_runs.one[net][f"{case}/scales"]
    assert want.size and np.all(want > 0)
    for r, rk in enumerate(int8_runs.results[(name, net)]):
        np.testing.assert_array_equal(rk[f"{case}/scales"], want, err_msg=f"rank {r}")


@pytest.mark.parametrize("name,net", GRID, ids=IDS)
def test_one_scale_all_reduce_a_layer(int8_runs, name, net):
    """A rank's dynamic forward all-reduces its scales' absmaxes with MAX
    once a layer (each multigrid layer's parts in one vector; a conv
    outside a layer alone), not once a part; a static one never."""
    layers = int8_runs.one[net]["layers"]
    assert layers < int8_runs.one[net]["dynamic/scales"].size
    for r, rk in enumerate(int8_runs.results[(name, net)]):
        assert rk["layers"] == layers
        for case in CASES:
            want = 0 if case == "static" else layers
            assert rk[f"{case}/reduces"] == want, (r, case, rk[f"{case}/reduces"], want)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("name,net", GRID, ids=IDS)
def test_outputs_equal_the_one_rank_forward(int8_runs, name, net, case):
    """The ranks' outputs are the one-rank forward's: bit for bit under
    -spatial alone (the batch is the same, and every op is exact or
    elementwise), within 1e-5 of their scale where the data ranks split
    the batch (the classifier's matmul runs at another batch)."""
    got = _gathered(int8_runs.results[(name, net)], name, case)
    ref = int8_runs.one[net][f"{case}/out"]
    assert got.shape == ref.shape and np.isfinite(got).all()
    if MESHES[name][0] == 1:
        np.testing.assert_array_equal(got, ref)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())


JAX_GRID = [(name, net) for name in MESHES for net in JAX_NETS]


@pytest.mark.parametrize("case", ["dynamic", "static"])
@pytest.mark.parametrize("name,net", JAX_GRID, ids=[f"{a}-{b}" for a, b in JAX_GRID])
def test_outputs_match_jax(int8_runs, name, net, case):
    """The ranks' outputs against JAX's eager one-device int8 forward of
    the global batch (static: with the scales the ranks calibrated), at
    tests/test_torch_int8_serve.py's bound: 1e-5 of the outputs' scale,
    or three times the change that moving the images by 1e-6 makes to
    JAX's own forward."""
    got = _gathered(int8_runs.results[(name, net)], name, case)
    ref = int8_runs.jax[net]
    err, scale = np.abs(got - ref[case]).max(), np.abs(ref[case]).max()
    own = np.abs(ref[f"{case}/moved"] - ref[case]).max()
    assert got.shape == ref[case].shape
    assert err <= max(1e-5 * scale, 3 * own), (err, scale, own)


@pytest.mark.parametrize("name,net", GRID, ids=IDS)
def test_calibrated_scales_hold_the_same_bits_on_every_rank(int8_runs, name, net):
    """Each rank calibrates on the same whole batches before any group is
    active: its static scales are the one-rank calibration's, bit for
    bit."""
    want = int8_runs.one[net]["sx"]
    for r, rk in enumerate(int8_runs.results[(name, net)]):
        np.testing.assert_array_equal(rk["sx"], want, err_msg=f"rank {r}")
