"""The mesh's second axis in the port (`mgtpu_torch/parallel/axis.py`,
-spatial and -tensor through `make_mesh`, `shard_batch`, the layers, the
train step, the Session and the launcher) on the CPU, over gloo, against
the port's one-rank step on the global batch and JAX's one-device step.

Three groups of ranks are spawned once for the module, all at once: 1 x 2
under -spatial ('model'), 2 x 2 (data x 'model') and 1 x 2 under -tensor.
Each runs one f32 step of each net on its part of one global batch of 4:

- a narrowed R-MG-34 (depth 34, widths cut to 8-32, 224 px: H-slabs at
  224, 112, 56 and 28 rows, whole from 14 down, as at full width), a
  narrowed ``cifar/nmg`` (the plan of tests/test_torch_dp.py, 32 px) and
  a narrowed ``mnist-cluttered/unmg`` (its segmentation head and
  `UpConvBN`, 64 px);
- the loss to rtol 1e-5 of the one-rank step's, the parameters, running
  stats and momentum to rtol 1e-3 / atol 1e-4 (the bounds of
  tests/test_train_dp.py's mesh steps); ``cifar/nmg`` also against the
  JAX step, on weights drawn with numpy (no JAX init);
- every leaf that the mesh keeps whole holds the same bits on every rank;
- under -tensor each rank holds half the bytes of every eligible leaf,
  and a checkpoint is the whole tree (a one-rank run's), which resumes
  on a one-rank model and on the sliced ranks.

Beside them: the split rules against JAX's (`constrain_spatial`,
`tp_sharding`, `shard_batch(spatial=True)`), the conv kernels' plain
versions under per-side padding against the whole image's rows, the CLI
under ``-nGPU 2 -spatial 2`` and ``-nGPU 2 -tensor 2``, and the four
refusals. Every spawned process has a deadline.
"""

import os
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import mgtpu_torch.models.ilsvrc.rnmg as trnmg
from mgtpu_torch.main import free_port
from mgtpu_torch.parallel.mesh import Mesh
from test_torch_dp import BLOCKS as CIFAR_BLOCKS, _flat, _init_draw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 240
LR, WD = 0.1, 5e-4
BATCH = 4
# name -> (data ranks, model ranks, axis)
MESHES = {"spatial": (1, 2, "model"), "data-spatial": (2, 2, "model"),
          "tensor": (1, 2, "tensor")}
# R-MG-34 and unmg with their widths cut, as the CIFAR plans are
RNMG_STEM = [16, 8, 8]
RNMG_BLOCKS = [([16, 8, 8], [3, 3, 3], False), ([32, 16, 8], [3, 3, 3], True),
               ([32, 16], [3, 3], True), ([32], [3], False)]
UNMG_BLOCKS = [([16, 8, 8], False), ([16, 16, 8], True), ([32, 16], True), ([32], None)]
NETS = {"rnmg": ("ilsvrc/rnmg", "ilsvrc"), "nmg": ("cifar/nmg", "cifar100"),
        "unmg": ("mnist-cluttered/unmg", "mnist-seg")}
STEP_RTOL, STEP_ATOL = 1e-3, 1e-4
RNMG_FULL = trnmg.STEM, trnmg.BLOCKS  # R-MG's published widths


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _narrow(setattr_=setattr):
    """The narrowed plans in the port's model modules (a rank process
    sets them for good, the test process through a monkeypatch)."""
    import mgtpu_torch.models.cifar.nmg as tnmg
    import mgtpu_torch.models.mnist_cluttered.unmg as tunmg

    setattr_(tnmg, "BLOCKS", CIFAR_BLOCKS["cifar/nmg"])
    setattr_(trnmg, "STEM", RNMG_STEM)
    setattr_(trnmg, "BLOCKS", RNMG_BLOCKS)
    setattr_(tunmg, "BLOCKS", UNMG_BLOCKS)


@pytest.fixture(autouse=True, scope="module")
def narrowed():
    """The narrowed plans while the module runs, restored after it: the
    suite's other modules in this worker build the nets at their
    widths."""
    with pytest.MonkeyPatch.context() as mpatch:
        _narrow(mpatch.setattr)
        yield


def _port_model(net, ckpt=None):
    """(model, SGD state) of the port's ``net``, loaded from ``ckpt``."""
    from mgtpu_torch.models import NetOpts, create_model, get_spec
    from mgtpu_torch.train.optim import sgd_init
    from mgtpu_torch.utils.bridge import load_jax_tree, load_momentum
    from mgtpu_torch.utils.checkpoint import load_checkpoint

    name, dataset = NETS[net]
    model = create_model(NetOpts(netType=name, dataset=dataset),
                         generator=torch.Generator().manual_seed(0))
    if ckpt is None:
        return model, sgd_init(model.parameters()), get_spec(name)
    ck = load_checkpoint(ckpt)
    load_jax_tree(model, ck["params"], ck["stats"])
    return model, load_momentum(model, ck["opt_state"]), get_spec(name)


def _state(model, opt_state):
    from mgtpu_torch.utils.bridge import export_jax_tree, export_momentum

    p, s = export_jax_tree(model)
    out = {f"p/{k}": v for k, v in _flat(p).items()}
    out.update({f"s/{k}": v for k, v in _flat(s).items()})
    out.update({f"m/{k}": v for k, v in _flat(export_momentum(model, opt_state)["m"]).items()})
    return out


def _batch(net, path):
    data = np.load(path + ".npz")
    return {"x": torch.from_numpy(data["x"]), "y": torch.from_numpy(data["y"])}


def _step_case(mesh, net, path, out_dir, tag):
    """One f32 step of ``net`` on this rank: its part of the global batch,
    the whole state after it (gathered under -tensor), whether the leaves
    the mesh keeps whole hold the same bits on every rank, and under
    -tensor the bytes held, a checkpoint and its resumes."""
    from mgtpu_torch.parallel import (gather_tree, replicate, same_bits, shard_batch,
                                      shard_params_tp, whole_tensors)
    from mgtpu_torch.parallel.axis import sliced
    from mgtpu_torch.train.step import make_train_step
    from mgtpu_torch.utils.checkpoint import save_checkpoint

    model, opt_state, spec = _port_model(net, path)
    whole_bytes = [p.nbytes for p in model.parameters()]
    model = replicate(mesh, model)
    tensor = mesh.axis == "tensor"
    opt_state = shard_params_tp(mesh, model, opt_state)
    step = make_train_step(model, spec.create_loss(None), spec, mesh=mesh, bucket_sgd=not tensor,
                           log_grad_norm=True)
    batch = shard_batch(mesh, _batch(net, path), 0, spatial=not tensor)
    metrics = step(opt_state, batch, LR, WD)
    params = list(model.parameters())
    kept = [p for p in params if not sliced(p)] + [m for p, m in zip(params, opt_state["m"])
                                                   if not sliced(p)]
    kept += [b for b in model.buffers() if not sliced(b)]
    res = {"bits": np.array(same_bits(mesh, kept)),
           "p_bytes": np.array([p.nbytes for p in params]), "whole_bytes": np.array(whole_bytes),
           "sliced": np.array([sliced(p) for p in params])}
    res.update({f"metric/{k}": np.float64(v) for k, v in metrics.items()})
    ckpt = os.path.join(out_dir, f"{tag}.{net}.ckpt")
    # as the Session checkpoints: the momentum gathered, then the parameters
    gathered = gather_tree(mesh, opt_state, model.parameters())
    with whole_tensors(mesh, model, gathered) as whole:
        res.update(_state(model, whole))
        if mesh.rank == 0 and mesh.model_rank == 0:
            save_checkpoint(ckpt, model, whole, 1, {"netType": NETS[net][0]})
    if tensor:  # the rank's checkpoint resumed on the rank: its slices, bit for bit
        dist.barrier()
        again, again_state, _ = _port_model(net, ckpt)
        again_state = shard_params_tp(mesh, replicate(mesh, again), again_state)
        res["resume_bits"] = np.array(
            all(torch.equal(a, b) for a, b in zip([*model.parameters(), *model.buffers(),
                                                   *opt_state["m"]],
                                                  [*again.parameters(), *again.buffers(),
                                                   *again_state["m"]])))
    return res


def _group(rank, name, init, out_dir, paths):
    """A rank of mesh ``name``: every net's step; results in
    ``out_dir``/<name>.<net>.<rank>.npz."""
    from mgtpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    _narrow()
    n_data, n_model, ax = MESHES[name]
    mesh = make_mesh(n_data, rank=rank, device="cpu", init_method=init, n_model=n_model,
                     model_axis=ax)
    try:
        for net in NETS:
            np.savez(os.path.join(out_dir, f"{name}.{net}.{rank}.npz"),
                     **_step_case(mesh, net, paths[net], out_dir, name))
    finally:
        dist.destroy_process_group()


def _spawn(name, out_dir, paths):
    n_data, n_model, _ = MESHES[name]
    return mp.start_processes(_group, args=(name, f"tcp://127.0.0.1:{free_port()}", out_dir,
                                            paths),
                              nprocs=n_data * n_model, join=False, start_method="spawn")


def _join(ctxs, start):
    try:
        for ctx in ctxs:
            while not ctx.join(timeout=2):
                assert time.monotonic() < start + DEADLINE, f"the ranks took over {DEADLINE} s"
    finally:
        for ctx in ctxs:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()


def _inputs(net, tmp, seed):
    """Weights drawn with numpy by the init's laws into the port model's
    JAX trees (BN affines and stats jittered), a momentum and a batch;
    written as a checkpoint and an npz. Returns (path, p, s, m, x, y)."""
    import jax

    from mgtpu_torch.utils.bridge import export_jax_tree
    from mgtpu_torch.utils.checkpoint import write_checkpoint
    from test_torch_cifar_train import _jitter

    from mgtpu_torch.models import NetOpts

    model, _, spec = _port_model(net)
    opt = NetOpts(netType=NETS[net][0], dataset=NETS[net][1])
    p, s = export_jax_tree(model)
    rng = np.random.default_rng(seed)
    p = _init_draw(p, rng)
    _jitter(p, s, rng)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32) * 0.01, p)
    x = rng.standard_normal((BATCH, *spec.image_shape), dtype=np.float32)
    ts = spec.target_shape(opt)
    y = ((rng.random((BATCH, *ts)) > 0.5).astype(np.float32) if ts
         else rng.integers(0, spec.n_classes(opt), BATCH))
    path = str(tmp / net)
    write_checkpoint(path, p, s, {"m": m})
    np.savez(path + ".npz", x=x, y=y)
    return path, p, s, m, x, y


def _one_rank(net, path):
    """The port's group-less step on the global batch: (metrics, state)."""
    from mgtpu_torch.train.step import make_train_step

    model, opt_state, spec = _port_model(net, path)
    step = make_train_step(model, spec.create_loss(None), spec, log_grad_norm=True)
    metrics = step(opt_state, _batch(net, path), LR, WD)
    return {k: float(v) for k, v in metrics.items()}, _state(model, opt_state)


def _jax_step(p, s, m, x, y):
    """JAX's jitted one-device step of the narrowed cifar/nmg."""
    import jax
    import jax.numpy as jnp

    import mgtpu.models.cifar.nmg as jnmg
    from mgtpu.models import get_net
    from mgtpu.train.step import make_train_step

    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(jnmg, "BLOCKS", CIFAR_BLOCKS["cifar/nmg"])
        jnet = get_net("cifar/nmg")
        jm = jnet.create_model(types.SimpleNamespace(dataset="cifar100", nLayer=1,
                                                     isDropout=False))
        step = jax.jit(make_train_step(jm, jnet.create_loss(None), jnet))
        p2, s2, o2, m2 = step(p, s, {"m": m}, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, LR,
                              WD, jax.random.PRNGKey(0))
    ref = {f"p/{k}": v for k, v in _flat(jax.tree.map(np.asarray, p2)).items()}
    ref.update({f"s/{k}": v for k, v in _flat(jax.tree.map(np.asarray, s2)).items()})
    ref.update({f"m/{k}": v for k, v in _flat(jax.tree.map(np.asarray, o2["m"])).items()})
    return {k: float(v) for k, v in m2.items()}, ref


@pytest.fixture(scope="module")
def axis_runs(tmp_path_factory):
    """The inputs of each net, the three meshes' ranks on all of them, and
    meanwhile the one-rank steps and the JAX step: ``results`` {(mesh,
    net): [rank 0, ...]}, ``one`` {net: (metrics, state)}, ``jax``
    (metrics, state) of cifar/nmg, ``tmp``."""
    tmp = tmp_path_factory.mktemp("axis")
    inputs = {net: _inputs(net, tmp, seed) for seed, net in enumerate(NETS)}
    paths = {net: v[0] for net, v in inputs.items()}
    start = time.monotonic()
    ctxs = [_spawn(name, str(tmp), paths) for name in MESHES]
    try:
        one = {net: _one_rank(net, paths[net]) for net in NETS}
        jax_ref = _jax_step(*inputs["nmg"][1:])
    finally:
        _join(ctxs, start)
    results = {(name, net): [dict(np.load(tmp / f"{name}.{net}.{r}.npz"))
                             for r in range(MESHES[name][0] * MESHES[name][1])]
               for name in MESHES for net in NETS}
    return types.SimpleNamespace(results=results, one=one, jax=jax_ref, tmp=tmp)


def _assert_state_close(got, ref):
    assert ref and set(ref) <= set(got)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=STEP_RTOL, atol=STEP_ATOL, err_msg=k)


CASES = [(name, net) for name in MESHES for net in NETS]


@pytest.mark.parametrize("name,net", CASES, ids=[f"{a}-{b}" for a, b in CASES])
def test_step_equals_the_one_rank_step(axis_runs, name, net):
    """The step on the mesh is the one-rank step on the global batch:
    loss, parameters, running stats and momentum."""
    metrics, ref = axis_runs.one[net]
    got = axis_runs.results[(name, net)][0]
    np.testing.assert_allclose(got["metric/loss"], metrics["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["metric/gradnorm"], metrics["gradnorm"], rtol=1e-3)
    _assert_state_close(got, ref)


@pytest.mark.parametrize("name", list(MESHES))
def test_step_equals_the_jax_step(axis_runs, name):
    """cifar/nmg on the mesh against JAX's jitted one-device step on the
    same numpy-drawn weights and batch."""
    metrics, ref = axis_runs.jax
    got = axis_runs.results[(name, "nmg")][0]
    np.testing.assert_allclose(got["metric/loss"], metrics["loss"], rtol=1e-5)
    _assert_state_close(got, ref)


@pytest.mark.parametrize("name", list(MESHES))
def test_whole_leaves_hold_the_same_bits_on_every_rank(axis_runs, name):
    """Every parameter, momentum and running stat that the mesh keeps
    whole is the same bits on every rank after the step, and every rank
    gathers the same whole state."""
    for net in NETS:
        ranks = axis_runs.results[(name, net)]
        assert all(r["bits"] for r in ranks), net
        for k in (k for k in ranks[0] if k[:2] in ("p/", "s/", "m/")):
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[k], ranks[0][k], err_msg=f"{net} {k}")


@pytest.mark.parametrize("net", list(NETS))
def test_tensor_rank_holds_half_the_eligible_bytes(axis_runs, net):
    """Under -tensor 2 each rank holds half the bytes of every parameter
    `tp_spec` shards (conv O, BN C, dense outputs with >= 8 a slice), and
    all of the others; some leaves of each kind are present."""
    from mgtpu_torch.parallel import tp_spec

    for r in axis_runs.results[("tensor", net)]:
        held, whole, cut = r["p_bytes"], r["whole_bytes"], r["sliced"]
        assert cut.any() and not cut.all()
        np.testing.assert_array_equal(held[cut] * 2, whole[cut])
        np.testing.assert_array_equal(held[~cut], whole[~cut])
    model, _, _ = _port_model(net)
    assert [bool(tp_spec(p.shape, 2)) for p in model.parameters()] == list(cut)


@pytest.mark.parametrize("net", list(NETS))
def test_tensor_checkpoint_is_a_one_rank_checkpoint(axis_runs, net):
    """The -tensor checkpoint holds the whole tree: a one-rank model
    resumes from it to the ranks' gathered state bit for bit, which is the
    one-rank step's within the step bounds; the ranks resumed from it
    hold their slices bit for bit."""
    from mgtpu_torch.utils.checkpoint import load_checkpoint

    path = str(axis_runs.tmp / f"tensor.{net}.ckpt")
    model, opt_state, _ = _port_model(net, path)
    got = _state(model, opt_state)
    ranks = axis_runs.results[("tensor", net)]
    for k, v in got.items():
        np.testing.assert_array_equal(v, ranks[0][k], err_msg=k)
    _assert_state_close(got, axis_runs.one[net][1])
    assert set(got) == set(axis_runs.one[net][1])
    assert load_checkpoint(path)["epoch"] == 1
    assert all(r["resume_bits"] for r in ranks)


# ----------------------------------------------------------- the rules

def _jax_mesh(n_model, axis_name="model"):
    from mgtpu.parallel import make_mesh

    return make_mesh(n_data=8 // n_model, n_model=n_model, model_axis=axis_name)


# R-MG-34's heights at 224 px: the image, the stems' convs and every scale
RMG34_HEIGHTS = [224, 112, 56, 28, 14, 7]


@pytest.mark.parametrize("n", [2, 4])
def test_spatial_split_is_constrain_spatial(n):
    """`spatial_split` splits H where JAX's `constrain_spatial` pins it to
    'model': the JAX test's 32- and 2-row maps and every height of
    R-MG-34 at 224 px."""
    import jax
    import jax.numpy as jnp

    from mgtpu.parallel.mesh import constrain_spatial
    from mgtpu_torch.parallel import spatial_split

    mesh = _jax_mesh(n)
    heights = sorted({32, 2, *RMG34_HEIGHTS})
    with jax.set_mesh(mesh):
        outs = jax.jit(lambda *xs: tuple(constrain_spatial(x) for x in xs))(
            *(jnp.ones((8 // n, h, 2, 8)) for h in heights))
    for h, y in zip(heights, outs):
        spec = tuple(y.sharding.spec) + (None, None)
        assert spatial_split(h, n) == (spec[1] == "model"), h
    assert [h for h in RMG34_HEIGHTS if spatial_split(h, n)] == (
        [224, 112, 56, 28] if n == 2 else [224, 112, 56])


@pytest.mark.parametrize("n", [2, 4])
def test_tp_spec_is_tp_sharding(n):
    """`tp_spec` is JAX's `tp_sharding` on the JAX test's leaves and on
    every leaf shape of the full-width R-MG-34."""
    import jax.numpy as jnp

    from mgtpu.parallel import tp_sharding
    from mgtpu_torch.models import NetOpts, create_model
    from mgtpu_torch.parallel import tp_spec
    from mgtpu_torch.utils.bridge import export_jax_tree

    mesh = _jax_mesh(n, "tensor")
    shapes = [(3, 3, 16, 32), (32,), (3, 3, 3, 8), (15,), ()]
    with pytest.MonkeyPatch.context() as mpatch:  # the full widths, one block each
        mpatch.setattr(trnmg, "STEM", RNMG_FULL[0])
        mpatch.setattr(trnmg, "BLOCKS", RNMG_FULL[1])
        mpatch.setattr(trnmg, "CFG", {**trnmg.CFG, 18: [1, 1, 1, 1]})
        p, s = export_jax_tree(create_model(NetOpts(depth=18)))
    shapes += sorted({v.shape for v in [*_flat(p).values(), *_flat(s).values()]})
    for shape in shapes:
        assert tp_spec(shape, n) == tuple(tp_sharding(mesh, jnp.ones(shape)).spec), shape


LAYOUTS = {"plain": ((8, 32, 32, 3), (8,), 0), "iterSize": ((2, 8, 32, 32, 3), (2, 8), 1),
           "tenCrop": ((8, 10, 32, 32, 3), (8,), 0)}


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_shard_batch_spatial_rows_are_jax_rows(layout):
    """`shard_batch(spatial=True)` on a 4 x 2 mesh gives each rank (i, j)
    the rows JAX's puts on device (i, j): H split (the true H of iterSize
    and ten-crop batches), labels split over the batch only."""
    import jax.numpy as jnp

    from mgtpu.parallel import shard_batch as jax_shard_batch

    xs, ys, axis_ = LAYOUTS[layout]
    x = np.arange(np.prod(xs), dtype=np.float32).reshape(xs)
    y = np.arange(np.prod(ys), dtype=np.int32).reshape(ys)
    mesh = _jax_mesh(2)
    placed = jax_shard_batch(mesh, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, axis_,
                             spatial=True)
    coords = {d: (i, j) for (i, j), d in np.ndenumerate(mesh.devices)}
    from mgtpu_torch.parallel import shard_batch

    for key, arr in (("x", x), ("y", y)):
        for shard in placed[key].addressable_shards:
            i, j = coords[shard.device]
            mine = shard_batch(Mesh(4, i, torch.device("cpu"), n_model=2, model_rank=j),
                               {key: torch.from_numpy(arr)}, axis_, spatial=True)[key]
            np.testing.assert_array_equal(mine.numpy(), np.asarray(shard.data),
                                          err_msg=f"{key} ({i}, {j})")


# ------------------------------------------------- the kernels' plain versions

PADS = [(1, 1), (1, 0), (0, 1), (0, 0)]


@pytest.mark.parametrize("prologue", [False, True], ids=["conv3x3", "conv3x3_bn_relu_in"])
@pytest.mark.parametrize("pads", PADS, ids=[f"pads{a}{b}" for a, b in PADS])
def test_plain_versions_under_per_side_padding(pads, prologue):
    """A slab's rows with the halo rows its pads leave out of the zero
    padding give the whole image's output rows, bit for bit; under the
    prologue the halo rows are normalized and the padding stays 0 (its
    shift makes relu(shift) > 0, so a normalized pad would show)."""
    from mgtpu_torch.ops.cuda_conv import (conv3x3_bn_relu_in_plain, conv3x3_plain,
                                           out_rows)

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 12, 5, 6), dtype=np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 3, 6, 7), dtype=np.float32))
    b = torch.from_numpy(rng.standard_normal(7, dtype=np.float32))
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 6).astype(np.float32))
    shift = torch.from_numpy(rng.uniform(0.5, 1.0, 6).astype(np.float32))
    extra = (scale, shift) if prologue else ()
    fn = conv3x3_bn_relu_in_plain if prologue else conv3x3_plain
    whole, _ = fn(x, w, b, *extra)
    pt, pb = pads
    lo, hi = (0 if pt else 4), (12 if pb else 8)  # the slab: output rows lo..hi
    xs = x[:, lo - (1 - pt):hi + (1 - pb)].contiguous()
    assert out_rows(xs, pt, pb) == hi - lo
    y, stats = fn(xs, w, b, *extra, pad_top=pt, pad_bottom=pb)
    np.testing.assert_array_equal(y.numpy(), whole[:, lo:hi].numpy())
    yf = whole[:, lo:hi].float()
    np.testing.assert_allclose(stats.numpy(), torch.stack([yf.sum((0, 1, 2)),
                                                          (yf * yf).sum((0, 1, 2))]).numpy(),
                               rtol=1e-5)


# conv_i8's per-side padding: (k, stride, pad) -> the (pad_top,
# pad_bottom) pairs; the 7x7/2 stem's halo is 3 rows above and 2 below
# (axis.window_rows(7, 2, 3)), so an H-slab pads 0..3 and 0..2
I8_PADS = ([((3, 1, 1), pads) for pads in [(0, 1), (1, 0), (0, 0)]]
           + [((7, 2, 3), (t, b)) for t in range(4) for b in range(3)]
           + [((1, 1, 0), (0, 0))])


@pytest.mark.parametrize("kernel,pads", I8_PADS,
                         ids=[f"k{k[0]}s{k[1]}-pads{a}{b}" for k, (a, b) in I8_PADS])
def test_conv_i8_plain_under_per_side_padding(kernel, pads):
    """The int8 conv's plain version on a slab's rows, with ``pad_top``
    zero rows above and ``pad_bottom`` below in place of ``pad``, gives
    the whole image's output rows bit for bit: the slab starts at the
    first input row of its first output row after the pads (the rows the
    pads stand for are the image's own zero padding, or rows of it set to
    0), and every other row it reads is the image's."""
    from mgtpu_torch.ops.cuda_conv_i8 import conv_i8_plain, out_size

    (k, s, p), (pt, pb) = kernel, pads
    rng = np.random.default_rng(k * 10 + pt * 3 + pb)
    h = 24
    x = rng.integers(-127, 128, (2, h, 9, 5)).astype(np.int8)
    w = torch.from_numpy(rng.integers(-127, 128, (k, k, 5, 4)).astype(np.int8))
    o0 = -(-(p - pt) // s) + 1  # an output row whose window starts at or below the slab
    r0 = o0 * s - p + pt  # the slab's first row
    r1 = r0 + 11
    x[:, max(r0 - pt, 0):r0] = 0  # what the pads stand for
    x[:, r1:r1 + pb] = 0
    x = torch.from_numpy(x)
    whole = conv_i8_plain(x, w, s, p)
    y = conv_i8_plain(x[:, r0:r1].contiguous(), w, s, p, pad_top=pt, pad_bottom=pb)
    n = out_size(r1 - r0, k, s, pt, pb)
    assert y.shape[1] == n >= 3 and o0 + n <= whole.shape[1]
    np.testing.assert_array_equal(y.numpy(), whole[:, o0:o0 + n].numpy())
    # (pad, pad) is the plain launch, bit for bit
    np.testing.assert_array_equal(conv_i8_plain(x, w, s, p, pad_top=p, pad_bottom=p).numpy(),
                                  whole.numpy())


# ------------------------------------------------------------- the CLI

def _cli(extra, tmp):
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    argv = [sys.executable, "-m", "mgtpu_torch.main", "-netType", "mnist-cluttered/unmg",
            "-dataset", "mnist-seg", "-data", "synthetic", "-synthSize", "16", "-batchSize",
            "4", "-nEpochs", "1", "-epochSize", "1", "-nDonkeys", "0", "-device", "cpu",
            "-cache", str(tmp), *extra]
    return subprocess.run(argv, capture_output=True, text=True, env=env, timeout=DEADLINE,
                          cwd=REPO)


@pytest.mark.parametrize("flags", [["-spatial", "2"], ["-tensor", "2"]], ids=lambda v: v[0])
def test_cli_runs_train_and_test(flags, tmp_path):
    """``python -m mgtpu_torch.main -device cpu -nGPU 2`` with the axis:
    two ranks of one data index train, test and checkpoint."""
    out = _cli(["-nGPU", "2", "-train", "-test", *flags], tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert f"==> 1 data-parallel ranks x 2 {'tensor' if flags[0] == '-tensor' else 'model'}" \
        in out.stdout
    assert "[TESTING]" in out.stdout and "avg.meanIU" in out.stdout
    assert len(list(tmp_path.rglob("model_1.ckpt"))) == 1


# the CLI on the narrowed cifar/nmg: a launcher script that narrows the
# port's plan at import, so the ranks it spawns (which run its top level
# again) build the same net
NARROW_MAIN = """import sys

import mgtpu_torch.models.cifar.nmg as tnmg

tnmg.BLOCKS = {blocks!r}
if __name__ == "__main__":
    from mgtpu_torch.main import main

    main(sys.argv[1:])
"""
I8_NMG = ["-netType", "cifar/nmg", "-dataset", "cifar100-whitened", "-data", "synthetic",
          "-synthSize", "20", "-batchSize", "8", "-imageSize", "36", "-imageCrop", "32",
          "-nDonkeys", "0", "-nEpochs", "1", "-test", "-int8", "-int8Calib", "2"]


def test_cli_int8_spatial_matches_one_rank_and_jax(tmp_path, capsys):
    """``-nGPU 2 -spatial 2 -test -int8 -int8Calib 2`` on the narrowed
    cifar/nmg from one checkpoint (two ranks of one data index, H-slabs
    at 32 and 16 rows, a tail of 4 in the test split): the test loss is
    the one-rank run's and the JAX Session's (one device) within rtol
    1e-4 (tests/test_torch_int8_serve.py's bound for the JAX Session;
    the lines print 5 decimals)."""
    import re

    from mgtpu.pipelines import standard as jax_standard
    from mgtpu.utils import opts as jax_opts
    from mgtpu_torch.main import main
    from mgtpu_torch.models import NetOpts, create_model
    from mgtpu_torch.utils.bridge import export_jax_tree
    from mgtpu_torch.utils.checkpoint import write_checkpoint
    from test_torch_pipeline import _run

    import mgtpu.models.cifar.nmg as jnmg

    model = create_model(NetOpts(netType="cifar/nmg", dataset="cifar100"),
                         generator=torch.Generator().manual_seed(0))
    start = str(tmp_path / "start.ckpt")
    write_checkpoint(start, *export_jax_tree(model), None, epoch=0,
                     meta={"netType": "cifar/nmg", "dataset": "cifar100-whitened",
                           "dtype": "float32"})
    script = tmp_path / "narrow_main.py"
    script.write_text(NARROW_MAIN.format(blocks=CIFAR_BLOCKS["cifar/nmg"]))
    argv = I8_NMG + ["-retrain", start]
    env = {**os.environ, "PYTHONPATH": REPO, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen([sys.executable, str(script), *argv, "-device", "cpu", "-nGPU", "2",
                             "-spatial", "2", "-cache", str(tmp_path / "mesh")], cwd=REPO,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        main(argv + ["-device", "cpu", "-cache", str(tmp_path / "one")])
        one = capsys.readouterr().out
        with pytest.MonkeyPatch.context() as mpatch:
            mpatch.setattr(jnmg, "BLOCKS", CIFAR_BLOCKS["cifar/nmg"])
            ref = _run(jax_standard, jax_opts.parse(argv + ["-cache", str(tmp_path / "jax")]),
                       capsys)[1]
        out, err = proc.communicate(timeout=DEADLINE)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    assert "==> 1 data-parallel ranks x 2 model" in out
    loss = re.compile(r"\[TESTING\].*avg\.loss:([0-9.]+)")
    got, want, jax_loss = (float(loss.search(t).group(1)) for t in (out, one, ref))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    np.testing.assert_allclose(got, jax_loss, rtol=1e-4)


@pytest.mark.parametrize("flags,message", [
    (["-spatial", "2", "-tensor", "2"], "both shard the second mesh axis"),
    (["-zero1", "-tensor", "2"], "-zero1 and -tensor are mutually exclusive"),
    (["-int8", "-tensor", "2"], "-int8 does not compose with -tensor"),
], ids=["spatial+tensor", "zero1+tensor", "int8+tensor"])
def test_clashes_are_refused(flags, message):
    """The JAX Session's refusals, in its words."""
    from mgtpu_torch.utils import opts

    with pytest.raises(SystemExit, match=message):
        opts.parse(["-netType", "cifar/nmg", "-dataset", "cifar100-whitened", "-test", *flags])
