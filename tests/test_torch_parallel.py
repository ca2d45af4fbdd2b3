"""The port's data-parallel layer in one process (`mgtpu_torch/parallel/mesh.py`,
the ``-nGPU`` clamp in `mgtpu_torch/main.py`) against the JAX package's
(`mgtpu/parallel/mesh.py`, the clamp in its Session): ZeRO-1's rule for
which momentum leaves shard, the clamp on every recipe's (nGPU,
batchSize), each rank's rows of a plain, an iterSize and a ten-crop
batch against the shards JAX places on a two-device mesh, and a mesh of
one rank as a passthrough. The two-rank runs are in
tests/test_torch_dp.py."""

import contextlib
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgtpu.parallel import make_mesh as jax_make_mesh
from mgtpu.parallel import shard_batch as jax_shard_batch
from mgtpu.parallel import zero1_spec as jax_zero1_spec
import mgtpu_torch.main as tmain
import mgtpu_torch.models.cifar.nmg as tnmg
from mgtpu_torch import parallel
from mgtpu_torch.models import NetOpts, create_model
from mgtpu_torch.nn import BatchNorm, Dropout, batch_group
from mgtpu_torch.utils import opts
from test_scripts import SCRIPTS, recipe_argv
from test_torch_dp import BLOCKS

# tests/test_train_dp.py::test_zero1_spec_logic's shapes
SPEC_SHAPES = [(3, 3, 16, 32), (16,), (15,), ()]


@pytest.mark.parametrize("n_data", [1, 2, 8])
def test_zero1_spec_is_the_jax_rule(n_data, monkeypatch):
    """On test_train_dp.py's shapes and on every parameter of a narrowed
    cifar/nmg, the port shards the leaves JAX shards, on the same dim."""
    monkeypatch.setattr(tnmg, "BLOCKS", BLOCKS["cifar/nmg"])
    shapes = SPEC_SHAPES + [tuple(p.shape) for p in create_model(
        NetOpts(netType="cifar/nmg", dataset="cifar100")).parameters()]
    got = [parallel.zero1_spec(torch.zeros(s), n_data) for s in shapes]
    assert got == [tuple(jax_zero1_spec(jnp.zeros(s), n_data)) for s in shapes]
    assert any(got) == (n_data > 1)


def _ranks(argv, device_count=None, monkeypatch=None):
    """(data_ranks of the parsed argv, what it printed)."""
    opt = opts.parse(argv)
    if device_count is not None:
        monkeypatch.setattr(torch.cuda, "device_count", lambda: device_count)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        n = tmain.data_ranks(opt)
    return n, out.getvalue()


@pytest.mark.parametrize("path", SCRIPTS, ids=[p.split("scripts/")[-1] for p in SCRIPTS])
def test_clamp_on_every_recipe(path):
    """The JAX Session's rule on each recipe's (nGPU, batchSize), with as
    many CPU ranks as it asks for: the largest divisor of batchSize not
    above nGPU, and the JAX line where the divisor moves it."""
    argv = recipe_argv(path) + ["-device", "cpu"] + (
        ["-trainedNet", "model_1.ckpt"] if "saliency" in path else [])
    opt = opts.parse(argv)
    n, out = _ranks(argv)
    asked = max(opt.nGPU, 1)
    assert n == max(d for d in range(1, asked + 1) if opt.batchSize % d == 0)
    assert (f"==> nGPU clamped to {n} (batchSize {opt.batchSize} must divide across the "
            f"data mesh)" in out) == (n != asked)


def test_clamp_to_the_cards_and_the_batch(monkeypatch):
    """cifar/rnmg.sh's batch 64 on 3 devices runs on 2 (the JAX line);
    -nGPU 2 on one card runs one rank, and says so; -nGPU 0 takes every
    card; no card under -device cuda stops the run."""
    rnmg = next(p for p in SCRIPTS if p.endswith("cifar/rnmg.sh"))
    assert _ranks(recipe_argv(rnmg), 4, monkeypatch) == (
        2, "==> nGPU clamped to 2 (batchSize 64 must divide across the data mesh)\n")
    base = ["-netType", "cifar/nmg", "-batchSize", "8", "-train"]
    assert _ranks(base + ["-nGPU", "2"], 1, monkeypatch) == (
        1, "==> nGPU clamped to 1 (1 CUDA devices)\n")
    assert _ranks(base + ["-nGPU", "0"], 4, monkeypatch) == (4, "")
    with pytest.raises(SystemExit, match="no CUDA device"):
        _ranks(base + ["-nGPU", "2"], 0, monkeypatch)


def _batches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((8, 4, 4, 3), dtype=np.float32)
    return {
        "plain": ({"x": x, "y": np.arange(8)}, 0),
        "iterSize": ({"x": x.reshape(2, 4, 4, 4, 3), "y": np.arange(8).reshape(2, 4)}, 1),
        "tenCrop": ({"x": rng.standard_normal((4, 10, 4, 4, 3), dtype=np.float32),
                     "y": np.arange(4)}, 0),
    }


@pytest.mark.parametrize("kind", ["plain", "iterSize", "tenCrop"])
def test_shard_batch_keeps_the_rows_jax_places_on_each_device(kind):
    """Rank r's rows of a batch are the shard JAX's shard_batch puts on
    device r of a two-device data mesh, for each batch layout."""
    tree, axis = _batches()[kind]
    placed = jax_shard_batch(jax_make_mesh(n_data=2), tree, axis)
    for r in (0, 1):
        mine = parallel.shard_batch(parallel.Mesh(2, r, torch.device("cpu")), tree, axis)
        for k, arr in placed.items():
            device = arr.sharding.mesh.devices[r, 0]
            shard = next(s for s in arr.addressable_shards if s.device == device)
            np.testing.assert_array_equal(mine[k], np.asarray(shard.data), err_msg=f"{k} {r}")
    with pytest.raises(ValueError, match="do not divide"):
        parallel.shard_batch(parallel.Mesh(3, 0, torch.device("cpu")), tree, axis)


def test_one_rank_is_a_passthrough():
    """A mesh of one rank joins no group: fetch_global, gather_tree,
    shard_batch, shard_opt_zero1, the gradient and metric reductions,
    replicate (Dropout seeds too) and same_bits change nothing, and
    BatchNorm under batch_group gives the group-less bits, forward and
    backward."""
    mesh = parallel.make_mesh()
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None) and parallel.is_primary()
    x = torch.arange(12.0).reshape(3, 4)
    assert parallel.fetch_global(mesh, x) is x
    tree = {"x": x}
    assert parallel.shard_batch(mesh, tree) is tree
    params = [torch.zeros(3, 3, 2, 4), torch.zeros(4)]
    state = {"m": [torch.ones(3, 3, 2, 4), torch.ones(4)]}
    assert all(a is b for a, b in zip(parallel.gather_tree(mesh, state, params)["m"], state["m"]))
    assert all(a is b for a, b in zip(
        parallel.shard_opt_zero1(mesh, state, params)["m"], state["m"]))
    g = [x.clone()]
    parallel.all_reduce_mean(mesh, g)
    assert torch.equal(g[0], x)
    metrics = {"loss": torch.tensor(1.5)}
    assert parallel.mean_metrics(mesh, metrics) is metrics
    drop = Dropout(0.5, torch.Generator().manual_seed(3))
    seed = drop.seed
    model = torch.nn.Sequential(drop)
    assert parallel.replicate(mesh, model) is model and drop.seed == seed
    assert parallel.same_bits(mesh, params)

    inp = torch.randn(2, 3, 3, 4, generator=torch.Generator().manual_seed(0), requires_grad=True)
    outs = []
    for ctx in (contextlib.nullcontext(), batch_group(mesh)):
        bn = BatchNorm(4).train()
        with ctx:
            y = bn(inp)
            scale, shift = bn.batch_affine(inp)
            grads = torch.autograd.grad((y * y).sum() + (scale * shift).sum(), inp)
        outs.append([y, scale, shift, *grads, bn.mean, bn.var])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_a_group_of_one_changes_no_bit(monkeypatch):
    """A gloo group of one rank (as NCCL runs on one card): the step's
    collectives run (the gradient all-reduce, the metrics' mean, the
    replica's broadcast and bit check) and change no bit of the
    group-less step on a narrowed cifar/nmg, iterSize 2."""
    import torch.distributed as dist

    from mgtpu_torch.models import get_spec
    from mgtpu_torch.train.optim import sgd_init
    from mgtpu_torch.train.step import make_train_step
    from mgtpu_torch.main import free_port

    monkeypatch.setattr(tnmg, "BLOCKS", BLOCKS["cifar/nmg"])
    spec = get_spec("cifar/nmg")
    rng = np.random.default_rng(0)
    batch = {"x": torch.from_numpy(rng.standard_normal((2, 4, 32, 32, 3), dtype=np.float32)),
             "y": torch.from_numpy(rng.integers(0, 100, (2, 4)))}
    outs = []
    for grouped in (False, True):
        mesh = (parallel.make_mesh(1, init_method=f"tcp://127.0.0.1:{free_port()}")
                if grouped else parallel.make_mesh())
        try:
            assert (mesh.group is not None) == grouped
            model = parallel.replicate(mesh, create_model(
                NetOpts(netType="cifar/nmg", dataset="cifar100"),
                generator=torch.Generator().manual_seed(0)))
            state = sgd_init(model.parameters())
            metrics = make_train_step(model, spec.create_loss(None), spec, iter_size=2,
                                      mesh=mesh, log_grad_norm=True)(state, batch, 0.1, 5e-4)
            assert parallel.same_bits(mesh, model.parameters())
            outs.append([*metrics.values(), *model.parameters(), *model.buffers(), *state["m"]])
        finally:
            if grouped:
                dist.destroy_process_group()
    assert len(outs[0]) == len(outs[1])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
