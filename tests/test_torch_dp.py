"""Data-parallel training and serving in the port (`mgtpu_torch/parallel`,
the train step's ``mesh`` and ``zero1``, BatchNorm under
`nn.batch_group`, the launcher in `mgtpu_torch/main.py`) on the CPU:
two ranks in two processes over gloo, against the port's one-rank step
on the global batch and the JAX step under ``make_mesh(n_data=2)``.

- narrowed ``cifar/nmg`` (batch 16 of 32x32, iterSize 1 and 2) and a
  narrowed ``cifar/prnmg`` of nLayer 1, whose BatchNorms reach
  `conv3x3_bn_relu_in` as a (scale, shift) through ``batch_affine``: the
  loss to rtol 1e-5 of the one-rank step's, the parameters, running
  stats and momentum to rtol 1e-4 / atol 1e-5 (the port-vs-JAX bound
  of tests/test_torch_cifar_train.py; measured apart by at most 6.2e-7
  in a parameter, 6.2e-6 in a momentum, 2.5e-5 of a running stat's
  value, all in prnmg), and to the JAX mesh step's at the same bounds
  (tighter than ``test_dp_matches_single_device``'s 1e-3 / 1e-4); the
  parameters the same bits on both ranks after each of two steps;
- BatchNorm's power: rank 1's half shifted by +3, the synced step meets
  the one-rank step, a step with each rank's own BatchNorm misses it by
  more than 10x the tolerance;
- ZeRO-1: each rank holds half the bytes of every eligible momentum
  leaf, the update, the gathered momentum and the checkpoint npz equal
  the plain two-rank step's bit for bit;
- each rank's dropout masks: rank 0's the one-rank masks, rank 1's
  others, both at the rate;
- a saliency group split over the ranks: the one-rank group's points
  and saliency;
- the CLI: ``-nGPU 2`` and ``-multihost`` (two launchers, one rank each)
  on ``mnist-cluttered/unmg`` as tests/test_multihost.py runs the JAX
  CLI: the same test loss on both ranks and, to print precision, the
  one-rank run's; one checkpoint, rank 0's; a ``-zero1`` resume.

Every spawned process has a deadline, so a hung rank fails its test
instead of the suite.
"""

import glob
import os
import re
import subprocess
import sys
import time
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from mgtpu_torch.main import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE = 240  # seconds for a spawned group or a CLI run
N_CLASSES = 100
LR, WD = 0.1, 5e-4
# narrowed plans, as tests/test_torch_cifar_train.py narrows them
BLOCKS = {
    "cifar/nmg": [([6, 5, 4], [3, 3, 3]), ([8, 6, 4], [3, 3, 3]), ([8, 6, 5], [3, 3, 3]),
                  ([10, 8, 6], [3, 3, 1]), ([12, 7], [3, 1])],
    "cifar/prnmg": [([8, 6, 4], [3, 3, 3]), ([10, 6, 5], [3, 3, 3]), ([12, 8, 4], [3, 3, 3]),
                    ([12, 8, 6], [3, 3, 1]), ([12, 10], [3, 1])],
}
# case -> (net, iterSize, zero1, shift of rank 1's half, steps)
STEPS = {
    "nmg": ("cifar/nmg", 1, False, 0.0, 2),
    "nmg-iter2": ("cifar/nmg", 2, False, 0.0, 1),
    "prnmg": ("cifar/prnmg", 1, False, 0.0, 1),
    "power": ("cifar/nmg", 1, False, 3.0, 1),
    "nmg-zero1": ("cifar/nmg", 1, True, 0.0, 2),
}
JAX_CASES = ["nmg", "nmg-iter2", "prnmg"]  # held to the one-rank and the JAX mesh step
SAL_WINDOWS, SAL_BLOCKS4 = 6, [8, 6, 5, 4]


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """At most two torch threads in this process while the module runs,
    as tests/test_torch_cifar_models.py holds them (each rank and each
    CLI process takes one): the suite's workers share the machine's
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    """{"a/b/...": numpy leaf} of a nested dict (the JAX trees' layout)."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _set_blocks(net):
    """The narrowed plan in the port's model module (in a rank process)."""
    import mgtpu_torch.models.cifar.nmg as tnmg
    import mgtpu_torch.models.cifar.pnmg as tpnmg

    (tnmg if net == "cifar/nmg" else tpnmg).BLOCKS = BLOCKS[net]


def _port_model(net, inputs, dropout=False):
    from mgtpu_torch.models import NetOpts, create_model
    from mgtpu_torch.utils.bridge import load_jax_tree, load_momentum
    from mgtpu_torch.utils.checkpoint import load_checkpoint

    _set_blocks(net)
    model = create_model(NetOpts(netType=net, dataset="cifar100", isDropout=dropout),
                         generator=torch.Generator().manual_seed(0))
    if inputs is None:
        return model, None
    ck = load_checkpoint(inputs)
    load_jax_tree(model, ck["params"], ck["stats"])
    return model, load_momentum(model, ck["opt_state"])


def _state(model, opt_state):
    from mgtpu_torch.utils.bridge import export_jax_tree, export_momentum

    p, s = export_jax_tree(model)
    out = {f"p/{k}": v for k, v in _flat(p).items()}
    out.update({f"s/{k}": v for k, v in _flat(s).items()})
    out.update({f"m/{k}": v for k, v in _flat(export_momentum(model, opt_state)["m"]).items()})
    return out


def _step_case(mesh, case, inputs, out_dir):
    """One STEPS case on this rank: the step(s) on its slice, the state
    after the first (momentum gathered), whether the ranks hold the same
    bits after each, the momentum's bytes here, and rank 0's checkpoint."""
    from mgtpu_torch.models import get_spec
    from mgtpu_torch.parallel import (gather_tree, replicate, same_bits, shard_batch,
                                      shard_opt_zero1)
    from mgtpu_torch.train.step import make_train_step
    from mgtpu_torch.utils.checkpoint import save_checkpoint

    net, iters, zero1, _, steps = STEPS[case]
    model, opt_state = _port_model(net, inputs)
    model = replicate(mesh, model)
    if zero1:
        opt_state = shard_opt_zero1(mesh, opt_state, model.parameters())
    spec = get_spec(net)
    step = make_train_step(model, spec.create_loss(None), spec, iter_size=iters, mesh=mesh,
                           zero1=zero1, bucket_sgd=not zero1, log_grad_norm=True)
    data = np.load(inputs + ".npz")
    batch = shard_batch(mesh, {"x": torch.from_numpy(data["x"]), "y": torch.from_numpy(data["y"])},
                        1 if iters > 1 else 0)
    res = {"m_bytes": np.array([m.nbytes for m in opt_state["m"]]),
           "p_bytes": np.array([p.nbytes for p in model.parameters()])}
    bits = []
    for i in range(steps):
        metrics = step(opt_state, batch, LR, WD)
        bits.append(same_bits(mesh, [*model.parameters(), *model.buffers()]))
        if i == 0:
            full = gather_tree(mesh, opt_state, model.parameters())
            res.update(_state(model, full))
            res.update({f"metric/{k}": np.float64(v) for k, v in metrics.items()})
            if mesh.rank == 0:
                save_checkpoint(os.path.join(out_dir, f"{case}.ckpt"), model, full, 1,
                                {"netType": net})
    res["bits"] = np.array(bits)
    return res


def _dropout_case(mesh):
    """The first two Dropouts' masks of a narrowed cifar/prnmg
    --isDropout replica on this rank."""
    from mgtpu_torch.nn import Dropout
    from mgtpu_torch.parallel import replicate

    model, _ = _port_model("cifar/prnmg", None, dropout=True)
    drops = [m for m in replicate(mesh, model).modules() if isinstance(m, Dropout)][:2]
    x = torch.ones(20_000)
    return {f"mask{i}": (d.train()(x) != 0).numpy() for i, d in enumerate(drops)}


def _saliency_session(mesh, dump):
    """A narrowed pnmg.mnist (its BatchNorms calibrated) on 4 synthetic
    mnist-saliency samples with the occlusion windows cut to
    SAL_WINDOWS, groups of 2."""
    import mgtpu_torch.data.mnist as tmnist
    import mgtpu_torch.models.mnist_cluttered.pnmg_mnist as tpnmg_mnist
    from mgtpu_torch.data.prefetch import DonkeyPool
    from mgtpu_torch.models import NetOpts, create_model, get_spec
    from mgtpu_torch.serve import calibrate_batchnorm

    tpnmg_mnist.BLOCKS4 = SAL_BLOCKS4
    full = tmnist.occlusion_masks
    tmnist.occlusion_masks = lambda: full()[:SAL_WINDOWS]
    try:
        opt = types.SimpleNamespace(dataset="mnist-saliency", data="synthetic", synthSize=4,
                                    saliencyBatch=2, saliencyDumpStack=dump)
        loaders = {"test": tmnist.build_mnist_saliency(opt)["test"]}
    finally:
        tmnist.occlusion_masks = full
    net = NetOpts(netType="mnist-cluttered/pnmg.mnist", dataset="mnist-aff")
    gen = torch.Generator().manual_seed(0)
    model = create_model(net, generator=gen)
    calibrate_batchnorm(model, gen, get_spec(net.netType).image_shape)
    return types.SimpleNamespace(opt=opt, loaders=loaders, model=model.eval(),
                                 device=torch.device("cpu"), mesh=mesh,
                                 pool=DonkeyPool(0, opt=opt, loaders=loaders))


def _saliency_case(mesh):
    from mgtpu_torch.pipelines.saliency import saliency_samples

    res = {}
    for dump in (1, 0):
        for ind, arrays in saliency_samples(_saliency_session(mesh, dump)):
            res.update({f"{dump}/{ind}/{k}": v for k, v in arrays.items()})
    return res


def _ranks(rank, init, out_dir, inputs):
    """A rank of the two-rank group: every case, its results in
    ``out_dir``/<case>.<rank>.npz."""
    from mgtpu_torch.parallel import make_mesh

    torch.set_num_threads(1)
    mesh = make_mesh(2, rank=rank, device="cpu", init_method=init)
    try:
        for case in STEPS:
            np.savez(os.path.join(out_dir, f"{case}.{rank}.npz"),
                     **_step_case(mesh, case, inputs[case], out_dir))
        np.savez(os.path.join(out_dir, f"dropout.{rank}.npz"), **_dropout_case(mesh))
        np.savez(os.path.join(out_dir, f"saliency.{rank}.npz"), **_saliency_case(mesh))
    finally:
        dist.destroy_process_group()


def _join(ctx, start):
    """Wait for the spawned ranks of ``ctx``; fail past the deadline."""
    try:
        while not ctx.join(timeout=5):
            assert time.monotonic() < start + DEADLINE, f"the ranks took over {DEADLINE} s"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def _jax_mesh_step(case, inputs):
    """The JAX step of a STEPS case on a two-device data mesh (params,
    stats and momentum replicated, the batch sharded): (metrics, state)."""
    import jax
    import jax.numpy as jnp

    import mgtpu.models.cifar.nmg as jnmg
    import mgtpu.models.cifar.pnmg as jpnmg
    from mgtpu.models import get_net
    from mgtpu.parallel import make_mesh, replicate, shard_batch
    from mgtpu.train.step import make_train_step

    net, iters = STEPS[case][:2]
    p, s, m, x, y = inputs
    with pytest.MonkeyPatch.context() as mpatch:
        mpatch.setattr(jnmg if net == "cifar/nmg" else jpnmg, "BLOCKS", BLOCKS[net])
        jnet = get_net(net)
        jm = jnet.create_model(types.SimpleNamespace(dataset="cifar100", nLayer=1,
                                                     isDropout=False))
        step = jax.jit(make_train_step(jm, jnet.create_loss(None), jnet, iter_size=iters))
        mesh = make_mesh(n_data=2)
        batch = shard_batch(mesh, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
                            1 if iters > 1 else 0)
        with jax.set_mesh(mesh):
            p2, s2, o2, m2 = step(replicate(mesh, p), replicate(mesh, s),
                                  replicate(mesh, {"m": m}), batch, LR, WD,
                                  jax.random.PRNGKey(0))
    ref = {f"p/{k}": v for k, v in _flat(jax.tree.map(np.asarray, p2)).items()}
    ref.update({f"s/{k}": v for k, v in _flat(jax.tree.map(np.asarray, s2)).items()})
    ref.update({f"m/{k}": v for k, v in _flat(jax.tree.map(np.asarray, o2["m"])).items()})
    return {k: float(v) for k, v in m2.items()}, ref


def _init_draw(p, rng):
    """The parameter tree ``p`` drawn anew with numpy by the init's laws
    (`mgtpu/nn.py`): a conv kernel N(0, 2 / (k*k*Co)), a dense kernel
    U(-1/sqrt(Ci), 1/sqrt(Ci)); biases and BN affines as they are (the
    init's constants)."""
    out = {}
    for k, v in p.items():
        if isinstance(v, dict):
            out[k] = _init_draw(v, rng)
        elif k == "w" and v.ndim == 4:
            kh, kw, _, co = v.shape
            out[k] = (rng.standard_normal(v.shape) * np.sqrt(2.0 / (kh * kw * co))).astype(
                np.float32)
        elif k == "w":
            bound = 1.0 / np.sqrt(v.shape[0])
            out[k] = rng.uniform(-bound, bound, v.shape).astype(np.float32)
        else:
            out[k] = v.copy()
    return out


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """Each STEPS case's inputs (initial weights drawn with numpy by the
    init's laws, one draw a net, in the JAX trees' layout of the port's
    model, jittered as the CIFAR parity tests jitter them, a momentum, a
    batch), the two ranks run on all cases, and the JAX mesh step of
    JAX_CASES meanwhile: ``inputs`` {case: (p, s, m, x, y)},
    ``results`` {case: [rank 0, rank 1]}, ``tmp``, ``jax`` {case:
    (metrics, state)}."""
    import jax

    from mgtpu_torch.utils.bridge import export_jax_tree
    from mgtpu_torch.utils.checkpoint import write_checkpoint
    from test_torch_cifar_train import _jitter

    tmp = tmp_path_factory.mktemp("dp")
    init = {}
    for seed, net in enumerate(("cifar/nmg", "cifar/prnmg")):
        p, s = export_jax_tree(_port_model(net, None)[0])
        init[net] = (_init_draw(p, np.random.default_rng(seed)), s)
    inputs, paths = {}, {}
    for case, (net, iters, _, shift, _) in STEPS.items():
        p, s = jax.tree.map(np.copy, init[net])
        rng = np.random.default_rng(1)
        _jitter(p, s, rng)
        m = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32) * 0.01, p)
        shape = (iters, 16) if iters > 1 else (16,)
        x = rng.standard_normal((*shape, 32, 32, 3), dtype=np.float32)
        x[..., 8:, :, :, :] += shift  # rank 1's half
        y = rng.integers(0, N_CLASSES, shape)
        path = str(tmp / case)
        write_checkpoint(path, p, s, {"m": m})
        np.savez(path + ".npz", x=x, y=y)
        inputs[case], paths[case] = (p, s, m, x, y), path
    start = time.monotonic()
    ctx = mp.start_processes(_ranks, args=(f"tcp://127.0.0.1:{free_port()}", str(tmp), paths),
                             nprocs=2, join=False, start_method="spawn")
    try:  # the JAX mesh steps while the ranks run
        jax_steps = {case: _jax_mesh_step(case, inputs[case]) for case in JAX_CASES}
    finally:
        _join(ctx, start)
    results = {case: [dict(np.load(tmp / f"{case}.{r}.npz")) for r in (0, 1)]
               for case in [*STEPS, "dropout", "saliency"]}
    return types.SimpleNamespace(inputs=inputs, results=results, tmp=tmp, jax=jax_steps)


def _one_rank(case, inputs, x=None, steps=1):
    """The port's group-less step on the global batch (or on ``x``)."""
    from mgtpu_torch.models import get_spec
    from mgtpu_torch.train.step import make_train_step

    net, iters = STEPS[case][:2]
    model, opt_state = _port_model(net, inputs)
    data = np.load(inputs + ".npz")
    spec = get_spec(net)
    step = make_train_step(model, spec.create_loss(None), spec, iter_size=iters,
                           log_grad_norm=True)
    batch = {"x": torch.from_numpy(data["x"] if x is None else x), "y": torch.from_numpy(data["y"])}
    metrics = step(opt_state, batch, LR, WD)
    return {k: float(v) for k, v in metrics.items()}, _state(model, opt_state)


def _assert_state_close(got, ref, rtol, atol, keys=("p", "s", "m")):
    want = {k: v for k, v in ref.items() if k.split("/")[0] in keys}
    assert want and set(want) <= set(got)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=rtol, atol=atol, err_msg=k)


def _update_error(got, ref, before):
    """||update - reference update|| / ||reference update|| over the
    parameters (chip_smoke's step error)."""
    keys = [k for k in ref if k.startswith("p/")]
    d = np.concatenate([(got[k] - before[k]).ravel() for k in keys])
    r = np.concatenate([(ref[k] - before[k]).ravel() for k in keys])
    return float(np.linalg.norm(d - r) / np.linalg.norm(r))


@pytest.mark.parametrize("case", JAX_CASES)
def test_two_ranks_equal_one_rank_and_each_other(dp, case):
    """The two-rank step is the one-rank step on the global batch, and
    both ranks hold the same bits after every step."""
    results, tmp = dp.results, dp.tmp
    r0, r1 = results[case]
    metrics, ref = _one_rank(case, str(tmp / case))
    np.testing.assert_allclose(r0["metric/loss"], metrics["loss"], rtol=1e-5)
    for k in ("top1", "gradnorm", "pnorm", "maxupd"):
        np.testing.assert_allclose(r0[f"metric/{k}"], metrics[k], rtol=1e-4, err_msg=k)
    _assert_state_close(r0, ref, rtol=1e-4, atol=1e-5)
    assert r0["bits"].all() and r1["bits"].all() and len(r0["bits"]) == STEPS[case][4]
    for k in ref:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


@pytest.mark.parametrize("case", JAX_CASES)
def test_two_ranks_equal_the_jax_mesh_step(dp, case):
    """The two-rank step against the JAX step on a two-device data mesh
    (params, stats and momentum replicated, the batch sharded), on the
    same weights."""
    metrics, ref = dp.jax[case]
    got = dp.results[case][0]
    np.testing.assert_allclose(got["metric/loss"], metrics["loss"], rtol=1e-5)
    _assert_state_close(got, ref, rtol=1e-4, atol=1e-5)


def test_batchnorm_sums_over_the_ranks(dp):
    """Power check: rank 1's half is shifted by +3, so the two halves'
    batch moments differ. The synced step meets the one-rank step on the
    global batch; each rank normalizing by its own half's moments (the
    reference's per-GPU BatchNorm: the mean of the two halves' gradients,
    each taken alone) misses it by more than 10x the tolerance."""
    from mgtpu_torch.train.optim import sgd_update

    inputs, results, tmp = dp.inputs, dp.results, dp.tmp
    path = str(tmp / "power")
    p, s, m, x, y = inputs["power"]
    before = {f"p/{k}": v for k, v in _flat(p).items()}
    _, ref = _one_rank("power", path)
    tol = 1e-5
    synced = _update_error(results["power"][0], ref, before)
    # per-rank BatchNorm: each half's gradient with its own moments
    # (momentum and weight decay 0, lr 0: the momentum buffer is the
    # gradient), averaged, then the step's SGD update
    from mgtpu_torch.models import get_spec
    from mgtpu_torch.train.step import make_train_step

    grads = []
    for half in (slice(0, 8), slice(8, 16)):
        model, _ = _port_model("cifar/nmg", path)
        zero = {"m": [torch.zeros_like(q) for q in model.parameters()]}
        spec = get_spec("cifar/nmg")
        make_train_step(model, spec.create_loss(None), spec, momentum=0.0)(
            zero, {"x": torch.from_numpy(x[half]), "y": torch.from_numpy(y[half])}, 0.0, 0.0)
        grads.append(zero["m"])
    model, opt_state = _port_model("cifar/nmg", path)
    sgd_update(list(model.parameters()), [(a + b) / 2 for a, b in zip(*grads)], opt_state, LR, WD)
    per_rank = _update_error(_state(model, opt_state), ref, before)
    print(f"update error against the one-rank step: synced {synced:.3g}, per-rank BN "
          f"{per_rank:.3g} (tolerance {tol})")
    assert synced <= tol < per_rank / 10


def test_zero1_holds_half_and_equals_the_plain_step(dp):
    """-zero1: each rank holds exactly half the bytes of every momentum
    leaf whose trailing dim divides 2 (the rest whole); the parameters,
    stats and gathered momentum after the step, the metrics (the
    gradient norm to rtol 1e-6), and rank 0's checkpoint npz equal the
    plain two-rank step's bit for bit; the ranks hold the same bits
    after each of two steps."""
    from mgtpu_torch.parallel import zero1_spec
    from mgtpu_torch.utils.checkpoint import load_checkpoint

    results, tmp = dp.results, dp.tmp
    z0, z1 = results["nmg-zero1"]
    plain = results["nmg"][0]
    model, _ = _port_model("cifar/nmg", str(tmp / "nmg"))
    eligible = np.array([bool(zero1_spec(q, 2)) for q in model.parameters()])
    assert eligible.sum() > 0 and (~eligible).sum() > 0
    for r in (z0, z1):
        np.testing.assert_array_equal(r["m_bytes"][eligible], r["p_bytes"][eligible] // 2)
        np.testing.assert_array_equal(r["m_bytes"][~eligible], r["p_bytes"][~eligible])
        assert r["bits"].all()
    np.testing.assert_array_equal(plain["m_bytes"], plain["p_bytes"])
    for k in plain:
        if k.split("/")[0] in ("p", "s", "m", "metric") and k != "metric/gradnorm":
            np.testing.assert_array_equal(z0[k], plain[k], err_msg=k)
    # the gradient norm sums the slices' squares over the ranks: another order
    np.testing.assert_allclose(z0["metric/gradnorm"], plain["metric/gradnorm"], rtol=1e-6)
    a, b = load_checkpoint(str(tmp / "nmg-zero1.ckpt")), load_checkpoint(str(tmp / "nmg.ckpt"))
    for key in ("params", "stats", "opt_state"):
        fa, fb = _flat(a[key]), _flat(b[key])
        assert sorted(fa) == sorted(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{key}/{k}")


def test_dropout_masks_differ_between_ranks(dp):
    """Every rank built the model from one seed; replicate offsets each
    Dropout's masks by the rank: rank 0 draws the one-rank masks, rank 1
    others, each kept at 1 - rate within 6 binomial deviations."""
    from mgtpu_torch.nn import Dropout

    results = dp.results
    r0, r1 = results["dropout"]
    model, _ = _port_model("cifar/prnmg", None, dropout=True)
    drops = [m for m in model.modules() if isinstance(m, Dropout)][:2]
    assert len(drops) == 2
    for i, d in enumerate(drops):
        one = (d.train()(torch.ones(20_000)) != 0).numpy()
        np.testing.assert_array_equal(r0[f"mask{i}"], one)
        assert not np.array_equal(r1[f"mask{i}"], one)
        for mask in (r0[f"mask{i}"], r1[f"mask{i}"]):
            n = mask.size
            assert abs(mask.mean() - (1 - d.rate)) <= 6 * np.sqrt(d.rate * (1 - d.rate) / n)


def test_saliency_group_split_over_the_ranks(dp):
    """A group of 2 samples split over the ranks (its 2 x 7 stack rows
    with the host probe, its 2 base images with the device probe), the
    outputs gathered before the probe: both ranks yield the one-rank
    samples, points bit for bit, saliency and outputs at rtol 1e-5 /
    atol 1e-6."""
    from mgtpu_torch.pipelines.saliency import saliency_samples

    results = dp.results
    ref = {}
    for dump in (1, 0):
        for ind, arrays in saliency_samples(_saliency_session(None, dump)):
            ref.update({f"{dump}/{ind}/{k}": v for k, v in arrays.items()})
    assert any(k.startswith("0/") for k in ref) and any(k.startswith("1/") for k in ref)
    for got in results["saliency"]:
        assert sorted(got) == sorted(ref)
        for k, v in ref.items():
            if k.endswith(("points", "input")):
                np.testing.assert_array_equal(got[k], v, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------- the CLI

SEG = ["-netType", "mnist-cluttered/unmg", "-dataset", "mnist-seg", "-data", "synthetic",
       "-synthSize", "40", "-batchSize", "8", "-nDonkeys", "0", "-device", "cpu"]
RUN = ["-nEpochs", "1", "-epochSize", "2", "-train", "-test"]
TESTING = re.compile(r"\[TESTING\].*avg\.loss:([0-9.]+)")


def _popen(args, **env):
    return subprocess.Popen([sys.executable, "-m", "mgtpu_torch.main", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
                            env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **env))


def _finish(procs):
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=DEADLINE)
            outs.append(out)
            assert p.returncode == 0, (out[-1500:], err[-1500:])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return outs


def _loss(text):
    m = TESTING.search(text)
    assert m, text[-800:]
    return float(m.group(1))


def _read(path):
    with open(path) as f:
        return f.read()


@pytest.fixture(scope="module")
def one_rank_loss(tmp_path_factory):
    """The one-rank run's test loss (in this process)."""
    import contextlib
    import io

    import mgtpu_torch.main as tmain

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tmain.main(SEG + RUN + ["-cache", str(tmp_path_factory.mktemp("one"))])
    return _loss(out.getvalue())


def test_cli_two_ranks_train_test_and_resume(one_rank_loss, tmp_path):
    """-nGPU 2 on the CPU: both ranks print the same test loss, the
    one-rank run's to print precision (tests/test_multihost.py's bound);
    one model_1.ckpt, rank 0's, and rank 1's logs under proc1/; a
    -zero1 resume from it (the momentum sharded after the load, gathered
    for the save) runs epoch 2 and writes model_2.ckpt."""
    out, = _finish([_popen(SEG + RUN + ["-nGPU", "2", "-cache", str(tmp_path / "a")])])
    assert "==> 2 data-parallel ranks" in out
    rank1 = glob.glob(str(tmp_path / "a" / "**" / "proc1" / "stdout.log"), recursive=True)
    assert len(rank1) == 1, rank1
    np.testing.assert_allclose(_loss(out), _loss(_read(rank1[0])), rtol=1e-6)
    np.testing.assert_allclose(_loss(out), one_rank_loss, atol=2e-5)
    ckpts = glob.glob(str(tmp_path / "a" / "**" / "model_1.ckpt"), recursive=True)
    assert len(ckpts) == 1 and "proc1" not in ckpts[0], ckpts
    out, = _finish([_popen(SEG + ["-nGPU", "2", "-zero1", "-retrain", ckpts[0], "-epochNumber",
                                  "2", "-nEpochs", "2", "-epochSize", "1", "-train",
                                  "-cache", str(tmp_path / "b")])])
    assert f"=> resumed from {ckpts[0]} (epoch 1)" in out and "Epoch: [2][1/1]" in out
    ckpts = glob.glob(str(tmp_path / "b" / "**" / "model_*.ckpt"), recursive=True)
    assert [os.path.basename(c) for c in ckpts] == ["model_2.ckpt"], ckpts


def test_cli_multihost(one_rank_loss, tmp_path):
    """-multihost: two launcher processes, one rank each, joined by the
    MGTPU_* variables: the same test loss on both, the one-rank run's to
    print precision; rank 1 writes under proc1/ and no checkpoint."""
    env = {"MGTPU_COORDINATOR": f"127.0.0.1:{free_port()}", "MGTPU_NUM_PROCESSES": "2"}
    args = SEG + RUN + ["-nGPU", "2", "-multihost", "-cache", str(tmp_path)]
    out0, out1 = _finish([_popen(args, MGTPU_PROCESS_ID=str(pid), **env) for pid in (0, 1)])
    assert "process 1/2, ranks 1..1" in out1 and not TESTING.search(out1)
    rank1 = glob.glob(str(tmp_path / "**" / "proc1" / "stdout.log"), recursive=True)
    assert len(rank1) == 1, rank1
    np.testing.assert_allclose(_loss(out0), _loss(_read(rank1[0])), rtol=1e-6)
    np.testing.assert_allclose(_loss(out0), one_rank_loss, atol=2e-5)
    ckpts = glob.glob(str(tmp_path / "**" / "model_1.ckpt"), recursive=True)
    assert len(ckpts) == 1 and "proc1" not in ckpts[0], ckpts
