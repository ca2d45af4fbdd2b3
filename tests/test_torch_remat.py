"""The train step's ``remat`` and ``bucket_sgd`` (`mgtpu_torch/train/step.py`,
the port of `mgtpu/train/step.py:21-58,84`), on the CPU.

- ``remat`` runs each micro-batch's forward under
  ``torch.utils.checkpoint``, a segment a top-level layer, and the whole
  forward again in the backward:
  on the CPU (deterministic plain versions) the step equals the plain
  step bit for bit, BatchNorm running stats included (updated once, not
  again by the run in the backward), for a narrowed mnist net and for a
  narrowed CIFAR net with dropout (the run in the backward draws the
  first forward's masks), over steps of two micro-batches; the
  forward's kernels are called twice a micro-batch (the pin
  ``chip_smoke.REMAT_PER_STEP`` holds on the card); ``-remat`` reaches
  the step through the run loop;
- ``bucket_sgd`` picks the multi-tensor update (True) or the loop over
  tensors (False): the same values bit for bit, each matching the JAX
  ``sgd_update`` with ``bucket`` True and False.
"""

import contextlib
import io

import jax
import numpy as np
import pytest
import torch

import mgtpu.models.cifar.pnmg as jpnmg
import mgtpu.models.mnist_cluttered.prnmg_mnist as jprnmg_mnist
from mgtpu.train.optim import _BUCKET_THRESHOLD
from mgtpu.train.optim import sgd_init as jax_sgd_init
from mgtpu.train.optim import sgd_update as jax_sgd_update
import mgtpu_torch.models.cifar.pnmg as tpnmg
import mgtpu_torch.models.mnist_cluttered.prnmg_mnist as tprnmg_mnist
import mgtpu_torch.main as tmain
from chip_smoke import PER_STEP, REMAT_PER_STEP, record_kernel_shapes
from mgtpu_torch.models import create_model, get_spec
from mgtpu_torch.models.base import NetOpts
from mgtpu_torch.train.optim import sgd_update
from mgtpu_torch.train.step import make_train_step
from mgtpu_torch.utils.bridge import export_jax_tree, load_jax_tree, load_momentum
from mgtpu_torch.utils.checkpoint import load_checkpoint
from test_torch_cifar_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_cifar_train import NARROW as CIFAR_NARROW
from test_torch_cifar_train import _jitter
from test_torch_seg_train import NARROW as SEG_NARROW

# net -> (options, the modules and widths that narrow it, image, target,
# steps: two where a dropout generator must carry on from one step to the next)
NETS = {
    "prnmg.mnist": (NetOpts(netType="mnist-cluttered/prnmg.mnist", dataset="mnist-spt"),
                    [(jprnmg_mnist, tprnmg_mnist, "BLOCKS4",
                      SEG_NARROW["mnist-cluttered/prnmg.mnist"][2]["BLOCKS4"])],
                    (16, 16, 1), (16, 16, 1), 1),
    "cifar/prnmg isDropout": (NetOpts(netType="cifar/prnmg", isDropout=True, dataset="cifar100"),
                              [(jpnmg, tpnmg, "BLOCKS", CIFAR_NARROW["cifar/prnmg"][2])],
                              (32, 32, 3), (), 2),
}


def _state(model):
    return {k: v.clone() for k, v in model.state_dict().items()}


@pytest.mark.parametrize("name", sorted(NETS))
def test_remat_step_equals_the_plain_step(name, monkeypatch):
    """Steps of two micro-batches of 2, from the same jittered weights,
    momentum and dropout seed: loss, parameters, running stats and
    momentum equal the plain step's bit for bit after each step, and the
    stats moved (the first forward updated them)."""
    opt, narrow, image, target, steps = NETS[name]
    for jmod, tmod, attr, value in narrow:
        monkeypatch.setattr(jmod, attr, value)
        monkeypatch.setattr(tmod, attr, value)
    spec = get_spec(opt.netType)
    p, s = export_jax_tree(create_model(opt, generator=torch.Generator().manual_seed(0)))
    rng = np.random.default_rng(1)
    _jitter(p, s, rng)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32) * 0.01, p)
    x = torch.from_numpy(rng.standard_normal((steps, 2, 2, *image), dtype=np.float32))
    if target:
        y = torch.from_numpy((rng.random((steps, 2, 2, *target)) > 0.5).astype(np.float32))
    else:
        y = torch.from_numpy(rng.integers(0, spec.n_classes(opt), (steps, 2, 2)))
    runs = []
    for remat in (False, True):
        model = load_jax_tree(create_model(opt, generator=torch.Generator().manual_seed(0)), p, s)
        opt_state = load_momentum(model, {"m": m})
        step = make_train_step(model, spec.create_loss(opt), spec, iter_size=2, remat=remat)
        states = []
        for i in range(steps):
            metrics = step(opt_state, {"x": x[i], "y": y[i]}, 0.1, 5e-4)
            states.append((float(metrics["loss"]), _state(model),
                           [t.clone() for t in opt_state["m"]]))
        runs.append(states)
    initial = load_jax_tree(create_model(opt), p, s).state_dict()
    stats = [k for k in initial if k.endswith((".mean", ".var"))]
    assert stats
    for (loss_a, state_a, m_a), (loss_b, state_b, m_b) in zip(*runs):
        assert loss_a == loss_b
        assert state_a.keys() == state_b.keys()
        for k in state_a:
            assert torch.equal(state_a[k], state_b[k]), k
        for a, b in zip(m_a, m_b):
            assert torch.equal(a, b)
    first = runs[1][0][1]
    assert all(not torch.equal(first[k], initial[k]) for k in stats)


def test_remat_calls_the_forward_kernels_twice():
    """An R-MG-34 training micro-batch with remat calls the forward's
    kernels twice and the backward's once: the pin chip_smoke holds the
    card's launches to (REMAT_PER_STEP), against the plain step's
    (PER_STEP)."""
    got = {k: sum(c.values()) for k, c in record_kernel_shapes(True, remat=True).items()}
    assert got == REMAT_PER_STEP
    forward = ("conv3x3", "conv3x3_bn_relu_in", "maxpool2")
    assert got == {k: v * (2 if k in forward else 1) for k, v in PER_STEP.items()}


RUN = ["-netType", "mnist-cluttered/unmg", "-dataset", "mnist-seg", "-data", "synthetic",
       "-synthSize", "8", "-batchSize", "2", "-iterSize", "2", "-nEpochs", "1",
       "-epochSize", "1", "-nDonkeys", "0", "-train", "-device", "cpu"]


def test_remat_flag_through_the_run_loop(tmp_path):
    """python -m mgtpu_torch.main ... -remat trains unmg to the checkpoint
    the run without it writes, bit for bit."""
    ckpts = []
    for flags in ([], ["-remat"]):
        with contextlib.redirect_stdout(io.StringIO()):
            sess = tmain.main(RUN + flags + ["-cache", str(tmp_path / (flags or ["plain"])[0])])
        assert sess.opt.remat == bool(flags)
        ckpts.append(load_checkpoint(f"{sess.opt.save}/model_1.ckpt"))
    for part in ("params", "stats", "opt_state"):
        a, b = (jax.tree.leaves(jax.tree.map(np.asarray, c[part])) for c in ckpts)
        assert len(a) == len(b) and a
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)


def _tree(rng):
    """Leaves on both sides of the JAX bucket threshold (8,192 elements):
    small BN-like vectors and biases, and two conv kernels."""
    shapes = {"a": (64,), "b": (3, 3, 16, 32), "c": (10,), "d": (3, 3, 64, 64), "e": (7, 3)}
    return {k: rng.standard_normal(v, dtype=np.float32) for k, v in shapes.items()}


@pytest.mark.parametrize("bucket", [True, False], ids=["bucket", "per-tensor"])
def test_bucket_sgd_matches_jax(bucket):
    """Three steps of the port's update with foreach=bucket against JAX's
    sgd_update(bucket=bucket), at tests/test_torch_train.py's tolerance;
    and the two port updates equal bit for bit."""
    rng = np.random.default_rng(2)
    p, grads = _tree(rng), [_tree(rng) for _ in range(3)]
    sizes = [v.size for v in p.values()]  # JAX buckets some leaves and not others
    assert sum(s < _BUCKET_THRESHOLD for s in sizes) > 1
    assert any(s >= _BUCKET_THRESHOLD for s in sizes)
    st = jax_sgd_init(p)
    keys = sorted(p)
    ports = {}
    for foreach in (True, False):
        tp = [torch.tensor(p[k]) for k in keys]
        tst = {"m": [torch.zeros_like(t) for t in tp]}
        for g in grads:
            sgd_update(tp, [torch.tensor(g[k]) for k in keys], tst, 0.1, 1e-4, 0.9,
                       foreach=foreach)
        ports[foreach] = [t.numpy() for t in tp + tst["m"]]
    jp = p
    for g in grads:
        jp, st = jax_sgd_update(jp, g, st, 0.1, 1e-4, 0.9, bucket=bucket)
    ref = [np.asarray(jp[k]) for k in keys] + [np.asarray(st["m"][k]) for k in keys]
    for a, b in zip(ports[True], ports[False]):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ports[bucket], ref):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_bucket_sgd_option_of_the_step(monkeypatch):
    """make_train_step(bucket_sgd=False) takes the per-tensor update and
    gives the default's parameters and momentum bit for bit."""
    import mgtpu_torch.train.step as step_mod

    calls = []

    def spy(*a, foreach=True, **kw):
        calls.append(foreach)
        return sgd_update(*a, foreach=foreach, **kw)

    monkeypatch.setattr(step_mod, "sgd_update", spy)
    opt = NetOpts(netType="cifar/nmg", dataset="cifar100")
    spec = get_spec(opt.netType)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((2, 32, 32, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, 100, 2))
    got = []
    for bucket in (True, False):
        model = create_model(opt, generator=torch.Generator().manual_seed(0))
        opt_state = {"m": [torch.zeros_like(q) for q in model.parameters()]}
        make_train_step(model, spec.create_loss(opt), spec, bucket_sgd=bucket)(
            opt_state, {"x": x, "y": y}, 0.1, 5e-4)
        got.append([q.detach().clone() for q in model.parameters()] + opt_state["m"])
    assert calls == [True, False]
    for a, b in zip(*got):
        assert torch.equal(a, b)
