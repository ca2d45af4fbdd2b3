"""The port's training path (`mgtpu_torch.train`, `mgtpu_torch.trainer`,
the loss, metrics and SGD) against the JAX package, in f32 on the CPU:
the SGD rule, one train step of a narrow multigrid net built from the
same modules in both packages (loss, metrics, new parameters, running
stats and momentum; with ``iter_size=2`` and ``log_grad_norm``), the
eval step, the weight bridge round trip, and the kernel calls of one
R-MG-34 training step."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgtpu.models import get_net as jax_get_net
from mgtpu.models.base import imagenet_rule as jax_imagenet_rule
from mgtpu.models.base import nll_loss as jax_nll_loss
from mgtpu.models.common import LogSoftmaxClassifier as JClassifier
from mgtpu.models.common import MgNet as JMgNet
from mgtpu.models.ilsvrc.rnmg import NET as JNET
from mgtpu.ops import mg as jmg
from mgtpu.train.optim import sgd_init as jax_sgd_init
from mgtpu.train.optim import sgd_update as jax_sgd_update
from mgtpu.train.step import make_eval_step as jax_make_eval_step
from mgtpu.train.step import make_train_step as jax_make_train_step
from mgtpu.utils.metrics import topk_accuracy as jax_topk
from mgtpu.utils.checkpoint import save_checkpoint
from mgtpu_torch.models import NetOpts, create_model, get_spec
from mgtpu_torch.models.base import imagenet_rule, nll_loss
from mgtpu_torch.models.common import LogSoftmaxClassifier, MgNet
from mgtpu_torch.ops import cuda_conv, cuda_pool
from mgtpu_torch.ops import mg as tmg
from mgtpu_torch.train.optim import reset_momentum, sgd_init, sgd_update
from mgtpu_torch.train.step import make_eval_step, make_train_step
from mgtpu_torch.trainer import Trainer, main as trainer_main
from mgtpu_torch.utils.bridge import (export_jax_tree, export_momentum, load_jax_tree,
                                      load_momentum)
from mgtpu_torch.utils.metrics import topk_accuracy

NET = get_spec("ilsvrc/rnmg")


# ---------------------------------------------------------------- SGD


def _sgd(p, g, m, lr, wd, mu, foreach=True):
    ps = [torch.tensor(v) for v in p]
    st = {"m": [torch.tensor(v) for v in m]}
    sgd_update(ps, [torch.tensor(v) for v in g], st, lr, wd, mu, foreach=foreach)
    return [t.numpy() for t in ps], [t.numpy() for t in st["m"]]


def test_sgd_matches_reference_semantics():
    """g' = g + wd*p; m = mu*m + g'; p -= lr*m, and the second step
    accumulates momentum (ported from tests/test_train_dp.py)."""
    lr, wd, mu = 0.1, 0.01, 0.9
    p, g = [np.array([1.0, 2.0], np.float32)], [np.array([0.5, 0.5], np.float32)]
    p1, m1 = _sgd(p, g, [np.zeros(2, np.float32)], lr, wd, mu)
    exp_m = np.array([0.5 + 0.01 * 1.0, 0.5 + 0.01 * 2.0])
    np.testing.assert_allclose(m1[0], exp_m, rtol=1e-6)
    np.testing.assert_allclose(p1[0], np.array([1.0, 2.0]) - 0.1 * exp_m, rtol=1e-6)
    _, m2 = _sgd(p1, g, m1, lr, wd, mu)
    np.testing.assert_allclose(m2[0], mu * exp_m + (g[0] + wd * p1[0]), rtol=1e-6)


def test_sgd_scale_invariant_norm_decay_envelope():
    """With a zero gradient, coupled L2 and momentum shrink a weight by
    1 - lr*wd/(1-mu) per step once the momentum transient has passed."""
    lr, wd, mu = 0.1, 5e-4, 0.9
    p = [torch.tensor([100.0])]
    st = sgd_init(p)
    norms = [100.0]
    for _ in range(600):
        sgd_update(p, [torch.zeros(1)], st, lr, wd, mu)
        norms.append(float(p[0][0]))
    tail = np.array(norms[-100:])
    np.testing.assert_allclose(tail[1:] / tail[:-1], 1.0 - lr * wd / (1.0 - mu), rtol=3e-5)


def test_sgd_foreach_matches_per_tensor():
    """The multi-tensor update equals the per-tensor loop bit for bit,
    over three steps of a mixed list (small vectors and a conv)."""
    rng = np.random.default_rng(0)
    shapes = [(64,)] * 4 + [(3, 3, 64, 64)]
    p = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    g = [np.full(s, 0.25, np.float32) for s in shapes]
    m = [np.zeros(s, np.float32) for s in shapes]
    pa, ma, pb, mb = p, m, p, m
    for _ in range(3):
        pa, ma = _sgd(pa, g, ma, 0.1, 1e-4, 0.9, foreach=True)
        pb, mb = _sgd(pb, g, mb, 0.1, 1e-4, 0.9, foreach=False)
    for a, b in zip(pa + ma, pb + mb):
        np.testing.assert_array_equal(a, b)


def test_sgd_matches_jax():
    rng = np.random.default_rng(1)
    p = {"a": rng.standard_normal((5, 3), dtype=np.float32),
         "b": rng.standard_normal(7, dtype=np.float32)}
    g = {k: rng.standard_normal(v.shape, dtype=np.float32) for k, v in p.items()}
    st = jax_sgd_init(p)
    tp, tm = [p["a"], p["b"]], [np.zeros((5, 3), np.float32), np.zeros(7, np.float32)]
    for _ in range(2):
        p, st = jax_sgd_update(p, g, st, 0.1, 1e-4, 0.9)
        tp, tm = _sgd(tp, [g["a"], g["b"]], tm, 0.1, 1e-4, 0.9)
    for a, b in zip(tp + tm, [p["a"], p["b"], st["m"]["a"], st["m"]["b"]]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)


def test_reset_momentum():
    st = {"m": [torch.ones(3), torch.ones(2, 2)]}
    assert not any(t.any() for t in reset_momentum(st)["m"])


# --------------------------------------------------- loss, metrics, rule


def test_loss_metrics_and_rule_match_jax():
    rng = np.random.default_rng(2)
    logits = rng.standard_normal((16, 10), dtype=np.float32)
    lp = np.array(jax.nn.log_softmax(jnp.asarray(logits)))
    y = rng.integers(0, 10, 16)
    t_lp, t_y = torch.from_numpy(lp), torch.from_numpy(y)
    np.testing.assert_allclose(float(nll_loss(t_lp, t_y)),
                               float(jax_nll_loss(jnp.asarray(lp), jnp.asarray(y))), rtol=1e-6)
    for k in (1, 5):
        assert float(topk_accuracy(t_lp, t_y, k)) == float(jax_topk(jnp.asarray(lp),
                                                                    jnp.asarray(y), k))
    for epoch in (1, 30, 31, 61, 90):
        assert imagenet_rule(epoch) == jax_imagenet_rule(epoch)
    m = NET.train_metrics(t_lp, t_y, nll_loss(t_lp, t_y))
    ref = JNET.train_metrics(jnp.asarray(lp), jnp.asarray(y), 0.0)
    assert sorted(m) == sorted(ref) == ["loss", "top1", "top5"]
    assert NET.train_rule(1, None) == {"lr": 0.1, "wd": 1e-4}


# ------------------------------------------------ one step of a narrow net

# stem [16,8,8]; blocks [16,8,8] plain, [32,16,8] concat, [32,16] concat
# and [64], one layer each: identity, zero-pad and 1x1-ConvBN shortcuts
# and both pool modes
STEM = [16, 8, 8]
BLOCKS = [([16, 8, 8], "plain"), ([32, 16, 8], "concat"), ([32, 16], "concat"), ([64], None)]
N_CLASSES = 10


def _narrow(pkg):
    ops = jmg if pkg == "jax" else tmg
    layers = [ops.MgStem7x7(STEM)]
    widths = list(STEM)
    for ws, pool in BLOCKS:
        layers.append(ops.MgResidual(widths, ws))
        widths = list(ws)
        if pool:
            layers.append(ops.MgPool(widths, pool))
            widths = layers[-1].out_widths
    if pkg == "jax":
        return JMgNet(layers + [JClassifier(widths[0], N_CLASSES, pool=7)])
    return MgNet(layers + [LogSoftmaxClassifier(widths[0], N_CLASSES, pool=7)])


@pytest.fixture(scope="module")
def narrow():
    """The narrow net's JAX weights (BN affines and running stats drawn
    away from their init), a 2x224x224x3 batch, and the JAX train step's
    result: one step with log_grad_norm, one with iter_size=2.

    The BN biases are drawn positive, in [1, 2), so that activations sit
    off the ReLU kink and pool windows do not tie near zero. There the
    step is a smooth function of its inputs: a 1e-6 relative change of
    the input moves this net's gradients by 1e-5 of each leaf's largest
    entry (measured). With biases around 0 the same change moves them
    by up to 8% through flipped ReLU masks and pool choices, so f32
    rounding alone would exceed any tight bound."""
    jm = _narrow("jax")
    p, s = jax.tree.map(np.asarray, jax.jit(jm.init)(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)

    def jitter(p, s):
        for k, v in p.items():
            if k == "bn" and v:
                v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(np.float32)
                v["bias"] = rng.uniform(1.0, 2.0, v["bias"].shape).astype(np.float32)
                s[k]["mean"] = rng.normal(0, 0.2, s[k]["mean"].shape).astype(np.float32)
                s[k]["var"] = rng.uniform(0.5, 1.5, s[k]["var"].shape).astype(np.float32)
            elif isinstance(v, dict):
                jitter(v, s.get(k, {}))

    jitter(p, s)
    x = rng.standard_normal((2, 224, 224, 3), dtype=np.float32)
    y = np.array([3, 7])
    # a momentum from an earlier step, so the update carries one
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32) * 0.01, p)
    lr, wd = 0.1, 1e-4
    loss_fn = JNET.create_loss(None)
    step = jax.jit(jax_make_train_step(jm, loss_fn, JNET, log_grad_norm=True))
    res1 = step(p, s, {"m": m}, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, lr, wd,
                jax.random.PRNGKey(0))
    step2 = jax.jit(jax_make_train_step(jm, loss_fn, JNET, iter_size=2))
    res2 = step2(p, s, {"m": m}, {"x": jnp.asarray(x[:, None]), "y": jnp.asarray(y[:, None])},
                 lr, wd, jax.random.PRNGKey(0))
    ev, ev_out = jax_make_eval_step(jm, loss_fn, JNET)(p, s, {"x": jnp.asarray(x),
                                                               "y": jnp.asarray(y)})
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return types.SimpleNamespace(p=p, s=s, m=m, x=x, y=y, lr=lr, wd=wd, res1=to_np(res1),
                                 res2=to_np(res2), eval=(to_np(ev), np.asarray(ev_out)))


def _port(narrow):
    model = load_jax_tree(_narrow("torch"), narrow.p, narrow.s)
    return model, load_momentum(model, {"m": narrow.m})


def _assert_tree_close(got, ref, rtol, atol):
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def _assert_step_matches(model, opt_state, metrics, ref):
    p, s, o, m = ref
    for k, v in m.items():
        # f32: the loss and norms sum in another order
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)
    got_p, got_s = export_jax_tree(model)
    # the new parameters differ from JAX's by lr * (the gradients'
    # summation-order error); the gradients of this batch-2 net are
    # O(1), summed over up to 2*56*56 terms through two BN backwards
    _assert_tree_close(got_p, p, rtol=1e-4, atol=1e-5)
    # the one-pass variance E[x^2] - E[x]^2 loses digits as mean^2/var
    # grows, as it does with these positive BN biases
    _assert_tree_close(got_s, s, rtol=1e-4, atol=1e-5)
    _assert_tree_close(export_momentum(model, opt_state), o, rtol=1e-4, atol=1e-5)


def test_narrow_train_step_matches_jax(narrow):
    """One step: loss, top-1/5, gradnorm/pnorm/maxupd, new parameters,
    running stats and momentum against mgtpu.train.step.make_train_step."""
    model, opt = _port(narrow)
    step = make_train_step(model, NET.create_loss(None), NET, log_grad_norm=True)
    metrics = step(opt, {"x": torch.from_numpy(narrow.x), "y": torch.from_numpy(narrow.y)},
                   narrow.lr, narrow.wd)
    assert sorted(metrics) == ["gradnorm", "loss", "maxupd", "pnorm", "top1", "top5"]
    _assert_step_matches(model, opt, metrics, narrow.res1)


def test_narrow_train_step_iter_size_2_matches_jax(narrow):
    """Two micro-batches of one image: gradients averaged, metrics
    averaged, the BN running stats threaded through both in order."""
    model, opt = _port(narrow)
    step = make_train_step(model, NET.create_loss(None), NET, iter_size=2)
    metrics = step(opt, {"x": torch.from_numpy(narrow.x[:, None]),
                         "y": torch.from_numpy(narrow.y[:, None])}, narrow.lr, narrow.wd)
    _assert_step_matches(model, opt, metrics, narrow.res2)


def test_train_step_asks_cudnn_for_deterministic_algorithms():
    """The step's forward and backward run with cuDNN's deterministic
    algorithms, and the caller's setting comes back after it."""
    seen = []

    class Probe(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            seen.append(("forward", torch.backends.cudnn.deterministic))
            return x.clone()

        @staticmethod
        def backward(ctx, g):
            seen.append(("backward", torch.backends.cudnn.deterministic))
            return g

    model = torch.nn.Linear(4, 3)
    net = types.SimpleNamespace(train_metrics=lambda out, y, loss: {"loss": loss})
    step = make_train_step(model, lambda out, y: Probe.apply(out).square().mean(), net)
    torch.backends.cudnn.deterministic = False
    step(sgd_init(list(model.parameters())), {"x": torch.ones(2, 4), "y": None}, 0.1, 0.0)
    assert seen == [("forward", True), ("backward", True)]
    assert torch.backends.cudnn.deterministic is False


def test_narrow_eval_step_matches_jax(narrow):
    model, _ = _port(narrow)
    metrics, out = make_eval_step(model, NET.create_loss(None), NET)(
        {"x": torch.from_numpy(narrow.x), "y": torch.from_numpy(narrow.y)})
    ref_m, ref_out = narrow.eval
    np.testing.assert_allclose(out.numpy(), ref_out, rtol=1e-5, atol=1e-5)
    for k, v in ref_m.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, err_msg=k)


def test_narrow_bridge_round_trip(narrow):
    model, opt = _port(narrow)
    p, s = export_jax_tree(model)
    _assert_tree_close(p, narrow.p, rtol=0, atol=0)
    _assert_tree_close(s, narrow.s, rtol=0, atol=0)
    _assert_tree_close(export_momentum(model, opt)["m"], narrow.m, rtol=0, atol=0)
    with pytest.raises(KeyError):
        load_momentum(model, {"m": {"0": {}}})


# ---------------------------------------------------- R-MG-34 and the CLI


def test_rmg34_train_step_kernel_calls():
    """One R-MG-34 training forward and backward at batch 1 calls the
    kernels' entry points 76 times for conv3x3, 36 for
    conv3x3_bn_relu_in, 46 for the maxpool2 forward and 29 for its
    backward, which takes the pools of a multigrid layer together (on a
    card each call is one launch)."""
    calls = dict.fromkeys(["conv3x3", "conv3x3_bn_relu_in", "maxpool2", "maxpool2_bwd"], 0)
    patched = {(cuda_conv, "conv3x3_forward"): "conv3x3",
               (cuda_conv, "conv3x3_bn_relu_in_forward"): "conv3x3_bn_relu_in",
               (cuda_pool, "maxpool2_forward"): "maxpool2",
               (cuda_pool, "maxpool2_backward_group"): "maxpool2_bwd"}

    def counting(fn, name):
        def wrapped(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return wrapped

    mp = pytest.MonkeyPatch()
    for (mod, attr), name in patched.items():
        mp.setattr(mod, attr, counting(getattr(mod, attr), name))
    try:
        model = create_model(NetOpts(depth=34)).train()
        out = model(torch.randn(1, 224, 224, 3, generator=torch.Generator().manual_seed(0)))
        nll_loss(out, torch.tensor([5])).backward()
    finally:
        mp.undo()
    assert calls == {"conv3x3": 76, "conv3x3_bn_relu_in": 36, "maxpool2": 46,
                     "maxpool2_bwd": 29}


def test_trainer_cli_on_cpu(capsys):
    trainer_main(["--random", "--depth", "18", "--batch", "2", "--steps", "2",
                  "--device", "cpu"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line]
    assert all(np.isfinite(r["loss"]) and r["device"] == "cpu" for r in rows)
    assert [r["step"] for r in rows] == [0, 1]


def test_trainer_iter_size_splits_the_batch():
    """Trainer(iter_size=2) takes a batch of 2 as two micro-batches of 1:
    the same step as make_train_step(iter_size=2) on the split batch."""
    x = np.random.default_rng(5).standard_normal((2, 224, 224, 3), dtype=np.float32)
    y = np.array([4, 9])
    kw = dict(opt=NetOpts(depth=18), seed=0, device="cpu", compute_dtype=torch.float32)
    tr = Trainer(**kw, iter_size=2)
    metrics = tr.step(x, y, 0.1, 1e-4)
    ref = Trainer(**kw)
    step = make_train_step(ref.model, nll_loss, NET, iter_size=2)
    ref_metrics = step(ref.opt_state, {"x": torch.from_numpy(x[:, None]),
                                       "y": torch.from_numpy(y[:, None])}, 0.1, 1e-4)
    assert {k: float(v) for k, v in metrics.items()} == {k: float(v)
                                                         for k, v in ref_metrics.items()}
    # the CPU's threaded conv backward sums in a varying order
    for a, b in zip(tr.model.state_dict().values(), ref.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


def test_trainer_resumes_a_jax_checkpoint(tmp_path):
    """A checkpoint the JAX trainer writes (params, stats and the SGD
    momentum) resumes in the port's Trainer, every leaf in place, and it
    takes a step."""
    model = jax_get_net("ilsvrc/rnmg").create_model(types.SimpleNamespace(depth=18))
    p, s = jax.tree.map(np.asarray, jax.jit(model.init)(jax.random.PRNGKey(1)))
    rng = np.random.default_rng(4)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32) * 0.01, p)
    path = str(tmp_path / "model_1.ckpt")
    save_checkpoint(path, p, s, opt_state={"m": m}, epoch=1,
                    meta={"netType": "ilsvrc/rnmg", "depth": 18})
    tr = Trainer(ckpt=path, device="cpu", compute_dtype=torch.float32)
    assert tr.opt.depth == 18
    _assert_tree_close(export_momentum(tr.model, tr.opt_state)["m"], m, rtol=0, atol=0)
    got_p, got_s = export_jax_tree(tr.model)
    _assert_tree_close(got_p, p, rtol=0, atol=0)
    _assert_tree_close(got_s, s, rtol=0, atol=0)
    x = rng.standard_normal((2, 224, 224, 3), dtype=np.float32)
    metrics = tr.step(x, np.array([1, 2]), 0.1, 1e-4)
    assert np.isfinite(float(metrics["loss"]))
