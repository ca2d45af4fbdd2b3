"""The CIFAR zoo's modules and entry points in the port, on the CPU:
each new block (`MgConvInput`, `MgConv`, `TailOp`, `PerScale`,
`ResBlock`, `Pool2`, `FlatClassifier`) against the JAX one in eval and
train mode (values, running stats, gradients), ``ConvBN``'s forward
through the conv3x3 entry point, the weight bridge both ways for a
pyramid-prefix residual net, a checkpoint written by
`mgtpu.utils.checkpoint` served by `Server` and resumed by `Trainer`,
and the two command lines with ``--net``."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mgtpu.models import common as jcommon
from mgtpu.ops import mg as jmg
from mgtpu.utils.checkpoint import save_checkpoint
from mgtpu_torch import nn as tnn
from mgtpu_torch.models import common as tcommon
from mgtpu_torch.models import get_spec, net_options
from mgtpu_torch.models.base import NetOpts
from mgtpu_torch.ops import cuda_conv
from mgtpu_torch.ops.fold import fold_batchnorm
from mgtpu_torch.ops import mg as tmg
from mgtpu_torch.serve import Server, main as serve_main
from mgtpu_torch.trainer import Trainer, main as trainer_main
from mgtpu_torch.utils.bridge import (_live, export_jax_tree, export_momentum, load_jax_tree,
                                      load_momentum)
from test_torch_cifar_models import (_jax_model, _port, assert_logprobs_close,  # noqa: F401
                                     few_torch_threads, jax_weights)


def _np(tree):
    return jax.tree.map(np.array, tree)


def _pyr(hws, cs, seed, batch=2):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((batch, h, w, c), dtype=np.float32) for (h, w), c in
                 zip(hws, cs))


def _outs(y):
    return [np.asarray(a) for a in (y if isinstance(y, tuple) else (y,))]


# (JAX block, port block, input): single arrays for the single-grid
# blocks, pyramids (finest first) for the multigrid ones
BLOCKS = {
    "MgConvInput": (lambda: jmg.MgConvInput([5, 4, 3], eps=1e-3),
                    lambda: tmg.MgConvInput([5, 4, 3], eps=1e-3),
                    lambda: _pyr([(16, 16)], [3], 0)[0]),
    "MgConv": (lambda: jmg.MgConv([5, 4, 3], [6, 3, 4], [3, 3, 1]),
               lambda: tmg.MgConv([5, 4, 3], [6, 3, 4], [3, 3, 1]),
               lambda: _pyr([(8, 8), (4, 4), (2, 2)], [5, 4, 3], 1)),
    "TailOp": (lambda: jmg.TailOp(1, jmg.MgResidual([4, 3], [4, 3]), [5, 4, 3]),
               lambda: tmg.TailOp(1, tmg.MgResidual([4, 3], [4, 3]), [5, 4, 3]),
               lambda: _pyr([(8, 8), (4, 4), (2, 2)], [5, 4, 3], 2)),
    "PerScale": (lambda: jmg.PerScale([None, jcommon.ResBlock(4, 4)]),
                 lambda: tmg.PerScale([None, tcommon.ResBlock(4, 4)]),
                 lambda: _pyr([(8, 8), (4, 4)], [5, 4], 3)),
    "ResBlock_widen": (lambda: jcommon.ResBlock(4, 6), lambda: tcommon.ResBlock(4, 6),
                       lambda: _pyr([(6, 6)], [4], 4)[0]),
    "ResBlock_narrow": (lambda: jcommon.ResBlock(6, 4), lambda: tcommon.ResBlock(6, 4),
                        lambda: _pyr([(6, 6)], [6], 5)[0]),
    "ResBlock_C": (lambda: jcommon.ResBlock(4, 4, shortcut_type="C"),
                   lambda: tcommon.ResBlock(4, 4, shortcut_type="C"),
                   lambda: _pyr([(6, 6)], [4], 6)[0]),
    "Pool2_ceil": (lambda: jcommon.Pool2(True), lambda: tcommon.Pool2(),
                   lambda: _pyr([(7, 5)], [3], 7)[0]),
    "FlatClassifier": (lambda: jcommon.FlatClassifier(6, 10),
                       lambda: tcommon.FlatClassifier(6, 10),
                       lambda: _pyr([(1, 1)], [6], 9)[0]),
}


def _jitter(p, s, rng):
    for k, v in p.items():
        if k == "bn" and v:
            v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(np.float32)
            v["bias"] = rng.uniform(1.0, 2.0, v["bias"].shape).astype(np.float32)
            s[k]["mean"] = rng.normal(0, 0.2, s[k]["mean"].shape).astype(np.float32)
            s[k]["var"] = rng.uniform(0.5, 1.5, s[k]["var"].shape).astype(np.float32)
        elif isinstance(v, dict):
            _jitter(v, s.get(k, {}), rng)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_block_matches_jax(block, train):
    check_block_matches_jax(*(f() for f in BLOCKS[block]), train)


def check_block_matches_jax(jb, tb, x, train):
    """Forward values (train mode: with batch statistics) and, in train
    mode, the running stats and the gradients of a random projection of
    the output, in f32, of JAX block ``jb`` and port block ``tb`` on
    ``x`` (an array or a pyramid). BN biases are drawn in [1, 2) to keep
    values off the ReLU kink."""
    p, s = _np(jb.init(jax.random.PRNGKey(0)))
    _jitter(p, s, np.random.default_rng(1))
    load_jax_tree(tb, p, s)
    tb.train(train)
    jx = tuple(map(jnp.asarray, x)) if isinstance(x, tuple) else jnp.asarray(x)
    tx = (tuple(torch.from_numpy(a).requires_grad_() for a in x) if isinstance(x, tuple)
          else torch.from_numpy(x).requires_grad_())
    ref, ref_s = jb.apply(p, s, jx, train=train)
    got = tb(tx)
    for a, b in zip(_outs(ref), _outs(tuple(t.detach() for t in got) if isinstance(got, tuple)
                                      else got.detach())):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
    if not train:
        return
    _, got_s = export_jax_tree(tb)
    for a, b in zip(jax.tree.leaves(ref_s), jax.tree.leaves(got_s)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-5, atol=1e-6)
    rng = np.random.default_rng(2)
    r = [rng.standard_normal(np.shape(a)).astype(np.float32) for a in _outs(ref)]

    def loss(p, x):
        y = jb.apply(p, s, x, train=True)[0]
        return sum(jnp.sum(a * b) for a, b in zip(y if isinstance(y, tuple) else (y,), r))

    gp, gx = jax.grad(loss, argnums=(0, 1))(p, jx)
    got_l = got if isinstance(got, tuple) else (got,)
    sum((a * torch.from_numpy(b)).sum() for a, b in zip(got_l, r)).backward()
    grads = jax.tree.map(lambda t: t.grad.numpy(), _live(tb)[0])
    assert jax.tree.structure(grads) == jax.tree.structure(gp)
    # a conv bias under a train-mode BN has a gradient of exactly 0: its
    # rounding noise is measured against the largest gradient of the block
    scale = max([np.abs(np.asarray(a)).max() for a in jax.tree.leaves(gp)], default=0.0)
    for a, b in zip(jax.tree.leaves(gp), jax.tree.leaves(grads)):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5 * scale)
    for a, b in zip(_outs(gx), (tx if isinstance(tx, tuple) else (tx,))):
        # a scale the block drops reaches no output: no gradient, JAX's zeros
        g = torch.zeros_like(b) if b.grad is None else b.grad
        np.testing.assert_allclose(g.numpy(), a, rtol=1e-4, atol=1e-5 * np.abs(a).max())


def test_convbn_3x3_forward_launches_conv3x3(monkeypatch):
    """A 3x3/s1/p1 ConvBN's forward goes through the conv3x3 entry point
    (on a card, one kernel launch); a 1x1 or strided one does not."""
    calls = []
    real = cuda_conv.conv3x3_forward
    monkeypatch.setattr(cuda_conv, "conv3x3_forward",
                        lambda *a, **kw: calls.append(a[0].shape) or real(*a, **kw))
    x = torch.randn(2, 6, 6, 3, generator=torch.Generator().manual_seed(0))
    for k, stride, launches in ((3, 1, 1), (1, 1, 0), (3, 2, 0)):
        calls.clear()
        tnn.ConvBN(3, 4, k, stride).eval()(x)
        assert len(calls) == launches, (k, stride)


def test_convbn_forward_matches_conv_then_bn():
    """The kernel-routed forward is the stock conv plus bias, BN and ReLU."""
    layer = tnn.ConvBN(5, 7, generator=torch.Generator().manual_seed(1)).eval()
    x = torch.randn(2, 9, 8, 5, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        ref = torch.relu(layer.bn(layer.conv(x)))
        torch.testing.assert_close(layer(x), ref, rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def prnmg():
    """cifar/prnmg at -nLayer 1: JAX weights with jittered BN, two images,
    and their log-probs through the port's unfolded eval forward (which
    tests/test_torch_cifar_models.py holds to JAX's)."""
    p, s = jax_weights(_jax_model("cifar/prnmg"), seed=5)
    x = np.random.default_rng(6).standard_normal((2, 32, 32, 3), dtype=np.float32)
    with torch.inference_mode():
        ref = load_jax_tree(_port("cifar/prnmg"), p, s)(torch.from_numpy(x)).numpy()
    return types.SimpleNamespace(p=p, s=s, x=x, ref=ref)


def _assert_trees_equal(got, ref):
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("folded", [False, True])
def test_bridge_round_trip(prnmg, folded):
    """export_jax_tree inverts load_jax_tree on a net with PerScale (an
    identity scale and a ResBlock), TailOp, MgResidual and MgConvInput,
    folded BNs (empty dicts) included, and the SGD momentum carries
    across both ways. The folded tree is the port's fold, exported."""
    p, s = prnmg.p, prnmg.s
    if folded:
        p, s = export_jax_tree(fold_batchnorm(load_jax_tree(_port("cifar/prnmg"), p, s)))
        assert p["0"]["0"]["bn"] == {} and s["0"]["0"]["bn"] == {}
    model = load_jax_tree(_port("cifar/prnmg"), p, s)
    got_p, got_s = export_jax_tree(model)
    _assert_trees_equal(got_p, p)
    _assert_trees_equal(got_s, s)
    rng = np.random.default_rng(7)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32), p)
    opt = load_momentum(model, {"m": m})
    _assert_trees_equal(export_momentum(model, opt)["m"], m)
    if folded:  # the folded tree serves the unfolded net's function
        with torch.inference_mode():
            assert_logprobs_close(model(torch.from_numpy(prnmg.x)), prnmg.ref)


def test_server_and_trainer_from_jax_checkpoint(prnmg, tmp_path):
    """A checkpoint the JAX trainer writes names its net in its meta: the
    port's Server rebuilds cifar/prnmg from it and serves it (BN folded,
    f32 on the CPU, the unfolded net's log-probs); the Trainer resumes it
    with its momentum and steps."""
    rng = np.random.default_rng(8)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32) * 0.01, prnmg.p)
    path = str(tmp_path / "model_1.ckpt")
    save_checkpoint(path, prnmg.p, prnmg.s, opt_state={"m": m}, epoch=1,
                    meta={"netType": "cifar/prnmg", "dataset": "cifar100-whitened",
                          "nLayer": 1, "isDropout": False})
    server = Server(ckpt=path, device="cpu", compute_dtype=torch.float32)
    assert server.opt.netType == "cifar/prnmg" and server.image_shape == (32, 32, 3)
    assert_logprobs_close(server.predict(prnmg.x), prnmg.ref)
    tr = Trainer(ckpt=path, device="cpu", compute_dtype=torch.float32, iter_size=2)
    _assert_trees_equal(export_momentum(tr.model, tr.opt_state)["m"], m)
    got_p, _ = export_jax_tree(tr.model)
    _assert_trees_equal(got_p, prnmg.p)
    metrics = tr.step(prnmg.x, np.array([1, 2]), 0.1, 5e-4)
    assert sorted(metrics) == ["loss", "top1"] and np.isfinite(float(metrics["loss"]))


def test_checkpoint_of_an_unported_net_is_refused(prnmg, tmp_path):
    path = str(tmp_path / "model_1.ckpt")
    save_checkpoint(path, prnmg.p, prnmg.s, epoch=1,
                    meta={"netType": "cifar/nonesuch"})
    with pytest.raises(KeyError, match="unknown net"):
        Server(ckpt=path, device="cpu")


def test_net_opts_and_image_shape():
    """NetOpts() is R-MG-34; a net's dataset and depth, unless named, are
    its NetSpec's (and the label of its log lines says so)."""
    opt = NetOpts()
    assert (opt.netType, opt.depth, opt.dataset) == ("ilsvrc/rnmg", None, None)
    assert get_spec("ilsvrc/rnmg").describe(net_options(opt)) == "ilsvrc/rnmg depth 34"
    opt = NetOpts(netType="cifar/vgg", nLayer=4)
    assert get_spec("cifar/vgg").describe(opt) == "cifar/vgg nLayer 4 cifar100"
    assert get_spec("cifar/vgg").n_classes(opt) == 100
    server = Server(NetOpts(netType="cifar/vgg", dataset="cifar10"), seed=1, device="cpu",
                    compute_dtype=torch.float32)
    assert server.image_shape == (32, 32, 3)
    y = server.predict(np.zeros((3, 32, 32, 3), np.float32))
    assert y.shape == (3, 10)
    torch.testing.assert_close(torch.logsumexp(y, -1), torch.zeros(3), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="NHWC"):
        server.predict(np.zeros((1, 224, 224, 3), np.float32))


def test_serve_cli_on_cpu(capsys):
    serve_main(["--net", "cifar/vgg", "--nLayer", "2", "--random", "--batches", "2",
                "--device", "cpu"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line]
    assert [r["out_shape"] for r in rows] == [[2, 100]]
    assert rows[0]["finite"] and rows[0]["net"] == "cifar/vgg nLayer 2 cifar100"


def test_trainer_cli_on_cpu(capsys):
    """--batch is a micro-batch, as the JAX CLI's -batchSize: 2 x 2
    images a step."""
    trainer_main(["--net", "cifar/resnet", "--isDropout", "--random", "--batch", "2",
                  "--iterSize", "2", "--steps", "2", "--device", "cpu"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["iterSize"] == 2 for r in rows)
    assert rows[0]["net"] == "cifar/resnet nLayer 1 isDropout cifar100"
