"""The cluttered-MNIST nets' and PR-MG's modules and entry points in the
port, on the CPU: each new block (`ConvTranspose`, `UpConvBN`, `MgPool`
mode "drop", `DropCoarsest`, `MgUpConv`, `MgConv(relu=False)` at k = 1,
`MgResidual(final_relu=False)` through both its eval and its train
stages, `MgConvInput(c_in=1)`, `SigmoidHead`, the classifier on the
coarsest scale) against the JAX one in eval and train mode; the
transposed conv's kernel flip; the BN fold of the up-convs against the
JAX fold; ``bce_loss`` on saturated sigmoids; the U-Net's floor-mode
pool on even and odd maps; the weight bridge both ways for each net; a
checkpoint written by `mgtpu.utils.checkpoint` served and resumed; the
entry points' images, targets and outputs; and the two command lines."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import SEG_RECIPES
from mgtpu import nn as jnn
from mgtpu.models import common as jcommon
from mgtpu.models.base import bce_loss as jax_bce_loss
from mgtpu.ops import mg as jmg
from mgtpu.ops.fold import fold_batchnorm as jax_fold_batchnorm
from mgtpu.ops.resample import maxpool as jax_maxpool
from mgtpu.utils.checkpoint import save_checkpoint
from mgtpu_torch import nn as tnn
from mgtpu_torch.models import common as tcommon
from mgtpu_torch.models import create_model, get_spec
from mgtpu_torch.models.base import NetOpts, bce_loss
from mgtpu_torch.ops import cuda_pool
from mgtpu_torch.ops import mg as tmg
from mgtpu_torch.ops.fold import fold_batchnorm
from mgtpu_torch.ops.resample import maxpool2_floor, nchw, nhwc
from mgtpu_torch.serve import Server, main as serve_main
from mgtpu_torch.trainer import Trainer, main as trainer_main, synthetic_batch
from mgtpu_torch.utils.bridge import export_jax_tree, export_momentum, load_jax_tree, load_momentum
from test_torch_cifar_io import _assert_trees_equal, _pyr, check_block_matches_jax
from test_torch_cifar_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_seg_models import assert_outputs_close, jax_model, port_weights

SEG = sorted(SEG_RECIPES)

# (JAX block, port block, input), as in tests/test_torch_cifar_io.py
BLOCKS = {
    "ConvTranspose": (lambda: jnn.ConvTranspose(4, 5), lambda: tnn.ConvTranspose(4, 5),
                      lambda: _pyr([(5, 6)], [4], 20)[0]),
    "UpConvBN": (lambda: jnn.UpConvBN(4, 5), lambda: tnn.UpConvBN(4, 5),
                 lambda: _pyr([(5, 6)], [4], 21)[0]),
    "MgPool_drop": (lambda: jmg.MgPool([5, 4, 3], "drop"), lambda: tmg.MgPool([5, 4, 3], "drop"),
                    lambda: _pyr([(7, 7), (4, 4), (2, 2)], [5, 4, 3], 22)),
    "DropCoarsest": (lambda: jmg.DropCoarsest([5, 4, 3]), lambda: tmg.DropCoarsest([5, 4, 3]),
                     lambda: _pyr([(8, 8), (4, 4), (2, 2)], [5, 4, 3], 23)),
    "MgUpConv": (lambda: jmg.MgUpConv([5, 4], [3, 6]), lambda: tmg.MgUpConv([5, 4], [3, 6]),
                 lambda: _pyr([(4, 4), (2, 2)], [5, 4], 24)),
    "MgConv_k1_no_relu": (lambda: jmg.MgConv([5, 4, 3], [2, 2, 2], [1, 1, 1], relu=False,
                                             eps=1e-3),
                          lambda: tmg.MgConv([5, 4, 3], [2, 2, 2], [1, 1, 1], relu=False,
                                             eps=1e-3),
                          lambda: _pyr([(8, 8), (4, 4), (2, 2)], [5, 4, 3], 25)),
    # train mode takes MgResidual._train_stages (the prologue's path), eval
    # mode the fused exchange of _stage
    "MgResidual_no_final_relu": (
        lambda: jmg.MgResidual([5, 4, 3], [6, 4, 2], [3, 3, 3], final_relu=False),
        lambda: tmg.MgResidual([5, 4, 3], [6, 4, 2], [3, 3, 3], final_relu=False),
        lambda: _pyr([(8, 8), (4, 4), (2, 2)], [5, 4, 3], 26)),
    # prnmg.mnist's output layer: one scale, k = 1, a narrowing shortcut
    "MgResidual_k1_out": (lambda: jmg.MgResidual([6], [2], [1], final_relu=False),
                          lambda: tmg.MgResidual([6], [2], [1], final_relu=False),
                          lambda: _pyr([(8, 8)], [6], 27)),
    "MgConvInput_c1": (lambda: jmg.MgConvInput([5, 4, 3], c_in=1, eps=1e-3),
                       lambda: tmg.MgConvInput([5, 4, 3], c_in=1, eps=1e-3),
                       lambda: _pyr([(16, 16)], [1], 28)[0]),
    "SigmoidHead": (lambda: jcommon.SigmoidHead(0), lambda: tcommon.SigmoidHead(0),
                    lambda: _pyr([(8, 8), (4, 4)], [3, 2], 29)),
    "LogSoftmaxClassifier_coarsest": (
        lambda: jcommon.LogSoftmaxClassifier(3, 10, pool=2, scale=-1),
        lambda: tcommon.LogSoftmaxClassifier(3, 10, pool=2, scale=-1),
        lambda: _pyr([(8, 8), (4, 4), (2, 2)], [5, 4, 3], 30)),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("block", sorted(BLOCKS))
def test_seg_block_matches_jax(block, train):
    check_block_matches_jax(*(f() for f in BLOCKS[block]), train)


def test_conv_transpose_flips_the_kernel():
    """Input pixel (i, j) adds x[i, j] @ w[1 - a, 1 - b] to output pixel
    (2i + a, 2j + b), in JAX and in the port; F.conv_transpose2d on the
    unflipped kernel adds w[a, b] there, and differs from JAX."""
    rng = np.random.default_rng(31)
    x = rng.standard_normal((1, 3, 4, 2), dtype=np.float32)
    layer = tnn.ConvTranspose(2, 3)
    w = layer.w.detach().numpy()
    ref = np.asarray(jnn.ConvTranspose(2, 3).apply(
        {"w": jnp.asarray(w), "b": jnp.asarray(layer.b.detach().numpy())}, {},
        jnp.asarray(x))[0])
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
        unflipped = nhwc(F.conv_transpose2d(nchw(torch.from_numpy(x)),
                                            layer.w.permute(2, 3, 0, 1), layer.b, stride=2))
    b = layer.b.detach().numpy()
    for a in (0, 1):
        for c in (0, 1):
            want = np.einsum("nhwi,io->nhwo", x, w[1 - a, 1 - c]) + b
            np.testing.assert_allclose(ref[:, a::2, c::2], want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)
    assert np.abs(unflipped.numpy() - ref).max() > 0.1


def test_fold_matches_jax_fold_and_keeps_the_function():
    """unet's BatchNorms, those of its transposed convs included, folded
    by the port equal the JAX package's fold of the same tree, and the
    folded net serves the unfolded net's function."""
    opt = SEG_RECIPES["mnist-cluttered/unet"][0]
    p, s = port_weights(opt)
    ref_p, ref_s = jax_fold_batchnorm(jax_model(opt), p, s)
    model = load_jax_tree(create_model(opt), p, s)
    x = torch.from_numpy(np.random.default_rng(32).standard_normal((2, 64, 64, 1),
                                                                   dtype=np.float32))
    with torch.inference_mode():
        unfolded = model(x)
        got_p, got_s = export_jax_tree(fold_batchnorm(model))
        assert got_p["sub"]["up"]["bn"] == {} and got_s["sub"]["up"]["bn"] == {}
        assert_outputs_close(model(x), unfolded.numpy())
    assert jax.tree.structure(got_p) == jax.tree.structure(ref_p)
    assert jax.tree.structure(got_s) == jax.tree.structure(ref_s)
    for a, b in zip(jax.tree.leaves(got_p), jax.tree.leaves(ref_p)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=1e-7)


def test_bce_loss_on_saturated_sigmoids_matches_jax():
    """Logits of +-17 (the residual heads' at init), where the f32
    sigmoid rounds to 1 and 1 - 1e-12 to 1: a finite loss, equal to
    JAX's, as is its gradient through the sigmoid, at 0 and 1 targets."""
    rng = np.random.default_rng(33)
    logits = np.concatenate([np.full(8, 17.0), np.full(8, -17.0),
                             rng.standard_normal(16)]).astype(np.float32).reshape(2, 4, 4, 1)
    t = (rng.random(logits.shape) > 0.5).astype(np.float32)
    t.flat[:4] = 0.0  # saturated at 1, target 0
    t.flat[8:12] = 1.0  # saturated at 0, target 1
    z = torch.from_numpy(logits).requires_grad_()
    loss = bce_loss(torch.sigmoid(z), torch.from_numpy(t))
    loss.backward()

    def jloss(z):
        return jax_bce_loss(jax.nn.sigmoid(z), jnp.asarray(t))

    ref, ref_g = jax.value_and_grad(jloss)(jnp.asarray(logits))
    assert torch.isfinite(loss) and torch.isfinite(z.grad).all()
    np.testing.assert_allclose(float(loss.detach()), float(ref), rtol=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("hw", [(8, 6), (7, 5), (8, 5)])
def test_unet_pool_floor_mode_matches_jax(hw, monkeypatch):
    """maxpool2_floor against the JAX U-Net's maxpool(x, 2, 2, 0), values
    and gradients (ties at 0 and above, first-tie rule); every map, odd
    ones cropped to even sides, goes to the pool kernel's entry point."""
    calls = []
    real = cuda_pool.maxpool2_forward
    monkeypatch.setattr(cuda_pool, "maxpool2_forward",
                        lambda x: calls.append(x.shape) or real(x))
    rng = np.random.default_rng(34)
    x = np.maximum(np.round(rng.standard_normal((2, *hw, 3)) * 2) / 2, 0).astype(np.float32)
    r = rng.standard_normal((2, hw[0] // 2, hw[1] // 2, 3)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    y = maxpool2_floor(xt)
    (y * torch.from_numpy(r)).sum().backward()
    ref_y = np.asarray(jax_maxpool(jnp.asarray(x), 2, 2, 0))
    ref_g = np.asarray(jax.grad(lambda a: jnp.sum(jax_maxpool(a, 2, 2, 0) * r))(jnp.asarray(x)))
    np.testing.assert_array_equal(y.detach().numpy(), ref_y)
    np.testing.assert_array_equal(xt.grad.numpy(), ref_g)
    assert calls == [(2, hw[0] - hw[0] % 2, hw[1] - hw[1] % 2, 3)]


@pytest.mark.parametrize("net", SEG)
def test_bridge_round_trip(net):
    """export_jax_tree inverts load_jax_tree on each net, unfolded and
    folded (empty dicts for the folded BNs, the up-convs' included), and
    the SGD momentum carries across both ways."""
    opt = SEG_RECIPES[net][0]
    p, s = port_weights(opt, seed=5)
    for folded in (False, True):
        if folded:
            p, s = export_jax_tree(fold_batchnorm(load_jax_tree(create_model(opt), p, s)))
        model = load_jax_tree(create_model(opt), p, s)
        got_p, got_s = export_jax_tree(model)
        _assert_trees_equal(got_p, p)
        _assert_trees_equal(got_s, s)
    rng = np.random.default_rng(7)
    model = load_jax_tree(create_model(opt), *port_weights(opt, seed=5))
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32),
                     export_jax_tree(model)[0])
    _assert_trees_equal(export_momentum(model, load_momentum(model, {"m": m}))["m"], m)


@pytest.mark.parametrize("net", ["ilsvrc/prnmgseg", "mnist-cluttered/unmg"])
def test_server_and_trainer_from_jax_checkpoint(net, tmp_path):
    """A checkpoint the JAX trainer writes names its net and its flags in
    its meta (prnmgseg: depth and shortcutType; unmg: the dataset, which
    sets its 10 classes): the Server rebuilds the net from the meta alone
    (not from the default R-MG-34 options it was given) and serves it (BN
    folded, f32 on the CPU: the unfolded net's outputs); the Trainer
    resumes it with its momentum and steps, on int labels or dense
    targets."""
    opt = SEG_RECIPES[net][0]
    p, s = port_weights(opt, seed=8)
    spec = get_spec(net)
    x = np.random.default_rng(9).standard_normal((2, *spec.image_shape), dtype=np.float32)
    with torch.inference_mode():
        ref = load_jax_tree(create_model(opt), p, s)(torch.from_numpy(x)).numpy()
    rng = np.random.default_rng(10)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32) * 0.01, p)
    meta = {"netType": net, "dataset": opt.dataset or spec.dataset, "nLayer": 1,
            "isDropout": False}
    if net == "ilsvrc/prnmgseg":
        meta.update(depth=opt.depth, shortcutType=opt.shortcutType)
    path = str(tmp_path / "model_1.ckpt")
    save_checkpoint(path, p, s, opt_state={"m": m}, epoch=1, meta=meta)
    server = Server(NetOpts(), ckpt=path, device="cpu", compute_dtype=torch.float32)
    assert (server.opt.netType, server.opt.depth, server.opt.shortcutType) == (
        net, opt.depth, opt.shortcutType)
    assert server.image_shape == spec.image_shape
    assert_outputs_close(server.predict(x), ref)
    tr = Trainer(NetOpts(), ckpt=path, device="cpu", compute_dtype=torch.float32, iter_size=2)
    _assert_trees_equal(export_momentum(tr.model, tr.opt_state)["m"], m)
    xb, yb = synthetic_batch(2, 11, spec.n_classes(tr.opt), spec.image_shape, tr.target_shape)
    metrics = tr.step(xb, yb, 0.1, 5e-4)
    assert np.isfinite(float(metrics["loss"]))
    assert sorted(metrics) == (["loss", "top1", "top5"] if net == "ilsvrc/prnmgseg" else ["loss"])


def test_entry_points_take_1_channel_images_and_dense_targets():
    """An mnist net takes (B, 64, 64, 1) images; Server.predict gives f32
    probabilities (B, 64, 64, classes), its transposed convs cast to the
    compute dtype; Trainer.step takes f32 {0, 1} targets of the output's
    shape (synthetic_batch makes them) and refuses int labels."""
    opt = NetOpts(netType="mnist-cluttered/unet")
    server = Server(opt, seed=1, device="cpu", compute_dtype=torch.float32)
    assert server.image_shape == (64, 64, 1)
    y = server.predict(np.zeros((3, 64, 64, 1), np.float32))
    assert y.shape == (3, 64, 64, 1) and y.dtype == torch.float32
    assert bool(((y >= 0) & (y <= 1)).all())
    with pytest.raises(ValueError, match="NHWC"):
        server.predict(np.zeros((1, 64, 64, 3), np.float32))
    tr = Trainer(opt, device="cpu", compute_dtype=torch.float32)
    assert tr.target_shape == (64, 64, 1)
    x, t = synthetic_batch(2, 3, 1, tr.image_shape, tr.target_shape)
    assert t.dtype == np.float32 and set(np.unique(t)) == {0.0, 1.0} and t.shape == (2, 64, 64, 1)
    assert np.isfinite(float(tr.step(x, t, 0.01, 5e-4)["loss"]))
    with pytest.raises(ValueError, match="targets"):
        tr.step(x, np.array([0, 1]), 0.01, 5e-4)
    bf16 = Server(opt, seed=1, device="cpu")
    assert {m.w.dtype for m in bf16.model.modules()
            if isinstance(m, (tnn.Conv, tnn.ConvTranspose))} == {torch.bfloat16}
    assert bf16.predict(np.zeros((1, 64, 64, 1), np.float32)).dtype == torch.float32


def test_serve_cli_on_cpu(capsys):
    """A probability map has no top-1: the line gives its range."""
    serve_main(["--net", "mnist-cluttered/unmg", "--dataset", "mnist-seg", "--random",
                "--batches", "2", "--device", "cpu"])
    serve_main(["--net", "ilsvrc/prnmgseg", "--depth", "30", "--shortcutType", "A", "--random",
                "--batches", "1", "--device", "cpu"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line]
    assert [r["out_shape"] for r in rows] == [[2, 64, 64, 10], [1, 1000]]
    assert all(r["finite"] for r in rows)
    assert "top1_first" not in rows[0] and 0 <= rows[0]["prob_range"][0] <= rows[0]["prob_range"][1] <= 1
    assert rows[0]["net"] == "mnist-cluttered/unmg mnist-seg"
    assert rows[1]["net"] == "ilsvrc/prnmgseg depth 30 shortcutType A" and "top1_first" in rows[1]
    with pytest.raises(SystemExit):
        serve_main(["--net", "ilsvrc/prnmgseg", "--depth", "34", "--random", "--device", "cpu"])


def test_trainer_cli_on_cpu(capsys):
    trainer_main(["--net", "mnist-cluttered/prnmg.mnist", "--random", "--batch", "2",
                  "--iterSize", "2", "--steps", "2", "--device", "cpu"])
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines() if line]
    assert [r["step"] for r in rows] == [0, 1]
    assert all(np.isfinite(r["loss"]) and r["iterSize"] == 2 for r in rows)
    assert rows[0]["net"] == "mnist-cluttered/prnmg.mnist nLayer 1 mnist-spt"
