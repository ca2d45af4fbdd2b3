"""The port's cluttered-MNIST nets and PR-MG (`mgtpu_torch.models.
mnist_cluttered`, `mgtpu_torch.models.ilsvrc.prnmgseg`) against the JAX
package, on the CPU: parameter counts and tree structures, the eval
forward of each net at its recipe's options with the weights carried
across by the bridge, the NetSpec subset (rules, classes, shapes,
metrics), the registry and its defaults, and the kernel calls (and the
designs they route to) that one serving forward and one training
micro-batch of each net make, which ``chip_smoke.py`` holds the card's
launches to."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (PNMG_SEG, PRNMGSEG52, PRNMGSEG52_PER_FORWARD, SEG_PER_FORWARD,
                        SEG_PER_MICRO, SEG_RECIPES, predicted_routes, record_kernel_shapes)
from mgtpu.models import get_net as jax_get_net
from mgtpu.models import list_models as jax_list_models
from mgtpu.nn import param_count as jax_param_count
from mgtpu.utils.metrics import mnist_iu as jax_mnist_iu
from mgtpu_torch.models import create_model, get_spec, list_models, net_options
from mgtpu_torch.models.base import NetOpts
from mgtpu_torch.nn import param_count
from mgtpu_torch.utils.bridge import export_jax_tree, load_jax_tree
from mgtpu_torch.serve import calibrate_batchnorm
from test_torch_cifar_models import few_torch_threads  # noqa: F401

SEG = sorted(SEG_RECIPES)
# each net's parameters as the JAX package counts them (pinned here
# besides the comparison with it)
PARAMS = [
    (SEG_RECIPES["mnist-cluttered/unet"][0], 3_790_915),
    (SEG_RECIPES["mnist-cluttered/unmg"][0], 5_903_290),
    (SEG_RECIPES["mnist-cluttered/pnmg.mnist"][0], 600_507),
    (SEG_RECIPES["mnist-cluttered/prnmg.mnist"][0], 1_198_554),
    (NetOpts(netType="ilsvrc/prnmgseg", depth=30, shortcutType="A"), 31_905_432),
    (NetOpts(netType="ilsvrc/prnmgseg", depth=30, shortcutType="B"), 32_138_952),
    (NetOpts(netType="ilsvrc/prnmgseg", depth=52, shortcutType="A"), 60_463_560),
    (NetOpts(netType="ilsvrc/prnmgseg", depth=52, shortcutType="B"), 60_697_080),
]


def jax_opt(opt: NetOpts):
    """The JAX options namespace of the port's NetOpts (the net's own
    dataset where ``opt`` names none)."""
    return types.SimpleNamespace(dataset=opt.dataset or get_spec(opt.netType).dataset,
                                 nLayer=opt.nLayer, isDropout=opt.isDropout, depth=opt.depth,
                                 shortcutType=opt.shortcutType, nEpochs=opt.nEpochs)


def jax_model(opt: NetOpts):
    return jax_get_net(opt.netType).create_model(jax_opt(opt))


def port_weights(opt: NetOpts, seed=0):
    """The port's seeded init of the net with its BatchNorms calibrated
    to their inputs (`serve.calibrate_batchnorm`: random affines, running
    stats the moments of each BN's input), exported to the JAX tree
    (numpy). With running stats drawn at random instead, the residual
    nets' activations grow layer by layer, and prnmg.mnist's f32 outputs
    differed by up to 5e-4 (in probability) between two summation
    orders."""
    gen = torch.Generator().manual_seed(seed)
    model = create_model(opt, generator=gen)
    calibrate_batchnorm(model, gen, get_spec(opt.netType).image_shape)
    return export_jax_tree(model)


@pytest.mark.parametrize("opt,n", PARAMS, ids=lambda v: getattr(v, "netType", None)
                         and f"{v.netType}-{v.depth}-{v.shortcutType}")
def test_param_count_and_tree_match_jax(opt, n):
    """The count equals the JAX package's and the pin, and the port's
    tree (its bridge export) has the JAX init's structure and shapes."""
    params, stats = jax.eval_shape(jax_model(opt).init, jax.random.PRNGKey(0))
    model = create_model(opt)
    assert param_count(model) == jax_param_count(params) == n
    got_p, got_s = export_jax_tree(model)
    for got, ref in ((got_p, params), (got_s, stats)):
        assert jax.tree.structure(got) == jax.tree.structure(ref)
        assert [a.shape for a in jax.tree.leaves(got)] == [a.shape for a in jax.tree.leaves(ref)]


def assert_outputs_close(got, ref):
    """f32 on both sides, summed in other orders; the CIFAR tests' bound,
    relative to the outputs' scale (log-probs, or probabilities)."""
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("net", SEG)
def test_eval_forward_matches_jax(net):
    """The recipe's options, one image (64x64x1, or 224x224x3), eval mode
    (BN running stats), weights carried across by the bridge."""
    opt = SEG_RECIPES[net][0]
    p, s = port_weights(opt)
    jm = jax_model(opt)
    x = np.random.default_rng(2).standard_normal((1, *get_spec(net).image_shape),
                                                 dtype=np.float32)
    ref = np.asarray(jax.jit(lambda p, s, x: jm.apply(p, s, x)[0])(p, s, jnp.asarray(x)))
    with torch.inference_mode():
        got = load_jax_tree(create_model(opt), p, s)(torch.from_numpy(x))
    spec = get_spec(net)
    assert got.shape == (1, *(spec.target_shape(opt) or (spec.n_classes(opt),)))
    assert_outputs_close(got, ref)


@pytest.mark.parametrize("net", SEG)
def test_spec_matches_jax(net):
    """The NetSpec subset: the rule at epoch 1 and 61 of 200, the classes
    and shapes on the recipe's dataset and on mnist-seg, the loss and the
    metrics' names and values against the JAX NetSpec's."""
    opt = SEG_RECIPES[net][0]
    spec, jspec = get_spec(net), jax_get_net(net)
    opt200 = NetOpts(**{**vars(opt), "nEpochs": 200})
    for epoch in (1, 61):
        assert spec.train_rule(epoch, opt200) == jspec.train_rule(epoch, jax_opt(opt200))
    rng = np.random.default_rng(3)
    if net == "ilsvrc/prnmgseg":
        assert spec.image_shape == (224, 224, 3) and spec.n_classes(opt) == 1000
        assert spec.target_shape(opt) == ()
        out = torch.log_softmax(torch.from_numpy(rng.standard_normal((4, 1000),
                                                                     dtype=np.float32)), -1)
        y = torch.tensor([1, 2, 3, 4])
    else:
        seg = NetOpts(netType=net, dataset="mnist-seg")
        assert spec.image_shape == (64, 64, 1)
        assert spec.n_classes(seg) == 10 and spec.n_classes(NetOpts(netType=net)) == (
            10 if spec.dataset == "mnist-seg" else 1)
        assert spec.target_shape(seg) == (64, 64, 10)
        out = torch.sigmoid(torch.from_numpy(rng.standard_normal((3, 64, 64, 10),
                                                                 dtype=np.float32)))
        y = torch.from_numpy((rng.random((3, 64, 64, 10)) > 0.5).astype(np.float32))
    # an f32 mean of 122,880 terms (BCE), summed in another order: 1e-5
    loss = spec.create_loss(opt)(out, y)
    ref_loss = jspec.create_loss(jax_opt(opt))(jnp.asarray(out.numpy()), jnp.asarray(y.numpy()))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    for fn, jfn in ((spec.train_metrics, jspec.train_metrics),
                    (spec.test_metrics, jspec.test_metrics)):
        got = fn(out, y, loss)
        ref = jfn(jnp.asarray(out.numpy()), jnp.asarray(y.numpy()), ref_loss)
        assert sorted(got) == sorted(ref)
        for k in got:
            np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5, err_msg=k)


def test_registry_and_defaults():
    """Every net of the JAX zoo is here (the mnist-test and
    mnist-saliency harnesses run on the ported run loop); each mnist
    net's dataset is its recipe's; prnmgseg's depth is its own (30), and
    R-MG-34's depth (34) is refused."""
    assert set(jax_list_models()) - set(list_models()) == set()
    assert {net: get_spec(net).dataset for net in SEG if net.startswith("mnist")} == {
        "mnist-cluttered/unet": "mnist-sca", "mnist-cluttered/unmg": "mnist-seg",
        "mnist-cluttered/pnmg.mnist": "mnist-aff", "mnist-cluttered/prnmg.mnist": "mnist-spt"}
    seg = NetOpts(netType="ilsvrc/prnmgseg")
    assert seg.depth is None and net_options(seg).depth == 30
    assert net_options(NetOpts()).depth == 34
    assert net_options(NetOpts(netType="cifar/vgg")).depth is None
    assert get_spec("ilsvrc/prnmgseg").describe(net_options(seg)) == (
        "ilsvrc/prnmgseg depth 30 shortcutType B")
    assert param_count(create_model(seg)) == 32_138_952  # depth 30, shortcut B
    with pytest.raises(ValueError, match="depth 34"):
        create_model(NetOpts(netType="ilsvrc/prnmgseg", depth=34))
    with pytest.raises(ValueError, match="shortcut"):
        create_model(NetOpts(netType="ilsvrc/prnmgseg", shortcutType="D"))
    # mnist-seg gives pnmg.mnist 10 output channels: the output conv's 64 * 9 * 9 weights
    # and 9 biases more, and 9 more BN scales and biases
    assert param_count(create_model(PNMG_SEG)) - param_count(
        create_model(SEG_RECIPES["mnist-cluttered/pnmg.mnist"][0])) == 9 * (64 * 9 + 3)


def test_mnist_iu_matches_jax():
    """Mean IU over the classes present, per sample, averaged over the
    samples with any class: against the JAX metric, with a sample whose
    target is empty and probabilities on the threshold."""
    rng = np.random.default_rng(4)
    probs = rng.random((4, 8, 8, 3)).astype(np.float32)
    probs[0, :2] = 0.5
    targets = (rng.random((4, 8, 8, 3)) > 0.7).astype(np.float32)
    targets[1] = 0
    targets[2, ..., 1] = 0
    from mgtpu_torch.utils.metrics import mnist_iu

    got = mnist_iu(torch.from_numpy(probs), torch.from_numpy(targets))
    ref = jax_mnist_iu(jnp.asarray(probs), jnp.asarray(targets), 0.5)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def _calls(shapes):
    return {k: sum(c.values()) for k, c in shapes.items()}


@pytest.mark.parametrize("net", SEG)
def test_kernel_calls_per_forward_and_micro_batch(net):
    """The counts chip_smoke.py holds each net's launches to: one serving
    forward (BN folded) and one training micro-batch, forward and
    backward, at the recipe's options; the designs they route to cover
    every call."""
    opt = SEG_RECIPES[net][0]
    serve, train = (record_kernel_shapes(t, opt) for t in (False, True))
    assert _calls(serve) == SEG_PER_FORWARD[net]
    assert _calls(train) == SEG_PER_MICRO[net]
    for shapes in (serve, train):
        routes = predicted_routes(shapes)
        for kernel in ("conv3x3", "conv3x3_bn_relu_in", "maxpool2", "maxpool2_bwd"):
            assert sum(n for (k, _), n in routes.items() if k == kernel) == _calls(shapes)[kernel]


def test_new_kernel_shapes_and_their_designs():
    """The shapes this slice brings to the kernels, and the designs that
    take them: the 1-channel stems (Ci = 1) and pnmg.mnist's output conv
    (Co = 1; 10 on mnist-seg) go to window, as do the 8-32 wide 7x7 and
    14x14 grids of prnmgseg; its 64-512 wide ones go to sm90; every pool
    of a 64 px net goes to sm90; PR-MG-52's forward makes the pinned
    calls."""
    pnmg = record_kernel_shapes(False, SEG_RECIPES["mnist-cluttered/pnmg.mnist"][0])["conv3x3"]
    pnmg_seg = record_kernel_shapes(False, PNMG_SEG)["conv3x3"]
    seg = record_kernel_shapes(False, SEG_RECIPES["ilsvrc/prnmgseg"][0])
    unet = record_kernel_shapes(False, SEG_RECIPES["mnist-cluttered/unet"][0])
    assert (64, 64, 1, 64) in pnmg and (64, 64, 64, 1) in pnmg and (64, 64, 64, 10) in pnmg_seg
    assert {(7, 7, 8, 8), (7, 7, 16, 32), (14, 14, 16, 32), (7, 7, 512, 512)} <= set(seg["conv3x3"])

    def route(*shape):
        return predicted_routes({"conv3x3": {shape: 1}, "conv3x3_bn_relu_in": {},
                                 "maxpool2": {}, "maxpool2_bwd": {}})

    for shape, design in (((64, 64, 1, 64), "window"), ((64, 64, 64, 1), "window"),
                          ((64, 64, 64, 10), "window"), ((7, 7, 8, 16), "window"),
                          ((14, 14, 16, 32), "window"), ((7, 7, 64, 128), "sm90")):
        assert route(*shape)[("conv3x3", design)] == 1, shape
    assert sorted(unet["maxpool2"]) == [(16, 16, 256), (32, 32, 128), (64, 64, 64)]
    assert predicted_routes(unet)[("maxpool2", "sm90")] == 3
    assert _calls(record_kernel_shapes(False, PRNMGSEG52)) == PRNMGSEG52_PER_FORWARD
