"""The port's CIFAR zoo (`mgtpu_torch.models.cifar`) against the JAX
package, on the CPU: parameter counts at ``-nLayer 1`` and at the
recipes' depths, the eval forward of each net at ``-nLayer 1`` with the
weights carried across by the bridge, the LR rules, the registry, and
the kernel calls (and the designs they route to) that one serving
forward and one training micro-batch of each net make at its recipe
depth, which ``chip_smoke.py`` holds the card's launches to."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (CIFAR_PER_FORWARD, CIFAR_PER_MICRO, CIFAR_RECIPES,
                        PRNMG_DROPOUT_PER_MICRO, cifar_opts, predicted_routes,
                        record_kernel_shapes)
from mgtpu.models import get_net as jax_get_net
from mgtpu.models.base import log_linear_rule as jax_log_linear_rule
from mgtpu.models.base import step_rule as jax_step_rule
from mgtpu.nn import param_count as jax_param_count
from mgtpu_torch.models import create_model, get_spec, list_models
from mgtpu_torch.models.base import NetOpts, log_linear_rule, step_rule
from mgtpu_torch.nn import param_count
from mgtpu_torch.utils.bridge import load_jax_tree

CIFAR = sorted(CIFAR_RECIPES)
DROPOUT_NETS = ("cifar/pnmg", "cifar/prnmg", "cifar/resnet", "cifar/rnmg")  # have --isDropout
# each net's parameters at its recipe's depth, as the JAX package counts
# them (pinned here besides the comparison with it)
RECIPE_PARAMS = {"cifar/nmg": 8_186_220, "cifar/rnmg": 26_994_780, "cifar/pnmg": 32_742_228,
                 "cifar/prnmg": 20_602_212, "cifar/resnet": 42_482_148, "cifar/vgg": 51_893_314}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """At most two torch threads while this module's tests run: the suite
    runs six workers on the machine's cores, and torch's default of one
    thread a core oversubscribes them, which slowed these small-op CPU
    passes 30-100 fold (measured). Restored afterwards."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _jax_model(name, n_layer=1, dropout=False):
    opt = types.SimpleNamespace(dataset="cifar100", nLayer=n_layer, isDropout=dropout)
    return jax_get_net(name).create_model(opt)


def _port(name, n_layer=1, dropout=False):
    return create_model(NetOpts(netType=name, nLayer=n_layer, isDropout=dropout,
                                dataset="cifar100"))


@pytest.mark.parametrize("name,n_layer", sorted({(n, 1) for n in CIFAR}
                                                | {(n, CIFAR_RECIPES[n][0]) for n in CIFAR}))
def test_param_count_matches_jax(name, n_layer):
    params, _ = jax.eval_shape(_jax_model(name, n_layer).init, jax.random.PRNGKey(0))
    n = param_count(_port(name, n_layer))
    assert n == jax_param_count(params)
    if n_layer == CIFAR_RECIPES[name][0]:
        assert n == RECIPE_PARAMS[name]


def _jitter_bn(p, s, rng):
    """Non-trivial BN affines and running stats everywhere in a tree
    (numpy, in place)."""
    for k, v in p.items():
        if k == "bn" and v:
            v["scale"] = rng.uniform(0.5, 1.5, v["scale"].shape).astype(np.float32)
            v["bias"] = rng.normal(0, 0.2, v["bias"].shape).astype(np.float32)
            s[k]["mean"] = rng.normal(0, 0.2, s[k]["mean"].shape).astype(np.float32)
            s[k]["var"] = rng.uniform(0.5, 1.5, s[k]["var"].shape).astype(np.float32)
        elif isinstance(v, dict):
            _jitter_bn(v, s.get(k, {}), rng)


def jax_weights(model, seed=0):
    p, s = jax.tree.map(np.array, jax.jit(model.init)(jax.random.PRNGKey(seed)))
    _jitter_bn(p, s, np.random.default_rng(seed + 1))
    return p, s


def assert_logprobs_close(got, ref):
    """f32 on both sides, summed in other orders; the bound is relative to
    the log-probs' scale (measured: up to 7e-7 of it)."""
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("name", CIFAR)
def test_eval_forward_matches_jax(name):
    """-nLayer 1, one 32x32x3 image, eval mode (BN running stats). The
    nets with --isDropout give the JAX eval forward too (JAX's --isDropout
    net is the same function in eval mode), and exactly the port's
    forward without dropout."""
    dropout = name in DROPOUT_NETS
    jm = _jax_model(name, dropout=dropout)
    p, s = jax_weights(jm)
    x = np.random.default_rng(2).standard_normal((1, 32, 32, 3), dtype=np.float32)
    ref = np.asarray(jm.apply(p, s, jnp.asarray(x))[0])
    with torch.inference_mode():
        got = load_jax_tree(_port(name), p, s)(torch.from_numpy(x))
        if dropout:
            got_dropout = load_jax_tree(_port(name, dropout=True), p, s)(torch.from_numpy(x))
            assert torch.equal(got_dropout, got)
    assert got.shape == (1, 100)
    assert_logprobs_close(got, ref)


@pytest.mark.parametrize("epoch", [1, 2, 59, 60, 61, 119, 120, 160, 200])
def test_lr_rules_match_jax(epoch):
    assert step_rule(epoch) == jax_step_rule(epoch)
    for n_epochs in (1, 20, 200):
        assert log_linear_rule(epoch, n_epochs) == jax_log_linear_rule(epoch, n_epochs)


@pytest.mark.parametrize("name", CIFAR)
def test_spec_matches_jax(name):
    """The NetSpec subset: 10 or 100 classes, the rule at epoch 1 and 61
    for the recipes' 200 epochs, the metrics' names."""
    spec, jspec = get_spec(name), jax_get_net(name)
    opt = NetOpts(netType=name, dataset="cifar100", nEpochs=200)
    jopt = types.SimpleNamespace(dataset="cifar100", nEpochs=200)
    for epoch in (1, 61):
        assert spec.train_rule(epoch, opt) == jspec.train_rule(epoch, jopt)
    assert spec.n_classes(opt) == 100 and spec.image_size == 32
    assert spec.n_classes(NetOpts(netType=name, dataset="cifar10")) == 10
    lp = torch.log_softmax(torch.randn(4, 100, generator=torch.Generator().manual_seed(0)), -1)
    y = torch.tensor([1, 2, 3, 4])
    ref = jspec.train_metrics(jnp.asarray(lp.numpy()), jnp.asarray(y.numpy()), 0.0)
    got = spec.train_metrics(lp, y, spec.create_loss(opt)(lp, y))
    assert sorted(got) == sorted(ref) == ["loss", "top1"]
    assert float(got["top1"]) == float(ref["top1"])


def test_registry_has_the_cifar_zoo():
    assert set(CIFAR) < set(list_models())
    assert get_spec("ilsvrc/rnmg").image_size == 224
    assert get_spec("ilsvrc/rnmg").dataset == "ilsvrc" and get_spec("cifar/vgg").dataset == "cifar100"
    # -dataset cifar10 gives the classifier 10 classes
    assert param_count(create_model(NetOpts(netType="cifar/prnmg", dataset="cifar10"))) == (
        param_count(_port("cifar/prnmg")) - 90 * 897)


def _calls(shapes):
    return {k: sum(c.values()) for k, c in shapes.items()}


@pytest.mark.parametrize("name", CIFAR)
def test_kernel_calls_per_forward_and_micro_batch(name):
    """The counts chip_smoke.py holds each net's launches to: one serving
    forward (BN folded) and one training micro-batch, forward and
    backward, at the recipe's depth; and the designs they route to
    cover every call."""
    serve, train = (record_kernel_shapes(t, cifar_opts(name)) for t in (False, True))
    assert _calls(serve) == CIFAR_PER_FORWARD[name]
    assert _calls(train) == CIFAR_PER_MICRO[name]
    for shapes in (serve, train):
        routes = predicted_routes(shapes)
        for kernel in ("conv3x3", "conv3x3_bn_relu_in", "maxpool2", "maxpool2_bwd"):
            assert sum(n for (k, _), n in routes.items() if k == kernel) == _calls(shapes)[kernel]


def test_prnmg_dropout_takes_materialized_parts_through_conv3x3():
    """Under dropout every residual block of blocks 2-5 convolves its
    masked parts with conv3x3; only block 1's prefix, which has no
    dropout, keeps the conv3x3_bn_relu_in prologue."""
    train = record_kernel_shapes(True, cifar_opts("cifar/prnmg", dropout=True))
    assert _calls(train) == PRNMG_DROPOUT_PER_MICRO
    plain = CIFAR_PER_MICRO["cifar/prnmg"]
    # each prologue launch given up is one conv3x3 launch, plus one for
    # each up part materialized at fine resolution
    assert PRNMG_DROPOUT_PER_MICRO["conv3x3"] - plain["conv3x3"] >= (
        plain["conv3x3_bn_relu_in"] - PRNMG_DROPOUT_PER_MICRO["conv3x3_bn_relu_in"])


def test_the_small_grids_reach_the_sm90_conv():
    """pnmg's blocks 4 and 5 convolve 4x4 and 2x2 grids of 256 and 512
    channels: bf16 with Ci and Co multiples of 64, so the sm90 design
    takes them (chip_smoke.py checks them against the plain version)."""
    serve = record_kernel_shapes(False, cifar_opts("cifar/pnmg"))["conv3x3"]
    assert (4, 4, 256, 512) in serve and (2, 2, 512, 512) in serve
    routes = predicted_routes({"conv3x3": {(2, 2, 512, 512): 1}, "conv3x3_bn_relu_in": {},
                               "maxpool2": {}, "maxpool2_bwd": {}})
    assert routes[("conv3x3", "sm90")] == 1
