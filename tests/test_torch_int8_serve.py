"""int8 serving of whole nets in the port against the JAX package, on the
CPU: the convs `quantize_model` picks on every net of the zoo, the int8
forwards of R-MG-18, ``cifar/prnmg`` and ``unmg`` with a quantized (and
calibrated) JAX tree carried across by the bridge, the `conv_i8` calls
an int8 forward makes (which ``chip_smoke.py`` holds the card's launches
to), `Server` and the ``mgtpu_torch.serve`` CLI under ``--int8``, and the
run loop's ``-test -int8 [-int8Calib N]`` against the JAX Session's."""

import json
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (I8_PER_FORWARD, I8_SERVE, PER_FORWARD, int8_layers,
                        record_kernel_shapes)
from mgtpu.models import get_net as jax_get_net
from mgtpu.ops import quant as jq
from mgtpu.ops.fold import fold_batchnorm as jax_fold
from mgtpu.pipelines import standard as jax_standard
from mgtpu.utils import opts as jax_opts
from mgtpu_torch import serve
from mgtpu_torch.models import create_model, get_spec, list_models, net_options
from mgtpu_torch.models.base import NetOpts
from mgtpu_torch.ops.fold import fold_batchnorm
from mgtpu_torch.ops.quant import quantize_model
from mgtpu_torch.pipelines import standard
from mgtpu_torch.serve import Server, calibrate_batchnorm
from mgtpu_torch.utils import opts
from mgtpu_torch.utils.bridge import export_jax_tree, load_jax_tree
from mgtpu_torch.utils.checkpoint import write_checkpoint
from test_torch_cifar_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_pipeline import _run

# every net of the zoo but the mnist-test and mnist-saliency harnesses
# (they rebuild a checkpoint's net), at its smallest options
ZOO = [net for net in list_models()
       if net not in ("mnist-cluttered/mnist-test", "mnist-cluttered/mnist-saliency")]


def _jax_opt(opt: NetOpts):
    opt = net_options(opt)
    return types.SimpleNamespace(dataset=opt.dataset or get_spec(opt.netType).dataset,
                                 nLayer=opt.nLayer, isDropout=opt.isDropout, depth=opt.depth,
                                 shortcutType=opt.shortcutType, nEpochs=opt.nEpochs)


def _paths(tree, prefix=""):
    """{path: leaf} of a nested dict."""
    if isinstance(tree, dict):
        return {k: v for key, sub in tree.items()
                for k, v in _paths(sub, f"{prefix}.{key}").items()}
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("net", ZOO)
def test_quantize_model_picks_the_jax_convs(net):
    """quantize_model quantizes exactly the kernels quantize_params does
    (every conv but the 2x2 transposed ones), to the same bits: the two
    trees are equal leaf for leaf."""
    model = create_model(NetOpts(netType=net))
    p, _ = export_jax_tree(model)
    ref = _paths(jq.quantize_params(p))
    got = _paths(export_jax_tree(quantize_model(model))[0])
    assert sorted(got) == sorted(ref)
    assert any(k.endswith(".w8") for k in got)
    for k, v in got.items():
        assert v.dtype == ref[k].dtype and np.array_equal(v, ref[k]), k
    # the 2x2 upsamplers of the U-Nets stay float
    assert all(v.shape[:2] != (2, 2) for k, v in got.items() if k.endswith(".w8"))


# net -> (options, images a batch, BN folded first): R-MG-18 in serving's
# order (fold, quantize, calibrate: tools/export_model.py), the others in
# the run loop's (quantize the unfolded net)
BRIDGE = {"ilsvrc/rnmg": (NetOpts(depth=18), 1, True),
          "cifar/prnmg": (NetOpts(netType="cifar/prnmg"), 2, False),
          "mnist-cluttered/unmg": (NetOpts(netType="mnist-cluttered/unmg"), 2, False)}


@pytest.mark.parametrize("mode", ["dynamic", "static"])
@pytest.mark.parametrize("net", sorted(BRIDGE))
def test_int8_forward_matches_jax_through_the_bridge(net, mode):
    """A JAX tree quantized (and, static, calibrated on two batches) by
    `mgtpu.ops.quant` goes into the port through the bridge, and the
    port's f32 forward gives JAX's forward, eager as `calibrate` runs it.
    Both compute the same int32 sums and dequants; the float ops between
    them (BN, pools, adds) may round in other places, and an input a
    rounding apart quantizes one step apart. So the bound is the repo's
    rule for two f32 forwards: 1e-5 of the outputs' scale, or three
    times the change that moving the images by 1e-6 makes to JAX's own
    forward (measured: at most 7.6e-6 on R-MG-18's log-probs of scale
    14.6). Not the jitted forward: XLA turns the dynamic scale's
    division by 127 into a multiplication by its reciprocal, one bit
    off for about 5% of the scales (measured), which flips quantize
    steps and moved R-MG-18's log-probs by 0.039 and unmg's
    probabilities by 0.017."""
    opt, batch, fold = BRIDGE[net]
    shape = get_spec(net).image_shape
    gen = torch.Generator().manual_seed(0)
    model = create_model(opt, generator=gen)
    calibrate_batchnorm(model, gen, shape)
    p, s = export_jax_tree(model)
    jm = jax_get_net(net).create_model(_jax_opt(opt))
    if fold:
        p, s = jax.tree.map(np.asarray, jax_fold(jm, p, s))
    pq = jax.tree.map(np.asarray, jq.quantize_params(p))
    rng = np.random.default_rng(3)
    if mode == "static":
        jq.calibrate(jm, pq, s, [rng.standard_normal((2, *shape), dtype=np.float32)
                                 for _ in range(2)])
    x = rng.standard_normal((batch, *shape), dtype=np.float32)
    moved = x * (1 + 1e-6 * rng.standard_normal(x.shape, dtype=np.float32))
    ref, ref_moved = (np.asarray(jm.apply(pq, s, jnp.asarray(a))[0]) for a in (x, moved))
    port = load_jax_tree(create_model(opt), pq, s)
    assert all(m.quantized and (m.sx is not None) == (mode == "static")
               for m in port.modules() if getattr(m, "quantized", False))
    with torch.inference_mode():
        got = port(torch.from_numpy(x)).numpy()
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    own = np.abs(ref_moved - ref).max()
    assert got.shape == ref.shape and err <= max(1e-5 * scale, 3 * own), (err, scale, own)


def _calls(shapes):
    return {k: sum(c.values()) for k, c in shapes.items()}


@pytest.mark.parametrize("net", sorted(I8_PER_FORWARD))
def test_int8_forward_launches_are_pinned(net):
    """One int8 serving forward (BN folded, quantized) calls conv_i8 once a
    quantized conv part, quant_i8 once a layer (every part of a multigrid
    layer in one group) and neither 3x3 conv kernel; it pools as the
    float forward does. The run loop's order (quantize the unfolded net)
    makes the same calls at the same shapes."""
    opt = I8_SERVE[net][0]
    got = record_kernel_shapes(False, opt, int8=True)
    assert _calls(got) == I8_PER_FORWARD[net]
    # one quantizer call a layer (one launch with static scales, two with
    # dynamic ones: chip_smoke.i8_pins), each conv part in one of them
    assert I8_PER_FORWARD[net]["quant_i8"] == int8_layers(quantize_model(create_model(opt)))
    assert sum(len(key) * n for key, n in got["quant_i8"].items()) == I8_PER_FORWARD[net][
        "conv_i8"]
    assert record_kernel_shapes(False, opt, fold=False, int8=True) == got
    floats = _calls(record_kernel_shapes(False, opt))
    assert floats["conv_i8"] == 0 and floats["maxpool2"] == I8_PER_FORWARD[net]["maxpool2"]
    # every conv_i8 call is a conv part: a 3x3 conv's parts each take one,
    # more than the float forward's conv3x3 launches (its exact-2x up
    # parts are folded into stock transposed convs there)
    assert I8_PER_FORWARD[net]["conv_i8"] > floats["conv3x3"]
    ks = {key[4:7] for key in got["conv_i8"]}
    if net == "ilsvrc/rnmg":
        assert floats == PER_FORWARD
        # the stems: 7x7/2 on 3-channel images, K = 147
        assert ks == {(3, 1, 1), (7, 2, 3)}
        assert {key[2] for key in got["conv_i8"] if key[4] == 7} == {3}
    if net == "mnist-cluttered/unmg":  # its 1x1 heads, Co = 10
        assert (1, 1, 0) in ks and {key[3] for key in got["conv_i8"] if key[4] == 1} == {10}


def _quantized(model):
    return [m for m in model.modules() if getattr(m, "quantized", False)]


def test_server_int8_serves_and_holds_the_two_orders():
    """Server(int8=True) folds, then quantizes, then calibrates
    (tools/export_model.py's order); the run loop quantizes the unfolded
    net (the JAX Session's). With the same frozen scales:
    quantize-then-fold serves what the unfolded quantized net serves
    within JAX's bound for that pair (tests/test_fold_bn.py: 1e-4, here
    of the log-probs' scale: w8 is the same, only ``scale * a`` against
    the BN's affine rounds apart); the server's fold-then-quantize rounds
    some weights to the other int8 value, so it is held to 1% of the
    scale and the same top-1 (measured: 8e-4 of it)."""
    opt = NetOpts(netType="cifar/nmg")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal((4, 32, 32, 3),
                                                                  dtype=np.float32))
    server = Server(opt, device="cpu", compute_dtype=torch.float32, int8=True, int8_calib=2)
    convs = _quantized(server.model)
    assert convs and all(m.sx is not None and m.w8.dtype == torch.int8 for m in convs)
    got = server.predict(x.numpy())
    assert got.shape == (4, 100) and bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.exp().sum(-1), torch.ones(4), rtol=0, atol=1e-5)

    def run_loop_order():
        gen = torch.Generator().manual_seed(0)
        model = create_model(opt, generator=gen)
        calibrate_batchnorm(model, gen, (32, 32, 3))  # the server's weights
        quantize_model(model)
        for m, served in zip(_quantized(model), convs, strict=True):
            m.sx = served.sx.clone()
        return model

    with torch.inference_mode():
        unfolded = run_loop_order()(x)
        then_folded = fold_batchnorm(run_loop_order())(x)
    scale = unfolded.abs().max().item()
    assert (then_folded - unfolded).abs().max().item() <= 1e-4 * scale
    assert (got - unfolded).abs().max().item() <= 1e-2 * scale
    assert torch.equal(got.argmax(-1), unfolded.argmax(-1))
    # bf16 serving: images go in as f32, the outputs stay f32 log-probs
    bf16 = Server(opt, device="cpu", int8=True, int8_calib=1).predict(x.numpy())
    assert bf16.dtype == torch.float32 and bool(torch.isfinite(bf16).all())


def test_serve_cli_int8(capsys):
    serve.main(["--random", "--net", "cifar/nmg", "--device", "cpu", "--batches", "2",
                "--int8", "--int8Calib", "1"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["dtype"] == "int8-static" and line["out_shape"] == [2, 100] and line["finite"]


@pytest.mark.parametrize("i,bs,size", [(i, bs, size) for i in range(6)
                                       for bs, size in ((4, 10), (32, 10), (7, 23), (8, 8))])
def test_calib_window_equals_jax(i, bs, size):
    assert standard.calib_window(i, bs, size) == jax_standard.calib_window(i, bs, size)


NMG = ["-netType", "cifar/nmg", "-dataset", "cifar100-whitened", "-data", "synthetic",
       "-synthSize", "32", "-batchSize", "8", "-imageSize", "36", "-imageCrop", "32",
       "-nDonkeys", "0", "-nEpochs", "1"]
LOSS = re.compile(r"\[TESTING\].*avg\.loss:([0-9.]+)")


@pytest.mark.parametrize("calib", [0, 2])
def test_session_int8_test_pass_matches_jax(tmp_path, capsys, calib):
    """-test -int8 [-int8Calib 2] from one checkpoint through the JAX
    Session and the port's: the same "==> int8:" lines, the same
    calibration batches (train split, the seeded generator), and test
    losses within 1e-4 (the int8 forwards agree as the bridge test
    holds them; the lines print 5 decimals)."""
    model = create_model(NetOpts(netType="cifar/nmg"), generator=torch.Generator().manual_seed(0))
    p, s = export_jax_tree(model)
    start = str(tmp_path / "start.ckpt")
    write_checkpoint(start, p, s, None, epoch=0,
                     meta={"netType": "cifar/nmg", "dataset": "cifar100-whitened",
                           "dtype": "float32"})
    argv = NMG + ["-retrain", start, "-test", "-int8"] + (["-int8Calib", str(calib)] * bool(calib))
    ref_opt = jax_opts.parse(argv + ["-cache", str(tmp_path / "jax")])
    got_opt = opts.parse(argv + ["-cache", str(tmp_path / "port"), "-device", "cpu"])
    _, ref_out = _run(jax_standard, ref_opt, capsys)
    sess, got_out = _run(standard, got_opt, capsys)
    assert sess.cast_dtype is None  # no host cast under -int8
    lines = [ln for ln in got_out.splitlines() if ln.startswith("==> int8:")]
    assert lines == [ln for ln in ref_out.splitlines() if ln.startswith("==> int8:")]
    assert ("calibrated over 2 batches" in got_out) == bool(calib)
    np.testing.assert_allclose(float(LOSS.search(got_out).group(1)),
                               float(LOSS.search(ref_out).group(1)), rtol=1e-4)
    convs = [m for m in sess.model.modules() if getattr(m, "quantized", False)]
    assert convs and all((m.sx is not None) == bool(calib) for m in convs)


def test_session_calibration_batches_are_the_jax_ones(tmp_path):
    """The calibration batches (the train split's sample with the seeded
    generator) equal what the JAX Session draws, bit for bit."""
    from mgtpu.data import get_loaders as jax_loaders
    from mgtpu_torch.data import get_loaders

    opt = opts.parse(NMG + ["-test", "-int8", "-int8Calib", "3", "-cache", str(tmp_path)])
    got = standard.calibration_batches(get_loaders(opt), opt)
    src = jax_loaders(jax_opts.parse(NMG + ["-test", "-cache", str(tmp_path)]))["train"]
    rng = np.random.default_rng(opt.manualSeed * 7919 + 13)
    ref = [src.sample(opt.batchSize, rng)[0] for _ in range(3)]
    assert len(got) == 3 and all(np.array_equal(a, b) for a, b in zip(got, ref))
