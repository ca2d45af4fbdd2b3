"""The benchmark's reference and work arithmetic, held to the port's
plain CPU path at full widths and to the repo's recorded numbers."""

import hashlib
import json

import numpy as np
import pytest
import torch

from portbench.common import ckpt, work
from portbench.common.harness import norm_gap
from portbench.reference import mgnet, saliency

SEED = 2 ** 33 + 17


def drawn(net, shape, seed=SEED, bn_images=2):
    g = torch.Generator().manual_seed(seed)
    params, stats = mgnet.init_trees(net, g, "cpu")
    mgnet.calibrate_bn(net, params, stats, torch.randn((bn_images, *shape), generator=g))
    return params, stats, g


def test_sizes_match_the_recorded_counts():
    rmg, pn = mgnet.rnmg(34, 1000), mgnet.pnmg_mnist(1, 1)
    assert mgnet.param_count(rmg) == 32_899_176
    assert mgnet.macs_per_image(rmg, (224, 224, 3)) == 5_760_277_760
    assert mgnet.param_count(pn) == 600_507
    assert mgnet.macs_per_image(pn, (64, 64, 1)) == 1_585_304_064


@pytest.mark.parametrize("config, mode, digest", [
    ("rmg34", "eval", "75fcd087636f976e8ff612f001d65e36cd35a25667a0a5fcaa53503235ea1adf"),
    ("rmg34", "train", "75fcd087636f976e8ff612f001d65e36cd35a25667a0a5fcaa53503235ea1adf"),
    ("pnmg-mnist", "eval", "04dcadded75096aa3296f40f7b84976c7d5806adb112fb68ce8c2acc61de9523"),
    ("pnmg-mnist", "train", "04dcadded75096aa3296f40f7b84976c7d5806adb112fb68ce8c2acc61de9523"),
])
def test_conv_shapes_match_the_recorded_list(config, mode, digest):
    """Every conv of a configuration's forward, entry by entry, as the
    reference listed it before nets and layer kinds could be added by
    modules: the sha256 of the list's JSON (75 convs for rmg34, 32 for
    pnmg-mnist)."""
    from portbench import run

    cfg = run.load_config(config)
    convs = mgnet.conv_shapes(mgnet.build(cfg), tuple(cfg["image_shape"]), mode)
    assert hashlib.sha256(json.dumps(convs).encode()).hexdigest() == digest


def test_work_matches_the_recorded_bound():
    """R-MG-34's conv3x3_bn_relu_in launches of a training step at batch
    128: 455.0 GFLOP, 822.9 MB, 0.4734 ms (the port's chip checks)."""
    convs = mgnet.conv_shapes(mgnet.rnmg(34, 1000), (224, 224, 3), "train")
    launches = work.conv3x3_launches(convs, train=True)
    assert sum(k == "conv3x3" for k, _ in launches) == 76
    prologue = [s for k, s in launches if k == "conv3x3_bn_relu_in"]
    assert len(prologue) == 36
    flops = nbytes = secs = 0
    for s in prologue:
        f, b = work.kernel_work("conv3x3_bn_relu_in", s, 128)
        flops, nbytes, secs = flops + f, nbytes + b, secs + work.bound(f, b, work.PEAK["bf16"])[0]
    assert round(flops / 1e9, 1) == 455.0
    assert round(nbytes / 1e6, 1) == 822.9
    assert round(secs * 1e3, 4) == 0.4734
    assert len(work.i8_keys(mgnet.conv_shapes(mgnet.rnmg(34, 1000), (224, 224, 3)))) == 155


@pytest.mark.parametrize("depth", [34])
def test_rmg_eval_matches_the_port(tmp_path, depth):
    from mgtpu_torch.models.base import NetOpts
    from mgtpu_torch.serve import Server

    net = mgnet.rnmg(depth, 1000)
    params, stats, g = drawn(net, (224, 224, 3))
    x = torch.randn((2, 224, 224, 3), generator=g)
    path = tmp_path / "w.ckpt"
    ckpt.write(path, params, stats, {"netType": "ilsvrc/rnmg", "depth": depth})
    server = Server(NetOpts(netType="ilsvrc/rnmg", depth=depth), ckpt=str(path), device="cpu",
                    compute_dtype=torch.float32)
    got = server.predict(x)
    with torch.no_grad():
        want = mgnet.forward(net, params, stats, x, "eval")
    assert torch.allclose(got, want, atol=2e-4, rtol=0), float((got - want).abs().max())


def test_rmg_train_step_matches_the_port(root):
    """One f32 step of the train driver's program against the reference's:
    the loss, every leaf's first-gradient norm, change and running stats.
    (One step: at 2 images a step and lr 0.1 the loss leaps from 10 to
    over 200 in the second, where round-off alone parts the two.)"""
    from portbench import run

    h, res = run.execute("small-train-f32", SEED, 0.2, False, device="cpu", root=root)
    assert h.correct(), h.checks
    values = dict((n, v) for n, v, _ in h.checks)
    assert values["loss_gap"] < 1e-5
    # the worst leaf of 2 images: BatchNorm's backward over 98 values a
    # channel on the 7x7 grids cancels to a thousandth; a wrong leaf reads 1
    for name in ("grad_gap_median", "change_gap_median", "stats_gap_median"):
        assert values[name] < 1e-2, (name, values[name])


def test_pnmg_matches_the_saliency_harness(tmp_path):
    from mgtpu_torch.models import create_model
    from mgtpu_torch.models.base import NetOpts

    net = mgnet.pnmg_mnist(1, 1)
    params, stats, g = drawn(net, (64, 64, 1), bn_images=16)
    x = torch.randn((3, 64, 64, 1), generator=g)
    path = tmp_path / "w.ckpt"
    ckpt.write(path, params, stats, {"netType": "mnist-cluttered/pnmg.mnist", "nLayer": 1,
                                     "dataset": "mnist-aff"})
    model = create_model(NetOpts(netType="mnist-cluttered/mnist-saliency",
                                 trainedNet=str(path)), device="cpu").eval()
    with torch.no_grad():
        got = model(x)
        want = mgnet.forward(net, params, stats, x, "eval")
    assert torch.allclose(got, want, atol=1e-5, rtol=0), float((got - want).abs().max())


def test_probe_copy_matches_the_port():
    from mgtpu_torch.data.mnist import occlusion_masks
    from mgtpu_torch.data.transforms import occlusion_noise
    from mgtpu_torch.pipelines.saliency import interest_points, saliency_maps

    mask = saliency.occlusion_masks()
    assert np.array_equal(mask, occlusion_masks())
    assert np.array_equal(saliency.occlusion_noise(mask), occlusion_noise(mask))
    g = torch.Generator().manual_seed(SEED)
    small = torch.from_numpy(mask[::40].copy())
    outs = torch.sigmoid(3 * torch.randn((3, 1 + small.shape[0], 64, 64, 1), generator=g))
    v1, p1 = saliency.interest_points(outs[:, 0])
    v2, p2 = interest_points(outs[:, 0])
    assert torch.equal(v1, v2) and torch.equal(p1, p2)
    assert torch.equal(saliency.saliency_maps(outs, p1, small), saliency_maps(outs, p2, small))


def test_norm_gap_takes_the_worst_leaf():
    ref = {"a": 1.0, "b": 2.0, "c": 1e-6}
    assert norm_gap({"a": 1.1, "b": 2.0, "c": 1.0}, ref, ["a", "b"]) == (pytest.approx(0.1), "a")
    assert norm_gap({"a": 1.0, "b": 2.0, "c": 0.5}, ref)[0] == pytest.approx(0.5, rel=1e-5)
