"""The port's run loop (`mgtpu_torch/pipelines/standard.py`) against the
JAX package's, in one process, on the cheapest net
(``mnist-cluttered/unet`` on mnist-sca, 64x64x1 images, its widths cut
to {6, 8, 10, 12} as tests/test_torch_seg_train.py cuts them): a JAX
Session and a port Session, both resumed (``-retrain``) from one
checkpoint, train two iterations and test. The per-iteration losses,
the epoch means and the logs agree to rtol 1e-4 (the step tests' bound;
the lines print 5 decimals), the two epoch-end checkpoints' updates to a
relative L2 of 1e-4, and the JAX ``mnist-test`` harness, run on the
checkpoint the port wrote, reproduces the port's test loss (rtol 1e-4)
and meanIU (1e-3 absolute: a pixel's probability near 0.5 may round to
the other side of the threshold)."""

import glob
import os
import re

import h5py
import jax
import numpy as np
import pytest
import torch

import mgtpu.models.mnist_cluttered.unet as junet
import mgtpu_torch.models.mnist_cluttered.unet as tunet
from mgtpu.pipelines import standard as jax_standard
from mgtpu.utils import opts as jax_opts
from mgtpu.utils.checkpoint import join_pending_saves as jax_join
from mgtpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from mgtpu_torch.models import create_model
from mgtpu_torch.models.base import NetOpts
from mgtpu_torch.pipelines import standard
from mgtpu_torch.utils import h5, opts
from mgtpu_torch.utils.bridge import export_jax_tree
from mgtpu_torch.utils.checkpoint import join_pending_saves, write_checkpoint
from test_torch_cifar_models import few_torch_threads  # noqa: F401 (autouse fixture)
from test_torch_cifar_train import _jitter

NET = "mnist-cluttered/unet"
ARGV = ["-netType", NET, "-dataset", "mnist-sca", "-data", "synthetic", "-synthSize", "16",
        "-batchSize", "4", "-nDonkeys", "0", "-nEpochs", "1", "-epochSize", "2"]
ITER = re.compile(r"Epoch: \[1\]\[(\d+)/2\]\tRun:\S+ lr:\S+ Data:\S+ loss:([0-9.]+)")


def _flat(tree):
    if isinstance(tree, dict):
        return np.concatenate([_flat(tree[k]) for k in sorted(tree)] or [np.zeros(0)])
    return np.asarray(tree.numpy() if isinstance(tree, torch.Tensor) else tree,
                      np.float64).ravel()


def _log(save, name):
    with open(os.path.join(save, f"{name}.log")) as f:
        lines = f.read().splitlines()
    return lines[0].split("\t"), [float(v) for v in lines[1].split("\t")]


def _run(package, opt, capsys):
    """Build the package's Session from ``opt``, run it, and return the
    Session and its output."""
    os.makedirs(opt.save)
    sess = package.Session(opt)
    try:
        package.run(sess)
    finally:
        sess.pool.shutdown()
    (jax_join if package is jax_standard else join_pending_saves)()
    return sess, capsys.readouterr().out


@pytest.fixture
def narrow_unet(monkeypatch):
    for mod in (junet, tunet):
        monkeypatch.setattr(mod, "BLOCKS", [6, 8, 10, 12])


def test_port_session_trains_and_tests_as_the_jax_session(tmp_path, capsys, narrow_unet):
    model = create_model(NetOpts(netType=NET, dataset="mnist-sca"),
                         generator=torch.Generator().manual_seed(0))
    p, s = export_jax_tree(model)
    rng = np.random.default_rng(1)
    _jitter(p, s, rng)
    m = jax.tree.map(lambda a: rng.standard_normal(a.shape, dtype=np.float32) * 0.01, p)
    start = str(tmp_path / "start.ckpt")
    write_checkpoint(start, p, s, {"m": m}, epoch=0,
                     meta={"netType": NET, "dataset": "mnist-sca", "dtype": "float32"})

    argv = ARGV + ["-retrain", start, "-train", "-test"]
    ref_opt = jax_opts.parse(argv + ["-cache", str(tmp_path / "jax")])
    got_opt = opts.parse(argv + ["-cache", str(tmp_path / "port"), "-device", "cpu"])
    _, ref_out = _run(jax_standard, ref_opt, capsys)
    _, got_out = _run(standard, got_opt, capsys)

    ref_iters, got_iters = ITER.findall(ref_out), ITER.findall(got_out)
    assert [i for i, _ in got_iters] == [i for i, _ in ref_iters] == ["1", "2"]
    np.testing.assert_allclose([float(v) for _, v in got_iters],
                               [float(v) for _, v in ref_iters], rtol=1e-4)
    for name in ("train", "test"):
        ref_head, ref_row = _log(ref_opt.save, name)
        got_head, got_row = _log(got_opt.save, name)
        assert got_head == ref_head
        np.testing.assert_allclose(got_row, ref_row, rtol=1e-4)

    ref_ck = jax_load_checkpoint(os.path.join(ref_opt.save, "model_1.ckpt"))
    got_path = os.path.join(got_opt.save, "model_1.ckpt")
    got_ck = jax_load_checkpoint(got_path)
    assert got_ck["epoch"] == ref_ck["epoch"] == 1 and got_ck["meta"] == ref_ck["meta"]
    for key, before in (("params", p), ("stats", s), ("opt_state", {"m": m})):
        ref_upd = _flat(ref_ck[key]) - _flat(before)
        got_upd = _flat(got_ck[key]) - _flat(before)
        rel = np.linalg.norm(got_upd - ref_upd) / np.linalg.norm(ref_upd)
        assert rel <= 1e-4, (key, rel)

    # the JAX harness on the port's checkpoint gives the port's test metrics
    harness = jax_opts.parse(["-netType", "mnist-cluttered/mnist-test"] + ARGV[2:]
                             + ["-retrain", got_path, "-test", "-cache", str(tmp_path / "h")])
    _, out = _run(jax_standard, harness, capsys)
    head, row = _log(harness.save, "test")
    want = dict(zip(*_log(got_opt.save, "test")))
    got = dict(zip(head, row))
    np.testing.assert_allclose(got["avg.loss (test set)"], want["avg.loss (test set)"], rtol=1e-4)
    assert "avg.meanIU (test set)" not in want  # unet's own test metrics: the loss
    port_harness = opts.parse(["-netType", "mnist-cluttered/mnist-test"] + ARGV[2:]
                              + ["-retrain", got_path, "-test", "-cache", str(tmp_path / "ph"),
                                 "-device", "cpu"])
    _run(standard, port_harness, capsys)
    port = dict(zip(*_log(port_harness.save, "test")))
    np.testing.assert_allclose(got["avg.loss (test set)"], port["avg.loss (test set)"],
                               rtol=1e-4)
    assert abs(got["avg.meanIU (test set)"] - port["avg.meanIU (test set)"]) <= 1e-3
    assert len(glob.glob(os.path.join(harness.save, "testOutput_1.h5"))) == 1
    # the two harnesses' dumps (the JAX one written by h5py, the port's by
    # mgtpu_torch.utils.h5), both read through the port's layer: the same
    # checkpoint's predictions, within the losses' rtol
    with h5.File(os.path.join(harness.save, "testOutput_1.h5"), "r") as f:
        ref = np.asarray(f["prediction"])
    with h5py.File(os.path.join(harness.save, "testOutput_1.h5"), "r") as f:
        assert np.asarray(f["prediction"]).tobytes() == ref.tobytes()
    with h5.File(os.path.join(port_harness.save, "testOutput_1.h5"), "r") as f:
        assert f.keys() == ["prediction"]
        pred = np.asarray(f["prediction"])
    assert pred.shape == ref.shape == (8, 64, 64, 1) and pred.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(pred, ref, rtol=1e-4, atol=1e-6)


def test_seg_counts_are_the_jax_counts():
    """seg_mean_iu_mean_acc: the per-class (tp, fp, fn) sums of
    mgtpu.utils.metrics, exactly (sums of 0/1 values in f32)."""
    from mgtpu.utils.metrics import seg_mean_iu_mean_acc as jax_counts
    from mgtpu_torch.utils.metrics import seg_mean_iu_mean_acc

    rng = np.random.default_rng(3)
    probs = rng.random((4, 16, 16, 10), dtype=np.float32)
    probs[0, 0, 0] = 0.5  # on the threshold
    targets = (rng.random((4, 16, 16, 10)) > 0.7).astype(np.float32)
    got = seg_mean_iu_mean_acc(torch.from_numpy(probs), torch.from_numpy(targets))
    ref = jax_counts(probs, targets)
    for g, r in zip(got, ref, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
