"""`python -m mgtpu_torch.main ... -device cpu` end to end, in
subprocesses, as tests/test_cli_integration.py drives the JAX CLI:
train and test a net, reload its checkpoint through the ``mnist-test``
harness, resume a run, and fall back loudly where a dataset has no eval
split. Comparisons are exact: the same computation on the same CPU."""

import glob
import json
import os
import re
import subprocess
import sys

import h5py
import numpy as np
import pytest

from mgtpu_torch.utils import h5
from mgtpu_torch.utils.checkpoint import load_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG = ["-dataset", "mnist-seg", "-data", "synthetic", "-synthSize", "32", "-batchSize", "8",
       "-device", "cpu"]
METRICS = re.compile(r"avg\.loss:([0-9.]+).*avg\.meanIU:([0-9.]+)")


def _main(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    r = subprocess.run([sys.executable, "-m", "mgtpu_torch.main", *args], capture_output=True,
                       text=True, timeout=timeout, env=env, cwd=REPO)
    assert r.returncode == 0, (r.stdout[-1500:], r.stderr[-1500:])
    return r.stdout


def _one(tmp_path, pattern):
    found = glob.glob(str(tmp_path / "**" / pattern), recursive=True)
    assert len(found) == 1, found
    return found[0]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """unmg on mnist-seg, one epoch of two iterations (the second traced
    by -profile), then the test pass."""
    tmp = tmp_path_factory.mktemp("unmg")
    out = _main("-netType", "mnist-cluttered/unmg", *SEG, "-cache", str(tmp), "-nEpochs", "1",
                "-epochSize", "2", "-profile", str(tmp / "trace"), "-train", "-test")
    return tmp, out


def test_train_and_test_write_the_run_dir(trained):
    tmp, out = trained
    assert re.search(r"Epoch: \[1\]\[2/2\]\tRun:[0-9.]+s lr:1\.000e-01 Data:[0-9.]+s "
                     r"loss:[0-9.]+", out), out[-800:]
    assert METRICS.search(out), out[-800:]
    run = os.path.dirname(_one(tmp, "model_1.ckpt"))
    for log in ("train.log", "test.log", "opts.json"):
        assert os.path.exists(os.path.join(run, log)), log
    with open(os.path.join(run, "test.log")) as f:
        assert f.readline().split() == ["avg.loss", "(test", "set)", "avg.meanIU", "(test", "set)"]
    assert f"profiler trace -> {tmp / 'trace'}" in out
    with open(tmp / "trace" / "trace.json") as f:
        assert "traceEvents" in json.load(f)
    assert load_checkpoint(_one(tmp, "model_1.ckpt"))["meta"] == {
        "netType": "mnist-cluttered/unmg", "dataset": "mnist-seg", "dtype": "float32"}


def test_profile_writes_the_spans_on_the_trace_clock(trained):
    """-profile's spans.json: the program's spans of the profiled
    iteration (the multigrid layers and hand-kernel entries of the
    training forward), on the clock of the trace.json beside it."""
    tmp, _ = trained
    with open(tmp / "trace" / "trace.json") as f:
        prof = json.load(f)
    with open(tmp / "trace" / "spans.json") as f:
        spans = json.load(f)
    assert spans["baseTimeNanoseconds"] == prof["baseTimeNanoseconds"]
    events = [e for e in spans["traceEvents"] if e["ph"] == "X"]
    names = {e["name"].split(".")[0] for e in events}
    assert {"MgConv", "conv3x3", "maxpool2"} <= names
    ops = [e for e in prof["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    lo, hi = min(e["ts"] for e in ops), max(e["ts"] + e["dur"] for e in ops)
    assert all(lo - 1e6 <= e["ts"] and e["ts"] + e["dur"] <= hi + 1e6 for e in events)


def test_harness_reproduces_the_test_metrics(trained, tmp_path):
    """mnist-test -retrain gives the training run's test metrics exactly
    and dumps its predictions NHWC, read the same through h5py and the
    port's HDF5 layer."""
    tmp, out = trained
    out2 = _main("-netType", "mnist-cluttered/mnist-test", *SEG, "-cache", str(tmp_path),
                 "-nEpochs", "1", "-retrain", _one(tmp, "model_1.ckpt"), "-test")
    assert "=> resumed from" in out2
    assert METRICS.search(out2).groups() == METRICS.search(out).groups()
    with h5py.File(_one(tmp_path, "testOutput_1.h5"), "r") as f:
        pred = np.asarray(f["prediction"])
    assert pred.shape == (8, 64, 64, 10)  # synthSize 32 // 4 test samples, NHWC
    assert pred.dtype == np.float32 and 0.0 <= pred.min() and pred.max() <= 1.0
    with h5.File(_one(tmp_path, "testOutput_1.h5"), "r") as f:  # the port's own reader
        assert f.keys() == ["prediction"]
        again = np.asarray(f["prediction"])
    assert again.dtype == pred.dtype and again.tobytes() == pred.tobytes()


def test_resume_equals_the_straight_run(tmp_path):
    """Two epochs straight == one epoch, -stopAfter, and a -retrain
    -epochNumber 2 resume: the same epoch-2 checkpoint, bit for bit
    (momentum and BN stats carried)."""
    common = ["-netType", "mnist-cluttered/unet", "-dataset", "mnist-sca", "-data", "synthetic",
              "-synthSize", "16", "-batchSize", "4", "-device", "cpu", "-nEpochs", "2",
              "-epochSize", "2", "-train"]
    _main(*common, "-cache", str(tmp_path / "straight"))
    out = _main(*common, "-cache", str(tmp_path / "chunks"), "-stopAfter", "1")
    assert "stopping after epoch 1 (-stopAfter)" in out and "Epoch: [2]" not in out
    out = _main(*common, "-cache", str(tmp_path / "chunks"), "-epochNumber", "2",
                "-retrain", _one(tmp_path / "chunks", "model_1.ckpt"))
    assert "Epoch: [2]" in out and "Epoch: [1]" not in out
    a = load_checkpoint(_one(tmp_path / "straight", "model_2.ckpt"))
    b = load_checkpoint(_one(tmp_path / "chunks", "model_2.ckpt"))
    assert a["epoch"] == b["epoch"] == 2

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [tree.numpy()]

    for key in ("params", "stats", "opt_state"):
        for x, y in zip(leaves(a[key]), leaves(b[key]), strict=True):
            np.testing.assert_array_equal(x, y)


def test_eval_without_an_eval_split_warns(tmp_path):
    out = _main("-netType", "cifar/nmg", "-dataset", "cifar100-whitened", "-data", "synthetic",
                "-synthSize", "64", "-nLayer", "1", "-batchSize", "8", "-imageSize", "36",
                "-imageCrop", "32", "-cache", str(tmp_path), "-nEpochs", "1", "-epochSize",
                "2", "-device", "cpu", "-train", "-eval")
    assert "WARNING: -eval requested" in out
    assert re.search(r"\[EVALUATION\].*avg\.loss:[0-9.]+", out), out[-800:]
