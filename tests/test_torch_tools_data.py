"""The port's data and file tools (`mgtpu_torch/tools/`) against the JAX
package's (`tools/*.py`) on the same small inputs, made from a seed with
numpy: each ported tool's npz arrays and PNG pixels bit for bit, and its
printed lines, equal to its root counterpart's; the port's soak chain of
two resuming ``mgtpu_torch.main`` processes against a straight run; and
`mgtpu_torch.ops.resample.global_avgpool` against the JAX one."""

import gzip
import os
import pickle
import struct
import subprocess
import sys

import h5py
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from mgtpu.ops.resample import global_avgpool as jax_global_avgpool
from mgtpu_torch.ops import global_avgpool
from mgtpu_torch.tools.soak_chain import recipe_argv
from mgtpu_torch.utils import h5
from mgtpu_torch.utils.checkpoint import load_checkpoint
from test_t7 import _fake_cifar_blob

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")


ENV = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")


def _run(cmd, cwd, timeout=300):
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=ENV, cwd=cwd)
    assert r.returncode == 0, (cmd, r.stdout[-1500:], r.stderr[-2000:])
    return r.stdout


def _both(tool, args, tmp_path):
    """The root tool and the port's side by side, each in a directory of
    its own with the same relative arguments: ({"root", "port"}: (stdout,
    directory))."""
    procs = {}
    for side, cmd in (("root", [sys.executable, os.path.join(TOOLS, f"{tool}.py")]),
                      ("port", [sys.executable, "-m", f"mgtpu_torch.tools.{tool}"])):
        cwd = tmp_path / side
        cwd.mkdir(exist_ok=True)
        procs[side] = (subprocess.Popen(cmd + args, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True, env=ENV, cwd=cwd), cwd)
    out = {}
    for side, (p, cwd) in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, (side, tool, stdout[-1500:], stderr[-2000:])
        out[side] = (stdout, cwd)
    return out


def _same_npz(a, b):
    za, zb = np.load(a), np.load(b)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        assert za[k].dtype == zb[k].dtype and za[k].shape == zb[k].shape, k
        np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def _same_png(a, b):
    from PIL import Image

    with Image.open(a) as ia, Image.open(b) as ib:
        assert ia.mode == ib.mode and ia.size == ib.size
        np.testing.assert_array_equal(np.asarray(ia), np.asarray(ib))


def _write_idx(path, arr, gz):
    arr = np.asarray(arr, np.uint8)
    data = struct.pack(f">i{arr.ndim}i", 0x800 + arr.ndim, *arr.shape) + arr.tobytes()
    with (gzip.open if gz else open)(path, "wb") as f:
        f.write(data)


@pytest.fixture(scope="module")
def mnist(tmp_path_factory):
    """IDX files of random digits (train images gzipped, the rest raw),
    60 train and 20 test, with digit-ish blobs so the clutter generator
    finds sprites; a 50k/10k split leaves the valid split empty."""
    rng = np.random.default_rng(0)
    src = tmp_path_factory.mktemp("mnist_raw")

    def blobs(n):
        imgs = rng.integers(0, 40, (n, 28, 28), np.uint8)
        for i in range(n):
            y, x = rng.integers(4, 18, 2)
            imgs[i, y:y + 8, x:x + 6] = 255
        return imgs

    _write_idx(src / "train-images-idx3-ubyte.gz", blobs(60), gz=True)
    _write_idx(src / "train-labels-idx1-ubyte", np.arange(60) % 10, gz=False)
    _write_idx(src / "t10k-images-idx3-ubyte", blobs(20), gz=False)
    _write_idx(src / "t10k-labels-idx1-ubyte.gz", np.arange(20) % 10, gz=True)
    return src


def test_download_mnist(mnist, tmp_path):
    out = _both("download_mnist", ["--src", str(mnist), "--out", "mnist.npz"], tmp_path)
    assert out["port"][0] == out["root"][0] and out["port"][0].startswith("wrote mnist.npz")
    _same_npz(out["root"][1] / "mnist.npz", out["port"][1] / "mnist.npz")


@pytest.mark.parametrize("task", ["segmentation", "spatial_transform"])
def test_generate_mnist_cluttered(task, tmp_path):
    """From an mnist.npz of blob digits (40 train, 20 valid, 20 test):
    segmentation's three splits, spatial_transform's train split merged
    with its valid split."""
    rng = np.random.default_rng(1)

    def blobs(n):
        imgs = np.zeros((n, 28, 28), np.uint8)
        for i in range(n):
            y, x = rng.integers(6, 18, 2)
            imgs[i, y:y + 8, x:x + 6] = 255
        return imgs

    np.savez(tmp_path / "mnist.npz", train_images=blobs(40), train_labels=np.arange(40) % 10,
             valid_images=blobs(20), valid_labels=np.arange(20) % 10,
             test_images=blobs(20), test_labels=np.arange(20) % 10)
    scale = "0.003" if task == "segmentation" else "0.0005"
    out = _both("generate_mnist_cluttered", ["--mnist", str(tmp_path / "mnist.npz"), "--task",
                                             task, "--scale", scale, "--out-dir", "data"],
                tmp_path)
    assert out["port"][0] == out["root"][0]
    name = f"data/mnist_{task}.npz"
    _same_npz(out["root"][1] / name, out["port"][1] / name)


@pytest.fixture(scope="module")
def cifar(tmp_path_factory):
    """cifar-100-python pickles of random images: 120 train, 40 test."""
    root = tmp_path_factory.mktemp("cifar")
    d = root / "cifar-100-python"
    d.mkdir()
    rng = np.random.default_rng(2)
    for split, n in (("train", 120), ("test", 40)):
        with open(d / split, "wb") as f:
            pickle.dump({"data": rng.integers(0, 256, (n, 3072), np.uint8),
                         "fine_labels": (np.arange(n) % 100).tolist()}, f)
    return root


@pytest.mark.parametrize("whiten", [False, True], ids=["plain", "whiten"])
def test_ingest_cifar(cifar, whiten, tmp_path):
    args = ["--root", str(cifar), "--dataset", "cifar100"] + (["--whiten"] if whiten else [])
    out = _both("ingest_cifar", args, tmp_path)
    assert out["port"][0] == out["root"][0]
    name = "cifar100_whitened.npz" if whiten else "cifar100.npz"
    _same_npz(out["root"][1] / name, out["port"][1] / name)


def test_ingest_cifar_t7(tmp_path):
    blob = tmp_path / "cifar100_whitened.t7"
    _fake_cifar_blob(str(blob))
    out = _both("ingest_cifar", ["--t7", str(blob), "--out", "out.npz"], tmp_path)
    assert out["port"][0] == out["root"][0]
    _same_npz(out["root"][1] / "out.npz", out["port"][1] / "out.npz")


def _seg_dump(tmp_path, writer):
    """A test pass's dump of 6 NHWC predictions (written by ``writer``)
    and the task's npz: inputs, and targets with one or two classes."""
    rng = np.random.default_rng(4)
    n, hw, c = 6, 16, 10
    inputs = rng.random((n, hw, hw, 1), dtype=np.float32)
    targets = np.zeros((n, hw, hw, c), np.float32)
    for i in range(n):
        for k in rng.choice(c, 1 + i % 2, replace=False):
            y, x = rng.integers(0, hw - 6, 2)
            targets[i, y:y + 6, x:x + 6, k] = 1.0
    pred = np.clip(targets * 0.7 + rng.random(targets.shape, dtype=np.float32) * 0.4, 0, 1)
    np.savez(tmp_path / "task.npz", test_inputs=inputs, test_targets=targets)
    path = tmp_path / "testOutput_1.h5"
    with (h5py.File if writer == "h5py" else h5.File)(path, "w") as f:
        f.create_dataset("prediction", data=pred)
    return path


@pytest.mark.parametrize("writer", ["h5py", "port"])
def test_seg_metrics(writer, tmp_path):
    dump = _seg_dump(tmp_path, writer)
    for extra in ([], ["--threshold", "0.6", "--layout", "nhwc"]):
        out = _both("seg_metrics", [str(dump), "--targets", str(tmp_path / "task.npz"), *extra],
                    tmp_path)
        assert out["port"][0] == out["root"][0] and out["port"][0].startswith("mean IU: ")


@pytest.mark.parametrize("writer", ["h5py", "port"])
def test_render_predictions(writer, tmp_path):
    dump = _seg_dump(tmp_path, writer)
    for extra in ([], ["--mode", "gray", "--ids", "1", "4", "--threshold", "0.5"]):
        out = _both("render_predictions", [str(dump), "--targets", str(tmp_path / "task.npz"),
                                           "--out", "viz", *extra], tmp_path)
        assert out["port"][0] == out["root"][0]
        for png in os.listdir(out["root"][1] / "viz"):
            _same_png(out["root"][1] / "viz" / png, out["port"][1] / "viz" / png)


@pytest.mark.parametrize("writer", ["h5py", "port"])
def test_render_saliency(writer, tmp_path):
    """A -saliencyDumpStack 1 dump's groups, 64x64 as the harness writes
    them: the same renders, pixel for pixel."""
    rng = np.random.default_rng(5)
    path = tmp_path / "testOutput.h5"
    with (h5py.File if writer == "h5py" else h5.File)(path, "w") as f:
        for i in (3, 30, 31):
            points = np.zeros((7, 64, 64, 1), np.float32)
            for j in range(7):
                y, x = rng.integers(1, 62, 2)
                points[j, y - 1:y + 2, x - 1:x + 2] = 1
            f.create_dataset(f"id{i:05d}/points", data=points)
            f.create_dataset(f"id{i:05d}/saliency",
                             data=rng.random((7, 64, 64, 1), dtype=np.float32) ** 4)
            f.create_dataset(f"id{i:05d}/input",
                             data=rng.standard_normal((64, 64, 1), dtype=np.float32))
            f.create_dataset(f"id{i:05d}/output", data=rng.random((5, 64, 64, 1),
                                                                   dtype=np.float32))
    out = _both("render_saliency", ["--h5", str(path), "--out", "viz", "--ids", "30", "31",
                                    "--nq", "5"], tmp_path)
    assert out["port"][0] == out["root"][0]
    pngs = sorted(os.listdir(out["root"][1] / "viz"))
    assert len(pngs) == 20 and sorted(os.listdir(out["port"][1] / "viz")) == pngs
    for png in pngs:
        _same_png(out["root"][1] / "viz" / png, out["port"][1] / "viz" / png)


SOAK_EXTRA = ["-device", "cpu", "-synthSize", "8", "-batchSize", "2", "-epochSize", "1",
              "-nDonkeys", "0"]


def test_soak_chain_equals_the_straight_run(tmp_path):
    """unmg's recipe chained in two one-epoch chunks (the second resuming
    from the first's checkpoint) on the CPU, `-- -device cpu ...`: the
    epoch-2 checkpoint equals a straight two-epoch run's bit for bit
    (params, stats and momentum), as test_torch_cli's resume test holds
    the resume itself."""
    recipe = os.path.join(REPO, "scripts", "mnist-cluttered", "unmg.sh")
    alone = subprocess.Popen(  # beside the chain
        [sys.executable, "-m", "mgtpu_torch.main", *recipe_argv(recipe, env={}), "-nEpochs",
         "2", "-nEpochsSave", "2", "-cache", str(tmp_path / "straight"), *SOAK_EXTRA],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=ENV, cwd=REPO)
    try:
        out = _run([sys.executable, "-m", "mgtpu_torch.tools.soak_chain", recipe, "--cache",
                    str(tmp_path / "chain"), "--epochs", "2", "--chunk", "1", "--",
                    *SOAK_EXTRA], REPO, timeout=600)
    finally:
        log = alone.communicate(timeout=600)[0]
    assert alone.returncode == 0, log[-2000:]
    lines = out.splitlines()
    assert "chunk: epochs 1..1 (resume fresh)" in lines[0]
    assert "chunk: epochs 2..2 (resume model_1.ckpt)" in lines[2]
    assert "chain complete: epoch 2/2" in lines[-1] and len(lines) == 5, out
    chained = list((tmp_path / "chain").rglob("model_2.ckpt"))
    straight = list((tmp_path / "straight").rglob("model_2.ckpt"))
    assert len(chained) == len(straight) == 1
    a, b = load_checkpoint(str(straight[0])), load_checkpoint(str(chained[0]))
    assert a["epoch"] == b["epoch"] == 2

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [tree.numpy()]

    for key in ("params", "stats", "opt_state"):
        for x, y in zip(leaves(a[key]), leaves(b[key]), strict=True):
            np.testing.assert_array_equal(x, y)


def test_recipe_argv_resolves_defaults_as_sh_does(tmp_path):
    recipe = os.path.join(REPO, "scripts", "mnist-cluttered", "unmg.sh")
    argv = recipe_argv(recipe, env={})
    assert argv[:2] == ["-data", "synthetic"] and argv[-2:] == ["-train", "-test"]
    assert recipe_argv(recipe, env={"DATA_PREFIX": "/data"})[:2] == ["-data", "/data"]
    assert recipe_argv(recipe, env={"DATA_PREFIX": ""})[:2] == ["-data", "synthetic"]
    (tmp_path / "other.sh").write_text("#!/bin/sh\npython -m other.main -x\n")
    with pytest.raises(ValueError, match="no `python -m mgtpu.main`"):
        recipe_argv(tmp_path / "other.sh")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_global_avgpool_matches_jax(dtype):
    x = np.random.default_rng(6).standard_normal((3, 7, 5, 4), dtype=np.float32)
    if dtype == "bfloat16":
        x = x.astype(ml_dtypes.bfloat16)
    ref = np.asarray(jax_global_avgpool(jnp.asarray(x)))
    got = global_avgpool(torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16)
                         if dtype == "bfloat16" else torch.from_numpy(x))
    assert got.shape == (3, 4) and got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    # f32: the mean of 35 values in another summation order; bf16: the f32
    # mean rounded to bf16, so at most one ulp (2^-8 relative) apart
    rtol = 1e-6 if dtype == "float32" else 2.0**-8
    np.testing.assert_allclose(got, ref.astype(np.float32), rtol=rtol, atol=0)
