"""The port's data layer (`mgtpu_torch/data`, `mgtpu_torch/native`)
against the JAX package's: on ``-data synthetic`` every dataset's
loaders give the same batches bit for bit (train, eval and test splits,
and the options that change them), through the donkey pool too; the
native resampler and warp give the JAX library's bits and PIL's values;
the ``-hostCast`` bf16 batch is the JAX package's, bit for bit."""

import numpy as np
import pytest
import torch
from PIL import Image

from mgtpu import native as jax_native
from mgtpu.data import get_loaders as jax_get_loaders
from mgtpu.data import list_datasets as jax_list_datasets
from mgtpu.data.prefetch import _exec_spec as jax_exec_spec
from mgtpu.pipelines.standard import host_cast_inputs as jax_host_cast_inputs
from mgtpu.utils import opts as jax_opts
from mgtpu_torch import native
from mgtpu_torch.data import get_loaders, list_datasets
from mgtpu_torch.data.prefetch import DonkeyPool
from mgtpu_torch.pipelines.standard import host_cast_inputs
from mgtpu_torch.utils import opts


def _both(argv):
    """(JAX loaders, port loaders) for the same command line."""
    argv = ["-data", "synthetic", "-test"] + argv
    return jax_get_loaders(jax_opts.parse(argv)), get_loaders(opts.parse(argv))


def _same_batch(a, b):
    """Bit for bit: dtype, shape and every value."""
    for u, v in zip(a, b):
        assert u.dtype == v.dtype and u.shape == v.shape
        np.testing.assert_array_equal(u, v)


def test_dataset_list_is_the_jax_list():
    assert list_datasets() == jax_list_datasets()


CASES = {name: ["-dataset", name, "-synthSize", "16"] for name in jax_list_datasets()}
CASES.update({
    "ilsvrc": ["-dataset", "ilsvrc", "-synthSize", "8", "-synthClasses", "10"],
    "ilsvrc-tenCrop": ["-dataset", "ilsvrc", "-synthSize", "8", "-synthClasses", "10",
                       "-tenCrop"],
    "ilsvrc-evalSplit": ["-dataset", "ilsvrc", "-synthSize", "8", "-synthClasses", "10",
                         "-evalSplit", "1"],
    "cifar100-whitened-evalSplit": ["-dataset", "cifar100-whitened", "-synthSize", "300",
                                    "-evalSplit", "1", "-imageSize", "36", "-imageCrop", "32"],
    "cifar10-synthDisjoint": ["-dataset", "cifar10", "-synthSize", "16", "-synthDisjoint"],
    "cifar100-whitened-affine-gray": ["-dataset", "cifar100-whitened", "-synthSize", "16",
                                      "-imageSize", "36", "-imageCrop", "32",
                                      "-dataAug", "affine", "-colorspace", "gray"],
    "cifar100-whitened-rotate": ["-dataset", "cifar100-whitened", "-synthSize", "16",
                                 "-imageSize", "36", "-imageCrop", "32", "-dataAug", "rotate"],
    "mnist-saliency": ["-dataset", "mnist-saliency", "-synthSize", "2"],
})


@pytest.mark.parametrize("case", sorted(CASES))
def test_loaders_give_the_jax_batches(case):
    ref, got = _both(CASES[case])
    assert sorted(got) == sorted(ref)
    for split in ref:
        assert got[split].size() == ref[split].size()
        n = min(ref[split].size(), 3)
        _same_batch(ref[split].get_inputs(1, n, 1), got[split].get_inputs(1, n, 1))
    if "train" in ref:
        for seed in (0, 12345):
            _same_batch(ref["train"].gen_inputs(3, 1, seed), got["train"].gen_inputs(3, 1, seed))


@pytest.mark.parametrize("n_donkeys", [0, 2], ids=["sync", "thread"])
def test_pool_stacks_micro_batches_as_jax(n_donkeys):
    """iterSize 2: (iterSize, batch, ...) stacked from seeds seed, seed+1,
    in spec order, through a sync and a thread pool."""
    ref, got = _both(["-dataset", "mnist-seg", "-synthSize", "16"])
    specs = [("gen", "train", 4, 1, 1_000_003 + 2 * i, 2) for i in range(3)]
    specs.append(("get", "test", 1, 3, 1))
    pool = DonkeyPool(n_donkeys, loaders=got)
    try:
        out = list(pool.imap_specs(specs))
    finally:
        pool.shutdown()
    for spec, b in zip(specs, out):
        a = jax_exec_spec(ref, spec)
        if spec[0] == "gen":
            assert b["x"].shape[:2] == (2, 4)
            _same_batch((a["x"], a["y"]), (b["x"], b["y"]))
        else:
            _same_batch(a, b)


def test_process_pool_gives_the_same_batches():
    """-donkeyMode process: workers rebuild the loaders from the options
    and give the sync pool's batches."""
    opt = opts.parse(["-dataset", "cifar100-whitened", "-data", "synthetic", "-synthSize",
                      "64", "-imageSize", "36", "-imageCrop", "32", "-test"])
    loaders = get_loaders(opt)
    specs = [("gen", "train", 4, 1, 100 + i, 1) for i in range(3)] + [("get", "test", 1, 3, 1)]
    ref = list(DonkeyPool(0, loaders=loaders).imap_specs(specs))
    pool = DonkeyPool(2, mode="process", opt=opt, loaders=loaders)
    try:
        got = list(pool.imap_specs(specs))
    finally:
        pool.shutdown()
    for a, b in zip(ref, got):
        _same_batch((a["x"], a["y"]) if isinstance(a, dict) else a,
                    (b["x"], b["y"]) if isinstance(b, dict) else b)


_PIL = {"bilinear": Image.BILINEAR, "bicubic": Image.BICUBIC, "nearest": Image.NEAREST}


@pytest.mark.parametrize("filt", sorted(_PIL))
@pytest.mark.parametrize("shape", [(32, 32, 3, 36, 36), (64, 48, 3, 32, 24),
                                   (256, 341, 3, 224, 224), (17, 23, 1, 40, 31)])
def test_native_resize_is_the_jax_library_and_pil(filt, shape):
    """Bit for bit the JAX package's native library (same source, same
    flags); PIL's within 5e-6, as tests/test_native.py holds that one."""
    h, w, c, oh, ow = shape
    img = np.random.default_rng(1234).normal(size=(h, w, c)).astype(np.float32)
    got = native.resize(img, oh, ow, filt)
    np.testing.assert_array_equal(got, jax_native.resize(img, oh, ow, filt))
    ref = np.stack([np.asarray(Image.fromarray(img[:, :, ch], mode="F").resize((ow, oh),
                                                                              _PIL[filt]))
                    for ch in range(c)], axis=-1)
    np.testing.assert_allclose(got, ref, atol=5e-6)


def test_native_warp_is_the_jax_library_and_pil():
    rng = np.random.default_rng(1234)
    worst = 0.0
    for _ in range(25):
        h, w = (int(v) for v in rng.integers(16, 96, 2))
        img = rng.normal(size=(h, w, 2)).astype(np.float32)
        coeffs = tuple(np.array([1, 0, 0, 0, 1, 0], np.float64) + rng.normal(0, 0.25, 6))
        got = native.warp_affine(img, coeffs)
        np.testing.assert_array_equal(got, jax_native.warp_affine(img, coeffs))
        ref = np.stack([np.asarray(Image.fromarray(img[:, :, ch], mode="F").transform(
            (w, h), Image.AFFINE, coeffs, resample=Image.BILINEAR)) for ch in range(2)], axis=-1)
        worst = max(worst, float(np.abs(got - ref).max()))
    assert worst < 5e-6


def test_native_crop_flip_normalize_and_whiten():
    rng = np.random.default_rng(1234)
    img = rng.normal(size=(40, 44, 3)).astype(np.float32)
    mean = np.array([0.1, -0.2, 0.3], np.float32)
    std = np.array([0.9, 1.1, 1.3], np.float32)
    for flip in (False, True):
        got = native.crop_flip_normalize(img, 5, 7, 32, flip, mean, std)
        np.testing.assert_array_equal(got, jax_native.crop_flip_normalize(img, 5, 7, 32, flip,
                                                                          mean, std))
        ref = (img[5:37, 7:39] - mean) / std
        np.testing.assert_allclose(got, ref[:, ::-1] if flip else ref, rtol=1e-6)
    with pytest.raises(ValueError):
        native.crop_flip_normalize(img, 10, 0, 32, False, mean, std)
    x = rng.normal(size=(37, 48)).astype(np.float32)
    mu = rng.normal(size=48).astype(np.float32)
    p = rng.normal(size=(48, 48)).astype(np.float32)
    np.testing.assert_array_equal(native.whiten(x, mu, p), jax_native.whiten(x, mu, p))


def test_host_cast_is_the_jax_cast():
    """-hostCast 1 under -dtype bfloat16: torch's cast of the input has
    ml_dtypes' bits; the targets and integer inputs stay as they are."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 8, 8, 3)) * 10.0 ** rng.integers(-8, 8, (4, 8, 8, 3))
         ).astype(np.float32)
    y = rng.normal(size=(4, 8, 8, 1)).astype(np.float32)
    ref = jax_host_cast_inputs({"x": x, "y": y}, jnp.bfloat16)
    got = host_cast_inputs({"x": x, "y": y}, torch.bfloat16)
    assert got["x"].dtype == torch.bfloat16 and got["y"].dtype == torch.float32
    np.testing.assert_array_equal(got["x"].view(torch.int16).numpy().view(np.uint16),
                                  np.asarray(ref["x"]).view(np.uint16))
    np.testing.assert_array_equal(got["y"].numpy(), y)
    np.testing.assert_array_equal(host_cast_inputs({"x": x, "y": y}, None)["x"].numpy(), x)
    labels = np.arange(4, dtype=np.int32)
    assert host_cast_inputs({"x": labels, "y": labels}, torch.bfloat16)["x"].dtype == torch.int32
