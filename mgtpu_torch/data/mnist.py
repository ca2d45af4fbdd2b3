"""Cluttered-MNIST task datasets (a copy of `mgtpu/data/mnist.py`) — rebuilds of `dataset/mnist-seg`,
`dataset/mnist-{spt,rot,sca,tra,aff,rec}` (identical loader code, only
the blob differs — SURVEY §2.5) and `dataset/mnist-saliency`.

Canonical on-disk format: `<data>/mnist_<task>.npz` with keys
train_inputs (N,64,64,1), train_targets (N,64,64,C), test_inputs,
test_targets — produced by tools/generate_mnist_cluttered.py from raw
MNIST IDX files (the rebuild of the reference's torch generator
scripts). `-data synthetic` synthesizes on the fly via the same engine
with fake digit sprites."""

from __future__ import annotations

import os

import numpy as np

from mgtpu_torch.data import transforms as tf
from mgtpu_torch.data.base import PairedDataset
from mgtpu_torch.data.cluttered import TASK_CONFIGS, ClutterConfig, ClutterGenerator, synthetic_digits

MNIST_MEANSTD = ([0.1141], [0.2746])  # mnist-seg/donkey.lua:20-23

# dataset name -> (blob task name, generator config key)
TASK_OF_DATASET = {
    "mnist-seg": ("segmentation", "segmentation"),
    "mnist-spt": ("spatial_transform", "spatial_transform"),
    "mnist-rot": ("rotation", "rotation"),
    "mnist-sca": ("scaling", "scaling"),
    "mnist-tra": ("translation", "translation"),
    "mnist-aff": ("affine", "affine"),
    "mnist-rec": ("reconstruction", "reconstruction"),
}


def _synth_split(cfg_key: str, n: int, seed: int):
    cfg = dict(TASK_CONFIGS[cfg_key])
    cfg["seed"] = seed
    n_digits = cfg.pop("n_digits")
    c = ClutterConfig(n_digits=n_digits, **cfg)
    digits, labels = synthetic_digits(seed=seed)
    gen = ClutterGenerator(digits, labels, c)
    return gen.generate(n)


def _load_task_npz(opt, task: str, cfg_key: str):
    """-> (train, eval_or_None, test) split pairs. The reference blobs
    carry {train,val,test} (`dataset/mnist-seg/dataset.lua:38-39`); the
    val split feeds `-eval` (`pipelines/standard/eval.lua:18-84`). Tasks
    whose generator merges valid into train (SPLITS[...] merge=True)
    have no val split — eval then falls back to test, loudly."""
    data_dir = getattr(opt, "data", "synthetic")
    if data_dir == "synthetic":
        n = getattr(opt, "synthSize", 256)
        m = max(n // 4, 8)
        return (
            _synth_split(cfg_key, n, 1),
            _synth_split(cfg_key, m, 3),
            _synth_split(cfg_key, m, 2),
        )
    path = os.path.join(data_dir, f"mnist_{task}.npz")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"{path} not found; run tools/generate_mnist_cluttered.py "
            f"--task {task} or use -data synthetic"
        )
    z = np.load(path)
    val = (z["valid_inputs"], z["valid_targets"]) if "valid_inputs" in z else None
    return (
        (z["train_inputs"], z["train_targets"]),
        val,
        (z["test_inputs"], z["test_targets"]),
    )


def build_mnist_task(opt, name: str):
    task, cfg_key = TASK_OF_DATASET[name]
    (tri, trt), val, (tei, tet) = _load_task_npz(opt, task, cfg_key)
    norm = tf.color_normalize(*MNIST_MEANSTD)
    loaders = {
        "train": PairedDataset(tri, trt, train_hook=norm, test_hook=norm),
        "test": PairedDataset(tei, tet, train_hook=norm, test_hook=norm),
    }
    if val is not None:
        loaders["eval"] = PairedDataset(val[0], val[1], train_hook=norm, test_hook=norm)
    return loaders


def occlusion_masks(size: int = 64, window: int = 8, stride: int = 2) -> np.ndarray:
    """All 8x8 windows at stride 2 over 64x64 -> (841, H, W, 1)
    (`dataset/mnist-saliency/dataset.lua:44-59`)."""
    pos = range(0, size - window + 1, stride)
    masks = np.zeros((len(list(pos)) ** 2, size, size, 1), np.float32)
    i = 0
    for y in range(0, size - window + 1, stride):
        for x in range(0, size - window + 1, stride):
            masks[i, y : y + window, x : x + window, 0] = 1.0
            i += 1
    return masks


class SaliencyDataset(PairedDataset):
    """Test-only loader whose hook expands each sample into a 1+841
    stack of occluded variants (`dataset/mnist-saliency/donkey.lua:
    40-45`); exposes `.mask` to the saliency pipeline
    (`pipelines/saliency/test.lua:36`).

    ``expand="device"`` (the -saliencyDumpStack 0 fast path) returns
    only the NORMALIZED base image and exposes `.noise`/`.meanstd` so
    the pipeline builds the identical stack on device — the occlusion
    expansion is a deterministic affine function of (img, mask, noise),
    so only ~16 KB/sample ever crosses the host-device link instead of
    the 13.8 MB stack."""

    def __init__(self, inputs, targets, mask, expand: str = "host"):
        assert expand in ("host", "device")
        norm = tf.color_normalize(*MNIST_MEANSTD)
        noise = tf.occlusion_noise(mask)  # one copy, shared with the hook
        if expand == "host":
            occl = tf.occlusion(mask, noise=noise)

            def hook(img, rng):
                stack = occl(img, rng)
                return norm(stack, rng)

        else:
            hook = norm  # base image only; occlusion happens on device
        super().__init__(inputs, targets, train_hook=None, test_hook=hook)
        self.mask = mask
        self.expand = expand
        self.noise = noise
        self.meanstd = MNIST_MEANSTD


def build_mnist_saliency(opt):
    data_dir = getattr(opt, "data", "synthetic")
    if data_dir == "synthetic":
        n = getattr(opt, "synthSize", 8)
        (tei, tet) = _synth_split("translation_3", n, 2)
    else:
        path = os.path.join(data_dir, "mnist_translation_3.npz")
        if not os.path.isfile(path):
            raise FileNotFoundError(
                f"{path} not found; run tools/generate_mnist_cluttered.py "
                "--task translation_3 (no generator ships in the reference "
                "either — SURVEY §2.5) or use -data synthetic"
            )
        z = np.load(path)
        tei, tet = z["test_inputs"], z["test_targets"]
    mask = occlusion_masks()
    expand = (
        "device"
        if not int(getattr(opt, "saliencyDumpStack", 1))
        else "host"
    )
    test = SaliencyDataset(tei, tet, mask, expand=expand)
    return {"test": test}
