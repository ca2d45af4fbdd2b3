"""Dataset loader contract (a copy of `mgtpu/data/base.py`) — the
rebuild of the reference's dataLoader
class (`dataset/cifar100-whitened/dataset.lua`, `INTRO.md:22-27`):

    size()                          -> number of test/eval samples
    gen_inputs(batch, epoch, seed)  -> (x, y) random training batch
    get_inputs(i1, i2, epoch)       -> (x, y) sequential slice (1-based,
                                       inclusive — keeping the reference
                                       pipeline's indexing)

Sampling semantics preserved exactly: classification datasets sample
class-balanced WITH replacement — uniform class, then uniform member
(`dataset.lua:90-126`) — an epoch is epochSize x batchSize random draws,
not a permutation (convergence parity depends on this, SURVEY §7).
Segmentation datasets sample uniform random indices
(`dataset/mnist-seg/dataset.lua:70-84`).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np

Hook = Callable[[np.ndarray, np.random.Generator], np.ndarray]


def _apply_hook(hook: Optional[Hook], img: np.ndarray, rng) -> np.ndarray:
    return img if hook is None else hook(img, rng)


def carve_seed(manual_seed: int) -> int:
    """The -evalSplit carve's RNG stream, derived identically for every
    dataset (cifar and ilsvrc) so 'deterministic per -manualSeed' means
    the same thing everywhere."""
    return manual_seed * 1_000_003 + 99991


def check_1based(i1: int) -> None:
    """Reject i1 < 1 in every loader's get(): the contract is 1-based
    inclusive (`INTRO.md:22-27`), and a 0 would silently wrap to the
    LAST sample via Python negative indexing and misalign the batch."""
    if i1 < 1:
        raise ValueError(f"get() indices are 1-based, got i1={i1}")


class ClassBalancedDataset:
    """In-memory classification dataset with class-balanced sampling.

    images: (N, H, W, C) float32 (HWC — already converted from the
    reference's CHW blobs at ingest); labels: (N,) int, 0-based.
    """

    def __init__(self, images, labels, n_classes: int,
                 train_hook: Optional[Hook] = None,
                 test_hook: Optional[Hook] = None):
        self.images = images
        self.labels = np.asarray(labels, np.int32)
        self.n_classes = n_classes
        self.train_hook = train_hook
        self.test_hook = test_hook
        self.class_list = [
            np.flatnonzero(self.labels == c) for c in range(n_classes)
        ]
        for c, idx in enumerate(self.class_list):
            if len(idx) == 0:
                raise ValueError(f"class {c} has no samples")

    def size(self) -> int:
        return len(self.labels)

    def sample(self, quantity: int, rng: np.random.Generator):
        xs, ys = [], []
        for _ in range(quantity):
            c = int(rng.integers(0, self.n_classes))
            members = self.class_list[c]
            i = int(members[rng.integers(0, len(members))])
            xs.append(_apply_hook(self.train_hook, self.images[i], rng))
            ys.append(c)
        return np.stack(xs).astype(np.float32), np.asarray(ys, np.int32)

    def gen_inputs(self, batch_size: int, epoch: int, seed: int):
        return self.sample(batch_size, np.random.default_rng(seed))

    def get(self, i1: int, i2: int, rng=None):
        rng = rng or np.random.default_rng(0)
        check_1based(i1)
        idx = range(i1 - 1, i2)  # reference slices are 1-based inclusive
        xs = [_apply_hook(self.test_hook, self.images[i], rng) for i in idx]
        ys = [self.labels[i] for i in idx]
        return np.stack(xs).astype(np.float32), np.asarray(ys, np.int32)

    def get_inputs(self, i1: int, i2: int, epoch: int):
        return self.get(i1, i2)


class PairedDataset:
    """In-memory (input image, target image) dataset with uniform
    sampling — mnist-seg/spt/... (`dataset/mnist-seg/dataset.lua`)."""

    def __init__(self, inputs, targets,
                 train_hook: Optional[Hook] = None,
                 test_hook: Optional[Hook] = None):
        assert len(inputs) == len(targets)
        self.inputs = inputs
        self.targets = targets
        self.train_hook = train_hook
        self.test_hook = test_hook

    def size(self) -> int:
        return len(self.inputs)

    def sample(self, quantity: int, rng: np.random.Generator):
        idx = rng.integers(0, len(self.inputs), quantity)
        xs = [_apply_hook(self.train_hook, self.inputs[i], rng) for i in idx]
        ys = [self.targets[i] for i in idx]
        return np.stack(xs).astype(np.float32), np.stack(ys).astype(np.float32)

    def gen_inputs(self, batch_size: int, epoch: int, seed: int):
        return self.sample(batch_size, np.random.default_rng(seed))

    def get(self, i1: int, i2: int, rng=None):
        rng = rng or np.random.default_rng(0)
        check_1based(i1)
        idx = range(i1 - 1, i2)
        xs = [_apply_hook(self.test_hook, self.inputs[i], rng) for i in idx]
        ys = [self.targets[i] for i in idx]
        return np.stack(xs).astype(np.float32), np.stack(ys).astype(np.float32)

    def get_inputs(self, i1: int, i2: int, epoch: int):
        return self.get(i1, i2)
