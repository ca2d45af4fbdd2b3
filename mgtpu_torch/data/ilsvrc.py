"""ILSVRC (ImageNet) dataset (a copy of `mgtpu/data/ilsvrc.py`) — rebuild of
`dataset/ilsvrc/`. PIL decodes the image files (imported where it runs);
the synthetic set needs no PIL.

Class discovery walks the directory-per-class tree (the reference
shelled out to GNU find and packed paths into CharTensors,
`dataset.lua:106-214`; plain os.scandir is the Python-native
equivalent). Robust JPEG loading mirrors the pcall +
image.decompress fallback (`donkey.lua:37-57`). Train transform:
RandomSizedCrop(224) -> ColorJitter(.4,.4,.4) -> Lighting(0.1, PCA) ->
ColorNormalize -> HFlip(.5); test: Scale(256) -> ColorNormalize ->
CenterCrop(224) or TenCrop with `-tenCrop` (the reference reads
OPT.tenCrop but never registers the flag — SURVEY §2.8; we register it).

`-data synthetic` builds procedural images so the ImageNet pipelines
run end-to-end on a zero-egress box."""

from __future__ import annotations

import io
import os
from typing import List, Optional

import numpy as np

from mgtpu_torch.data import transforms as tf
from mgtpu_torch.data.base import check_1based

MEANSTD = ([0.485, 0.456, 0.406], [0.229, 0.224, 0.225])  # donkey.lua:21-24
PCA_EIGVAL = np.array([0.2175, 0.0188, 0.0045], np.float32)
PCA_EIGVEC = np.array(
    [
        [-0.5675, 0.7192, 0.4009],
        [-0.5808, -0.0045, -0.8140],
        [-0.5836, -0.6948, 0.4203],
    ],
    np.float32,
)


def load_image(path: str) -> np.ndarray:
    """Robust decode -> HWC float32 in [0,1] (`donkey.lua:37-57`)."""
    from PIL import Image

    try:
        im = Image.open(path).convert("RGB")
    except Exception:
        with open(path, "rb") as f:
            im = Image.open(io.BytesIO(f.read())).convert("RGB")
    return np.asarray(im, np.float32) / 255.0


def train_transform():
    return tf.compose(
        [
            tf.random_sized_crop(224),
            tf.color_jitter(0.4, 0.4, 0.4),
            tf.lighting(0.1, PCA_EIGVAL, PCA_EIGVEC),
            tf.color_normalize(*MEANSTD),
            tf.horizontal_flip(0.5),
        ]
    )


def test_transform(ten_crop: bool = False):
    crop = tf.ten_crop(224) if ten_crop else tf.center_crop(224)
    return tf.compose([tf.scale(256), tf.color_normalize(*MEANSTD), crop])


class FolderDataset:
    """Directory-per-class image dataset with class-balanced sampling
    (samplingMode='balanced' default, `dataset.lua:41-44,299-313`)."""

    def __init__(self, root: str, hook, balanced: bool = True,
                 classes: Optional[List[str]] = None):
        self.root = root
        self.hook = hook
        self.classes = classes or sorted(
            d.name for d in os.scandir(root) if d.is_dir()
        )
        self.class_to_idx = {c: i for i, c in enumerate(self.classes)}
        self.paths: List[str] = []
        self.labels: List[int] = []
        self.class_list: List[List[int]] = [[] for _ in self.classes]
        exts = {".jpg", ".jpeg", ".png", ".ppm", ".bmp"}
        for c in self.classes:
            cdir = os.path.join(root, c)
            if not os.path.isdir(cdir):
                continue
            for e in sorted(os.scandir(cdir), key=lambda e: e.name):
                if os.path.splitext(e.name)[1].lower() in exts:
                    self.class_list[self.class_to_idx[c]].append(len(self.paths))
                    self.paths.append(e.path)
                    self.labels.append(self.class_to_idx[c])
        self.labels = np.asarray(self.labels, np.int32)
        self.balanced = balanced

    def size(self) -> int:
        return len(self.paths)

    def subset(self, keep: np.ndarray, hook) -> "FolderDataset":
        """A view over a subset of sample indices (no rescan), used by
        the single-tree train/test split (`dataset.lua:217-263`)."""
        ds = object.__new__(FolderDataset)
        ds.root, ds.balanced = self.root, self.balanced
        ds.classes, ds.class_to_idx = self.classes, self.class_to_idx
        ds.hook = hook
        ds.paths = [self.paths[i] for i in keep]
        ds.labels = self.labels[keep]
        ds.class_list = [[] for _ in self.classes]
        for new_i, lab in enumerate(ds.labels):
            ds.class_list[int(lab)].append(new_i)
        return ds

    def split_train_test(self, split_pct: int, seed: int, test_hook):
        """Per-class split: train takes floor(count*split/100 + 0.5) of
        a seeded permutation, test the remainder — the reference
        dataLoader's split option (`dataset/ilsvrc/dataset.lua:217-263`,
        exposed here as -split since the shipped donkey only ever used
        pre-split train/+val/ trees)."""
        rng = np.random.default_rng(seed)
        tr_idx, te_idx = [], []
        for members in self.class_list:
            members = np.asarray(members, np.int64)
            perm = rng.permutation(len(members))
            k = int(np.floor(len(members) * split_pct / 100 + 0.5))
            tr_idx.append(members[perm[:k]])
            te_idx.append(members[perm[k:]])
        tr_all = np.concatenate(tr_idx)
        te_all = np.concatenate(te_idx)
        if tr_all.size == 0:
            raise ValueError(
                f"-split {split_pct} rounded every class's train share "
                "to zero — the balanced sampler would spin forever on an "
                "empty train set; use a larger split or more images"
            )
        if te_all.size == 0:
            print(
                f"WARNING: -split {split_pct} left the TEST split empty "
                "(every class's images rounded to train); -test will "
                "measure nothing"
            )
        return (
            self.subset(tr_all, self.hook),
            self.subset(te_all, test_hook),
        )

    def carve_eval(self, per_class: int, seed: int, eval_hook):
        """-evalSplit for the folder tree: hold out ``per_class`` seeded
        images of every class as a validation subset-view (the ilsvrc
        leg of the three-way split; composes with -split, which carves
        test first)."""
        from mgtpu_torch.data.base import carve_seed

        rng = np.random.default_rng(carve_seed(seed))
        ev_idx, tr_idx = [], []
        for c, members in enumerate(self.class_list):
            members = np.asarray(members, np.int64)
            if 0 < len(members) <= per_class:
                raise ValueError(
                    f"-evalSplit {per_class} would empty class "
                    f"{self.classes[c]} ({len(members)} train images)"
                )
            perm = rng.permutation(len(members))
            ev_idx.append(members[perm[:per_class]])
            tr_idx.append(members[perm[per_class:]])
        return (
            self.subset(np.concatenate(tr_idx), self.hook),
            self.subset(np.concatenate(ev_idx), eval_hook),
        )

    def sample(self, quantity: int, rng: np.random.Generator):
        xs, ys = [], []
        for _ in range(quantity):
            if self.balanced:
                c = int(rng.integers(0, len(self.classes)))
                members = self.class_list[c]
                while not members:  # tolerate empty classes
                    c = int(rng.integers(0, len(self.classes)))
                    members = self.class_list[c]
                i = members[int(rng.integers(0, len(members)))]
            else:
                i = int(rng.integers(0, len(self.paths)))
            img = load_image(self.paths[i])
            xs.append(self.hook(img, rng))
            ys.append(self.labels[i])
        return np.stack(xs).astype(np.float32), np.asarray(ys, np.int32)

    def gen_inputs(self, batch_size, epoch, seed):
        return self.sample(batch_size, np.random.default_rng(seed))

    def get(self, i1, i2, rng=None):
        rng = rng or np.random.default_rng(0)
        check_1based(i1)
        xs, ys = [], []
        for i in range(i1 - 1, i2):
            img = load_image(self.paths[i])
            xs.append(self.hook(img, rng))
            ys.append(self.labels[i])
        return np.stack(xs).astype(np.float32), np.asarray(ys, np.int32)

    def get_inputs(self, i1, i2, epoch):
        return self.get(i1, i2)


class SynthIlsvrc:
    """Procedural stand-in: per-index deterministic 256px class-coded
    images, decoded lazily (no 150 GB tree needed)."""

    def __init__(self, n: int, hook, n_classes: int = 1000, seed: int = 5):
        self.n = n
        self.hook = hook
        self.n_classes = n_classes
        self.seed = seed
        self.labels = (np.arange(n) % n_classes).astype(np.int32)

    def _image(self, i: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + i)
        c = int(self.labels[i])
        yy, xx = np.mgrid[0:256, 0:256].astype(np.float32) / 256.0
        base = np.stack(
            [
                np.sin(2 * np.pi * ((c % 17) + 1) * yy),
                np.cos(2 * np.pi * ((c % 13) + 1) * xx),
                np.sin(2 * np.pi * ((c % 7) + 1) * (xx + yy)),
            ],
            axis=-1,
        )
        img = 0.5 + 0.25 * base + 0.1 * rng.standard_normal((256, 256, 3)).astype(np.float32)
        return np.clip(img, 0, 1)

    def size(self) -> int:
        return self.n

    def sample(self, quantity, rng):
        idx = rng.integers(0, self.n, quantity)
        xs = [self.hook(self._image(int(i)), rng) for i in idx]
        return np.stack(xs).astype(np.float32), self.labels[idx]

    def gen_inputs(self, batch_size, epoch, seed):
        return self.sample(batch_size, np.random.default_rng(seed))

    def get(self, i1, i2, rng=None):
        rng = rng or np.random.default_rng(0)
        check_1based(i1)
        xs = [self.hook(self._image(i), rng) for i in range(i1 - 1, i2)]
        return np.stack(xs).astype(np.float32), self.labels[i1 - 1 : i2]

    def get_inputs(self, i1, i2, epoch):
        return self.get(i1, i2)


def build_ilsvrc(opt):
    data_dir = getattr(opt, "data", "synthetic")
    ten = bool(getattr(opt, "tenCrop", False))
    per_class = int(getattr(opt, "evalSplit", 0))
    seed = getattr(opt, "manualSeed", 2)
    if data_dir == "synthetic":
        n = getattr(opt, "synthSize", 64)
        n_classes = getattr(opt, "synthClasses", 1000)
        out = {
            "train": SynthIlsvrc(n, train_transform(), n_classes),
            "test": SynthIlsvrc(max(n // 4, 8), test_transform(ten), n_classes),
        }
        if per_class > 0:  # distinct seed -> disjoint procedural images
            out["eval"] = SynthIlsvrc(
                max(n // 4, 8), test_transform(ten), n_classes, seed=seed + 17
            )
        return out
    split = int(getattr(opt, "split", 0))
    if split:  # single-tree per-class split (`dataset.lua:217-263`)
        full = FolderDataset(data_dir, train_transform())
        if not full.classes:
            raise FileNotFoundError(f"no class directories under {data_dir}")
        train, test = full.split_train_test(
            split, seed, test_transform(ten)
        )
        out = {"train": train, "test": test}
        if per_class > 0:  # three-way: eval carved from the train share
            out["train"], out["eval"] = train.carve_eval(
                per_class, seed, test_transform(ten)
            )
        return out
    train_dir = os.path.join(data_dir, "train")
    val_dir = os.path.join(data_dir, "val")
    out = {}
    if os.path.isdir(train_dir):
        out["train"] = FolderDataset(train_dir, train_transform())
        if per_class > 0:
            out["train"], out["eval"] = out["train"].carve_eval(
                per_class, seed, test_transform(ten)
            )
    if os.path.isdir(val_dir):
        classes = out["train"].classes if "train" in out else None
        out["test"] = FolderDataset(val_dir, test_transform(ten), classes=classes)
    if not out:
        raise FileNotFoundError(
            f"no train/ or val/ under {data_dir} (for a single "
            "directory-per-class tree, pass -split <pct-to-train>)"
        )
    return out
