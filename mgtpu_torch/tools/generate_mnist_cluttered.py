"""Cluttered-MNIST dataset generator: the port's counterpart of
`tools/generate_mnist_cluttered.py`, the rebuild of the reference's
torch generator scripts (`utils/mnist-cluttered/{segmentation,
spatial_transform,rotation,scaling,translation,affine_transform}.lua`),
over `mgtpu_torch.data.cluttered`.

Reads mnist.npz (`mgtpu_torch.tools.download_mnist`) and writes
mnist_<task>.npz with the split sizes and configs of the reference:
  segmentation:        10k/1k/1k,  5 digits, scale .5-1.25, rot 60
  spatial_transform:   50k+10k/10k, 1 digit,  scale .5-1.5, rot+aff 60
  rotation|scaling|translation|affine: single-factor variants (50k+10k/10k)
  translation_3:       3-digit variant read by mnist-saliency

    python -m mgtpu_torch.tools.generate_mnist_cluttered --mnist mnist.npz \\
        --task segmentation --out-dir data/

Imports neither torch nor the JAX package.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from mgtpu_torch.data.cluttered import TASK_CONFIGS, ClutterConfig, ClutterGenerator

# (n_train, n_valid, n_test, merge train+valid) per the generator scripts
SPLITS = {
    "segmentation": (10000, 1000, 1000, False),
    "spatial_transform": (50000, 10000, 10000, True),
    "rotation": (50000, 10000, 10000, True),
    "scaling": (50000, 10000, 10000, True),
    "translation": (50000, 10000, 10000, True),
    "affine": (50000, 10000, 10000, True),
    "translation_3": (0, 0, 1000, False),
    "reconstruction": (50000, 10000, 10000, True),
}


def gen_split(task, digits, labels, n):
    cfg = dict(TASK_CONFIGS[task])
    n_digits = cfg.pop("n_digits")
    gen = ClutterGenerator(digits, labels, ClutterConfig(n_digits=n_digits, **cfg))
    return gen.generate(n)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mnist", default="mnist.npz")
    ap.add_argument("--task", required=True, choices=sorted(SPLITS))
    ap.add_argument("--out-dir", default=".")
    ap.add_argument("--scale", type=float, default=1.0, help="shrink split sizes")
    args = ap.parse_args(argv)

    z = np.load(args.mnist)
    n_tr, n_va, n_te, merge = SPLITS[args.task]
    n_tr, n_va, n_te = (max(int(n * args.scale), 0) for n in (n_tr, n_va, n_te))
    if n_tr == 0 or n_te == 0:
        raise SystemExit(
            f"--scale {args.scale} rounds the train/test split to zero "
            f"samples (tr={n_tr}, te={n_te}); use a larger scale"
        )

    out = {}
    if n_tr:
        tr = gen_split(args.task, z["train_images"], z["train_labels"], n_tr)
        if merge and n_va:
            va = gen_split(args.task, z["valid_images"], z["valid_labels"], n_va)
            tr = (np.concatenate([tr[0], va[0]]), np.concatenate([tr[1], va[1]]))
        out["train_inputs"], out["train_targets"] = tr
        if not merge and n_va:
            va = gen_split(args.task, z["valid_images"], z["valid_labels"], n_va)
            out["valid_inputs"], out["valid_targets"] = va
    te = gen_split(args.task, z["test_images"], z["test_labels"], n_te)
    out["test_inputs"], out["test_targets"] = te

    os.makedirs(args.out_dir, exist_ok=True)
    path = os.path.join(args.out_dir, f"mnist_{args.task}.npz")
    np.savez_compressed(path, **out)
    print(f"wrote {path}: " + ", ".join(f"{k}={v.shape}" for k, v in out.items()))


if __name__ == "__main__":
    main()
