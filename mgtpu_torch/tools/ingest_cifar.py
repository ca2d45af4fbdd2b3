"""CIFAR ingest: the port's counterpart of `tools/ingest_cifar.py`.
Converts the public python pickles to the .npz format that
`mgtpu_torch/data/cifar.py` loads, optionally producing the ZCA-whitened
CIFAR-100 blob the reference downloads pre-computed (`README.md:49`,
`dataset/cifar100-whitened/dataset.lua:44`).

Whitening recipe (standard ZCA as in Goodfellow et al. maxout /
pylearn2, the lineage of the published blob): global contrast
normalize each image (subtract its mean, divide by its norm), then
X_zca = X U (S + eps)^-1/2 U^T with (U, S) from the covariance of the
TRAIN set; the same transform is applied to test. The product runs in
f32 through the port's native library (`mgtpu_torch.native.whiten`, the
same C++ and flags as the JAX package's), which is built with g++ at
first use; a failed build raises.

    python -m mgtpu_torch.tools.ingest_cifar --root <dir with cifar-100-python/> \\
        --dataset cifar100 --whiten --out cifar100_whitened.npz
    python -m mgtpu_torch.tools.ingest_cifar --t7 cifar100_whitened.t7

Imports neither torch nor the JAX package.
"""

from __future__ import annotations

import argparse

import numpy as np

from mgtpu_torch.data.cifar import load_cifar_python as load_cifar


def gcn(x: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    x = x.astype(np.float64)
    x = x - x.mean(axis=1, keepdims=True)
    norm = np.sqrt((x**2).sum(axis=1, keepdims=True)) + eps
    return x / norm * 55.0  # pylearn2 scale convention


def zca_fit(x: np.ndarray, eps: float = 0.1):
    mean = x.mean(axis=0)
    xc = x - mean
    cov = xc.T @ xc / len(xc)
    u, s, _ = np.linalg.svd(cov)
    w = u @ np.diag(1.0 / np.sqrt(s + eps)) @ u.T
    return mean, w


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=False, default=None)
    ap.add_argument("--dataset", default="cifar100", choices=["cifar10", "cifar100"])
    ap.add_argument("--whiten", action="store_true")
    ap.add_argument("--t7", default=None, metavar="BLOB",
                    help="ingest the reference's own torch.save artifact "
                         "(e.g. the pre-whitened cifar100_whitened.t7 from "
                         "README.md:49) instead of python pickles")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    if args.t7:
        # the canonical reference drop: already whitened, so no GCN/ZCA
        # pass, just the layout (CHW->HWC; labels stay 1-based, the
        # runtime loader's >=1 shift handles torch indexing)
        from mgtpu_torch.tools.read_t7 import convert_cifar
        from mgtpu_torch.utils import t7

        arrays = convert_cifar(t7.load(args.t7))
        out = args.out or "cifar100_whitened.npz"
        np.savez_compressed(out, **arrays)
        print(f"wrote {out}: train {arrays['train_data'].shape}, "
              f"test {arrays['test_data'].shape}")
        return
    if not args.root:
        ap.error("--root is required unless --t7 is given")

    if args.whiten and args.dataset != "cifar100":
        raise SystemExit(
            "--whiten is only consumed by -dataset cifar100-whitened, "
            "which loads cifar100_whitened.npz; a whitened "
            f"{args.dataset} blob would never be read by any runtime "
            "path (mgtpu_torch/data/cifar.py)"
        )
    (trd, trl), (ted, tel) = load_cifar(args.root, args.dataset)
    out = args.out or (
        f"{args.dataset}_whitened.npz" if args.whiten else f"{args.dataset}.npz"
    )
    if args.whiten:
        from mgtpu_torch import native

        tr = gcn(trd)
        te = gcn(ted)
        mean, w = zca_fit(tr)
        # (x - mean) @ w in float32, as the JAX tool computes it
        mean32, w32 = mean.astype(np.float32), np.ascontiguousarray(w, np.float32)
        trd = native.whiten(np.ascontiguousarray(tr, np.float32), mean32, w32)
        ted = native.whiten(np.ascontiguousarray(te, np.float32), mean32, w32)
    np.savez_compressed(
        out,
        train_data=trd.astype(np.float32),
        train_labels=trl.astype(np.int32),
        test_data=ted.astype(np.float32),
        test_labels=tel.astype(np.int32),
    )
    print(f"wrote {out}: train {trd.shape}, test {ted.shape}")


if __name__ == "__main__":
    main()
