"""Offline segmentation metrics: the port's counterpart of
`tools/seg_metrics.py`. The reference computed its published
meanIU/meanAcc in a notebook from the h5 prediction dump
(`notebooks/mnist-segmentation.ipynb` cells 0-1); this is that
computation as a CLI, reading the dump through `mgtpu_torch.utils.h5`.

Per class c over the WHOLE test set:
    IU_c  = TP_c / (TP_c + #mismatches_c)
    Acc_c = TP_c / #predicted_c            (precision, as the notebook)
meanIU / meanAcc = average over classes.

    python -m mgtpu_torch.tools.seg_metrics testOutput_1.h5 \\
        --targets mnist_segmentation.npz [--threshold 0.5]

Imports neither torch, h5py nor the JAX package.
"""

from __future__ import annotations

import argparse

import numpy as np

from mgtpu_torch.utils import h5


def mean_iu_acc(prediction: np.ndarray, labels: np.ndarray, threshold: float = 0.5,
                layout: str = "auto"):
    """prediction/labels: (N, H, W, C) or (N, C, H, W).

    layout: 'nhwc' | 'nchw' | 'auto'. Auto assumes channel-last (the
    dump layout) unless dim 1 is strictly smaller than the last dim;
    pass the layout explicitly when spatial extent <= channels (e.g.
    coarse-scale dumps), where any heuristic is ambiguous."""
    if prediction.shape != labels.shape:
        raise ValueError("prediction/labels shapes differ")
    pred = prediction >= threshold
    lab = labels >= threshold
    if layout == "auto":
        layout = "nchw" if (pred.ndim == 4 and pred.shape[1] < pred.shape[-1]) else "nhwc"
    if layout == "nchw":
        pred = np.moveaxis(pred, 1, -1)
        lab = np.moveaxis(lab, 1, -1)
    elif layout != "nhwc":
        raise ValueError(f"unknown layout {layout!r}")
    iu = acc = 0.0
    for c in range(pred.shape[-1]):
        p = pred[..., c]
        l = lab[..., c]
        tp = float((p & l).sum())
        mism = float((p != l).sum())
        iu += tp / max(tp + mism, 1e-12)
        acc += tp / max(float(p.sum()), 1e-12)
    c = pred.shape[-1]
    return iu / c, acc / c


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("h5", help="testOutput_<epoch>.h5 with a 'prediction' dataset")
    ap.add_argument("--targets", required=True, help="mnist_segmentation.npz")
    ap.add_argument("--split", default="test")
    ap.add_argument("--layout", default="auto", choices=["auto", "nhwc", "nchw"],
                    help="prediction tensor layout (auto is ambiguous "
                         "when spatial extent <= channels)")
    ap.add_argument("--threshold", type=float, default=0.5)
    args = ap.parse_args(argv)

    with h5.File(args.h5, "r") as f:
        pred = np.asarray(f["prediction"])
    z = np.load(args.targets)
    lab = z[f"{args.split}_targets"][: len(pred)]
    iu, acc = mean_iu_acc(pred, lab, args.threshold, layout=args.layout)
    print(f"mean IU: {iu:.6f}")
    print(f"mean Acc: {acc:.6f}")
    return iu, acc


if __name__ == "__main__":
    main()
