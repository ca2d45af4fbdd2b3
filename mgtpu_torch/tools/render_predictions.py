"""Render qualitative input | target | prediction panels from a test
pass's h5 dump: the port's counterpart of `tools/render_predictions.py`,
the rebuild of the reference's published figure panels (rows of
Input | True | U-NET cells, inverted grayscale, as
`figures/spatial_transform.png`), which the reference produced offline
from `testOutput_<E>.h5` + the task `.t7`. The dump is read through
`mgtpu_torch.utils.h5`; PIL is imported when the panel is drawn.

Two render modes:
  gray  one digit per sample (mnist-spt / mnist-ctrd): collapse the
        class channels with max() and draw dark-on-white like the
        published figure.
  seg   multi-digit masks (mnist-seg): tint each class channel with a
        10-color palette so overlapping digits stay distinguishable;
        the input column stays grayscale.
  auto  seg when the target marks >1 class in any rendered sample.

Sample i of the h5 'prediction' dataset is test-split sample i (the
test loop batches the test set in order, `mgtpu_torch/pipelines/standard.py`).

    python -m mgtpu_torch.tools.render_predictions <run>/testOutput_200.h5 \
        --targets mnist_segmentation.npz --out viz/ [--ids 0 1 2] \
        [--mode auto] [--threshold 0.0]

Imports neither torch, h5py nor the JAX package.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from mgtpu_torch.utils import h5

# 10 class tints (digit 0-9): matplotlib's tab10, a colorblind-tested
# categorical palette
PALETTE = np.array(
    [[31, 119, 180], [255, 127, 14], [44, 160, 44], [214, 39, 40],
     [148, 103, 189], [140, 86, 75], [227, 119, 194], [127, 127, 127],
     [188, 189, 34], [23, 190, 207]],
    np.float32,
) / 255.0


def collapse_gray(chw: np.ndarray) -> np.ndarray:
    """(H, W, C) class channels -> (H, W) intensity in [0, 1]."""
    return np.clip(chw.max(axis=-1), 0.0, 1.0)


def collapse_color(chw: np.ndarray) -> np.ndarray:
    """(H, W, C) -> (H, W, 3): white background, each class channel
    subtracting its palette complement (multiplicative tint blend, so
    overlaps darken instead of saturating)."""
    h, w, c = chw.shape
    rgb = np.ones((h, w, 3), np.float32)
    for ch in range(c):
        m = np.clip(chw[..., ch], 0.0, 1.0)[..., None]
        rgb *= 1.0 - m * (1.0 - PALETTE[ch % len(PALETTE)])
    return rgb


def to_cell(img: np.ndarray) -> np.ndarray:
    """-> (H, W, 3) float in [0,1]; grayscale inputs are INVERTED
    (dark digit on white) to match the published figure."""
    if img.ndim == 2:
        img = 1.0 - np.clip(img, 0.0, 1.0)
        return np.repeat(img[..., None], 3, axis=-1)
    return np.clip(img, 0.0, 1.0)


def assemble(rows, pad: int = 2, scale: int = 3) -> np.ndarray:
    """rows: list of lists of (H, W, 3) cells -> one uint8 canvas with
    ``pad``-px separators, NEAREST-upscaled by ``scale``."""
    h, w = rows[0][0].shape[:2]
    nr, nc = len(rows), len(rows[0])
    canvas = np.full(
        (nr * h + (nr + 1) * pad, nc * w + (nc + 1) * pad, 3), 0.5, np.float32
    )
    for r, row in enumerate(rows):
        for c, cell in enumerate(row):
            y = pad + r * (h + pad)
            x = pad + c * (w + pad)
            canvas[y:y + h, x:x + w] = cell
    arr = (np.clip(canvas, 0, 1) * 255).astype(np.uint8)
    from PIL import Image

    im = Image.fromarray(arr)
    return np.asarray(
        im.resize((arr.shape[1] * scale, arr.shape[0] * scale), Image.NEAREST)
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("h5", help="testOutput_<epoch>.h5 with a 'prediction' dataset")
    ap.add_argument("--targets", required=True,
                    help="mnist_<task>.npz (tools/generate_mnist_cluttered.py)")
    ap.add_argument("--split", default="test")
    ap.add_argument("--out", required=True,
                    help="output .png file, or a directory to receive "
                         "predictions_<mode>.png")
    ap.add_argument("--ids", type=int, nargs="*", default=None,
                    help="sample indices (default: first 8)")
    ap.add_argument("--mode", default="auto", choices=["auto", "gray", "seg"])
    ap.add_argument("--threshold", type=float, default=0.0,
                    help="zero out prediction values below this before "
                         "rendering (0 = raw confidences)")
    args = ap.parse_args(argv)

    with h5.File(args.h5, "r") as f:
        pred = np.asarray(f["prediction"])
    if pred.ndim == 4 and pred.shape[1] < pred.shape[-1]:
        pred = np.moveaxis(pred, 1, -1)  # NCHW dump -> NHWC
    z = np.load(args.targets)
    inputs = z[f"{args.split}_inputs"]
    targets = z[f"{args.split}_targets"]
    n = min(len(pred), len(inputs))
    ids = args.ids if args.ids is not None else list(range(min(8, n)))
    bad = [i for i in ids if not 0 <= i < n]
    if bad:
        raise SystemExit(f"ids {bad} out of range (have {n} samples)")

    mode = args.mode
    if mode == "auto":
        multi = any(
            (targets[i].reshape(-1, targets.shape[-1]).max(0) > 0.5).sum() > 1
            for i in ids
        )
        mode = "seg" if multi else "gray"
    collapse = collapse_color if mode == "seg" else collapse_gray

    rows = []
    for i in ids:
        p = pred[i]
        if args.threshold > 0:
            p = np.where(p >= args.threshold, p, 0.0)
        rows.append([
            to_cell(inputs[i][..., 0]),
            to_cell(collapse(targets[i])),
            to_cell(collapse(p)),
        ])

    from PIL import Image

    panel = assemble(rows)
    if args.out.endswith(".png"):
        out_path = args.out
        parent = os.path.dirname(out_path)
        if parent:
            os.makedirs(parent, exist_ok=True)
    else:
        os.makedirs(args.out, exist_ok=True)
        out_path = os.path.join(args.out, f"predictions_{mode}.png")
    Image.fromarray(panel).save(out_path)
    print(f"{len(rows)} rows (input | target | prediction, {mode}) -> {out_path}")


if __name__ == "__main__":
    main()
