"""Render saliency-map HSV visualizations from a saliency run's
testOutput.h5: the port's counterpart of `tools/render_saliency.py`, the
offline equivalent of the reference's `notebooks/saliency-map-hsv.ipynb`
(cells 2-5) as a CLI. The dump is read through `mgtpu_torch.utils.h5`;
PIL is imported when a PNG is written.

Per sample group id%05d/{points,saliency,input,output} this writes:
  <out>/id%05d_input.png           de-normalized, inverted input
  <out>/id%05d_points.png          output with all 7 probe points drawn
  <out>/id%05d_points_sel.png      green+red probe points only (the
                                   notebook masks hues 3..7 to zero)
  <out>/id%05d_saliency_<k>.png    HSV rendering per probe k: hue from
                                   the notebook's 7-hue table, saturation
                                   = decile-quantized saliency, value =
                                   binarized (>=.5) inverted input
The points panels draw on ``output``, which only a -saliencyDumpStack 1
dump holds: on another dump the tool stops and says so.

    python -m mgtpu_torch.tools.render_saliency --h5 <run>/testOutput.h5 --out viz/ \
        [--ids 30 31] [--mean 0.1141 --std 0.2746] [--nq 10]

Imports neither torch, h5py nor the JAX package.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from mgtpu_torch.utils import h5

# notebook cell 2: RGB point colors (green red yellow blue cyan magenta orange)
COLORS = np.array(
    [[0, 255, 0], [255, 0, 0], [255, 255, 0], [0, 0, 255],
     [0, 255, 255], [255, 0, 255], [255, 165, 0]],
    np.float32,
) / 255.0
# notebook cell 3: per-probe hues
HUES = np.array([2 / 6, 0.0, 1 / 6, 4 / 6, 3 / 6, 5 / 6, 1 / 12], np.float32)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """Vectorized HSV->RGB, hsv (..., 3) in [0,1] (image.hsv2rgb parity)."""
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = np.floor(h * 6.0) % 6
    f = h * 6.0 - np.floor(h * 6.0)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    rgb = np.zeros(hsv.shape, np.float32)
    for idx, (r, g, b) in enumerate([(v, t, p), (q, v, p), (p, v, t),
                                     (p, q, v), (t, p, v), (v, p, q)]):
        m = i == idx
        rgb[..., 0] = np.where(m, r, rgb[..., 0])
        rgb[..., 1] = np.where(m, g, rgb[..., 1])
        rgb[..., 2] = np.where(m, b, rgb[..., 2])
    return rgb


def draw_points(canvas: np.ndarray, points: np.ndarray) -> np.ndarray:
    """canvas (H,W) in [0,1], points (7,H,W). Returns (H,W,3) RGB —
    notebook drawPoints: out = canvas*(Π 1-p_i) + Σ p_i*color_i."""
    out = np.repeat(canvas[..., None], 3, axis=-1)
    for i in range(points.shape[0]):
        p = points[i][..., None]
        out = out * (1 - p) + p * COLORS[i]
    return out


def quantize(sal: np.ndarray, nq: int = 10) -> np.ndarray:
    """Decile quantization per map (notebook cell 4): the top 1/nq of
    nonzero values maps to 1.0, next decile to (nq-1)/nq, ..."""
    out = sal.copy()
    for i in range(out.shape[0]):
        arr = out[i]
        nz = np.sort(arr[arr > 0])[::-1]
        if nz.size == 0:
            continue
        q = arr.copy()
        for j in range(nq, 0, -1):
            th = nz[min(int(np.ceil(nz.size * j / nq)), nz.size) - 1]
            q[arr >= th] = (nq - j + 1) / nq
        out[i] = q
    return out


def draw_saliency(canvas: np.ndarray, sals: np.ndarray) -> np.ndarray:
    """canvas (H,W) binary, sals (7,H,W) quantized. Returns (7,H,W,3)."""
    hsv = np.zeros(sals.shape + (3,), np.float32)
    hsv[..., 0] = HUES[:, None, None]
    hsv[..., 1] = sals
    hsv[..., 2] = canvas[None]
    return hsv_to_rgb(hsv)


def to_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, -1)
    Image.fromarray(arr).resize((arr.shape[1] * 4, arr.shape[0] * 4),
                                Image.NEAREST).save(path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--h5", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ids", type=int, nargs="*", default=None)
    ap.add_argument("--mean", type=float, default=0.1141)
    ap.add_argument("--std", type=float, default=0.2746)
    ap.add_argument("--nq", type=int, default=10)
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    with h5.File(args.h5, "r") as f:
        gids = sorted(f.keys())
        if args.ids is not None:
            gids = [g for g in gids if int(g[2:]) in args.ids]
        for gid in gids:
            g = f[gid]
            if "output" not in g:
                raise SystemExit(f"{args.h5}: {gid} has no 'output'; the renders need a "
                                 "-saliencyDumpStack 1 dump")
            inp = np.asarray(g["input"])[..., 0]        # (H, W)
            points = np.asarray(g["points"])[..., 0]    # (7, H, W)
            output = np.asarray(g["output"])[0][..., 0] # original fwd (H, W)
            sal = np.asarray(g["saliency"])[..., 0]     # (7, H, W)

            # normalize saliency per map, de-normalize + invert input
            sal = sal / (sal.max(axis=(1, 2), keepdims=True) + 1e-12)
            canvas = 1.0 - (inp * args.std + args.mean)
            out_inv = 1.0 - output

            to_png(os.path.join(args.out, f"{gid}_input.png"), canvas)
            to_png(os.path.join(args.out, f"{gid}_points.png"),
                   draw_points(out_inv, points))
            sel = points.copy()
            sel[2:] = 0  # notebook keeps only green+red probes
            to_png(os.path.join(args.out, f"{gid}_points_sel.png"),
                   draw_points(out_inv, sel))
            color = draw_saliency((canvas >= 0.5).astype(np.float32),
                                  quantize(sal, args.nq))
            for k in range(color.shape[0]):
                to_png(os.path.join(args.out, f"{gid}_saliency_{k}.png"),
                       color[k])
            print(gid)
    print(f"renders -> {args.out}")


if __name__ == "__main__":
    main()
