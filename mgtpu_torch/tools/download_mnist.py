"""MNIST ingest: the port's counterpart of `tools/download_mnist.py`, the
rebuild of `utils/mnist-cluttered/download_mnist.lua`: parse the
big-endian IDX files and save mnist.npz with train/valid/test splits of
50k/10k/10k (`download_mnist.lua:42-176`).

On a networked machine ``--fetch`` downloads the four .gz files from the
usual mirror first; on a machine with no network place them (or the
unpacked idx files) under ``--src`` yourself.

    python -m mgtpu_torch.tools.download_mnist --src mnist_raw/ --out mnist.npz

Imports neither torch nor the JAX package.
"""

from __future__ import annotations

import argparse
import gzip
import os
import struct

import numpy as np

FILES = {
    "train_images": "train-images-idx3-ubyte",
    "train_labels": "train-labels-idx1-ubyte",
    "test_images": "t10k-images-idx3-ubyte",
    "test_labels": "t10k-labels-idx1-ubyte",
}
URLS = "https://storage.googleapis.com/cvdf-datasets/mnist/"


def read_idx(path: str) -> np.ndarray:
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rb") as f:
        data = f.read()
    magic, = struct.unpack(">i", data[:4])
    ndim = magic % 256
    dims = struct.unpack(f">{ndim}i", data[4:4 + 4 * ndim])
    arr = np.frombuffer(data, np.uint8, offset=4 + 4 * ndim)
    return arr.reshape(dims)


def find(src: str, base: str) -> str:
    for cand in (os.path.join(src, base), os.path.join(src, base + ".gz")):
        if os.path.isfile(cand):
            return cand
    raise FileNotFoundError(f"{base}[.gz] not found under {src}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default="mnist_raw", help="dir with idx[.gz] files")
    ap.add_argument("--out", default="mnist.npz")
    ap.add_argument("--fetch", action="store_true", help="try downloading first")
    args = ap.parse_args(argv)

    if args.fetch:
        import urllib.request

        os.makedirs(args.src, exist_ok=True)
        for base in FILES.values():
            dst = os.path.join(args.src, base + ".gz")
            if not os.path.exists(dst):
                print("fetching", base)
                urllib.request.urlretrieve(URLS + base + ".gz", dst)

    tri = read_idx(find(args.src, FILES["train_images"]))
    trl = read_idx(find(args.src, FILES["train_labels"]))
    tei = read_idx(find(args.src, FILES["test_images"]))
    tel = read_idx(find(args.src, FILES["test_labels"]))

    # 50k/10k/10k split (`download_mnist.lua`)
    out = dict(
        train_images=tri[:50000], train_labels=trl[:50000],
        valid_images=tri[50000:], valid_labels=trl[50000:],
        test_images=tei, test_labels=tel,
    )
    np.savez_compressed(args.out, **out)
    print(f"wrote {args.out}: " + ", ".join(f"{k}={v.shape}" for k, v in out.items()))


if __name__ == "__main__":
    main()
