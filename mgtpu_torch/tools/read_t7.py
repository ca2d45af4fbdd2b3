"""Inspect and convert Torch7 `.t7` blobs (reference artifacts): the
port's counterpart of `tools/read_t7.py`.

The reference pipeline's canonical data artifacts are torch.save files:
`cifar100_whitened.t7` (`dataset/cifar100-whitened/dataset.lua:44`),
`mnist_<task>.t7` (`utils/mnist-cluttered/segmentation.lua:66-70`) and
the raw `mnist/{train,valid,test}.t7` (`download_mnist.lua:107-163`).
This tool reads any of them with `mgtpu_torch.utils.t7` and either
prints the structure or converts to the .npz formats that
`mgtpu_torch/data/` reads:

  python -m mgtpu_torch.tools.read_t7 blob.t7                     # inspect
  python -m mgtpu_torch.tools.read_t7 blob.t7 --to-npz out.npz    # generic dump
  python -m mgtpu_torch.tools.read_t7 cifar100_whitened.t7 \
      --format cifar --to-npz cifar100_whitened.npz        # -> data/cifar.py
  python -m mgtpu_torch.tools.read_t7 mnist_segmentation.t7 \
      --format mnist-task --to-npz mnist_segmentation.npz  # -> data/mnist.py

Model checkpoints (`model_<EPOCH>.t7`) are handled by
`mgtpu_torch.tools.import_t7_model`. No device is used.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mgtpu_torch.utils import t7


def describe(obj, name="root", indent=0, file=sys.stdout):
    pad = "  " * indent
    if isinstance(obj, np.ndarray):
        print(f"{pad}{name}: tensor {obj.dtype} {tuple(obj.shape)}", file=file)
    elif isinstance(obj, t7.TorchObject):
        print(f"{pad}{name}: {obj.torch_type}", file=file)
        for k, v in obj.fields.items():
            describe(v, str(k), indent + 1, file)
    elif isinstance(obj, dict):
        print(f"{pad}{name}: table ({len(obj)} keys)", file=file)
        for k, v in obj.items():
            describe(v, str(k), indent + 1, file)
    elif isinstance(obj, list):
        print(f"{pad}{name}: list ({len(obj)})", file=file)
        for i, v in enumerate(obj):
            describe(v, f"[{i + 1}]", indent + 1, file)
    elif isinstance(obj, t7.TorchFunction):
        print(f"{pad}{name}: function ({len(obj.dumped)} bytes bytecode)", file=file)
    else:
        print(f"{pad}{name}: {obj!r}", file=file)


def collect_tensors(obj, prefix="", out=None, seen=None):
    """Flatten every tensor to a dotted-path key for the generic dump."""
    out = {} if out is None else out
    seen = set() if seen is None else seen
    if id(obj) in seen:
        return out
    if isinstance(obj, np.ndarray):
        out[prefix or "tensor"] = obj
    elif isinstance(obj, (dict, list, t7.TorchObject)):
        seen.add(id(obj))
        if isinstance(obj, t7.TorchObject):
            items = obj.fields.items()
        elif isinstance(obj, dict):
            items = obj.items()
        else:
            items = ((i + 1, v) for i, v in enumerate(obj))
        for k, v in items:
            key = f"{prefix}.{k}" if prefix else str(k)
            collect_tensors(v, key, out, seen)
    return out


def _nchw_to_nhwc(x: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(x.transpose(0, 2, 3, 1).astype(np.float32))


def convert_cifar(obj) -> dict:
    """{trainData={data,labels}, testData={...}} -> the keys
    mgtpu_torch/data/cifar.py loads (labels stay 1-based; the loader's
    `trl.min() >= 1` shift handles torch indexing)."""
    out = {}
    for src, dst in (("trainData", "train"), ("testData", "test")):
        split = obj[src]
        data = np.asarray(split["data"])
        labels = np.asarray(split["labels"]).reshape(-1).astype(np.int32)
        if data.ndim == 2:  # (N, 3072) flat CHW
            data = data.reshape(-1, 3, 32, 32)
        out[f"{dst}_data"] = _nchw_to_nhwc(data)
        out[f"{dst}_labels"] = labels
    return out


def convert_mnist_task(obj) -> dict:
    """{train,val,test}{data,labels} (NCHW) -> the
    mnist_<task>.npz keys mgtpu_torch/data/mnist.py loads (NHWC; the blob's
    'val' split becomes 'valid_*', feeding -eval)."""
    out = {}
    names = {"train": "train", "val": "valid", "valid": "valid", "test": "test"}
    for src, dst in names.items():
        if src not in obj:
            continue
        split = obj[src]
        out[f"{dst}_inputs"] = _nchw_to_nhwc(np.asarray(split["data"]))
        out[f"{dst}_targets"] = _nchw_to_nhwc(np.asarray(split["labels"]))
    if not out:
        raise SystemExit("no train/val/test splits found in this blob")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path")
    ap.add_argument("--to-npz", default=None, metavar="OUT")
    ap.add_argument("--format", default="generic",
                    choices=["generic", "cifar", "mnist-task"])
    ap.add_argument("--ascii", action="store_true",
                    help="force ascii decoding (default: sniff)")
    args = ap.parse_args(argv)

    obj = t7.load(args.path, ascii_mode=True if args.ascii else None)
    if args.to_npz is None:
        describe(obj, os.path.basename(args.path))
        return
    if args.format == "cifar":
        arrays = convert_cifar(obj)
    elif args.format == "mnist-task":
        arrays = convert_mnist_task(obj)
    else:
        arrays = collect_tensors(obj)
        if not arrays:
            raise SystemExit("no tensors found in this blob")
    np.savez_compressed(args.to_npz, **arrays)
    print(f"wrote {args.to_npz}: " + ", ".join(
        f"{k} {v.dtype}{tuple(v.shape)}" for k, v in arrays.items()))


if __name__ == "__main__":
    main()
