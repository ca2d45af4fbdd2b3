"""Run a ``.pt2`` program written by `mgtpu_torch.tools.export_model`:
the minimal serving side, with none of the port's model code on the
path (it imports `mgtpu_torch.ops.library`, which registers the
``mgtpu::`` kernel ops the program calls, and through it
`mgtpu_torch.kernels`, which builds the kernels at first use). The
port's counterpart of `tools/serve_exported.py`.

Usage:
  python -m mgtpu_torch.tools.serve_exported model.pt2 images.npy [--out preds.npy]
  python -m mgtpu_torch.tools.serve_exported model.pt2 --random  # smoke

The program runs on the device it was exported on; ``-device`` (default
cuda) must name it.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from mgtpu_torch.ops import library  # noqa: F401 (registers the mgtpu:: ops)


def load(path: str, device: str | torch.device = "cuda"):
    """(the program's forward, the (shape, dtype) of the images it
    takes) of the ``.pt2`` at ``path``; raises unless it was exported on
    ``device``'s type."""
    program = torch.export.load(path)
    (spec,) = [node.meta["val"] for node in program.graph.nodes
               if node.op == "placeholder"
               and node.name in program.graph_signature.user_inputs]
    device = torch.device(device)
    if spec.device.type != device.type:
        raise SystemExit(f"{path} was exported on {spec.device.type}, not {device.type}: "
                         f"export it with -device {device.type}")
    return program.module(), (tuple(spec.shape), spec.dtype)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("artifact")
    ap.add_argument("images", nargs="?", default=None)
    ap.add_argument("--random", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("-device", default="cuda")
    args = ap.parse_args(argv)

    forward, (shape, dtype) = load(args.artifact, args.device)
    device = torch.device(args.device)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"artifact expects {shape} {dtype}, on {name}")
    if args.random or args.images is None:
        x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    else:
        x = np.load(args.images)
    with torch.no_grad():
        y = forward(torch.as_tensor(x).to(device, dtype)).float().cpu().numpy()
    print(f"output {y.shape} {y.dtype}; top-1 of first 5: {y[:5].argmax(-1)}")
    if args.out:
        np.save(args.out, y)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
