"""Export a model's forward pass as a ``torch.export`` program (``.pt2``)
for serving without any of the port's model code: the port's
counterpart of `tools/export_model.py`.

The model is built as `mgtpu_torch.serve.Server` builds it (weights from
a checkpoint or a seed, BN folded, int8-quantized and calibrated where
asked, weights cast to the dtype), then ``torch.export.export`` traces
its eval forward at one fixed input shape and ``torch.export.save``
writes the program with the weights inside it. The program's kernels are
the custom ops of `mgtpu_torch.ops.library` (``mgtpu::conv3x3``,
``mgtpu::maxpool2``, ``mgtpu::conv_i8``, ``mgtpu::quant_i8``, ...), so
the serving side needs only that module and `mgtpu_torch.kernels`
(`mgtpu_torch.tools.serve_exported`), which build the kernels at first
use. The program runs on the device it was exported on (``-device``,
default cuda).

Usage:
  python -m mgtpu_torch.tools.export_model -netType ilsvrc/rnmg -depth 34 \\
      -ckpt model_90.ckpt -batch 128 -imageCrop 224 -out rmg34.pt2
  # serving:
  python -m mgtpu_torch.tools.serve_exported rmg34.pt2 images.npy
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def build_server(args):
    """The `Server` the flags describe, calibrated from ``-calib``."""
    from mgtpu_torch.models.base import NetOpts
    from mgtpu_torch.ops.quant import calibrate
    from mgtpu_torch.serve import Server

    shape = {k: getattr(args, k) for k in ("nLayer", "depth") if getattr(args, k) is not None}
    opt = NetOpts(netType=args.netType, nEpochs=200, shortcutType=args.shortcutType, **shape)
    server = Server(opt, ckpt=args.ckpt, seed=0, device=args.device,
                    compute_dtype=_DTYPES[args.dtype], int8=args.int8, fold_bn=args.fold_bn)
    if args.int8 and args.calib:
        cal = np.load(args.calib)
        if cal.ndim != 4:
            raise SystemExit(f"-calib expects NHWC images, got {cal.shape}")
        calibrate(server.model, [cal.astype(np.float32)])
    return server


def export(server, batch: int, crop: int, channels: int):
    """The ``torch.export`` program of ``server``'s forward on (batch,
    crop, crop, channels) images of the dtype its ``predict`` takes."""
    x = torch.zeros((batch, crop, crop, channels), device=server.device,
                    dtype=torch.float32 if server.int8 else server.compute_dtype)
    with torch.no_grad():
        return torch.export.export(server.model, (x,), strict=False)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-netType", required=True)
    ap.add_argument("-ckpt", default=None, help="checkpoint; random init if omitted")
    ap.add_argument("-batch", type=int, default=128)
    ap.add_argument("-imageCrop", type=int, default=224)
    ap.add_argument("-channels", type=int, default=3)
    ap.add_argument("-dtype", default="bfloat16", choices=list(_DTYPES))
    ap.add_argument("-nLayer", type=int, default=None)
    ap.add_argument("-depth", type=int, default=None)
    ap.add_argument("-shortcutType", default="A")
    ap.add_argument("-out", required=True)
    ap.add_argument("-allow-pickle", dest="allow_pickle", action="store_true",
                    help="refused: the port reads mgtpu-ckpt archives only and never unpickles")
    ap.add_argument("-int8", dest="int8", action="store_true",
                    help="post-training-quantize the conv kernels before export "
                         "(mgtpu_torch/ops/quant.py): int8 weights in the artifact, the "
                         "conv_i8 and quant_i8 kernels at serve time")
    ap.add_argument("-calib", default=None,
                    help="with -int8: .npy of NHWC calibration images; freezes static "
                         "activation scales into the artifact (without it the scales are "
                         "computed on every call)")
    ap.add_argument("-no-fold-bn", dest="fold_bn", action="store_false",
                    help="keep eval-mode BatchNorm as normalize passes instead of folding "
                         "it into the conv weights (mgtpu_torch/ops/fold.py; folding is "
                         "exact and default-on for this inference-only export)")
    ap.add_argument("-device", default="cuda",
                    help="the device the program is traced and served on (default cuda)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.allow_pickle:
        raise SystemExit("-allow-pickle: the port never unpickles a checkpoint "
                         "(pickle checkpoints are not read)")

    server = build_server(args)
    program = export(server, args.batch, args.imageCrop, args.channels)
    program.example_inputs = None  # the traced zeros are not part of the program
    torch.export.save(program, args.out)
    kind = f"{args.dtype}+int8" if args.int8 else args.dtype
    if args.fold_bn:
        kind += "+foldBN"
    dev = server.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"exported {args.netType} fwd (batch {args.batch}, {kind}) -> {args.out} "
          f"({os.path.getsize(args.out) / 1e6:.1f} MB, device {name})")


if __name__ == "__main__":
    main()
