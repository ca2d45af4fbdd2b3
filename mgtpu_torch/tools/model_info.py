"""Model analysis: parameter and multiply-add counts per netType, the
port's counterpart of `tools/model_info.py`.

The reference README publishes params/FLOPs tables (`README.md:85-92,
105-109`; the "FLOPs" column counts multiply-adds). This tool derives
both from the port's built model, counting the modules of one batch-1
eval forward on ``-device`` (default cuda) as they are called:

  macs_per_image          the reference formulation: each exchange conv
                          (`ConvBN.conv_parts`) as one dense conv over
                          the materialized resample-concat, k*k taps of
                          all its input channels at every output pixel;
                          each other Conv, ConvTranspose and Dense as
                          output elements x taps. This is what the JAX
                          tool counts under MGTPU_NO_FUSED_EXCHANGE=1,
                          and the published 5.76 G of R-MG-34.
  macs_per_image_as_run   the convs and products the port's forward
                          runs: each exchange part over its channel
                          slice as `ConvBN.conv_parts` runs it (an
                          exact-2x up part under a 3x3 conv as the 4x4/2
                          transposed conv of `nn._conv_up3`, a 1x1 up
                          part at the coarse resolution, every other part
                          at the output's), the rest as above but the
                          transposed convs, counted by their inputs'
                          pixels (the zero phases of the dilation are not
                          run).

Usage:
  python -m mgtpu_torch.tools.model_info -netType cifar/nmg -nLayer 1 [-imageCrop 32]
  python -m mgtpu_torch.tools.model_info -netType ilsvrc/rnmg -depth 34 -imageCrop 224
  python -m mgtpu_torch.tools.model_info --all-cifar [-device cpu]

One JSON line per net.
"""

from __future__ import annotations

import argparse
import json
import math

import torch


def _numel(shape) -> int:
    return math.prod(int(s) for s in shape)


def _part_macs(m, parts, y) -> int:
    """Multiply-adds of ``m.conv_parts(parts)`` (output ``y``) as it
    runs, part by part (eval mode: no dropout)."""
    conv = m.conv
    co, (oh, ow) = y.shape[3], y.shape[1:3]
    is3x3 = m.k == 3 and conv.stride == 1 and conv.pad == 1
    macs = 0
    for kind, xp in parts:
        n, h, w, c = (xp[0] if isinstance(xp, tuple) else xp).shape
        if kind == "up" and is3x3 and (oh, ow) == (2 * h, 2 * w):
            macs += n * h * w * c * co * 16  # the 4x4/2 transposed conv
        elif kind == "up" and m.k == 1 and conv.stride == 1 and conv.pad == 0:
            macs += n * h * w * c * co  # the 1x1 conv at the coarse resolution
        else:
            macs += n * oh * ow * co * m.k * m.k * c
    return macs


class Counts:
    """The multiply-adds of the forwards run while it is open, in both
    formulations (``reference``, ``as_run``): ``ConvBN.conv_parts`` of
    each ConvBN wrapped on the instance, forward hooks on the other
    convs and products; `close` restores the model."""

    def __init__(self, model):
        from mgtpu_torch.nn import Conv, ConvBN, ConvTranspose, Dense

        self.reference = self.as_run = 0
        self.wrapped = [m for m in model.modules() if isinstance(m, ConvBN)]
        for m in self.wrapped:
            m.conv_parts = self._conv_parts(m)
        # (reference taps an output element, as-run taps an output element)
        taps = {Conv: lambda m: (m.k * m.k * m.c_in,) * 2,
                ConvTranspose: lambda m: (4 * m.w.shape[2], m.w.shape[2]),  # 2x2/2 over Ci
                Dense: lambda m: (m.w.shape[0],) * 2}
        self.hooks = [m.register_forward_hook(self._hook(*fn(m)))
                      for m in model.modules() for cls, fn in taps.items() if type(m) is cls]

    def _conv_parts(self, m):
        run = type(m).conv_parts.__get__(m)

        def counted(parts, **kw):  # kw: a residual's shortcut and ReLU (y_in, relu)
            y = run(parts, **kw)
            self.reference += _numel(y.shape) * m.k * m.k * m.conv.c_in
            self.as_run += _part_macs(m, parts, y)
            return y

        return counted

    def _hook(self, reference, as_run):
        def hook(module, args, y):
            self.reference += _numel(y.shape) * reference
            self.as_run += _numel(y.shape) * as_run
        return hook

    def close(self):
        for m in self.wrapped:
            del m.conv_parts
        for h in self.hooks:
            h.remove()


def model_info(net_type: str, crop: int, device="cuda", **model_opts) -> dict:
    from mgtpu_torch.models import create_model, get_spec
    from mgtpu_torch.models.base import NetOpts
    from mgtpu_torch.nn import param_count

    opt = NetOpts(netType=net_type, nEpochs=200, **model_opts)
    device = torch.device(device)
    model = create_model(opt, device=device).eval()
    x = torch.zeros((1, crop, crop, get_spec(net_type).image_shape[2]), device=device)
    count = Counts(model)
    try:
        with torch.no_grad():
            model(x)
    finally:
        count.close()
    return {
        "netType": net_type,
        **{k: v for k, v in model_opts.items() if v is not None},
        "input": crop,
        "params": param_count(model),
        "macs_per_image": count.reference,
        "formulation": "reference",
        "macs_per_image_as_run": count.as_run,
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("-netType", default=None)
    ap.add_argument("-nLayer", type=int, default=None)
    ap.add_argument("-depth", type=int, default=None)
    ap.add_argument("-shortcutType", default="B",
                    help="matches ilsvrc/prnmgseg's training default")
    ap.add_argument("-imageCrop", type=int, default=32)
    ap.add_argument("-device", default="cuda", help="where the model is built (default cuda)")
    ap.add_argument("--all-cifar", action="store_true")
    args = ap.parse_args(argv)

    if args.all_cifar:
        for nt in ("cifar/nmg", "cifar/rnmg"):
            for nl in (1, 2, 3, 4):
                print(json.dumps(model_info(nt, 32, args.device, nLayer=nl)), flush=True)
        return
    if args.netType is None:
        ap.error("-netType or --all-cifar is required")
    kw = {}
    if args.nLayer is not None:
        kw["nLayer"] = args.nLayer
    if args.depth is not None:
        kw["depth"] = args.depth
    kw["shortcutType"] = args.shortcutType
    print(json.dumps(model_info(args.netType, args.imageCrop, args.device, **kw)))


if __name__ == "__main__":
    main()
