"""Serve a ported net (``models.list_models()``: R-MG-18/34
``ilsvrc/rnmg``, PR-MG-30/52 ``ilsvrc/prnmgseg``, the CIFAR zoo
``cifar/{nmg,rnmg,pnmg,prnmg,resnet,vgg}`` and the cluttered-MNIST nets
``mnist-cluttered/{unet,unmg,pnmg.mnist,prnmg.mnist}``) with the port:
build the net, take weights from an mgtpu-ckpt or a seeded init, fold
BatchNorm into the convs (and the transposed convs), cast their weights
to the compute dtype, and answer ``predict(images)`` with f32 log-probs
(the classifiers) or f32 per-pixel probabilities (the mnist nets).

The torch counterpart of the JAX serving path (`tools/export_model.py`
folds BN and exports; `tools/serve_exported.py` runs the artifact;
`tools/bench_serving.py` times the same graph). On a CUDA device every
3x3/s1 conv and every 2x2 pool runs the hand-written kernels.

    python -m mgtpu_torch.serve --random [--depth 34] [--batches 1 8 32] [--device cuda]
    python -m mgtpu_torch.serve --net cifar/vgg --nLayer 4 --random
    python -m mgtpu_torch.serve --net ilsvrc/prnmgseg --depth 30 --shortcutType A --random
    python -m mgtpu_torch.serve --net mnist-cluttered/unmg --dataset mnist-seg --random
    python -m mgtpu_torch.serve --ckpt run/model_90.ckpt

The net's flags take the JAX package's names (``--depth`` for the
ILSVRC nets, ``--shortcutType`` for ``ilsvrc/prnmgseg``, ``--nLayer``
and ``--isDropout`` where the net has them, ``--dataset``); the images
follow the net (224x224x3 for ILSVRC, 32x32x3 for CIFAR, 64x64x1 for
cluttered MNIST), and a checkpoint names its net. Serves bf16; with
``--int8`` the convs are quantized after the fold (`ops/quant.py`:
int8 kernels and activations, the `conv_i8` kernel on the card), with
static activation scales calibrated over ``--int8Calib N`` batches of
seeded images, or dynamic ones (N = 0). Prints one JSON line per batch
size: output shape, top-1 of the first images (a classifier) or the
range of the probabilities (an mnist net), and the median latency of 5
calls on the named device.

    python -m mgtpu_torch.serve --random --int8 --int8Calib 2 --batches 1 128
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from mgtpu_torch import trace
from mgtpu_torch.models import create_model, get_spec, list_models, net_options
from mgtpu_torch.models.base import NetOpts
from mgtpu_torch.nn import BatchNorm, Conv, ConvTranspose
from mgtpu_torch.ops.fold import fold_batchnorm
from mgtpu_torch.ops.quant import calibrate, quantize_model
from mgtpu_torch.utils.bridge import load_jax_tree, read_mgtpu_ckpt


def image_shape(opt: NetOpts) -> tuple[int, int, int]:
    """The (H, W, C) NHWC images the net of ``opt`` takes: the recipes'
    ``-imageCrop``, and 3 channels or (cluttered MNIST) 1."""
    return get_spec(opt.netType).image_shape


@torch.no_grad()
def calibrate_batchnorm(model: torch.nn.Module, generator: torch.Generator,
                        shape: tuple[int, int, int] = (224, 224, 3),
                        batch: Optional[int] = None) -> None:
    """Stand in for trained BatchNorms in a randomly initialised net:
    draw each BN's affine (scale in [0.5, 1.5), bias N(0, 0.2^2)) and set
    its running mean and (biased) variance to the moments of its input
    over ``batch`` random images of ``shape``, layer by layer in one eval
    forward, as training leaves them. The fold then has real work to do,
    and the activations and logits keep the scale of a trained net; with
    the init's stats (mean 0, var 1) they grow through every residual
    block, to log-probs near -1e6 at R-MG-34's depth 34. By default the
    batch gives each BN at least 64 values a channel on the coarsest grid
    (size / 32): 2 images at 224 px, 64 at 32 px. Fewer leave the 1x1
    grids of the CIFAR nets with the moments of a handful of values,
    which other images overshoot: log-probs reached -2e11 at batch 2.
    At 64 px it is 16 images."""
    if batch is None:
        batch = max(2, -(-64 // max(shape[0] // 32, 1) ** 2))
    bns = [m for m in model.modules() if isinstance(m, BatchNorm) and not m.folded]
    for m in bns:
        m.scale.copy_(torch.rand(m.c, generator=generator) + 0.5)
        m.bias.copy_(0.2 * torch.randn(m.c, generator=generator))

    def set_stats(bn, args):
        xf = args[0].float()
        bn.mean.copy_(xf.mean(dim=(0, 1, 2)))
        bn.var.copy_(xf.var(dim=(0, 1, 2), unbiased=False))

    hooks = [m.register_forward_pre_hook(set_stats) for m in bns]
    try:
        model(torch.randn((batch, *shape), generator=generator))
    finally:
        for h in hooks:
            h.remove()


def read_checkpoint(path: str, opt: NetOpts) -> tuple[dict, NetOpts]:
    """An mgtpu-ckpt (see `read_mgtpu_ckpt`) and the options of the net
    it holds, from its ``meta`` (netType, dataset, nLayer, isDropout,
    depth, shortcutType); what the meta does not name stays as in
    ``opt`` where ``opt`` names the same net, and is the net's default
    otherwise."""
    blob = read_mgtpu_ckpt(path)
    meta = blob["meta"]
    get_spec(meta["netType"])  # a net the port does not have raises here
    if meta["netType"] == opt.netType:
        meta = {**vars(opt), **meta}
    return blob, NetOpts.from_meta(meta)


# images a batch of the int8 calibration (tools/bench_serving.py's)
CALIB_BATCH = 8


class Server:
    """A ported net behind ``predict``: BN folded, conv and transposed
    conv weights in ``compute_dtype`` (biases, the classifier's bias and
    the outputs stay f32), resident on ``device``. ``opt`` names the net
    (default R-MG-34).

    ``ckpt`` is an mgtpu-ckpt written by the JAX trainer, which names
    its net; without it the weights come from ``seed`` (random, with
    calibrated BatchNorms, for smoke tests and timing).

    ``int8``: after the fold, every conv whose kernel is not 2x2 is
    quantized (`mgtpu_torch.ops.quant`, the order of
    `tools/export_model.py`), its activation scales calibrated over
    ``int8_calib`` batches of ``CALIB_BATCH`` seeded normal images
    (static) or, with 0, computed per call (dynamic); images go in as
    f32, since the int8 path quantizes the raw input.

    ``fold_bn`` False keeps the eval-mode BatchNorms as normalize passes
    (`tools/export_model.py`'s ``-no-fold-bn``)."""

    def __init__(self, opt: NetOpts = NetOpts(), ckpt: Optional[str] = None, seed: int = 0,
                 device: str | torch.device = "cuda",
                 compute_dtype: torch.dtype = torch.bfloat16, int8: bool = False,
                 int8_calib: int = 0, fold_bn: bool = True):
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.int8 = int8
        gen = torch.Generator().manual_seed(seed)
        if ckpt is not None:
            blob, opt = read_checkpoint(ckpt, opt)
        self.opt, self.image_shape = net_options(opt), image_shape(opt)
        model = create_model(opt, compute_dtype=compute_dtype, generator=gen)
        if ckpt is not None:
            load_jax_tree(model, blob["params"], blob["stats"])
        else:
            calibrate_batchnorm(model, gen, self.image_shape)
        if fold_bn:
            fold_batchnorm(model)
        if int8:
            quantize_model(model)
        with torch.no_grad():  # cast once, not on every call
            for m in model.modules():
                if isinstance(m, (Conv, ConvTranspose)) and not getattr(m, "quantized", False):
                    m.w.data = m.w.data.to(compute_dtype)
        self.model = model.to(self.device).eval()
        if int8 and int8_calib:
            rng = np.random.default_rng(seed)
            calibrate(self.model, [rng.standard_normal((CALIB_BATCH, *self.image_shape),
                                                       dtype=np.float32)
                                   for _ in range(int8_calib)])

    @torch.inference_mode()
    def predict(self, images) -> torch.Tensor:
        """images (B, H, W, C) NHWC (numpy or torch; ``self.image_shape``)
        -> on ``self.device``, f32 log-probs (B, classes) of a classifier
        or per-pixel probabilities (B, H, W, classes) of an mnist net. Spans
        (`mgtpu_torch.trace`): ``predict``, its ``input`` and ``forward``."""
        with trace.span("predict"):
            with trace.span("input"):
                x = torch.as_tensor(images).to(self.device,
                                               torch.float32 if self.int8 else self.compute_dtype)
                if x.dim() != 4 or tuple(x.shape[1:]) != self.image_shape:
                    raise ValueError(f"expected (B, {', '.join(map(str, self.image_shape))}) "
                                     f"NHWC images, got {tuple(x.shape)}")
                x = x.contiguous()
            with trace.span("forward"):
                return self.model(x)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def add_net_arguments(ap: argparse.ArgumentParser, argv) -> None:
    """``--net`` and, once it is known, the net's own flags (its NetSpec's
    ``arguments``) and ``--dataset``."""
    ap.add_argument("--net", default="ilsvrc/rnmg", choices=list_models(),
                    help="the -netType (a checkpoint names its own)")
    net = ap.parse_known_args(argv)[0].net
    get_spec(net).arguments(ap)
    ap.add_argument("--dataset", default=None,
                    help="cifar10 gives a CIFAR net 10 classes (default: 100); mnist-seg an "
                         "mnist net 10 (default: 1; the net's recipe's dataset)")


def parsed_net_opts(args) -> NetOpts:
    """The NetOpts of ``add_net_arguments``' flags."""
    flags = {k: getattr(args, k) for k in ("depth", "nLayer", "isDropout", "shortcutType")
             if hasattr(args, k)}
    return NetOpts(netType=args.net, dataset=args.dataset, **flags)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", help="mgtpu-ckpt written by the JAX trainer")
    src.add_argument("--random", action="store_true", help="seeded random weights")
    add_net_arguments(ap, argv)
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 32])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--int8", action="store_true",
                    help="serve int8-quantized convs (after the BN fold)")
    ap.add_argument("--int8Calib", type=int, default=0, metavar="N",
                    help="with --int8: static activation scales from N batches of "
                         f"{CALIB_BATCH} seeded images (0: dynamic scales)")
    args = ap.parse_args(argv)

    server = Server(parsed_net_opts(args), ckpt=args.ckpt, device=args.device, int8=args.int8,
                    int8_calib=args.int8Calib if args.int8 else 0)
    dev = server.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    label = get_spec(server.opt.netType).describe(server.opt)
    rng = np.random.default_rng(1)
    for b in args.batches:
        x = torch.from_numpy(rng.standard_normal((b, *server.image_shape), dtype=np.float32))
        y = server.predict(x)  # warm-up
        _sync(dev)
        lat = []
        for _ in range(5):
            t0 = time.perf_counter()
            y = server.predict(x)
            _sync(dev)
            lat.append(time.perf_counter() - t0)
        y = y.float().cpu()
        # a classifier's log-probs (B, classes), or an mnist net's probabilities
        fit = ({"top1_first": y[:5].argmax(-1).tolist()} if y.dim() == 2 else
               {"prob_range": [float(y.min()), float(y.max())]})
        print(json.dumps({
            "net": label, "dtype": ("int8-static" if args.int8Calib else "int8-dynamic")
            if args.int8 else "bf16", "batch": b,
            "device": name, "out_shape": list(y.shape),
            "finite": bool(torch.isfinite(y).all()), **fit,
            "p50_latency_ms": float(np.median(lat)) * 1e3,
        }), flush=True)


if __name__ == "__main__":
    main()
