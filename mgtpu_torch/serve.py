"""Serve R-MG-18/34 (``ilsvrc/rnmg``) with the port: build the net, take
weights from an mgtpu-ckpt or a seeded init, fold BatchNorm into the
convs, cast the conv weights to the compute dtype, and answer
``predict(images)`` with f32 log-probs.

The torch counterpart of the JAX serving path (`tools/export_model.py`
folds BN and exports; `tools/serve_exported.py` runs the artifact;
`tools/bench_serving.py` times the same graph). On a CUDA device every
3x3 exchange conv and every 2x2 pool runs the hand-written kernels.

    python -m mgtpu_torch.serve --random [--depth 34] [--batches 1 8 32] [--device cuda]
    python -m mgtpu_torch.serve --ckpt run/model_90.ckpt

Serves bf16. Prints one JSON line per batch size: output shape, top-1 of
the first images, and the median latency of 5 calls on the named
device.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from mgtpu_torch.models import get_net
from mgtpu_torch.nn import BatchNorm, Conv
from mgtpu_torch.ops.fold import fold_batchnorm
from mgtpu_torch.utils.bridge import load_jax_tree, read_mgtpu_ckpt

NET = "ilsvrc/rnmg"
IMAGE_SHAPE = (224, 224, 3)


@torch.no_grad()
def calibrate_batchnorm(model: torch.nn.Module, generator: torch.Generator,
                        batch: int = 2) -> None:
    """Stand in for trained BatchNorms in a randomly initialised net:
    draw each BN's affine (scale in [0.5, 1.5), bias N(0, 0.2^2)) and set
    its running mean and (biased) variance to the moments of its input
    over ``batch`` random images, layer by layer in one eval forward, as
    training leaves them. The fold then has real work to do, and the
    activations and logits keep the scale of a trained net; with the
    init's stats (mean 0, var 1) they grow through every residual block,
    to log-probs near -1e6 at depth 34."""
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
        model(torch.randn((batch, *IMAGE_SHAPE), generator=generator))
    finally:
        for h in hooks:
            h.remove()


class Server:
    """R-MG-``depth`` behind ``predict``: BN folded, conv weights in
    ``compute_dtype`` (biases, the classifier's bias and the log-probs
    stay f32), resident on ``device``.

    ``ckpt`` is an mgtpu-ckpt written by the JAX trainer; without it the
    weights come from ``seed`` (random, with calibrated BatchNorms, for
    smoke tests and timing)."""

    def __init__(self, depth: int = 34, ckpt: Optional[str] = None, seed: int = 0,
                 device: str | torch.device = "cuda",
                 compute_dtype: torch.dtype = torch.bfloat16):
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        gen = torch.Generator().manual_seed(seed)
        if ckpt is not None:
            blob = read_mgtpu_ckpt(ckpt)
            meta = blob["meta"]
            if meta.get("netType", NET) != NET:
                raise ValueError(f"{ckpt} holds a {meta['netType']!r}, not {NET!r}")
            depth = int(meta.get("depth", depth))
        model = get_net(NET)(depth=depth, compute_dtype=compute_dtype, generator=gen)
        if ckpt is not None:
            load_jax_tree(model, blob["params"], blob["stats"])
        else:
            calibrate_batchnorm(model, gen)
        fold_batchnorm(model)
        with torch.no_grad():  # cast once, not on every call
            for m in model.modules():
                if isinstance(m, Conv):
                    m.w.data = m.w.data.to(compute_dtype)
        self.depth = depth
        self.model = model.to(self.device).eval()

    @torch.inference_mode()
    def predict(self, images) -> torch.Tensor:
        """images (B, 224, 224, 3) NHWC (numpy or torch) -> log-probs
        (B, 1000) f32, on ``self.device``."""
        x = torch.as_tensor(images).to(self.device, self.compute_dtype)
        if x.dim() != 4 or tuple(x.shape[1:]) != IMAGE_SHAPE:
            raise ValueError(f"expected (B, {', '.join(map(str, IMAGE_SHAPE))}) NHWC "
                             f"images, got {tuple(x.shape)}")
        return self.model(x.contiguous())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", help="mgtpu-ckpt written by the JAX trainer")
    src.add_argument("--random", action="store_true", help="seeded random weights")
    ap.add_argument("--depth", type=int, default=34, choices=(18, 34),
                    help="with --random (a checkpoint names its depth)")
    ap.add_argument("--batches", type=int, nargs="+", default=[1, 8, 32])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    server = Server(args.depth, ckpt=args.ckpt, device=args.device)
    dev = server.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rng = np.random.default_rng(1)
    for b in args.batches:
        x = torch.from_numpy(rng.standard_normal((b, *IMAGE_SHAPE), dtype=np.float32))
        y = server.predict(x)  # warm-up
        _sync(dev)
        lat = []
        for _ in range(5):
            t0 = time.perf_counter()
            y = server.predict(x)
            _sync(dev)
            lat.append(time.perf_counter() - t0)
        y = y.float().cpu()
        print(json.dumps({
            "net": f"{NET} depth {server.depth}", "dtype": "bf16", "batch": b,
            "device": name, "out_shape": list(y.shape),
            "finite": bool(torch.isfinite(y).all()),
            "top1_first": y[:5].argmax(-1).tolist(),
            "p50_latency_ms": float(np.median(lat)) * 1e3,
        }), flush=True)


if __name__ == "__main__":
    main()
