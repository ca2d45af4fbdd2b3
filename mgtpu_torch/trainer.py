"""Train R-MG-18/34 (``ilsvrc/rnmg``) with the port: f32 master weights,
conv operands in the compute dtype (bf16 by default), BatchNorm,
log-softmax and loss in f32, SGD with momentum 0.9 and coupled weight
decay. On a CUDA device every 3x3 exchange conv, every BN-ReLU-conv
prologue and every 2x2 pool, forward and backward, runs the
hand-written kernels.

Stands in for ``python -m mgtpu.main -netType ilsvrc/rnmg -data
synthetic -train`` until the CLI is ported:

    python -m mgtpu_torch.trainer --random [--depth 34] [--batch 128] [--steps 3] [--device cuda]
    python -m mgtpu_torch.trainer --ckpt run/model_1.ckpt

Trains on one fixed synthetic batch (normal images, uniform labels, from
``--seed``) at the epoch-1 rate of ``imagenet_rule``, and prints one JSON
line per step: loss, top-1, top-5 and the step's wall time on the named
device.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from mgtpu_torch.models import get_net, get_spec
from mgtpu_torch.serve import IMAGE_SHAPE, NET, read_checkpoint
from mgtpu_torch.train.optim import sgd_init
from mgtpu_torch.train.step import make_train_step
from mgtpu_torch.utils.bridge import load_jax_tree, load_momentum


class Trainer:
    """R-MG-``depth`` in train mode on ``device`` with its SGD state.

    ``ckpt`` is an mgtpu-ckpt written by the JAX trainer (parameters,
    BN stats and, when it holds one, the momentum); without it the
    weights come from ``seed``. ``iter_size`` > 1 splits each batch into
    that many micro-batches and averages their gradients."""

    def __init__(self, depth: int = 34, ckpt: Optional[str] = None, seed: int = 0,
                 device: str | torch.device = "cuda",
                 compute_dtype: torch.dtype = torch.bfloat16, iter_size: int = 1):
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.iter_size = iter_size
        blob = None
        if ckpt is not None:
            blob, depth = read_checkpoint(ckpt, depth)
        model = get_net(NET)(depth=depth, compute_dtype=compute_dtype,
                             generator=torch.Generator().manual_seed(seed))
        if blob is not None:
            load_jax_tree(model, blob["params"], blob["stats"])
        self.depth = depth
        self.model = model.to(self.device).train()
        if blob is not None and blob["opt_state"] is not None:
            self.opt_state = load_momentum(self.model, blob["opt_state"])
        else:
            self.opt_state = sgd_init(self.model.parameters())
        self.net = get_spec(NET)
        self._step = make_train_step(self.model, self.net.create_loss(None), self.net,
                                     iter_size=iter_size)

    def step(self, images, labels, lr: float, wd: float) -> dict:
        """One SGD step on images (B, 224, 224, 3) NHWC and int labels
        (B,) (numpy or torch). Returns the metrics as 0-dim f32 tensors
        on the device (no host sync)."""
        x = torch.as_tensor(images).to(self.device, self.compute_dtype)
        y = torch.as_tensor(labels).to(self.device, torch.int64)
        if x.dim() != 4 or tuple(x.shape[1:]) != IMAGE_SHAPE or y.shape != x.shape[:1]:
            raise ValueError(f"expected (B, {', '.join(map(str, IMAGE_SHAPE))}) NHWC images "
                             f"and (B,) labels, got {tuple(x.shape)} and {tuple(y.shape)}")
        if self.iter_size > 1:
            x = x.reshape(self.iter_size, -1, *IMAGE_SHAPE)
            y = y.reshape(self.iter_size, -1)
        return self._step(self.opt_state, {"x": x.contiguous(), "y": y}, lr, wd)


def synthetic_batch(batch: int, seed: int, n_classes: int = 1000):
    """Normal images and uniform labels, as the JAX bench makes them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, *IMAGE_SHAPE), dtype=np.float32)
    return x, rng.integers(0, n_classes, batch)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", help="mgtpu-ckpt written by the JAX trainer")
    src.add_argument("--random", action="store_true", help="seeded random weights")
    ap.add_argument("--depth", type=int, default=34, choices=(18, 34),
                    help="with --random (a checkpoint names its depth)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    trainer = Trainer(args.depth, ckpt=args.ckpt, seed=args.seed, device=args.device)
    dev = trainer.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rule = trainer.net.train_rule(1, None)
    x, y = synthetic_batch(args.batch, args.seed + 1)
    for i in range(args.steps):
        t0 = time.perf_counter()
        m = trainer.step(x, y, rule["lr"], rule["wd"])
        m = {k: float(v) for k, v in m.items()}  # waits for the step
        ms = (time.perf_counter() - t0) * 1e3
        print(json.dumps({"net": f"{NET} depth {trainer.depth}", "dtype": "bf16",
                          "batch": args.batch, "step": i, "device": name, **m,
                          "step_ms": ms}), flush=True)


if __name__ == "__main__":
    main()
