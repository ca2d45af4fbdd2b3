"""Train a ported net (any of ``models.list_models()``, as
`mgtpu_torch.serve` lists them) with the port: f32 master weights, conv
operands in the compute dtype (bf16 by default), BatchNorm, log-softmax
or sigmoid, and the loss (NLL, or BCE for the mnist nets) in f32, SGD
with momentum 0.9 and coupled weight decay. On a CUDA device every
3x3/s1 conv, every BN-ReLU-conv prologue and every 2x2 pool, forward and
backward, runs the hand-written kernels.

A quick way to step a net on the card; the recipes run through
``python -m mgtpu_torch.main`` (the JAX CLI's flags, its data layer and
epochs):

    python -m mgtpu_torch.trainer --random [--depth 34] [--batch 128] [--steps 3] [--device cuda]
    python -m mgtpu_torch.trainer --net cifar/prnmg --random --batch 64 --iterSize 2
    python -m mgtpu_torch.trainer --net ilsvrc/prnmgseg --depth 30 --shortcutType A --random \
        --batch 16 --iterSize 16
    python -m mgtpu_torch.trainer --net mnist-cluttered/unmg --dataset mnist-seg --random --batch 64
    python -m mgtpu_torch.trainer --ckpt run/model_1.ckpt

The net's flags take the JAX package's names, as in
`mgtpu_torch.serve`; as the JAX CLI's ``-batchSize`` and ``-iterSize``,
``--batch`` is a micro-batch and a step takes ``--iterSize`` of them
(``--batch 64 --iterSize 2``: 128 images a step). Trains on one fixed
synthetic batch (normal images and uniform labels, or {0, 1} targets of
the output's shape for an mnist net, from ``--seed``) at the epoch-1
rate of the net's LR rule, and prints one JSON line per step: the net's
metrics and the step's wall time on the named device.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import numpy as np
import torch

from mgtpu_torch.models import create_model, get_spec, net_options
from mgtpu_torch.models.base import NetOpts
from mgtpu_torch.parallel import make_mesh, replicate, shard_batch, shard_params_tp
from mgtpu_torch.serve import add_net_arguments, image_shape, parsed_net_opts, read_checkpoint
from mgtpu_torch.train.optim import sgd_init
from mgtpu_torch.train.step import make_train_step
from mgtpu_torch.utils.bridge import load_jax_tree, load_momentum


class Trainer:
    """A ported net in train mode on ``device`` with its SGD state.
    ``opt`` names the net (default R-MG-34).

    ``ckpt`` is an mgtpu-ckpt written by the JAX trainer (parameters,
    BN stats and, when it holds one, the momentum), which names its net;
    without it the weights come from ``seed``, as do the dropout masks.
    ``iter_size`` > 1 splits each batch into that many micro-batches and
    averages their gradients. ``remat`` runs each micro-batch's forward
    again in the backward instead of keeping its activations
    (`mgtpu_torch.train.step.make_train_step`): the same values, less
    memory. ``mesh`` (`mgtpu_torch.parallel.make_mesh`, of several
    ranks; each rank builds its Trainer with its own): data parallelism,
    the model on ``mesh.device`` as rank 0's replica, each step on this
    rank's rows of the batch every rank passes, BatchNorm over the
    global batch. A mesh with a second axis (``make_mesh(n_data, rank,
    ..., n_model=M, model_axis="model" | "tensor")``): -spatial, each
    step also on this rank's part of the images' height; -tensor, the
    parameters, running stats and momentum held as this rank's channel
    slices (`parallel.shard_params_tp`)."""

    def __init__(self, opt: NetOpts = NetOpts(), ckpt: Optional[str] = None, seed: int = 0,
                 device: str | torch.device = "cuda",
                 compute_dtype: torch.dtype = torch.bfloat16, iter_size: int = 1,
                 remat: bool = False, mesh=None):
        self.mesh = mesh if mesh is not None else make_mesh(device=device)
        self.device = self.mesh.device
        self.compute_dtype = compute_dtype
        self.iter_size = iter_size
        blob = None
        if ckpt is not None:
            blob, opt = read_checkpoint(ckpt, opt)
        self.opt, self.image_shape = net_options(opt), image_shape(opt)
        self.net = get_spec(opt.netType)
        self.target_shape = self.net.target_shape(opt)
        model = create_model(opt, compute_dtype=compute_dtype,
                             generator=torch.Generator().manual_seed(seed))
        if blob is not None:
            load_jax_tree(model, blob["params"], blob["stats"])
        self.model = replicate(self.mesh, model.to(self.device)).train()
        if blob is not None and blob["opt_state"] is not None:
            self.opt_state = load_momentum(self.model, blob["opt_state"])
        else:
            self.opt_state = sgd_init(self.model.parameters())
        self.spatial = self.mesh.n_model > 1 and self.mesh.axis == "model"
        tensor = self.mesh.n_model > 1 and self.mesh.axis == "tensor"
        self.opt_state = shard_params_tp(self.mesh, self.model, self.opt_state)
        self._step = make_train_step(self.model, self.net.create_loss(opt), self.net,
                                     iter_size=iter_size, remat=remat, mesh=self.mesh,
                                     bucket_sgd=not tensor)

    def step(self, images, labels, lr: float, wd: float) -> dict:
        """One SGD step on images (B, H, W, C) NHWC (``self.image_shape``)
        and their targets (numpy or torch): int labels (B,) for a
        classifier, f32 {0, 1} targets (B, *``self.target_shape``) of the
        output's shape for an mnist net. Returns the metrics as 0-dim f32
        tensors on the device (no host sync). Under a ``mesh`` every rank
        passes the global batch and steps on its rows."""
        x, y = torch.as_tensor(images), torch.as_tensor(labels)
        shape = self.image_shape
        if (x.dim() != 4 or tuple(x.shape[1:]) != shape
                or tuple(y.shape) != (x.shape[0], *self.target_shape)):
            raise ValueError(f"expected (B, {', '.join(map(str, shape))}) NHWC images and "
                             f"(B, {', '.join(map(str, self.target_shape))}) targets, got "
                             f"{tuple(x.shape)} and {tuple(y.shape)}")
        if self.iter_size > 1:
            x = x.reshape(self.iter_size, -1, *shape)
            y = y.reshape(self.iter_size, -1, *self.target_shape)
        batch = shard_batch(self.mesh, {"x": x, "y": y}, 1 if self.iter_size > 1 else 0,
                            spatial=self.spatial)
        x = batch["x"].to(self.device, self.compute_dtype).contiguous()
        y = batch["y"].to(self.device, torch.float32 if self.target_shape else torch.int64)
        return self._step(self.opt_state, {"x": x, "y": y}, lr, wd)


def synthetic_batch(batch: int, seed: int, n_classes: int = 1000,
                    shape: tuple[int, int, int] = (224, 224, 3), target_shape: tuple = ()):
    """Normal images of ``shape`` and uniform labels, as the JAX bench
    makes them; with a ``target_shape`` (a net that takes dense
    targets), f32 targets of that shape, each 0 or 1 with probability
    1/2, as tests/test_zoo.py makes them."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, *shape), dtype=np.float32)
    if target_shape:
        return x, (rng.random((batch, *target_shape)) > 0.5).astype(np.float32)
    return x, rng.integers(0, n_classes, batch)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--ckpt", help="mgtpu-ckpt written by the JAX trainer")
    src.add_argument("--random", action="store_true", help="seeded random weights")
    add_net_arguments(ap, argv)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iterSize", type=int, default=1, help="micro-batches per SGD step")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    trainer = Trainer(parsed_net_opts(args), ckpt=args.ckpt, seed=args.seed, device=args.device,
                      iter_size=args.iterSize)
    dev = trainer.device
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    rule = trainer.net.train_rule(1, trainer.opt)
    x, y = synthetic_batch(args.batch * args.iterSize, args.seed + 1,
                           trainer.net.n_classes(trainer.opt), trainer.image_shape,
                           trainer.target_shape)
    for i in range(args.steps):
        t0 = time.perf_counter()
        m = trainer.step(x, y, rule["lr"], rule["wd"])
        m = {k: float(v) for k, v in m.items()}  # waits for the step
        ms = (time.perf_counter() - t0) * 1e3
        print(json.dumps({"net": trainer.net.describe(trainer.opt), "dtype": "bf16",
                          "batch": args.batch, "iterSize": args.iterSize, "step": i,
                          "device": name, **m, "step_ms": ms}), flush=True)


if __name__ == "__main__":
    main()
