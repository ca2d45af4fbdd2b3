"""The weights a cell hands to both sides, made on the device from the
seed: `mgnet.init_trees`, then each BatchNorm's running stats set to the
moments of its input over a few images of the cell's own kind (as the
port's ``serve.calibrate_batchnorm`` gives a drawn net the scale of a
trained one), and the checkpoint the program loads them from."""

from __future__ import annotations

import contextlib
import os

import torch

from portbench.common import ckpt
from portbench.common.harness import exact_f32
from portbench.reference import mgnet


def bn_batch(image_shape) -> int:
    """Images for the BatchNorm moments: at least 64 values a channel on
    the coarsest grid (size / 32), and 2 at least."""
    return max(2, -(-64 // max(image_shape[0] // 32, 1) ** 2))


def weights(h, net, images=None):
    """(params, stats) trees on the device. ``images`` (NHWC) sets the
    BatchNorm moments; by default N(0, 1) images of the config's shape."""
    g = h.generator(0)
    params, stats = mgnet.init_trees(net, g, h.device)
    if images is None:
        shape = tuple(h.config["image_shape"])
        images = torch.randn((bn_batch(shape), *shape), generator=g, device=h.device)
    with exact_f32():
        mgnet.calibrate_bn(net, params, stats, images)
    return params, stats


@contextlib.contextmanager
def checkpoint(h, params, stats, meta):
    """The trees as an mgtpu-ckpt file under the run's temporary directory,
    removed once the block has loaded it."""
    path = os.path.join(h.tmp, f"portbench_weights_{os.getpid()}.ckpt")
    ckpt.write(path, params, stats, meta)
    try:
        yield path
    finally:
        os.remove(path)


def host(tree):
    return mgnet.map_tree(tree, lambda t: t.detach().float().cpu())


def device(tree, dev, grad=False):
    return mgnet.map_tree(tree, lambda t: t.to(dev).clone().requires_grad_(grad))
